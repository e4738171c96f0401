"""Noise-parameterization example patch.

Port of `maua_tpu/audiovisual/patches/examples/noise_parameterization.py`:
onset-, volume- and chroma-driven blends of spline loops and
chroma-weighted latents, and a structured noise pyramid (a rotating
perlin annulus over static perlin noise inside a disc, one revolution
every 6-8 s, with slow random noise on the three coarsest layers). The
recipe's choices are numpy RandomState(seed) draws, as in maua_tpu; its
random tensors come from one torch.Generator seeded with `seed`
(`noise_draws`), where maua_tpu draws them from JAX keys.
"""

import math

import numpy as np
import torch

from maua_tpu_torch.audiovisual import audioreactive as ar
from maua_tpu_torch.audiovisual.patches.base import StyleGAN2Patch
from maua_tpu_torch.ops.noise import perlin_noise_from_angles, round_to_closest_divisor
from maua_tpu_torch.ops.warp import rotate


def circular_mask(h, w, radius=None):
    cy, cx = h / 2, w / 2
    radius = radius if radius is not None else min(cx, cy)
    yy, xx = np.ogrid[:h, :w]
    return (np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2) <= radius).astype(np.float32)


class NoiseParameterization(StyleGAN2Patch):
    seed = 42

    def process_audio(self):
        n = self.n_frames
        self.onsets = ar.onsets(self.audio, self.sr, n, clip=95, smooth=40).reshape(-1, 1, 1)
        self.volume = ar.volume(self.audio, self.sr, n, smooth=80).reshape(-1, 1, 1)
        self.chroma = ar.chroma(self.audio, self.sr, n)

    def process_mapper_inputs(self):
        return {"latent_z": self.stylegan2.get_z_latents("1-40,400-440")}

    def noise_draws(self, angle_shape, extra_shapes):
        """The recipe's random tensors, from a generator seeded with `seed`:
        the gradient angles (theta, phi) of the rotating and of the static
        perlin volume, each `angle_shape` and uniform in [0, 2 pi), then one
        standard-normal tensor of each of `extra_shapes`."""
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        angles = [2 * math.pi * torch.rand(angle_shape, generator=gen, device=self.device) for _ in range(4)]
        extras = [torch.randn(shape, generator=gen, device=self.device) for shape in extra_shapes]
        return angles, extras

    def process_synthesizer_inputs(self, latent_w):
        n = self.n_frames
        rng = np.random.RandomState(self.seed)

        def sel(pool, k):
            return pool[torch.from_numpy(rng.permutation(pool.shape[0])[:k]).to(pool.device)]

        base_structure = sel(latent_w[:40], 10)
        chroma_colors = sel(latent_w[40:], 12)
        onset_colors = sel(latent_w[40:], rng.choice(range(3, 7)))
        volume_colors = sel(latent_w[40:], rng.choice(range(3, 7)))

        latents = ar.chroma_weight_latents(self.chroma, chroma_colors)
        base_loop = ar.spline_loops(base_structure, n, n_loops=int(rng.choice(range(1, 3))))
        onset_latents = ar.spline_loops(onset_colors, n, n_loops=int(rng.choice(range(2, 7))))
        volume_latents = ar.spline_loops(volume_colors, n, n_loops=int(rng.choice(range(2, 7))))

        latents = latents.clone()
        latents[:, :4] = base_loop[:, :4]
        latents = (1 - self.volume) * latents + self.volume * volume_latents
        latents = (1 - self.onsets) * latents + self.onsets * onset_latents
        latents = ar.gaussian_filter(latents, 2)

        # one revolution every ~6-8 seconds, tiled over the video
        steps_per_rev = int(rng.choice([6, 6.5, 7, 8]) * self.fps)
        revolution = -np.linspace(0, 360 * (1 - 1 / steps_per_rev), steps_per_rev, dtype=np.float32)
        angles = np.resize(np.tile(revolution, max(n // steps_per_rev + 1, 1)), n)

        s = 64
        time_res = int(rng.choice([4, 8]))
        space_res = int(rng.choice([4, 8]))
        shape = (n, s, s)
        res = [round_to_closest_divisor(shape[i], r) for i, r in enumerate((time_res, space_res, space_res))]
        # the pyramid's layer sizes (of a zero frame), for the extras drawn with the perlin angles
        names = self.stylegan2.make_noise_pyramid(torch.zeros(1, 1, s, s, device=self.device), layer_limit=13)
        extra_shapes = [(n, 1) + tuple(names[k].shape[2:]) for k in list(names)[:3]]
        (t1, p1, t2, p2), extras = self.noise_draws(tuple(r + 1 for r in res), extra_shapes)
        rot_src = perlin_noise_from_angles(t1, p1, shape)[:, None]
        rotating = rotate(rot_src, torch.from_numpy(angles).to(self.device), padding_mode="reflection")
        static = perlin_noise_from_angles(t2, p2, shape)[:, None]

        disc = circular_mask(s, s) - circular_mask(s, s, radius=int(s / rng.choice([6, 6.5, 7])))
        disc = torch.from_numpy(disc).to(self.device)[None, None]
        noise = (1 - disc) * static + float(rng.choice([1, 2, 3, 4])) * disc * rotating
        noise = noise - noise.mean(dim=(2, 3), keepdim=True)
        noise = noise / ar.gaussian_filter(noise.std(dim=(2, 3), keepdim=True, correction=0), 10)
        noise = noise * float(rng.choice([1, 2, 3, 4]))

        noises = self.stylegan2.make_noise_pyramid(noise, layer_limit=13)
        # slow-drifting random noise over the three coarsest layers
        for i, name in enumerate(list(noises)[:3]):
            extra = ar.gaussian_filter(extras[i], 50)
            extra = extra / ar.gaussian_filter(extra.std(dim=(2, 3), keepdim=True, correction=0), 10)
            noises[name] = extra if i == 0 else noises[name] + (2.0 if i == 1 else 1.0) * extra

        return {"latent_w_plus": latents, **noises}
