"""The canonical audio -> StyleGAN2 recipe.

Port of `maua_tpu/audiovisual/patches/examples/stylegan2.py`: split the
sources, build kick / snare / drum onsets, bass / vocal loudness and
chroma envelopes, then mix chroma-weighted latents, spline loops,
onset-driven blends, a two-speed noise pyramid and beat-driven
translation, zoom and rotation.
"""

import torch

from maua_tpu_torch.audiovisual import audioreactive as ar
from maua_tpu_torch.audiovisual.patches.base import StyleGAN2Patch


class ExampleSG2Patch(StyleGAN2Patch):
    def process_audio(self):
        vocals, drums, bass, other = ar.separate_sources(self.audio, self.sr)

        n = self.n_frames
        self.kick_onsets = ar.onsets(ar.low_pass(drums, self.sr, 100, 24), self.sr, n, margin=2, clip=95, smooth=2)
        self.snare_onsets = ar.onsets(ar.band_pass(drums, self.sr, 100, 400, 24), self.sr, n,
                                      margin=2, clip=95, smooth=2)
        self.drum_onsets = ar.onsets(drums, self.sr, n, margin=2, clip=95, smooth=2).reshape(-1, 1, 1)
        self.bass_rms = ar.rms(bass, self.sr, n, smooth=20, clip=95, power=1).reshape(-1, 1, 1)
        self.vocal_rms = ar.rms(vocals, self.sr, n, smooth=5, clip=95, power=1).reshape(-1, 1, 1)
        self.vocal_chroma = ar.chroma(vocals, self.sr, n, margin=2)
        self.other_chroma = ar.chroma(other, self.sr, n, margin=2)

    def process_mapper_inputs(self):
        return {"z": self.stylegan2.get_z_latents("1-12,24-36,77-87,777-787,7777-7787")}

    def base_noise(self, n):
        """The random draws of the recipe: two (n, 1, 64, 64) noise videos and
        (n,) rotation jitter, standard normal, from a generator seeded with 0."""
        gen = torch.Generator(device=self.device).manual_seed(0)
        return (torch.randn(n, 1, 64, 64, generator=gen, device=self.device),
                torch.randn(n, 1, 64, 64, generator=gen, device=self.device),
                torch.randn(n, generator=gen, device=self.device))

    def process_synthesizer_inputs(self, latent_w):
        n = self.n_frames
        vocal_chroma_latents = ar.chroma_weight_latents(self.vocal_chroma, latent_w[:12])
        other_chroma_latents = ar.chroma_weight_latents(self.other_chroma, latent_w[12:24])
        drum_latents = ar.spline_loops(latent_w[24:34], n, n_loops=max(int(self.duration / 7), 1))
        bass_latents = ar.spline_loops(latent_w[34:44], n, n_loops=max(int(self.duration / 5), 1))

        latent_w_plus = ar.spline_loops(latent_w[44:], n, n_loops=1)
        latent_w_plus = (1 - self.vocal_rms) * latent_w_plus + self.vocal_rms * vocal_chroma_latents
        latent_w_plus[:, 10:] = other_chroma_latents[:, 10:]
        latent_w_plus = (1 - self.drum_onsets) * latent_w_plus + self.drum_onsets * drum_latents
        latent_w_plus = (1 - self.bass_rms) * latent_w_plus + self.bass_rms * bass_latents

        slow, fast, jitter = self.base_noise(n)
        noise_slow = ar.gaussian_filter(slow, 15)
        noise_slow = noise_slow / ar.gaussian_filter(noise_slow.std((1, 2, 3), correction=0), 5).reshape(-1, 1, 1, 1)
        noise_fast = ar.gaussian_filter(fast, 3)
        noise_fast = noise_fast / (0.5 * ar.gaussian_filter(noise_fast.std((1, 2, 3), correction=0), 5)
                                   .reshape(-1, 1, 1, 1))
        onsets4 = self.drum_onsets[..., None]
        noise = (1 - onsets4) * noise_slow + onsets4 * noise_fast
        noises = self.stylegan2.make_noise_pyramid(noise)
        # freeze the coarsest noise layers mid-song for structure
        for name in list(noises.keys())[:3]:
            noises[name] = noises[name][n // 2 : n // 2 + 1].repeat(n, 1, 1, 1)

        translation = torch.cat([0.1 * (1 - self.snare_onsets.reshape(-1, 1)),
                                 torch.zeros(n, 1, device=self.device)], dim=1)
        zoom = 1 - 0.3 * self.kick_onsets
        rotation = self.kick_onsets * 5 * ar.gaussian_filter(jitter, 1)

        return {
            "latent_w_plus": latent_w_plus,
            "zoom": zoom,
            "translation": translation,
            "rotation": rotation,
            **noises,
        }
