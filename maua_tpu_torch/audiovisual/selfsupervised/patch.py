"""The seeded random audio-reactive patch: a stack of latent and noise
subpatches, mutated and saved as JSON.

Port of `maua_tpu/audiovisual/selfsupervised/patch.py`. The patch's
choices (subpatch kinds, features, merge rules, intensities, the base
palette selection) are numpy `default_rng` draws, as in maua_tpu, so a
patch of a seed makes the same choices, prints the same and saves the
same JSON. Its tensors (each latent subpatch's palette order, the noise
banks) come through one seam, `Patch.draws`: a `Draws` on a
torch.Generator seeded with the patch's seed, on the palette's device,
where maua_tpu folds indices into a JAX key.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .features import ALLFEATS, UNITFEATS
from .latent import latent_patch, spline_loop_latents
from .noise import Loop, noise_patch

NOISE_SIZES = [4, 8, 8, 16, 16, 32, 32, 64, 64, 128, 128, 256, 256, 512, 512, 1024, 1024]


def seeded_normal(seed: int, shape: Tuple[int, ...], device=None) -> torch.Tensor:
    """Standard normal draws from a torch.Generator seeded with `seed` on
    `device`: the port's palette draw where maua_tpu draws
    jax.random.normal(PRNGKey(seed), shape)."""
    device = torch.device("cpu" if device is None else device)
    return torch.randn(shape, generator=torch.Generator(device=device).manual_seed(int(seed)), device=device)


class Draws:
    """The random tensors of one realization, drawn in order from a
    torch.Generator seeded with the patch's seed on `device`. `path` names
    each draw by the indices maua_tpu folds into its key: (i,) for latent
    subpatch i, (1000 + s,) for the base noise of size s, (2000 + i, n)
    for noise subpatch i at layer n; a replacement can draw by it."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(int(seed))

    def permutation(self, path: Tuple[int, ...], n: int) -> torch.Tensor:
        return torch.randperm(n, generator=self.gen, device=self.device)

    def normal(self, path: Tuple[int, ...], shape: Tuple[int, ...]) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device)


def _choice(rng: np.random.Generator, options, weights=None):
    p = None
    if weights is not None:
        w = np.asarray(weights, float)
        p = w / w.sum()
    return options[rng.choice(len(options), p=p)]


def skewnorm(rng: np.random.Generator, a: float, loc: float, scale: float) -> float:
    """One skew-normal draw (shape a) from two standard normals."""
    u0 = rng.standard_normal()
    v = rng.standard_normal()
    d = a / np.sqrt(1 + a**2)
    u1 = d * u0 + v * np.sqrt(1 - d**2)
    return float(loc + scale * (u1 if u0 >= 0 else -u1))


class Patch:
    """A seeded stack of latent and noise subpatches over (T, F) features
    and per-frame segmentations keyed (feature, k)."""

    def __init__(self, features: Dict, segmentations: Dict, tempo: float, fps: float = 24, seed: int = 42,
                 min_subpatches: int = 2, max_subpatches: int = 20):
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.fps = fps
        self.tempo = tempo
        self.features = features
        self.segmentations = segmentations
        self.length = int(next(iter(features.values())).shape[0])
        self.ks = sorted(set(k for (_, k) in segmentations.keys()))
        self.min_subpatches, self.max_subpatches = min_subpatches, max_subpatches

        self.n_base_latents = int(self.rng.integers(3, 15))
        self.sigma_base_noise = float(1 + 9 * self.rng.random())
        self.loops_base_noise = int(_choice(self.rng, [1, 2, 4, 8, 16, 32, 64]))

        self.randomize_latent_patches()
        self.randomize_noise_patches()

    # ------------------------------------------------------ randomizing
    def randomize_latent_patches(self):
        n = int(self.rng.integers(self.min_subpatches, self.max_subpatches))
        self.latent_patches = [self.random_latent_patch() for _ in range(n)]

    def randomize_noise_patches(self):
        n = int(self.rng.integers(self.min_subpatches, self.max_subpatches))
        self.noise_patches = [self.random_noise_patch() for _ in range(n)]

    def random_latent_patch(self) -> Dict:
        return dict(
            patch_type=_choice(self.rng, ["segmentation", "feature", "loop"]),
            segments=int(_choice(self.rng, self.ks)),
            loop_bars=int(_choice(self.rng, [4, 8, 16, 32], weights=[2, 2, 2, 1])),
            seq_feat=_choice(self.rng, ALLFEATS),
            seq_feat_weight=1.0,
            mod_feat=_choice(self.rng, UNITFEATS),
            mod_feat_weight=1.0,
            merge_type=_choice(self.rng, ["average", "modulate"], weights=[1, 3]),
            merge_depth=_choice(self.rng, ["low", "mid", "high", "lowmid", "midhigh", "all"],
                                weights=[3, 3, 3, 2, 2, 1]),
        )

    def random_noise_patch(self) -> Dict:
        return dict(
            patch_type=_choice(self.rng, ["blend", "multiply", "loop"]),
            loop_bars=int(_choice(self.rng, [4, 8, 16, 32], weights=[2, 2, 2, 1])),
            seq_feat=_choice(self.rng, ALLFEATS),
            seq_feat_weight=1.0,
            mod_feat=_choice(self.rng, UNITFEATS),
            mod_feat_weight=1.0,
            merge_type=_choice(self.rng, ["average", "modulate"], weights=[1, 3]),
            merge_depth=_choice(self.rng, ["low", "mid", "high", "lowmid", "midhigh", "all"],
                                weights=[3, 3, 3, 2, 2, 1]),
            noise_mean=0.0,
            noise_std=1.0,
        )

    def update_intensity(self, val: float):
        """Redraw every subpatch's feature weights (and noise std) from a
        skew-normal around `val`."""
        for p in self.latent_patches:
            p["seq_feat_weight"] = skewnorm(self.rng, 5, val, 0.5)
            p["mod_feat_weight"] = skewnorm(self.rng, 5, val, 0.5)
        for p in self.noise_patches:
            p["seq_feat_weight"] = skewnorm(self.rng, 5, val, 0.5)
            p["mod_feat_weight"] = skewnorm(self.rng, 5, val, 0.5)
            p["noise_std"] = skewnorm(self.rng, 5, val, 0.5)

    # ------------------------------------------------------- realization
    def draws(self, device) -> Draws:
        """The source of this patch's random tensors on `device`."""
        return Draws(self.seed, device)

    def __call__(self, latent_palette: torch.Tensor, downscale_factor: int = 1, aspect_ratio: float = 1.0,
                 noise_sizes: Optional[Sequence[int]] = None):
        """-> (latents (T, L, D) on the palette's device, one lazy noise
        module per size)."""
        rng = np.random.default_rng(self.seed)
        draws = self.draws(latent_palette.device)
        n_palette = len(latent_palette)

        base_selection = rng.permutation(n_palette)[: self.n_base_latents]
        latents = spline_loop_latents(latent_palette[torch.as_tensor(base_selection, device=latent_palette.device)],
                                      self.length)
        for i, subpatch in enumerate(self.latent_patches):
            latents = latent_patch(draws.permutation((i,), n_palette), latents, latent_palette, self.segmentations,
                                   self.features, self.tempo, self.fps, **subpatch)

        sizes = list(noise_sizes if noise_sizes is not None else NOISE_SIZES)
        noise = []
        for si, size in enumerate(sizes):
            hw = (max(round(aspect_ratio * size / downscale_factor), 1), max(round(size / downscale_factor), 1))
            noise.append(Loop(draws.normal((1000 + si,), (3, *hw)), self.length, n_loops=self.loops_base_noise,
                              sigma=self.sigma_base_noise))
        for i, subpatch in enumerate(self.noise_patches):
            noise = noise_patch(lambda n, shape, i=i: draws.normal((2000 + i, n), shape), noise, self.features,
                                self.tempo, self.fps, **subpatch)
        return latents, noise

    # ------------------------------------------------------ persistence
    def save(self, path: str):
        state = dict(
            seed=self.seed,
            latent_patches=self.latent_patches,
            noise_patches=self.noise_patches,
            n_base_latents=self.n_base_latents,
            sigma_base_noise=self.sigma_base_noise,
            loops_base_noise=self.loops_base_noise,
        )
        with open(path, "w") as f:
            f.write(json.dumps(state))

    @staticmethod
    def load(path: str, features, segmentations, tempo, fps: float = 24) -> "Patch":
        patch = Patch(features, segmentations, tempo, fps)
        with open(path) as f:
            info = json.loads(f.read())
        for k, v in info.items():
            setattr(patch, k, v)
        return patch

    def __repr__(self):
        lines = [f"Patch(seed={self.seed}, {len(self.latent_patches)} latent + "
                 f"{len(self.noise_patches)} noise subpatches)"]
        for p in self.latent_patches:
            lines.append(f"  latent: {p['patch_type']:<12} {p['seq_feat']:<18} {p['merge_type']}/{p['merge_depth']}")
        for p in self.noise_patches:
            lines.append(f"  noise : {p['patch_type']:<12} {p['seq_feat']:<18} {p['merge_type']}/{p['merge_depth']}")
        return "\n".join(lines)
