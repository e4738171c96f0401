"""Model blending, SeFa directions and seed-to-image generation.

Port of `maua_tpu/gan/analysis.py` (blend_models, sefa, apply_direction,
generate_images) over the port's parameter dicts: fc weights are (out,
in) here, so SeFa stacks the transposed style affines, as maua_tpu's
(in, out) ones.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from . import stylegan2 as sg2


def _blend(a, b, t: float):
    if isinstance(a, dict):
        return {k: _blend(a[k], b[k], t) for k in a}
    if isinstance(a, (list, tuple)):
        return [_blend(x, y, t) for x, y in zip(a, b)]
    return a * (1 - t) + b * t


def blend_models(params_lo: Dict, params_hi: Dict, cfg: sg2.SG2Config, midpoint_resolution: int = 32,
                 blend_width: Optional[float] = None) -> Dict:
    """Layer-wise blend of two generators: the mapping and the blocks up to
    `midpoint_resolution` from params_lo, the rest from params_hi; with
    `blend_width` (in octaves) a linear ramp across the midpoint."""
    mid_log = math.log2(midpoint_resolution)

    def layer_weight(res: int) -> float:
        if blend_width is None:
            return 0.0 if res <= midpoint_resolution else 1.0
        return float(np.clip((math.log2(res) - mid_log) / blend_width + 0.5, 0, 1))

    return {"mapping": params_lo["mapping"],
            "synthesis": {f"b{res}": _blend(params_lo["synthesis"][f"b{res}"], params_hi["synthesis"][f"b{res}"],
                                            layer_weight(res)) for res in cfg.block_resolutions}}


def sefa(params: Dict, cfg: sg2.SG2Config, n_components: int = 10, layers: Optional[List[str]] = None):
    """Closed-form semantic factors: the top left singular vectors of the
    stacked style affines (w_dim, sum ci). Returns (directions (k, w_dim),
    singular values (k,)); a direction's sign is the SVD's choice."""
    mats = []
    for res in cfg.block_resolutions:
        block = params["synthesis"][f"b{res}"]
        for conv in ("conv0", "conv1"):
            if conv in block and (layers is None or f"b{res}.{conv}" in layers):
                mats.append(block[conv]["affine"]["w"].t())  # (w_dim, ci)
    u, s, _ = torch.linalg.svd(torch.cat(mats, dim=1), full_matrices=False)
    return u[:, :n_components].T, s[:n_components]


def apply_direction(ws: torch.Tensor, direction: torch.Tensor, magnitude: float) -> torch.Tensor:
    """Move w+ latents (B, num_ws, w_dim) along a direction (w_dim,)."""
    return ws + magnitude * direction[None, None, :]


def generate_images(
    generator,
    seeds: str = "0-8",
    truncation: float = 1.0,
    batch_size: int = 8,
    out_dir: Optional[str] = None,
    grid: bool = False,
    sampling_strategy: str = "random",
    gen: Optional[torch.Generator] = None,
    class_idx: Optional[int] = None,
    translation=None,
    rotation=None,
    langevin_critic: str = "discriminator",
) -> np.ndarray:
    """Seeds -> z (the seeds' numpy draws, or `sampling_strategy` from `gen`,
    seed 0 when None, at truncation 1 as maua_tpu does) -> optional class
    one-hot, translation and rotation -> batched rendering -> uint8 images
    (N, H, W, C), written as seed_XXXX.png (or grid.png) under out_dir."""
    z = generator.get_z_latents(seeds)
    if sampling_strategy != "random":
        from .sampling import sample_latents

        if gen is None:
            gen = torch.Generator(device=generator.device).manual_seed(0)
        z = sample_latents(sampling_strategy, gen, z.shape[0], generator.params, generator.cfg,
                           generator=generator, critic=langevin_critic)
        truncation = 1.0
    c = None
    if class_idx is not None:
        c_dim = getattr(generator.cfg, "c_dim", 0)
        if not c_dim:
            raise ValueError("class_idx given but the model is unconditional (c_dim=0)")
        c = torch.nn.functional.one_hot(torch.full((z.shape[0],), class_idx, device=z.device), c_dim).float()
    ws = generator.mapper(z, c=c, truncation=truncation)
    T = ws.shape[0]
    render_kw = {}
    if translation is not None:
        render_kw["translation"] = torch.tensor(translation, dtype=torch.float32).reshape(1, 2).repeat(T, 1)
    if rotation is not None:
        render_kw["rotation"] = torch.full((T,), float(rotation))
    imgs = np.stack(list(generator.render(ws, batch_size=batch_size, **render_kw)))
    if out_dir is not None:
        from ..ops.io import tensor2img

        os.makedirs(out_dir, exist_ok=True)
        if grid:
            n = len(imgs)
            cols = int(math.ceil(math.sqrt(n)))
            rows = int(math.ceil(n / cols))
            h, w, ch = imgs[0].shape
            canvas = np.zeros((rows * h, cols * w, ch), np.uint8)
            for i, im in enumerate(imgs):
                r, col = divmod(i, cols)
                canvas[r * h : (r + 1) * h, col * w : (col + 1) * w] = im
            tensor2img(canvas.astype(np.float32) / 255).save(f"{out_dir}/grid.png")
        else:
            for i, im in enumerate(imgs):
                tensor2img(im.astype(np.float32) / 255).save(f"{out_dir}/seed_{i:04d}.png")
    return imgs
