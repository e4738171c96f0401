"""Latent sequences of self-supervised patches.

Port of `maua_tpu/audiovisual/selfsupervised/latent.py`: wrapping spline
loops and the merge rules of one latent subpatch. The palette order a
subpatch draws (a permutation, from a JAX key in maua_tpu) is given.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ...audio.latent import natural_cubic_spline_coeffs, natural_cubic_spline_evaluate
from ...ops.signal import gaussian_filter


def linspace(stop: float, num: int, device=None) -> torch.Tensor:
    """f32 `num` points from 0 to stop: i * (stop * r) with r = f32(1 / (num
    - 1)), the last exactly stop. This is jnp.linspace(0, stop, num) as XLA
    evaluates it (the division by num - 1 made a product with its f32
    reciprocal, stop folded into it); a phase of many turns magnifies any
    other rounding of it (64 turns: 3e-5 rad, 1e-3 in a noise window)."""
    if num == 1:
        return torch.zeros(1, device=device)
    step = torch.tensor(stop, dtype=torch.float32) * torch.tensor(1.0 / (num - 1), dtype=torch.float32)
    out = torch.arange(num - 1, dtype=torch.float32, device=device) * step.to(device)
    return torch.cat([out, torch.tensor([stop], dtype=torch.float32, device=device)])


def spline_loop_latents(y: torch.Tensor, size: int, n_loops: float = 1.0) -> torch.Tensor:
    """Natural-cubic-spline loop through y and back to its first row, time
    wrapped n_loops times. (K, L, D) -> (size, L, D)."""
    y = torch.cat([y, y[:1]], dim=0)
    t_in = linspace(1.0, y.shape[0], device=y.device)
    t_out = torch.remainder(linspace(float(n_loops), size, device=y.device), 1.0)
    return natural_cubic_spline_evaluate(natural_cubic_spline_coeffs(t_in, y), t_out)


_DEPTH_SLICES = {
    "low": (0, 6),
    "mid": (6, 12),
    "high": (12, 18),
    "lowmid": (0, 12),
    "midhigh": (6, 18),
    "all": (0, 18),
}


def latent_patch(
    permutation: torch.Tensor,  # (P,) palette order
    latents: torch.Tensor,  # (T, L, D)
    palette: torch.Tensor,  # (P, L, D)
    segmentations: Dict,
    features: Dict,
    tempo: float,
    fps: float,
    patch_type: str,
    segments: int,
    loop_bars: int,
    seq_feat: str,
    seq_feat_weight: float,
    mod_feat: str,
    mod_feat_weight: float,
    merge_type: str,
    merge_depth: str,
) -> torch.Tensor:
    """Apply one latent subpatch: a sequence through the palette (by
    segmentation, by feature weights or as a tempo loop), merged into the
    layers of `merge_depth`."""
    t, n_layers, _ = latents.shape
    feature = seq_feat_weight * features[seq_feat][:t]
    if patch_type == "segmentation":
        segmentation = torch.as_tensor(np.asarray(segmentations[(seq_feat, int(segments))])[:t], dtype=torch.long,
                                       device=palette.device)
        sequence = gaussian_filter(palette[permutation[: int(segments)][segmentation]], 5.0)
    elif patch_type == "feature":
        n_select = feature.shape[1]
        if n_select == 1:
            selection = palette[permutation[:2]]
            f = feature[..., None]
            sequence = f * selection[0][None] + (1 - f) * selection[1][None]
        else:
            # wrap when the feature has more channels than the palette rows
            selection = permutation[torch.arange(n_select, device=permutation.device) % permutation.shape[0]]
            sequence = torch.einsum("TN,NWL->TWL", feature, palette[selection])
    else:  # loop
        n_loops = max(t / fps * max(tempo, 1e-3) / 60 / 4 / loop_bars, 0.25)
        sequence = spline_loop_latents(palette[permutation[: int(segments)]], t, n_loops=n_loops)
    sequence = gaussian_filter(sequence, 1.0)

    lo, hi = _DEPTH_SLICES[merge_depth]
    hi = min(hi, n_layers)
    if merge_type == "average":
        merged = (latents[:, lo:hi] + sequence[:, lo:hi]) / 2
    elif merge_type == "modulate":
        modulation = mod_feat_weight * features[mod_feat][:t, :1][..., None]
        merged = latents[:, lo:hi] * (1 - modulation) + modulation * sequence[:, lo:hi]
    else:
        merged = sequence[:, lo:hi]
    out = latents.clone()
    out[:, lo:hi] = merged
    return out
