"""Oversampled decoding for non-native aspect ratios, and sparse attention masks.

Port of `maua_tpu/autoregressive/oversample.py`: widen a square-trained
model by sampling overlapping column windows, each window's first
`overlap` columns teacher-forced with the previous window's last ones; the
row, column and conv masks for models trained with them (numpy, (T, T)
bool, True = attend).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .transformer import ARConfig, generate_tokens, resolve_draw


def get_row_mask(cfg: ARConfig) -> np.ndarray:
    """Causal mask restricted to the previous image row and the text."""
    t = cfg.total_length
    mask = np.tril(np.ones((t, t), bool))
    for q in range(cfg.text_length, t):
        lo = cfg.text_length + max(q - cfg.text_length - cfg.image_cols, 0)
        mask[q, cfg.text_length: lo] = False
    return mask


def get_col_mask(cfg: ARConfig) -> np.ndarray:
    """Causal mask attending the same column in earlier rows (and the previous row)."""
    t = cfg.total_length
    mask = np.tril(np.ones((t, t), bool))
    for q in range(cfg.text_length, t):
        img_q = q - cfg.text_length
        img_k = np.arange(q - cfg.text_length)
        drop = (img_k % cfg.image_cols != img_q % cfg.image_cols) & (img_q - img_k > cfg.image_cols)
        mask[q, cfg.text_length: q] &= ~drop
    return mask


def get_conv_mask(cfg: ARConfig, kernel: int = 11) -> np.ndarray:
    """Causal mask over a local 2D window of the image grid."""
    t = cfg.total_length
    mask = np.tril(np.ones((t, t), bool))
    r = kernel // 2
    for q in range(cfg.text_length, t):
        qr, qc = divmod(q - cfg.text_length, cfg.image_cols)
        kr, kc = np.divmod(np.arange(q - cfg.text_length), cfg.image_cols)
        drop = (np.abs(kr - qr) > r) | (np.abs(kc - qc) > r)
        mask[q, cfg.text_length: q] &= ~drop
    return mask


def oversample_generate(params, text_tokens, cfg: ARConfig, target_cols: int, overlap: int = 4,
                        temperature: float = 1.0, top_k: int = 64, decode_fn: Optional[Callable] = None,
                        gen: Optional[torch.Generator] = None, draw: Optional[Callable] = None):
    """A (B, rows, target_cols) token grid (decoded through decode_fn if given) from overlapping
    windows of the model's native columns: each window after the first teacher-forces its first
    `overlap` columns with the previous window's last ones. Draws as in `generate_tokens`."""
    rows, cols = cfg.image_rows, cfg.image_cols
    if target_cols < cols:
        raise ValueError(f"target_cols {target_cols} is narrower than the model's {cols} columns")
    draw = resolve_draw(params, gen, draw)
    grid = None
    while True:
        if grid is None:
            toks = generate_tokens(params, text_tokens, cfg, temperature=temperature, top_k=top_k, draw=draw)
        else:
            forced = torch.zeros(grid.shape[0], rows, cols, dtype=torch.long, device=grid.device)
            forced[:, :, :overlap] = grid[:, :, -overlap:]
            mask = np.zeros((rows, cols), bool)
            mask[:, :overlap] = True
            toks = generate_tokens(params, text_tokens, cfg, temperature=temperature, top_k=top_k,
                                   forced_tokens=forced.reshape(grid.shape[0], -1), forced_mask=mask.reshape(-1),
                                   draw=draw)
        window = toks.reshape(-1, rows, cols)
        grid = window if grid is None else torch.cat([grid, window[:, :, overlap:]], dim=2)
        if grid.shape[2] >= target_cols:
            grid = grid[:, :, :target_cols]
            break
    return decode_fn(grid) if decode_fn is not None else grid
