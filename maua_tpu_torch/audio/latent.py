"""Latent-space interpolation loops for audio-reactive synthesis.

Port of `spline_loops` (natural cubic splines, solved as a tridiagonal
system) and `slerp_loops` from `maua_tpu/audio/latent.py`, including its
pair-major flattening of the slerp segments.
"""

from __future__ import annotations

import torch

from ..ops.signal import resample_1d


def slerp(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation of raw vectors. a, b: (K, L, D); t: (T,) -> (T, K, L, D)."""
    an = a / a.norm(dim=-1, keepdim=True).clamp_min(1e-10)
    bn = b / b.norm(dim=-1, keepdim=True).clamp_min(1e-10)
    d = (an * bn).sum(dim=-1, keepdim=True).clamp(-1.0, 1.0)
    omega = torch.arccos(d)[None]
    so = torch.sin(omega)
    tt = t[:, None, None, None]
    safe = so.clamp_min(1e-6)
    slerped = (torch.sin((1.0 - tt) * omega) / safe) * a[None] + (torch.sin(tt * omega) / safe) * b[None]
    lerped = (1.0 - tt) * a[None] + tt * b[None]
    return torch.where(so < 1e-6, lerped, slerped)


def slerp_loops(y: torch.Tensor, size: int, n_loops: int) -> torch.Tensor:
    """Looping slerp through latents. (K, L, D) -> (size, L, D)."""
    y = torch.cat([y.repeat(n_loops, 1, 1), y[:1]], dim=0)
    n_seg = y.shape[0] - 1
    steps = max(round(size / y.shape[0]), 1)
    t = torch.linspace(0, 1, steps, device=y.device)
    out = slerp(y[:-1], y[1:], t)  # (steps, n_seg, L, D)
    out = out.permute(1, 0, 2, 3).reshape(n_seg * steps, *y.shape[1:])
    return resample_1d(out, size)


def natural_cubic_spline_coeffs(t: torch.Tensor, y: torch.Tensor):
    """Per-interval cubics a + b dt + c dt^2 + d dt^3 through (t_i, y_i),
    natural boundary conditions. t: (N,) increasing; y: (N, ...)."""
    n = t.shape[0]
    h = t[1:] - t[:-1]
    y2 = y.reshape(n, -1)
    one = torch.ones(1, device=t.device)
    zero = torch.zeros(1, device=t.device)
    A = (torch.diag(torch.cat([one, 2.0 * (h[:-1] + h[1:]), one]))
         + torch.diag(torch.cat([h[:-1], zero]), -1) + torch.diag(torch.cat([zero, h[1:]]), 1))
    dy = (y2[1:] - y2[:-1]) / h[:, None]
    zrow = torch.zeros(1, y2.shape[1], device=t.device)
    rhs = torch.cat([zrow, 6.0 * (dy[1:] - dy[:-1]), zrow])
    M = torch.linalg.solve(A, rhs)
    a = y2[:-1]
    b = dy - h[:, None] * (2.0 * M[:-1] + M[1:]) / 6.0
    c = M[:-1] / 2.0
    d = (M[1:] - M[:-1]) / (6.0 * h[:, None])
    shape = y.shape[1:]
    return t, a.reshape(-1, *shape), b.reshape(-1, *shape), c.reshape(-1, *shape), d.reshape(-1, *shape)


def natural_cubic_spline_evaluate(coeffs, t_out: torch.Tensor) -> torch.Tensor:
    t, a, b, c, d = coeffs
    idx = (torch.searchsorted(t, t_out, right=True) - 1).clamp(0, t.shape[0] - 2)
    dt = (t_out - t[idx]).reshape((-1,) + (1,) * (a.dim() - 1))
    return a[idx] + b[idx] * dt + c[idx] * dt**2 + d[idx] * dt**3


def spline_loops(y: torch.Tensor, size: int, n_loops: int) -> torch.Tensor:
    """Looping natural-cubic-spline interpolation. (K, L, D) -> (size, L, D)."""
    y = torch.cat([y.repeat(n_loops, 1, 1), y[:1]], dim=0).float()
    t_in = torch.linspace(0.0, 1.0, y.shape[0], device=y.device)
    t_out = torch.linspace(0.0, 1.0, size, device=y.device)
    return natural_cubic_spline_evaluate(natural_cubic_spline_coeffs(t_in, y), t_out)
