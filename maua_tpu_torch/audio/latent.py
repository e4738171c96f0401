"""Latent-space interpolation for audio-reactive synthesis.

Port of `maua_tpu/audio/latent.py`: envelope-weighted blends
(single_weighted, multi_weighted, select_modulo), eerp / copeerp, slerp,
`spline_loops` (natural cubic splines, solved as a tridiagonal system),
`slerp_loops` with its pair-major flattening of the segments, and
`tempo_loops`.
"""

from __future__ import annotations

import torch

from ..ops.signal import gaussian_filter, normalize, resample_1d


def single_weighted(low_latent: torch.Tensor, high_latent: torch.Tensor, envelope: torch.Tensor) -> torch.Tensor:
    """Blend two latents by an envelope: (L, D), (L, D), (T,) -> (T, L, D)."""
    e = envelope[:, None, None]
    return low_latent[None] * (1 - e) + high_latent[None] * e


def multi_weighted(latents: torch.Tensor, envelopes: torch.Tensor) -> torch.Tensor:
    """Latents weighted by per-latent envelopes: (K, L, D), (T, K) -> (T, L, D);
    envelope k weights latent k modulo the number of latents."""
    w = envelopes / envelopes.sum(dim=1, keepdim=True).clamp_min(1e-10)
    k = envelopes.shape[1]
    sel = latents[torch.arange(k, device=latents.device) % latents.shape[0]]
    return torch.einsum("tk,kld->tld", w, sel)


def select_modulo(latents: torch.Tensor, envelope: torch.Tensor, smooth: float = 2.0) -> torch.Tensor:
    """The latent whose index is the envelope's level between its quartiles, smoothed."""
    low, high = torch.quantile(envelope, 0.25), torch.quantile(envelope, 0.75)
    idx = torch.round(normalize(envelope.clamp(low, high)) * (latents.shape[0] - 1)).long()
    return gaussian_filter(latents[idx], smooth, causal=0.0)


def eerp(a, b, t):
    """Exponential interpolation."""
    return a ** (1 - t) * b**t


def copeerp(a, b, t):
    """Co-exponential interpolation."""
    return a**t * (1 - b**t) / (1 - a**t + b**t)


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


def tempo_loops(latents: torch.Tensor, n_frames: int, fps: float, tempo: float, type: str = "spline") -> torch.Tensor:
    """Loops through the latents, one loop per bar of 4 beats at `tempo` BPM."""
    bars_per_sec = tempo / 4.0 / 60.0
    n_loops = max(round(n_frames / fps * bars_per_sec), 1)
    if type == "spline":
        return spline_loops(latents, n_frames, n_loops)
    return slerp_loops(latents, n_frames, n_loops)
