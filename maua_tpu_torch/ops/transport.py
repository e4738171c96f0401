"""Sliced optimal transport and histogram matching.

Port of `maua_tpu/ops/transport.py`: random SO(N) rotations from a QR
decomposition, per-channel CDF histogram matching (256-bin scatter-add
histograms and two `interp` remaps), covariance colour transfer in
cholesky, PCA and symmetric modes, and the sliced-OT iteration built from
them. Inputs are channel-last (..., C), as in the reference. PyTorch has no
`interp`; `interp` here follows `jnp.interp`'s rules.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def random_rotation(n: int, gen: Optional[torch.Generator] = None, normal: Optional[torch.Tensor] = None,
                    device=None) -> torch.Tensor:
    """Haar-random SO(n) matrix (det +1, inverse = transpose) from an (n, n) standard normal matrix:
    `normal` where given, else a draw from `gen`."""
    if normal is None:
        device = gen.device if gen is not None else device
        normal = torch.randn(n, n, generator=gen, device=device)
    q, r = torch.linalg.qr(normal.float())
    q = q * torch.sign(torch.diagonal(r))
    # force det +1 by flipping one axis when the reflection part is odd
    q = q.clone()
    q[:, -1] = q[:, -1] * torch.sign(torch.linalg.det(q))
    return q


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """`jnp.interp(x, xp, fp)` for increasing (possibly repeated) xp: the ends clamp to fp[0] and
    fp[-1]; inside, i = clip(searchsorted(xp, x, 'right'), 1, len - 1) and
    fp[i-1] + (x - xp[i-1]) * (fp[i] - fp[i-1]) / (xp[i] - xp[i-1]), where a zero-width interval
    gives fp[i-1] (its slope is 0)."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, xp.shape[-1] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = torch.abs(dx) <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def cdf_match(target: torch.Tensor, source: torch.Tensor, bins: int = 256) -> torch.Tensor:
    """Per-channel CDF histogram matching: remap `target` values so that its per-channel empirical
    distribution matches `source`'s. target (..., C), source (..., C); returns target's shape."""
    c = target.shape[-1]
    t = target.reshape(-1, c).T.float()  # (C, Nt)
    s = source.reshape(-1, c).T.float()  # (C, Ns)
    steps = torch.linspace(0.0, 1.0, bins + 1, device=t.device)[1:]
    out = []
    for tc, sc in zip(t, s):
        lo = torch.minimum(tc.min(), sc.min())
        hi = torch.maximum(tc.max(), sc.max())
        span = torch.clamp_min(hi - lo, 1e-12)
        edges = lo + span * steps

        def cdf(x):
            idx = torch.clamp(((x - lo) / span * bins).to(torch.int32), 0, bins - 1).long()
            h = torch.zeros(bins, device=x.device).index_add_(0, idx, torch.ones_like(x))
            h = torch.cumsum(h, 0)
            return h / h[-1]

        remapped = interp(cdf(tc), cdf(sc), edges)
        out.append(interp(tc, edges, remapped))
    out = torch.stack(out).T.reshape(target.shape)
    return torch.clamp(out, target.min(), target.max()).to(target.dtype)


def _cov(x: torch.Tensor, eps: float) -> torch.Tensor:
    """(C, N) centered features -> (C, C) covariance + eps*I."""
    return x @ x.T / x.shape[1] + eps * torch.eye(x.shape[0], dtype=x.dtype, device=x.device)


def _psd_sqrt(c: torch.Tensor) -> torch.Tensor:
    eva, eve = torch.linalg.eigh(c)
    return eve @ torch.diag(torch.sqrt(torch.clamp_min(eva, 0.0))) @ eve.T


def hist_match(target: torch.Tensor, source: torch.Tensor, mode: str = "cdf", eps: float = 1e-2) -> torch.Tensor:
    """Match target's per-channel statistics to source's; both (..., C). Modes: 'cdf' the full
    per-channel CDF remap; 'chol', 'pca' and 'sym' second-moment colour transfer through cholesky,
    PCA whitening or the symmetric Monge map."""
    if mode == "cdf":
        return cdf_match(target, source)

    c = target.shape[-1]
    t = target.reshape(-1, c).T.float()
    s = source.reshape(-1, c).T.float()
    mu_t = t.mean(dim=1, keepdim=True)
    mu_s = s.mean(dim=1, keepdim=True)
    cov_t = _cov(t - mu_t, eps)
    cov_s = _cov(s - mu_s, eps)

    if mode == "chol":
        matched = torch.linalg.cholesky(cov_s) @ torch.linalg.inv(torch.linalg.cholesky(cov_t)) @ (t - mu_t)
    elif mode == "pca":
        matched = _psd_sqrt(cov_s) @ torch.linalg.inv(_psd_sqrt(cov_t)) @ (t - mu_t)
    elif mode == "sym":
        qt = _psd_sqrt(cov_t)
        qt_inv = torch.linalg.inv(qt)
        matched = qt_inv @ _psd_sqrt(qt @ cov_s @ qt) @ qt_inv @ (t - mu_t)
    else:
        raise ValueError(f"unknown hist_match mode {mode!r}")
    return (matched + mu_s).T.reshape(target.shape).to(target.dtype)


def sliced_histogram_transport(source: torch.Tensor, target: torch.Tensor, iters: int = 8,
                               gen: Optional[torch.Generator] = None, normals=None) -> torch.Tensor:
    """Iterative sliced-OT colour transfer: rotate channels by a random SO(C) basis, CDF-match per
    rotated channel, rotate back; repeat. source and target are (..., C). Each iteration's (C, C)
    normal matrix comes from `normals` where given, else from `gen` (seed 0 on source's device)."""
    c = source.shape[-1]
    if normals is None and gen is None:
        gen = torch.Generator(device=source.device).manual_seed(0)
    for i in range(iters):
        rot = random_rotation(c, gen, None if normals is None else torch.as_tensor(normals[i], device=source.device))
        source = cdf_match(source @ rot, target @ rot) @ rot.T
    return source
