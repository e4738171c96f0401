"""Audio-video alignment metrics.

Port of `maua_tpu/audiovisual/selfsupervised/correlation.py`: every
metric of METRICS (per-column pearson / spearman / concordance, gram and
subspace similarities, RV and its adjustments, CCA, SVCCA, PWCCA, CKA,
HSIC, distance correlation, ...) and `audio_video_correlation`, in f32
on the features' device, as JAX computes them. X: (T, Dx), Y: (T, Dy).
Medians take the mean of the two middle values, as jnp.median does.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch


def _center(x):
    return x - x.mean(dim=0, keepdim=True)


def _median(x: torch.Tensor) -> torch.Tensor:
    srt = x.flatten().sort().values
    n = srt.numel()
    return (srt[(n - 1) // 2] + srt[n // 2]) * 0.5


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def rv(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """RV coefficient."""
    X, Y = _center(X), _center(Y)
    Sxy = X.T @ Y
    Sxx = X.T @ X
    Syy = Y.T @ Y
    num = torch.trace(Sxy @ Sxy.T)
    den = torch.sqrt(torch.trace(Sxx @ Sxx) * torch.trace(Syy @ Syy))
    return num / den.clamp_min(1e-10)


def rv2(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Modified RV (diagonal removed)."""
    X, Y = _center(X), _center(Y)
    AA = X @ X.T
    BB = Y @ Y.T
    AA = AA - torch.diag(torch.diag(AA))
    BB = BB - torch.diag(torch.diag(BB))
    num = torch.trace(AA @ BB)
    den = torch.sqrt(torch.trace(AA @ AA) * torch.trace(BB @ BB))
    return num / den.clamp_min(1e-10)


def linear_cka(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Linear centered kernel alignment."""
    X, Y = _center(X), _center(Y)
    num = (Y.T @ X).square().sum()
    den = torch.linalg.norm(X.T @ X) * torch.linalg.norm(Y.T @ Y)
    return num / den.clamp_min(1e-10)


def _rbf_gram(X, sigma_frac=0.5):
    sq = X.square().sum(1)
    d2 = (sq[:, None] + sq[None] - 2 * X @ X.T).clamp_min(0.0)
    return torch.exp(-d2 / (2 * sigma_frac * _median(d2)).clamp_min(1e-10))


def _center_gram(K):
    n = K.shape[0]
    H = _eye(n, K) - 1.0 / n
    return H @ K @ H


def rbf_cka(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    Kx = _center_gram(_rbf_gram(X))
    Ky = _center_gram(_rbf_gram(Y))
    num = (Kx * Ky).sum()
    den = torch.sqrt((Kx * Kx).sum() * (Ky * Ky).sum())
    return num / den.clamp_min(1e-10)


def hsic(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Hilbert-Schmidt independence criterion (biased, RBF)."""
    n = X.shape[0]
    Kx = _center_gram(_rbf_gram(X))
    Ky = _center_gram(_rbf_gram(Y))
    return (Kx * Ky).sum() / (n - 1) ** 2


def _inv_sqrt(S, eps):
    eva, eve = torch.linalg.eigh(S)
    return (eve * (1.0 / eva.clamp_min(eps).sqrt())[None]) @ eve.T


def cca(X: torch.Tensor, Y: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Mean canonical correlation."""
    X, Y = _center(X), _center(Y)
    n = X.shape[0]
    Sxx = X.T @ X / n + eps * _eye(X.shape[1], X)
    Syy = Y.T @ Y / n + eps * _eye(Y.shape[1], Y)
    Sxy = X.T @ Y / n
    s = torch.linalg.svdvals(_inv_sqrt(Sxx, eps) @ Sxy @ _inv_sqrt(Syy, eps))
    return s.clamp(0, 1).mean()


def distance_correlation(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Szekely distance correlation."""

    def dmat(Z):
        sq = Z.square().sum(1)
        d = (sq[:, None] + sq[None] - 2 * Z @ Z.T).clamp_min(0.0).sqrt()
        return d - d.mean(0, keepdim=True) - d.mean(1, keepdim=True) + d.mean()

    A, B = dmat(X), dmat(Y)
    dcov2 = (A * B).mean()
    dvar_x = (A * A).mean()
    dvar_y = (B * B).mean()
    return dcov2.clamp_min(0).sqrt() / (dvar_x * dvar_y).sqrt().sqrt().clamp_min(1e-10)


def pearson_mean(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Mean absolute pairwise Pearson correlation."""
    Xn = _center(X) / X.std(0, keepdim=True, correction=0).clamp_min(1e-10)
    Yn = _center(Y) / Y.std(0, keepdim=True, correction=0).clamp_min(1e-10)
    return (Xn.T @ Yn / X.shape[0]).abs().mean()


def norm_similarity(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Correlation of the per-frame magnitude envelopes."""
    nx = torch.linalg.norm(X, dim=1)
    ny = torch.linalg.norm(Y, dim=1)
    nx = (nx - nx.mean()) / nx.std(correction=0).clamp_min(1e-10)
    ny = (ny - ny.mean()) / ny.std(correction=0).clamp_min(1e-10)
    return (nx * ny).mean()


def _pearson_cols(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Per-column Pearson r."""
    cov = (_center(X) * _center(Y)).sum(0) / (X.shape[0] - 1)
    return cov / (X.std(0) * Y.std(0)).clamp_min(1e-12)


def pearson(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Median per-column Pearson."""
    return _median(_pearson_cols(X, Y))


def _ranks_lastdim(X: torch.Tensor) -> torch.Tensor:
    """Exact ranks along the feature axis (stable for ties)."""
    return torch.argsort(torch.argsort(X, dim=-1, stable=True), dim=-1, stable=True).to(X.dtype) + 1.0


def spearman(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Median per-column rank correlation."""
    return pearson(_ranks_lastdim(X) / X.shape[-1], _ranks_lastdim(Y) / Y.shape[-1])


def concordance(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Median per-column concordance correlation coefficient."""
    n = X.shape[0]
    bessel = (n - 1) / n
    r = _pearson_cols(X, Y)
    sx, sy = X.std(0), Y.std(0)
    mx, my = X.mean(0), Y.mean(0)
    return _median(2 * r * sx * sy / (sx**2 + sy**2 + (mx - my) ** 2 / bessel))


def autocorrcorr(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Pearson correlation of the upper triangles of the two self-similarity
    (gram) matrices."""
    Xc, Yc = _center(X), _center(Y)
    Xn = Xc / torch.linalg.norm(Xc, dim=1, keepdim=True).clamp_min(1e-12)
    Yn = Yc / torch.linalg.norm(Yc, dim=1, keepdim=True).clamp_min(1e-12)
    iu, ju = torch.triu_indices(X.shape[0], X.shape[0], 1, device=X.device)
    a = (Xn @ Xn.T)[iu, ju]
    b = (Yn @ Yn.T)[iu, ju]
    return _pearson_cols(a[:, None], b[:, None])[0]


def rvadj_maye(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Maye-adjusted RV on standardized data."""
    X = _center(X) / X.std(0, keepdim=True, correction=0).clamp_min(1e-12)
    Y = _center(Y) / Y.std(0, keepdim=True, correction=0).clamp_min(1e-12)
    n, p = X.shape
    q = Y.shape[1]
    XX, YY = X.T @ X, Y.T @ Y

    def adj(tr, ab):
        return ab - (n - 1) / (n - 2) * (ab - tr / (n - 1) ** 2)

    xy = adj(torch.trace(XX @ YY), p * q)
    xx = adj(torch.trace(XX @ XX), p * p)
    yy = adj(torch.trace(YY @ YY), q * q)
    return xy / (xx * yy).clamp_min(1e-12).sqrt()


def rvadj_ghaziri(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Ghaziri-adjusted RV."""
    X, Y = _center(X), _center(Y)
    n = X.shape[0]
    XX, YY = X.T @ X, Y.T @ Y
    rv_ = torch.trace(XX @ YY) / (torch.linalg.norm(XX @ XX) * torch.linalg.norm(YY @ YY)).clamp_min(1e-12)
    mrvB = (
        torch.sqrt(torch.trace(XX) ** 2 / torch.trace(XX @ XX).clamp_min(1e-12))
        * torch.sqrt(torch.trace(YY) ** 2 / torch.trace(YY @ YY).clamp_min(1e-12))
        / (n - 1)
    )
    return (rv_ - mrvB) / (1 - mrvB).clamp_min(1e-12)


def _svd(Z):
    return torch.linalg.svd(Z, full_matrices=False)


def smi(X: torch.Tensor, Y: torch.Tensor, n_components: int = 10) -> torch.Tensor:
    """Similarity of Matrices Index, orthogonal projection: the median of
    the cumulative subspace-overlap grid."""
    X, Y = _center(X), _center(Y)
    k = min(n_components, min(X.shape), min(Y.shape))
    UX = _svd(X)[0][:, :k]
    UY = _svd(Y)[0][:, :k]
    ar = torch.arange(k, device=X.device)
    m = torch.minimum(ar[:, None], ar[None, :]) + 1
    grid = ((UX.T @ UY) ** 2).cumsum(dim=1).cumsum(dim=0) / m
    return _median(grid.clamp(0.0, 1.0))


def r1(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Row-gram inner-product similarity."""
    X, Y = _center(X), _center(Y)
    return torch.trace(X @ Y.T) / (torch.trace(X @ X.T) * torch.trace(Y @ Y.T)).clamp_min(1e-12).sqrt()


def r2(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """r1 on the scaled left singular bases."""
    UX, sX, _ = _svd(_center(X))
    UY, sY, _ = _svd(_center(Y))
    return r1(UX * sX[None], UY * sY[None])


def r3(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """r1 on the orthogonal polar factors."""
    UX, _, VXt = _svd(_center(X))
    UY, _, VYt = _svd(_center(Y))
    return r1(UX @ VXt, UY @ VYt)


def r4(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """r1 on the left singular bases."""
    return r1(_svd(_center(X))[0], _svd(_center(Y))[0])


def rG(X: torch.Tensor, Y: torch.Tensor, n_components: int = 10) -> torch.Tensor:
    """Yanai's GCD on the truncated principal subspace projectors U U^T:
    ||UX^T UY||_F^2 / k (maua_tpu's intended coefficient)."""
    k = min(n_components, min(X.shape), min(Y.shape))
    UX = _svd(_center(X))[0][:, :k]
    UY = _svd(_center(Y))[0][:, :k]
    return ((UX.T @ UY) ** 2).sum() / k


def coxhead2(X: torch.Tensor, Y: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Coxhead's multivariate association, in feature space with a relative
    ridge."""
    X, Y = _center(X), _center(Y)
    if Y.shape[1] > X.shape[1]:
        X, Y = Y, X
    q = Y.shape[1]
    Sxx = X.T @ X
    Syy = Y.T @ Y
    Sxy = X.T @ Y
    ridge_x = eps * torch.trace(Sxx) / X.shape[1]
    A = Sxy.T @ torch.linalg.solve(Sxx + ridge_x * _eye(X.shape[1], X), Sxy)  # the explained part of Syy
    E = Syy - A
    # jnp.linalg.pinv's cutoff: 10 max(m, n) eps of the largest singular value
    M = torch.linalg.pinv(E + eps * torch.trace(Syy) / q * _eye(q, Y), rtol=10 * q * torch.finfo(Y.dtype).eps)
    return torch.trace(M @ A) / torch.trace(M @ Syy).clamp_min(1e-12)


def _canonical_correlations(X: torch.Tensor, Y: torch.Tensor, eps: float = 1e-6):
    """Canonical correlations and the X-basis that attains them."""
    X, Y = _center(X), _center(Y)
    n = X.shape[0]
    Sxx = X.T @ X / n + eps * _eye(X.shape[1], X)
    Syy = Y.T @ Y / n + eps * _eye(Y.shape[1], Y)
    Sxy = X.T @ Y / n
    Wx = _inv_sqrt(Sxx, eps)
    U, s, _ = _svd(Wx @ Sxy @ _inv_sqrt(Syy, eps))
    return s.clamp(0, 1), Wx @ U


def svcca(X: torch.Tensor, Y: torch.Tensor, accept_rate: float = 0.99) -> torch.Tensor:
    """CCA on the principal subspaces that keep `accept_rate` of the variance."""

    def principal(Z):
        U, s, _ = _svd(_center(Z))
        energy = np.cumsum(s.cpu().numpy() ** 2)
        energy = energy / max(energy[-1], 1e-12)
        k = int(np.searchsorted(energy, accept_rate)) + 1
        return (U * s[None])[:, :k]

    corrs, _ = _canonical_correlations(principal(X), principal(Y))
    return corrs.mean()


def pwcca(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Projection-weighted mean canonical correlation."""
    corrs, dirs = _canonical_correlations(X, Y)
    proj = ((_center(X) @ dirs).T @ _center(X)).abs().sum(dim=1)
    w = proj / proj.sum().clamp_min(1e-12)
    return (w * corrs).sum()


def op(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Orthogonal-procrustes similarity: the nuclear norm of the normalized
    cross-gram."""
    Xc, Yc = _center(X), _center(Y)
    Xn = Xc / torch.linalg.norm(Xc).clamp_min(1e-12)
    Yn = Yc / torch.linalg.norm(Yc).clamp_min(1e-12)
    return torch.linalg.svdvals(Xn.T @ Yn).sum()


METRICS: Dict[str, Callable] = {
    # the reference's exported battery
    "pearson": pearson,
    "spearman": spearman,
    "concordance": concordance,
    "autocorrcorr": autocorrcorr,
    "rv": rv,
    "rv2": rv2,
    "smi": smi,
    "r1": r1,
    "r3": r3,
    "svcca": svcca,
    "pwcca": pwcca,
    "linear_cka": linear_cka,
    "op": op,
    # internal variants and extras
    "rvadj_maye": rvadj_maye,
    "rvadj_ghaziri": rvadj_ghaziri,
    "r2": r2,
    "r4": r4,
    "rG": rG,
    "coxhead2": coxhead2,
    "rbf_cka": rbf_cka,
    "hsic": hsic,
    "cca": cca,
    "distance_correlation": distance_correlation,
    "pearson_mean": pearson_mean,
    "norm_similarity": norm_similarity,
}

# metrics defined only for matched feature dimensions (per-column stats,
# trace(X @ Y.T) contractions, trace(XX @ YY) of the two feature grams)
_MATCHED_DIMS_ONLY = (
    "pearson", "spearman", "concordance", "r1", "r2", "r3", "r4",
    "rvadj_maye", "rvadj_ghaziri",
)


def audio_video_correlation(audio_feats, video_feats) -> Dict[str, float]:
    """The whole battery over the common frames of (T, Da) audio and (T, Dv)
    video features."""
    X, Y = torch.as_tensor(audio_feats), torch.as_tensor(video_feats)
    t = min(X.shape[0], Y.shape[0])
    X, Y = X[:t].float(), Y[:t].float().to(X.device)
    return {
        name: float(fn(X, Y))
        for name, fn in METRICS.items()
        if X.shape[1] == Y.shape[1] or name not in _MATCHED_DIMS_ONLY
    }
