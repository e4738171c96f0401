"""Structural segmentation: recurrence matrices, k-means and laplacian
segmentation.

Port of `maua_tpu/audio/segment.py` (recurrence_matrix,
timelag_median_filter, kmeans, sync_median, laplacian_segmentation).
`kmeans` takes its initial centres' indices; without them it draws them
from a `torch.Generator` seeded with 0 (JAX's `PRNGKey(0)` draw cannot
be reproduced by a torch generator). The beat grid and the boundaries
are picked on the host, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .beat import onset_strength, tempo
from .chroma import _median_last
from .constantq import cqt
from .convert import amplitude_to_db
from .pitch import masked_median
from .spectral import median_filter_axis, mfcc


def recurrence_matrix(X: torch.Tensor, k: Optional[int] = None, width: int = 1, metric: str = "cosine",
                      sym: bool = True) -> torch.Tensor:
    """Affinity-mode k-NN recurrence matrix: (d, T) features -> (T, T) in [0, 1]."""
    d, t = X.shape
    if k is None:
        k = min(t - 1, int(np.ceil(np.sqrt(t * (1 - width / t)))) if t > width else 1)
    if metric == "cosine":
        xn = X / X.norm(dim=0, keepdim=True).clamp_min(1e-10)
        dist = 1.0 - xn.t() @ xn
    else:  # euclidean
        sq = X.square().sum(dim=0)
        dist = (sq[:, None] + sq[None, :] - 2.0 * (X.t() @ X)).clamp_min(0.0).sqrt()
    idx = torch.arange(t, device=X.device)
    invalid = (idx[:, None] - idx[None, :]).abs() < width  # a band around the diagonal
    dist_masked = torch.where(invalid, torch.full_like(dist, torch.finfo(torch.float32).max), dist)
    kth = dist_masked.sort(dim=1).values[:, k - 1 : k]
    link = (dist_masked <= kth) & ~invalid
    sigma = masked_median(dist, link)
    aff = torch.where(link, torch.exp(-dist / sigma.clamp_min(1e-10)), torch.zeros_like(dist))
    return torch.maximum(aff, aff.t()) if sym else aff


def timelag_median_filter(R: torch.Tensor, size: int = 7) -> torch.Tensor:
    """Median-filter a recurrence matrix along its diagonals: skew to the
    time-lag form, filter along time, unskew."""
    t = R.shape[0]
    rows = torch.arange(t, device=R.device)[:, None]
    cols = torch.arange(t, device=R.device)[None, :]
    L = R[rows, (rows + cols) % t]
    return median_filter_axis(L, size, dim=0)[rows, (cols - rows) % t]


def kmeans_init(n: int, k: int) -> torch.Tensor:
    """The k rows of n that kmeans starts from by default: drawn by a CPU
    generator seeded with 0."""
    return torch.randperm(n, generator=torch.Generator().manual_seed(0))[:k]


def kmeans_distances(X: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Squared distances (n, k) of the rows of X to the centres."""
    return (X[:, None, :] - centers[None]).square().sum(dim=-1)


def kmeans_centers(X: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    """Lloyd's update: the mean of each label's rows (an empty label's centre is 0)."""
    onehot = F.one_hot(labels, k).to(X.dtype)
    return (onehot.t() @ X) / onehot.sum(dim=0).clamp_min(1.0)[:, None]


def kmeans(X: torch.Tensor, k: int, n_iter: int = 50,
           init_idx: Optional[Sequence[int]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's k-means, hard assignment: (n, d) -> (labels (n,), centres (k, d)).
    The first centres are the rows `init_idx`, or those of `kmeans_init`."""
    if init_idx is None:
        init_idx = kmeans_init(X.shape[0], k)
    centers = X[torch.tensor(np.asarray(init_idx), dtype=torch.long, device=X.device)]
    for _ in range(n_iter):
        centers = kmeans_centers(X, kmeans_distances(X, centers).argmin(dim=1), k)
    return kmeans_distances(X, centers).argmin(dim=1), centers


def sync_median(X: torch.Tensor, boundaries: np.ndarray, n_out: int) -> torch.Tensor:
    """Median of the feature frames between boundaries (librosa.util.sync)."""
    bounds = list(boundaries) + [X.shape[1]]
    return torch.stack([_median_last(X[:, bounds[i] : max(bounds[i + 1], bounds[i] + 1)]) for i in range(n_out)],
                       dim=1)


def laplacian_segmentation(y: torch.Tensor, sr: float, k: int = 5,
                           hop_length: int = 512) -> Tuple[np.ndarray, np.ndarray]:
    """Pattern-recurrence segmentation: CQT -> beat-sync -> recurrence +
    path affinities -> normalized laplacian eigenvectors -> k-means ->
    (boundary times in seconds, segment labels)."""
    bpo, n_oct = 12 * 3, 7
    C = amplitude_to_db(cqt(y, sr=sr, hop_length=hop_length, n_bins=n_oct * bpo, bins_per_octave=bpo).abs())
    bpm = float(tempo(onset_strength(y, sr=sr, hop_length=hop_length), sr=sr, hop_length=hop_length))
    frames_per_beat = (60.0 / max(bpm, 1e-3)) * sr / hop_length
    n_beats = max(int(C.shape[1] / frames_per_beat), 2 * k)
    beats = np.linspace(0, C.shape[1] - 1, n_beats + 1).astype(int)[:-1]

    Rf = timelag_median_filter(recurrence_matrix(sync_median(C, beats, n_beats), width=3), size=7)
    Msync = sync_median(mfcc(y, sr, hop_length=hop_length), beats, n_beats)
    path_distance = torch.diff(Msync, dim=1).square().sum(dim=0)
    sigma = _median_last(path_distance)
    path_sim = torch.exp(-path_distance / sigma.clamp_min(1e-10))
    R_path = torch.diag(path_sim, 1) + torch.diag(path_sim, -1)

    deg_path, deg_rec = R_path.sum(dim=1), Rf.sum(dim=1)
    mu = deg_path @ (deg_path + deg_rec) / (deg_path + deg_rec).square().sum().clamp_min(1e-10)
    A = mu * Rf + (1 - mu) * R_path
    dinv = torch.rsqrt(A.sum(dim=1).clamp_min(1e-10))
    L = torch.eye(A.shape[0], device=A.device) - (dinv[:, None] * A) * dinv[None, :]
    # the time-lag filter leaves A unsymmetric; jnp.linalg.eigh symmetrizes
    # its input, torch.linalg.eigh would read only the lower triangle
    _, evecs = torch.linalg.eigh(0.5 * (L + L.t()))
    evecs = median_filter_axis(evecs, 9, dim=0)
    Cnorm = evecs.square().cumsum(dim=1).sqrt()
    X = evecs[:, :k] / Cnorm[:, k - 1 : k].clamp_min(1e-10)

    seg_ids = kmeans(X, k)[0].cpu().numpy()
    bound_beats = np.concatenate([[0], 1 + np.flatnonzero(seg_ids[:-1] != seg_ids[1:])])
    bound_times = np.asarray(beats[bound_beats] * hop_length / sr, float)
    if len(bound_times) and bound_times[0] != 0:
        bound_times[0] = 0.0
    return bound_times, seg_ids[bound_beats]
