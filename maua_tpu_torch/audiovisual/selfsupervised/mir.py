"""Music information retrieval for self-supervised patches.

Port of `maua_tpu/audiovisual/selfsupervised/mir.py`: the eight features,
a Laplacian segmentation of each at several k, and the tempo. The beat
grid and the per-frame labels are made on the host, as in maua_tpu; the
features, the recurrence matrices and their eigenvectors stay on the
signal's device.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ...audio import beat as _beat
from ...audio import segment as _segment
from ...ops.signal import gaussian_filter, normalize
from .features import extract_features, salience_weighted

HOP = 1024


def laplacian_eigen(feature: torch.Tensor, beats: np.ndarray, ks: Sequence[int]):
    """The stages of segment_feature before k-means, for a (T, F) feature:
    (the beat grid it syncs to, the normalized Laplacian of the beat-synced
    recurrence matrix filtered along its diagonals, its eigenvalues and
    eigenvectors in ascending order)."""
    t = feature.shape[0]
    beats = np.asarray([b for b in beats if 0 <= b < t])
    if len(beats) < max(ks) + 2:
        beats = np.linspace(0, t - 1, max(max(ks) + 2, 8)).astype(int)
    Xsync = _segment.sync_median(feature.t(), beats, len(beats))
    R = _segment.recurrence_matrix(Xsync, width=2, sym=True)
    Rf = _segment.timelag_median_filter(R, size=5)
    dinv = 1.0 / Rf.sum(dim=1).clamp_min(1e-10).sqrt()
    L = torch.eye(Rf.shape[0], device=Rf.device) - (dinv[:, None] * Rf) * dinv[None, :]
    # the time-lag filter leaves Rf unsymmetric; jnp.linalg.eigh symmetrizes
    # its input, torch.linalg.eigh would read only the lower triangle
    L = 0.5 * (L + L.t())
    evals, evecs = torch.linalg.eigh(L)
    return beats, L, evals, evecs


def embedding(evecs: torch.Tensor, k: int) -> torch.Tensor:
    """The rows k-means clusters at k: the first k eigenvectors, each row
    scaled to unit norm."""
    Cnorm = evecs.square().cumsum(dim=1).sqrt()
    return evecs[:, :k] / Cnorm[:, k - 1 : k].clamp_min(1e-10)


def frame_labels(labels: np.ndarray, beats: np.ndarray, t: int) -> np.ndarray:
    """Per-frame labels of T frames from one label per beat segment."""
    bounds = list(beats) + [t]
    out = np.zeros(t, np.int32)
    for i in range(len(beats)):
        out[bounds[i] : bounds[i + 1]] = labels[i]
    out[: bounds[0]] = labels[0]
    return out


def segment_feature(feature: torch.Tensor, beats: np.ndarray, ks: Sequence[int]) -> List[np.ndarray]:
    """Laplacian segmentation of a (T, F) feature at each k of `ks`: the
    beat-synced recurrence matrix, filtered along its diagonals, its
    normalized Laplacian's eigenvectors, k-means of the first k. Returns
    per-frame labels for each k."""
    beats, _, _, evecs = laplacian_eigen(feature, beats, ks)
    return [frame_labels(_segment.kmeans(embedding(evecs, k), k)[0].cpu().numpy(), beats, feature.shape[0])
            for k in ks]


def beat_grid(t: int, tempo: float, sr) -> np.ndarray:
    """The frames at hop HOP where each beat of `tempo` starts."""
    frames_per_beat = max((60.0 / max(tempo, 1e-3)) * sr / HOP, 1.0)
    return np.arange(frames_per_beat, t, frames_per_beat).astype(int)


def retrieve_music_information(audio: torch.Tensor, sr, ks: Sequence[int] = (2, 4, 6, 8, 12, 16)):
    """(features, segmentations, tempo): the eight features smoothed,
    salience-weighted and normalized, each (T, F) on the signal's device;
    per-frame labels (numpy) keyed by (feature name, k); the tempo in BPM."""
    raw_feats = extract_features(audio, sr)

    onset_env = _beat.onset_strength(audio, sr=sr, hop_length=HOP)
    tempo = float(_beat.tempo(onset_env, sr=sr, hop_length=HOP, start_bpm=120.0, max_tempo=240.0))
    beats = beat_grid(next(iter(raw_feats.values())).shape[0], tempo, sr)

    segmentations: Dict[Tuple[str, int], np.ndarray] = {}
    for name, feature in raw_feats.items():
        for k, seg in zip(ks, segment_feature(feature, beats, ks)):
            segmentations[(name, k)] = seg

    features = {k: normalize(salience_weighted(gaussian_filter(f, 2.0))) for k, f in raw_feats.items()}
    return features, segmentations, tempo
