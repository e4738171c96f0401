"""The port's audio-video alignment metrics (selfsupervised/correlation.py)
and video descriptors (selfsupervised/video_features.py) against
maua_tpu, on the CPU.

Metrics: every entry of METRICS on a correlated pair of unequal widths,
an independent one, and matched-width pairs (X against X without one
principal component, and against noise), f32 as JAX computes them:
<= 1e-3 absolute (eigh, SVD and solves differ in their last bits), but
for r3 on the rank-deficient pair, where the value is not unique (see
NOT_UNIQUE). Video descriptors of a 6-frame 32^2 clip with motion
in it: <= 1e-4 of each descriptor's largest magnitude; the histograms'
bin counts are equal (numpy's bin index, edges and closed last bin).
Farneback flow is OpenCV's on the host in both, on the same uint8 frames.
"""

import numpy as np
import pytest
import torch

from maua_tpu.audiovisual.selfsupervised import correlation as JC
from maua_tpu.audiovisual.selfsupervised import video_features as JV
from maua_tpu_torch.audiovisual.selfsupervised import correlation as TC
from maua_tpu_torch.audiovisual.selfsupervised import video_features as TV


def pairs():
    rs = np.random.RandomState(0)
    X = rs.randn(64, 5).astype(np.float32)
    Y = X @ rs.randn(5, 3).astype(np.float32) + 0.1 * rs.randn(64, 3).astype(np.float32)
    Z = rs.randn(64, 3).astype(np.float32)
    rs = np.random.RandomState(1)
    A = rs.randn(120, 16).astype(np.float32)
    A -= A.mean()
    U, s, V = np.linalg.svd(A, full_matrices=False)
    A1 = (np.delete(U, 2, 1) @ np.diag(np.delete(s, 2)) @ np.delete(V, 2, 0)).astype(np.float32)
    A2 = rs.randn(120, 16).astype(np.float32)
    return {"dependent": (X, Y), "independent": (X, Z), "minus_one_pc": (A, A1), "noise": (A, A2)}


PAIRS = pairs()


# r3 reads the polar factor U V^T of each centred matrix; the pair without one principal component is rank
# deficient, where that factor is not unique (any orthonormal completion of the null space), and LAPACK
# builds differ in the one they return. The battery's ordering is asserted on it instead (below).
NOT_UNIQUE = {("r3", "minus_one_pc")}


@pytest.mark.parametrize("name", list(JC.METRICS))
def test_metric_matches_maua_tpu(name):
    assert list(TC.METRICS) == list(JC.METRICS)
    for label, (X, Y) in PAIRS.items():
        if (X.shape[1] != Y.shape[1] and name in JC._MATCHED_DIMS_ONLY) or (name, label) in NOT_UNIQUE:
            continue
        want = float(JC.METRICS[name](X, Y))
        got = float(TC.METRICS[name](torch.from_numpy(X), torch.from_numpy(Y)))
        assert np.isfinite(got) and abs(got - want) <= 1e-3, (label, got, want)


def test_audio_video_correlation_orders_the_pairs():
    X, Y = PAIRS["dependent"]
    _, Z = PAIRS["independent"]
    dep = TC.audio_video_correlation(X, Y)
    ind = TC.audio_video_correlation(torch.from_numpy(X), torch.from_numpy(Z)[:50])
    assert set(dep) == set(JC.audio_video_correlation(X, Y)) == set(ind)
    assert "pearson" not in dep  # widths 5 and 3: the per-column metrics are left out
    for name in ("rv", "linear_cka", "cca", "distance_correlation", "pearson_mean"):
        assert dep[name] > ind[name], name
    A, A1 = PAIRS["minus_one_pc"]
    _, A2 = PAIRS["noise"]
    hi, lo = TC.audio_video_correlation(A, A1), TC.audio_video_correlation(A, A2)
    assert len(hi) == len(TC.METRICS)
    for name in ("pearson", "spearman", "concordance", "rv", "smi", "r1", "r3", "svcca", "pwcca", "op"):
        assert hi[name] > lo[name], name


def clip():
    """6 frames of 32^2: a moving bright square over a colour gradient and noise."""
    rs = np.random.RandomState(0)
    yy, xx = np.mgrid[:32, :32] / 31.0
    frames = []
    for t in range(6):
        f = np.stack([xx, yy, 0.5 * (xx + yy)], -1) * 0.6 + 0.1 * rs.rand(32, 32, 3)
        f[8 + t : 16 + t, 4 + 2 * t : 12 + 2 * t] = [0.95, 0.9, 0.2]
        frames.append(f)
    return np.clip(np.stack(frames), 0, 1).astype(np.float32)


CLIP = clip()
DESCRIPTORS = ["luminance_envelope", "color_moments", "edge_energy", "flow_magnitude", "redogram", "greenogram",
               "blueogram", "rgb_hist", "huestogram", "saturogram", "valueogram", "hsv_hist", "visual_variance",
               "absdiff", "video_spectrogram", "low_freq_rms", "mid_freq_rms", "high_freq_rms", "adaptive_freq_rms",
               "video_flow_onsets", "video_spectral_onsets"]


def close_to_max(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30), what


HISTOGRAMS = ("redogram", "greenogram", "blueogram", "rgb_hist", "huestogram", "saturogram", "valueogram", "hsv_hist")


@pytest.mark.parametrize("name", DESCRIPTORS)
def test_video_descriptor_matches_maua_tpu(name):
    got = getattr(TV, name)(torch.from_numpy(CLIP)).numpy()
    want = getattr(JV, name)(CLIP)
    if name in HISTOGRAMS:
        np.testing.assert_array_equal(got, want)
    else:
        close_to_max(got, want, 1e-4, name)


@pytest.fixture
def linear_polar(monkeypatch):
    """OpenCV 5 removed linearPolar, so both packages bin by radius on this
    host; this gives cv2 the OpenCV 4 function (warpPolar at the source's
    size, as linearPolar calls it), so that both take the log-polar branch."""
    import cv2

    def linear(src, center, max_radius, flags):
        return cv2.warpPolar(src, (src.shape[1], src.shape[0]), center, max_radius, flags | cv2.WARP_POLAR_LINEAR)

    monkeypatch.setattr(cv2, "linearPolar", linear, raising=False)


@pytest.mark.parametrize("name", ["video_spectrogram", "adaptive_freq_rms", "video_spectral_onsets"])
def test_log_polar_spectrogram_matches_maua_tpu(name, linear_polar):
    close_to_max(getattr(TV, name)(torch.from_numpy(CLIP)).numpy(), getattr(JV, name)(CLIP), 1e-4, name)


def test_histograms_bin_as_numpy():
    """Values on bin edges and at the closed last edge land where
    np.histogram puts them."""
    x = np.array([[0.0, 0.25, 0.5, 0.75, 1.0, 0.1, 0.3, 1.0], [-1.0, 3.0, 1.0, 1.0, 2.0, 0.0, 2.9999, -1.0]],
                 np.float32)
    lo, hi = x.min(axis=1).astype(np.float64), x.max(axis=1).astype(np.float64)
    got = TV._histogram_rows(torch.from_numpy(x), 4, lo, hi).numpy()
    want = np.stack([np.histogram(r, bins=4, range=(a, b))[0] for r, a, b in zip(x, lo, hi)])
    np.testing.assert_array_equal(got, want)
    w = np.abs(x) + 0.5
    got = TV._histogram_rows(torch.from_numpy(x), 4, lo, hi, weights=torch.from_numpy(w)).numpy()
    want = np.stack([np.histogram(r, bins=4, range=(a, b), weights=ww)[0] for r, a, b, ww in zip(x, lo, hi, w)])
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_directogram_and_onsets():
    flow = np.random.RandomState(3).randn(5, 8, 8, 2).astype(np.float32)
    close_to_max(TV.directogram(torch.from_numpy(flow)).numpy(), JV.directogram(flow), 1e-5, "directogram")
    spec = np.random.RandomState(4).rand(9, 6).astype(np.float32)
    close_to_max(TV.onset_envelope(TV.spectral_flux(torch.from_numpy(spec))).numpy(),
                 JV.onset_envelope(JV.spectral_flux(spec)), 1e-5, "onsets")


def test_extract_video_features_and_matrix():
    want = JV.extract_video_features(CLIP, n_frames_out=12)
    got = TV.extract_video_features(CLIP, n_frames_out=12)
    assert list(got) == list(want)
    for k in want:
        close_to_max(got[k].numpy(), np.asarray(want[k]), 1e-4, k)
    M = TV.video_feature_matrix(torch.from_numpy(CLIP))
    assert M.shape == (6, sum(v.shape[1] for v in want.values()))
    assert TV.absdiff(torch.from_numpy(np.concatenate([np.zeros((5, 4, 4, 3)), np.ones((5, 4, 4, 3))]))).argmax() == 4
