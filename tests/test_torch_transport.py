"""The port's sliced transport and histogram matching against maua_tpu's, on the CPU.

Inputs are numpy draws from seeds, channel-last as in the reference. The
rotations take JAX's own normal matrices (`jax.random.normal` of each split
key), so the port's QR and sign fixes are held on the same draws. The
histogram inputs include channels with empty bins (a two-cluster source and
a target with a gap), where the source CDF is flat and `interp`'s rule for a
repeated xp decides the output.

Tolerances, f32: rotations and covariance modes 1e-5 of the largest
magnitude (eigh, cholesky and inv in LAPACK on both sides); CDF matching
1e-5 of the value range, except where an input value sits within 1e-5 of a
bin edge (the int cast of (x - lo) / span * 256 may then land in the
neighbouring bin): at most 0.2 % of the values, each within one bin's
width.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.ops import transport as J
from maua_tpu_torch.ops import transport as T

torch.set_num_threads(1)


def _normals(key, iters, c):
    return [np.asarray(jax.random.normal(k, (c, c))) for k in jax.random.split(key, iters)]


def test_random_rotation_matches():
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(J.random_rotation(key, 5))
        got = T.random_rotation(5, normal=torch.from_numpy(np.array(jax.random.normal(key, (5, 5))))).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
        assert abs(np.linalg.det(got) - 1) < 1e-5
    r = T.random_rotation(3, torch.Generator().manual_seed(0))
    assert torch.allclose(r @ r.T, torch.eye(3), atol=1e-5)


@pytest.mark.parametrize("xp,fp,x", [
    ([0.0, 1.0, 1.0, 1.0, 2.0], [0.0, 1.0, 2.0, 3.0, 4.0], [-1.0, 0.5, 1.0, 1.5, 2.0, 3.0]),
    ([0.0, 0.0, 0.5, 1.0], [5.0, 6.0, 7.0, 8.0], [0.0, 0.25, 0.5, 0.99, 1.0]),
])
def test_interp_follows_jnp_interp(xp, fp, x):
    """Repeated xp (a flat CDF over empty bins) and the clamped ends."""
    want = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp)))
    got = T.interp(torch.tensor(x), torch.tensor(xp), torch.tensor(fp)).numpy()
    np.testing.assert_array_equal(got, want)


def _inputs(seed):
    rs = np.random.RandomState(seed)
    target = rs.randn(24, 20, 3).astype(np.float32)
    target[..., 1] = np.where(target[..., 1] > 0, target[..., 1] + 3, target[..., 1])  # a gap: empty bins
    source = (rs.rand(18, 22, 3).astype(np.float32) * 2 - 0.5)
    source[..., 2] = np.where(rs.rand(18, 22) < 0.5, -4.0, 4.0) + 0.1 * rs.randn(18, 22)  # two clusters
    return target, source


def _cdf_close(got, want, target):
    span = float(target.max() - target.min())
    err = np.abs(got - want)
    off = err > 1e-5 * span
    assert off.mean() <= 2e-3 and err.max() <= span / 256 * 1.01, (off.mean(), err.max())


def test_cdf_match_with_empty_bins():
    target, source = _inputs(0)
    want = np.asarray(J.cdf_match(jnp.asarray(target), jnp.asarray(source)))
    got = T.cdf_match(torch.from_numpy(target), torch.from_numpy(source)).numpy()
    _cdf_close(got, want, target)


@pytest.mark.parametrize("mode", ["cdf", "chol", "pca", "sym"])
def test_hist_match_modes(mode):
    target, source = _inputs(1)
    want = np.asarray(J.hist_match(jnp.asarray(target), jnp.asarray(source), mode=mode))
    got = T.hist_match(torch.from_numpy(target), torch.from_numpy(source), mode=mode).numpy()
    if mode == "cdf":
        _cdf_close(got, want, target)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError, match="unknown hist_match mode"):
        T.hist_match(torch.from_numpy(target), torch.from_numpy(source), mode="bogus")


@pytest.mark.parametrize("iters", [1, 4])
def test_sliced_histogram_transport_matches(iters):
    """Each rotation from JAX's normals of the split key. One iteration is held as cdf_match is; over four,
    a value that crossed a bin edge in an earlier iteration has moved every later CDF step by 1 / N, so
    the bar is each value within one bin's width of the range and the mean within 1e-4 of it."""
    rs = np.random.RandomState(2)
    source = rs.rand(16, 16, 3).astype(np.float32)
    target = (rs.rand(12, 12, 3) ** 2).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(J.sliced_histogram_transport(jnp.asarray(source), jnp.asarray(target), iters=iters, key=key))
    got = T.sliced_histogram_transport(torch.from_numpy(source), torch.from_numpy(target), iters=iters,
                                       normals=_normals(key, iters, 3)).numpy()
    if iters == 1:
        _cdf_close(got, want, source)
    else:
        span = float(want.max() - want.min())
        err = np.abs(got - want)
        assert err.max() <= span / 256 and err.mean() <= 1e-4 * span, (err.max() / span, err.mean() / span)
    out = T.sliced_histogram_transport(torch.from_numpy(source), torch.from_numpy(target), iters=2)
    assert out.shape == source.shape and torch.isfinite(out).all()
