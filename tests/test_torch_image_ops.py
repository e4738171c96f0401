"""The port's image ops (maua_tpu_torch/ops/image.py and the resizes of
ops/warp.py) against maua_tpu's, on the CPU in f32.

Tolerances, f32: `resample` and the other jax.image.resize kernels 1e-5
absolute on values in [0, 1] (the same weights, built in numpy rather
than in XLA, summed in another order); destitch exact; restitch,
sharpen 1e-5; match_histogram 1e-4 (a 3x3 eigendecomposition and
inverse after sums over every pixel, in f32), with maua_tpu's jitter
draws handed to the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.ops import image as JI
from maua_tpu_torch.ops import image as TI
from maua_tpu_torch.ops import warp as TW


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


@pytest.mark.parametrize("size,tile,overtile", [((40, 56), 16, 1), ((96, 80), 32, 2), ((33, 20), 20, 1)])
def test_destitch_restitch_match(size, tile, overtile):
    img = np.random.RandomState(0).rand(1, *size, 3).astype(np.float32)
    ref = np.asarray(JI.destitch(jnp.asarray(img), tile, overtile))
    tiles = TI.destitch(t(img), tile, overtile)
    np.testing.assert_array_equal(tiles.numpy(), ref)
    processed = np.tanh(ref * 3 - 1) + np.arange(len(ref), dtype=np.float32)[:, None, None, None] * 0.01
    ref = np.asarray(JI.restitch(jnp.asarray(processed), *size, overtile))
    out = TI.restitch(t(processed), *size, overtile).numpy()
    assert out.shape == ref.shape == (1, *size, 3)
    assert np.abs(out - ref).max() <= 1e-5
    np.testing.assert_allclose(TI.restitch(tiles, *size, overtile).numpy(), img, atol=1e-6)


def test_smoothstep_and_blend_weights_match():
    x = np.linspace(0, 1, 17).astype(np.float32)
    np.testing.assert_allclose(TI.smoothstep(t(x)).numpy(), np.asarray(JI.smoothstep(jnp.asarray(x))), atol=1e-6)
    for args in ((16, 0, 5), (16, 5, 0), (20, 7, 7)):
        np.testing.assert_allclose(TI.blend_weight1d(*args).numpy(), np.asarray(JI.blend_weight1d(*args)),
                                   atol=1e-6)


@pytest.mark.parametrize("src,dst", [
    ((32, 48), (75, 110)),  # up, non-integer ratios
    ((75, 110), (32, 47)),  # down, non-integer ratios
    ((64, 40), (128, 80)),  # x2
    ((50, 30), 36),  # an int: the short side, the long one scaled and made even
])
def test_resample_matches(src, dst):
    img = np.random.RandomState(1).rand(2, *src, 3).astype(np.float32)
    ref = np.asarray(JI.resample(jnp.asarray(img), dst))
    out = TI.resample(t(img), dst).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 1e-5
    assert TI.scaled_height_width(*src, 36) == JI.scaled_height_width(*src, 36)


@pytest.mark.parametrize("method", ["bilinear", "bicubic", "lanczos3"])
def test_resize_kernels_match_jax(method):
    x = np.random.RandomState(2).rand(1, 3, 21, 34).astype(np.float32)
    for size in ((7, 9), (21, 68), (40, 17)):
        ref = np.asarray(jax.image.resize(jnp.asarray(x), (1, 3) + size, method, antialias=True))
        assert np.abs(TW.resize(t(x), size, method).numpy() - ref).max() <= 1e-5


@pytest.mark.parametrize("strength", [0.0, 0.5, 2.0])
def test_sharpen_matches(strength):
    img = np.random.RandomState(3).rand(2, 9, 12, 3).astype(np.float32) * 2 - 1
    ref = np.asarray(JI.sharpen(jnp.asarray(img), strength))
    out = TI.sharpen(t(img), strength).numpy()
    assert np.abs(out - ref).max() <= 1e-5
    np.testing.assert_array_equal(out[:, 0], img[:, 0])  # the border stays


def jax_jitter(target_shape, source_shapes, key=None):
    """maua_tpu's match_histogram jitter draws in the port's order: per source,
    the mean source frame's draw, then each target frame's."""
    key = jax.random.PRNGKey(0) if key is None else key
    draws = []
    for i, shape in enumerate(source_shapes):
        k1, k2 = jax.random.split(jax.random.fold_in(key, i))
        draws.append(np.asarray(jax.random.normal(k2, (1,) + tuple(shape[1:]))))
        for k in jax.random.split(k1, target_shape[0]):
            draws.append(np.asarray(jax.random.normal(k, (1,) + tuple(target_shape[1:]))))
    return draws


def test_match_histogram_matches_with_the_same_jitter():
    rs = np.random.RandomState(4)
    target = (rs.rand(3, 16, 20, 3) * np.array([0.5, 1.0, 0.3]) - 0.2).astype(np.float32)
    sources = [(rs.rand(2, 12, 10, 3) * 1.6 - 0.8).astype(np.float32),
               (rs.rand(1, 8, 8, 3) - 0.5).astype(np.float32)]
    ref = np.asarray(JI.match_histogram(jnp.asarray(target), [jnp.asarray(s) for s in sources]))
    noise = iter(jax_jitter(target.shape, [s.shape for s in sources]))
    out = TI.match_histogram(t(target), [t(s) for s in sources], noise=noise).numpy()
    assert np.abs(out - ref).max() <= 1e-4
    assert next(noise, None) is None  # every draw used
    assert np.abs(out - target).max() > 0.1


def test_match_histogram_other_modes():
    rs = np.random.RandomState(5)
    target, source = t(rs.rand(2, 8, 8, 3)), t(rs.rand(3, 8, 8, 3) * 0.5)
    assert TI.match_histogram(target, source, mode="False") is target
    out = TI.match_histogram(target, source, mode="random")
    assert out.shape == target.shape and torch.isfinite(out).all()
    assert float(out.max()) <= float(source.max()) + 1e-6
    torch.testing.assert_close(TI.match_histogram(target, source), TI.match_histogram(target, source))
