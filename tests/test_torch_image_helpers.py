"""The port's remaining `ops/image.py` helpers against maua_tpu's, on the
CPU, f32, seeded numpy inputs: colour spaces and original_colors, local
statistics, gaussian blur and unsharp masking, colour balance, min-max
normalisation, positive, wrapping slices and the LBP and SVD blur maps.
Tolerance 1e-5 of each output's largest magnitude (rounded outputs in
[0, 255] exactly, but for a level where an unrounded value sits at .5
within f32 noise)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.ops import image as J
from maua_tpu_torch.ops import image as T

torch.set_num_threads(1)


def _img(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).rand(*shape) * scale).astype(np.float32)


def _close(got, want, rtol=1e-5, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-30), (what, np.abs(got - want).max())


def _rounded_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1.0 and (got != want).mean() < 1e-3


@pytest.mark.parametrize("name", ["luminance", "rgb_to_ycbcr", "ycbcr_to_rgb", "positive", "normalize_minmax"])
def test_pointwise_helpers(name):
    x = _img(1, 2, 9, 11, 3) * 2 - 0.5
    _close(getattr(T, name)(torch.from_numpy(x)), getattr(J, name)(jnp.asarray(x)), what=name)


@pytest.mark.parametrize("shape", [(1, 16, 16, 3), (1, 20, 24, 3)])
def test_original_colors(shape):
    content, generated = _img(2, 1, 16, 16, 3), _img(3, *shape)
    _close(T.original_colors(torch.from_numpy(content), torch.from_numpy(generated)),
           J.original_colors(jnp.asarray(content), jnp.asarray(generated)))
    rt = T.ycbcr_to_rgb(T.rgb_to_ycbcr(torch.from_numpy(generated)))
    _close(rt, generated, 1e-5)


def test_local_std():
    x = _img(4, 2, 13, 15, 1)
    _close(T.local_std(torch.from_numpy(x), 5), J.local_std(jnp.asarray(x), 5))
    # several channels (maua_tpu's grouped conv refuses them): the window's std over all channels
    x3 = _img(5, 1, 10, 12, 3)
    got = T.local_std(torch.from_numpy(x3), 3).numpy()
    p = np.pad(x3, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="reflect")
    want = np.array([[p[0, i:i + 3, j:j + 3].std() for j in range(12)] for i in range(10)])[None, ..., None]
    _close(got, want, 1e-5)


def test_immerkaer_and_wrapping_slice():
    x = _img(6, 3, 17, 19, 3)
    _close(T.immerkaer(torch.from_numpy(x)), J.immerkaer(jnp.asarray(x)))
    _close(T.immerkaer(torch.from_numpy(x[..., :1])), J.immerkaer(jnp.asarray(x[..., :1])))
    for start, length in ((1, 5), (2, 2)):
        _close(T.wrapping_slice(torch.from_numpy(x), start, length), J.wrapping_slice(jnp.asarray(x), start, length))
    _close(T.wrapping_slice(torch.from_numpy(x[:1]), 2, 3), J.wrapping_slice(jnp.asarray(x[:1]), 2, 3))


@pytest.mark.parametrize("ks,sigma", [((7, 7), 1.0), ((5, 9), 1.7)])
def test_gaussian_blur_and_unsharp_mask(ks, sigma):
    x = _img(7, 2, 14, 16, 3)
    _close(T._gaussian_kernel1d(ks[1], sigma), J._gaussian_kernel1d(ks[1], sigma))
    _close(T.gaussian_blur(torch.from_numpy(x), ks, sigma), J.gaussian_blur(jnp.asarray(x), ks, sigma))
    u8 = np.round(x * 255)
    _rounded_close(T.unsharp_mask(torch.from_numpy(u8), ks, sigma, 1.5, 2.0),
                   J.unsharp_mask(jnp.asarray(u8), ks, sigma, 1.5, 2.0))


def test_color_balance():
    x = np.round(_img(8, 20, 18, 3, scale=200.0) + 20)
    _rounded_close(T.color_balance(torch.from_numpy(x), 5.0), J.color_balance(jnp.asarray(x), 5.0))


def test_blur_maps():
    g = _img(9, 18, 20)
    _close(T._box_sum(torch.from_numpy(g), 5), J._box_sum(jnp.asarray(g), 5))
    _close(T.blurriness_lbp(torch.from_numpy(g), 5, 0.02), J.blurriness_lbp(jnp.asarray(g), 5, 0.02))
    _close(T.blurriness_svd(torch.from_numpy(g), 3, 2), J.blurriness_svd(jnp.asarray(g), 3, 2))
