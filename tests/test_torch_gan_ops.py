"""The port's StyleGAN ops (NCHW) against maua_tpu.gan.ops (NHWC), on the
shapes of tests/test_gan_ops.py. Tolerances: 1e-5 absolute for the FIR
ops, 1e-4 for the convs (f32, summation order differs)."""

import numpy as np
import pytest
import torch

from maua_tpu.gan import ops as J
from maua_tpu_torch.gan import ops as T


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize(
    "up,down,pad",
    [
        (1, 1, (0, 0, 0, 0)),
        (1, 1, (1, 1, 1, 1)),
        (2, 1, (1, 1, 1, 1)),
        (2, 1, (2, 1, 2, 1)),
        (1, 2, (1, 1, 1, 1)),
        (2, 2, (1, 2, 2, 1)),
        (1, 1, (-1, 2, 0, -1)),
        (2, 1, (-1, -1, 2, 2)),
    ],
)
@pytest.mark.parametrize("separable", [False, True])
def test_upfirdn2d(up, down, pad, separable):
    x = np.random.RandomState(0).randn(2, 8, 8, 3).astype(np.float32)
    taps = [1, 3, 3, 1]
    fj = J.setup_filter(taps, separable=separable)
    ft = T.setup_filter(taps, separable=separable)
    np.testing.assert_array_equal(fj, ft)
    ref = np.asarray(J.upfirdn2d(x, fj, up=up, down=down, padding=pad, gain=1.5))
    out = T.upfirdn2d(nchw(x), ft, up=up, down=down, padding=pad, gain=1.5)
    np.testing.assert_allclose(nhwc(out), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("up,down,padding,k", [(1, 1, 1, 3), (2, 1, 1, 3), (1, 2, 1, 3), (1, 1, 0, 1), (2, 1, 0, 1)])
def test_conv2d_resample(up, down, padding, k):
    rs = np.random.RandomState(1)
    x = rs.randn(2, 8, 8, 4).astype(np.float32)
    w_hwio = rs.randn(k, k, 4, 5).astype(np.float32)
    f = J.setup_filter([1, 3, 3, 1])
    ref = np.asarray(J.conv2d_resample(x, w_hwio, f=f, up=up, down=down, padding=padding))
    w = torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))
    out = T.conv2d_resample(nchw(x), w, f=f, up=up, down=down, padding=padding)
    np.testing.assert_allclose(nhwc(out), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("up,demod", [(1, True), (1, False), (2, True)])
def test_modulated_conv2d(up, demod):
    rs = np.random.RandomState(2)
    B, ci, co, k, h = 3, 6, 8, 3, 8
    x = rs.randn(B, h, h, ci).astype(np.float32)
    w_hwio = rs.randn(k, k, ci, co).astype(np.float32) * 0.3
    styles = rs.rand(B, ci).astype(np.float32) + 0.5
    noise = rs.randn(B, h * up, h * up, 1).astype(np.float32) * 0.1
    f = J.setup_filter([1, 3, 3, 1])
    ref = np.asarray(J.modulated_conv2d(x, w_hwio, styles, noise=noise, up=up, padding=k // 2,
                                        resample_filter=f if up > 1 else None, demodulate=demod))
    out = T.modulated_conv2d(nchw(x), torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1))),
                             torch.from_numpy(styles), noise=nchw(noise), up=up, padding=k // 2,
                             resample_filter=f if up > 1 else None, demodulate=demod)
    np.testing.assert_allclose(nhwc(out), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("act,clamp", [("lrelu", 0.5), ("lrelu", None), ("linear", 256.0), ("relu", None),
                                       ("tanh", None), ("swish", None)])
def test_bias_act(act, clamp):
    rs = np.random.RandomState(3)
    x = rs.randn(2, 4, 4, 8).astype(np.float32)
    b = rs.randn(8).astype(np.float32)
    ref = np.asarray(J.bias_act(x, b, act=act, clamp=clamp))
    out = T.bias_act(nchw(x), torch.from_numpy(b), act=act, clamp=clamp)
    np.testing.assert_allclose(nhwc(out), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("fn", ["upsample2d", "downsample2d"])
def test_resample2d(fn):
    x = np.random.RandomState(4).randn(1, 6, 6, 2).astype(np.float32)
    f = J.setup_filter([1, 3, 3, 1])
    ref = np.asarray(getattr(J, fn)(x, f))
    out = getattr(T, fn)(nchw(x), f)
    np.testing.assert_allclose(nhwc(out), ref, rtol=0, atol=1e-5)


def test_normalize_2nd_moment():
    x = np.random.RandomState(5).randn(4, 16).astype(np.float32)
    np.testing.assert_allclose(T.normalize_2nd_moment(torch.from_numpy(x)).numpy(),
                               np.asarray(J.normalize_2nd_moment(x)), rtol=1e-6, atol=1e-6)
