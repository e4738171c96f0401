"""The port's filtered leaky ReLU against the JAX package's.

On the CPU the wrapper runs its plain PyTorch version. It is held
against `maua_tpu.gan.stylegan3._filtered_lrelu_direct` (the XLA chain
the synthesis runs off the TPU, with the affines applied outside it) at
the shapes of tests/test_filtered_lrelu.py, f32, to 1e-5 absolute; and
against the Pallas kernel in interpret mode (as that file runs it) with
all three per-plane affines, to 1e-4 absolute, its own tolerance there.
NHWC in JAX, NCHW here. The CUDA kernel itself is held against the
plain version in test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.gan.stylegan3 import _filtered_lrelu_direct, _lowpass
from maua_tpu.kernels.filtered_lrelu import filtered_lrelu_pallas
from maua_tpu_torch.gan.stylegan3 import _lowpass as port_lowpass
from maua_tpu_torch.kernels import filtered_lrelu as FL


def _filters(up):
    return _lowpass(6 * up, 100.0, 80.0, 1024.0), _lowpass(12, 100.0, 80.0, 1024.0)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _affines(rs, b, c):
    return (rs.rand(b, c).astype(np.float32) + 0.5, rs.randn(b, c).astype(np.float32),
            rs.rand(b, c).astype(np.float32) + 0.5)


@pytest.mark.parametrize("up,down,h,w,c", [
    (2, 2, 24, 20, 5),
    (2, 2, 33, 31, 3),
    (4, 2, 16, 12, 5),
    (4, 2, 21, 19, 2),
    (2, 2, 70, 260, 2),
    (4, 2, 70, 260, 2),
])
def test_plain_matches_jax_direct(up, down, h, w, c):
    rs = np.random.RandomState(0)
    up_f, down_f = _filters(up)
    x = rs.randn(2, h, w, c).astype(np.float32)
    ps, pa, po = _affines(rs, 2, c)
    xin = x * ps[:, None, None, :] + pa[:, None, None, :]
    ref = np.asarray(_filtered_lrelu_direct(jnp.asarray(xin), up_f, down_f, up, down)) * po[:, None, None, :]
    out = FL.filtered_lrelu_plain(_nchw(x), up_f, down_f, up, down, torch.from_numpy(ps), torch.from_numpy(pa),
                                  torch.from_numpy(po))
    assert tuple(out.shape) == (2, c, h * up // down, w * up // down) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("up,down,h,w,c", [(2, 2, 24, 20, 3), (4, 2, 16, 12, 2)])
def test_plain_matches_pallas_interpret(up, down, h, w, c):
    rs = np.random.RandomState(3)
    up_f, down_f = _filters(up)
    x = rs.randn(2, h, w, c).astype(np.float32)
    ps, pa, po = _affines(rs, 2, c)
    ref = np.asarray(filtered_lrelu_pallas(jnp.asarray(x), up_f, down_f, up, down, interpret=True,
                                           pre_scale=jnp.asarray(ps), pre_add=jnp.asarray(pa),
                                           post_scale=jnp.asarray(po)))
    out = FL.filtered_lrelu(_nchw(x), up_f, down_f, up, down, pre_scale=torch.from_numpy(ps),
                            pre_add=torch.from_numpy(pa), post_scale=torch.from_numpy(po))
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), ref, rtol=0, atol=1e-4)


def test_lowpass_matches_jax():
    for args in [(12, 2.0, 2.29, 32.0), (24, 16.0, 16.0, 128.0), (12, 512.0, 107.4, 2048.0)]:
        np.testing.assert_array_equal(port_lowpass(*args), _lowpass(*args))
    assert port_lowpass(1, 2.0, 2.0, 16.0) is None


def test_wrapper_takes_the_plain_path_on_the_cpu():
    rs = np.random.RandomState(1)
    up_f, down_f = _filters(4)
    x = torch.from_numpy(rs.randn(2, 3, 9, 11).astype(np.float32)).to(torch.bfloat16)
    post = torch.rand(2, 3) + 0.5
    FL.reset_launches()
    out = FL.filtered_lrelu(x, up_f, down_f, 4, 2, post_scale=post)
    assert FL.launches == 0  # the plain path is not a launch
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (2, 3, 18, 22)
    torch.testing.assert_close(out, FL.filtered_lrelu_plain(x, up_f, down_f, 4, 2, post_scale=post), rtol=0, atol=0)


@pytest.mark.parametrize("up,down,taps", [(1, 2, 6), (3, 2, 18), (2, 1, 12), (2, 4, 12)])
def test_wrapper_raises_on_up_down_it_does_not_take(up, down, taps):
    x = torch.zeros(1, 2, 8, 8)
    with pytest.raises(ValueError, match="up in"):
        FL.filtered_lrelu(x, np.ones(taps, np.float32), np.ones(12, np.float32), up, down)


def test_wrapper_raises_on_taps_and_shapes_it_does_not_take():
    x = torch.zeros(2, 3, 8, 8)
    up_f, down_f = _filters(2)
    with pytest.raises(ValueError, match="taps"):
        FL.filtered_lrelu(x, up_f[:10], down_f, 2, 2)
    with pytest.raises(ValueError, match="taps"):
        FL.filtered_lrelu(x, up_f, np.ones(8, np.float32), 2, 2)
    with pytest.raises(ValueError, match="post_scale"):
        FL.filtered_lrelu(x, up_f, down_f, 2, 2, post_scale=torch.ones(3))
    with pytest.raises(ValueError, match="B, C, H, W"):
        FL.filtered_lrelu(x[0], up_f, down_f, 2, 2)


@pytest.mark.parametrize("up,h,w,crop", [
    (4, 16, 12, (10, 10, 12, 4)),  # StyleGAN3's centre crop: 10 off each side
    (2, 33, 31, (3, 0, 27, 31)),
    (4, 21, 19, (0, 2, 42, 30)),
    (2, 24, 20, (23, 19, 1, 1)),
])
def test_cropped_plain_is_a_window_of_the_uncropped(up, h, w, crop):
    """The kept window, contiguous, equals the slice of the full output and
    JAX's direct chain followed by the same crop."""
    rs = np.random.RandomState(4)
    up_f, down_f = _filters(up)
    x = rs.randn(2, h, w, 3).astype(np.float32)
    ps, pa, po = _affines(rs, 2, 3)
    aff = dict(pre_scale=torch.from_numpy(ps), pre_add=torch.from_numpy(pa), post_scale=torch.from_numpy(po))
    full = FL.filtered_lrelu_plain(_nchw(x), up_f, down_f, up, 2, **aff)
    out = FL.filtered_lrelu(_nchw(x), up_f, down_f, up, 2, crop=crop, **aff)
    top, left, ch, cw = crop
    assert tuple(out.shape) == (2, 3, ch, cw) and out.is_contiguous()
    torch.testing.assert_close(out, full[:, :, top : top + ch, left : left + cw], rtol=0, atol=0)
    xin = x * ps[:, None, None, :] + pa[:, None, None, :]
    ref = np.asarray(_filtered_lrelu_direct(jnp.asarray(xin), up_f, down_f, up, 2)) * po[:, None, None, :]
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), ref[:, top : top + ch, left : left + cw], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("crop", [(-1, 0, 4, 4), (0, 0, 0, 4), (10, 0, 7, 4), (0, 13, 4, 4)])
def test_wrapper_raises_on_a_crop_outside_the_output(crop):
    up_f, down_f = _filters(2)
    with pytest.raises(ValueError, match="crop"):
        FL.filtered_lrelu(torch.zeros(1, 2, 8, 8), up_f, down_f, 2, 2, crop=crop)
