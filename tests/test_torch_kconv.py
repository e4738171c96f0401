"""The port's kconv3x3 (plain version, the CPU path) against maua_tpu's
Pallas kernel in interpret mode, at the shapes of tests/test_kconv.py,
with and without the fused epilogue.

Tolerances: f32 to 1e-5 relative plus 1e-5 absolute on outputs of
magnitude up to ~10 (a sum of 9 Ci products in another order). bf16
storage, f32 arithmetic on both sides: the JAX kernel rounds the styled
input and the weights to bf16 as the port does, and each side rounds its
f32 result once, so they differ by at most one bf16 ulp of the output
(2^-7 relative) plus the f32 allowance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.kernels.kconv import kconv3x3 as jax_kconv3x3
from maua_tpu_torch.kernels import kconv as K


def inputs(b, h, w, ci, co, seed, epilogue):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, h, w, ci).astype(np.float32)
    wt = (rs.randn(3, 3, ci, co) * 0.1).astype(np.float32)
    kw = {}
    if epilogue:
        kw = dict(bias=rs.randn(co).astype(np.float32), style=(rs.rand(b, ci) + 0.5).astype(np.float32),
                  demod=(rs.rand(b, co) + 0.5).astype(np.float32))
    return x, wt, kw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("h,w,ci,co", [(16, 20, 5, 3), (13, 130, 32, 32), (24, 33, 51, 51), (9, 260, 81, 51)])
def test_kconv_matches_the_pallas_kernel(h, w, ci, co, epilogue, dtype):
    x, wt, kw = inputs(2, h, w, ci, co, 0, epilogue)
    act = dict(alpha=0.2, gain=float(np.sqrt(2.0))) if epilogue else {}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = np.asarray(jax_kconv3x3(jnp.asarray(x, jdt), jnp.asarray(wt), **{k: jnp.asarray(v) for k, v in kw.items()},
                                  **act, interpret=True).astype(jnp.float32))
    out = K.kconv3x3(torch.from_numpy(x).to(tdt), torch.from_numpy(wt), **{k: torch.from_numpy(v) for k, v in kw.items()},
                     **act)
    assert out.dtype == tdt and out.shape == (2, h, w, co)
    rtol = 2.0**-7 + 1e-5 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=rtol, atol=1e-5)


def test_gain_applies_only_with_the_activation():
    """As in the TPU kernel, `gain` scales the leaky relu's output and nothing else."""
    x, wt, _ = inputs(1, 6, 7, 4, 5, 1, False)
    xt, wtt = torch.from_numpy(x), torch.from_numpy(wt)
    torch.testing.assert_close(K.kconv3x3(xt, wtt, gain=3.0), K.kconv3x3(xt, wtt))
    ref = np.asarray(jax_kconv3x3(jnp.asarray(x), jnp.asarray(wt), gain=3.0, interpret=True))
    np.testing.assert_allclose(K.kconv3x3(xt, wtt, gain=3.0).numpy(), ref, atol=1e-5)


def test_cpu_tensors_take_the_plain_version_and_shapes_are_checked():
    x, wt, kw = inputs(2, 5, 6, 3, 4, 2, True)
    t = {k: torch.from_numpy(v) for k, v in kw.items()}
    K.reset_launches()
    out = K.kconv3x3(torch.from_numpy(x), torch.from_numpy(wt), **t, alpha=0.2)
    assert torch.equal(out, K.kconv3x3_plain(torch.from_numpy(x), torch.from_numpy(wt), **t, alpha=0.2))
    assert K.launches == 0
    with pytest.raises(ValueError):
        K.kconv3x3(torch.from_numpy(x), torch.from_numpy(wt[:1]))
    with pytest.raises(ValueError):
        K.kconv3x3(torch.from_numpy(x), torch.from_numpy(wt), style=t["style"][:, :2])
    with pytest.raises(ValueError):
        K.kconv3x3(torch.from_numpy(x[0]), torch.from_numpy(wt))


@pytest.mark.parametrize("ci,co", [(81, 51), (51, 32), (32, 32), (5, 3), (17, 72), (192, 64)])
def test_packed_weights_rebuild_the_conv(ci, co):
    """The bf16 kernel's weight tiles, contracted by im2col in the kernel's K order (per input chunk of 16,
    the nine taps), give the plain version's conv; padding of Ci and Co is zero."""
    x, wt, _ = inputs(2, 7, 9, ci, co, 3, False)
    xt, wtt = torch.from_numpy(x), torch.from_numpy(wt)
    wp = K.pack_weights(wtt, torch.float32)
    t = K.tile_co(co)
    assert t == (32 if co <= 32 else 64)
    nco, nci = -(-co // t), -(-ci // K.TILE_CI)
    assert wp.shape == (nco, nci, 9, K.TILE_CI, t) and wp.is_contiguous()
    # the weight matrix, rows (tap, input channel) and columns output channels, both zero-padded
    wmat = wp.permute(2, 1, 3, 0, 4).reshape(9, nci * K.TILE_CI, nco * t)
    assert not wmat[:, ci:].any() and not wmat[:, :, co:].any()
    xpad = torch.nn.functional.pad(xt, (0, nci * K.TILE_CI - ci, 1, 1, 1, 1))
    cols = torch.stack([xpad[:, dy:dy + 7, dx:dx + 9] for dy in range(3) for dx in range(3)], dim=3)
    y = torch.zeros(2, 7, 9, nco * t, dtype=torch.float64)
    for c in range(nci):  # the kernel's K loop: a chunk of 16 input channels, then its nine taps
        sl = slice(c * K.TILE_CI, (c + 1) * K.TILE_CI)
        y += torch.einsum("bhwtc,tcn->bhwn", cols[..., sl].double(), wmat[:, sl].double())
    torch.testing.assert_close(y[..., :co].float(), K.kconv3x3_plain(xt, wtt), rtol=1e-5, atol=1e-5)
    assert torch.equal(K.pack_weights(wtt, torch.bfloat16).float(),
                       K.pack_weights(wtt.to(torch.bfloat16).float(), torch.float32))


@pytest.mark.parametrize("ci,co", [(81, 51), (51, 32), (5, 3), (17, 33), (192, 64), (8, 65)])
def test_f32_packed_weights_rebuild_the_conv(ci, co):
    """The f32 kernel's weight tiles (8 input channels a step, 32 or 64 output channels a block),
    contracted by im2col in the kernel's K order (per input chunk of 8, the nine taps), give the plain
    version's conv; padding of Ci and Co is zero."""
    x, wt, _ = inputs(2, 7, 9, ci, co, 4, False)
    xt, wtt = torch.from_numpy(x), torch.from_numpy(wt)
    wp = K.pack_weights(wtt, torch.float32, K.F32_TILE_CI)
    t = K.tile_co(co)
    nco, nci = -(-co // t), -(-ci // K.F32_TILE_CI)
    assert wp.shape == (nco, nci, 9, K.F32_TILE_CI, t) and wp.is_contiguous()
    wmat = wp.permute(2, 1, 3, 0, 4).reshape(9, nci * K.F32_TILE_CI, nco * t)
    assert not wmat[:, ci:].any() and not wmat[:, :, co:].any()
    xpad = torch.nn.functional.pad(xt, (0, nci * K.F32_TILE_CI - ci, 1, 1, 1, 1))
    cols = torch.stack([xpad[:, dy:dy + 7, dx:dx + 9] for dy in range(3) for dx in range(3)], dim=3)
    y = torch.zeros(2, 7, 9, nco * t, dtype=torch.float64)
    for c in range(nci):
        sl = slice(c * K.F32_TILE_CI, (c + 1) * K.F32_TILE_CI)
        y += torch.einsum("bhwtc,tcn->bhwn", cols[..., sl].double(), wmat[:, sl].double())
    torch.testing.assert_close(y[..., :co].float(), K.kconv3x3_plain(xt, wtt), rtol=1e-5, atol=1e-5)
