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
