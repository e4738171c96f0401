"""The port's modulated-conv epilogue against the JAX package's.

On the CPU the wrapper runs its plain PyTorch version; it is held
against `maua_tpu.kernels.epilogue._xla_epilogue` and against the Pallas
kernel in interpret mode (as tests/test_kernels.py runs it), NHWC there
and NCHW here. Tolerance: 1e-5 absolute, f32 (both compute the same
f32 chain; only the order of the noise reshape differs). The CUDA
kernel itself is held against the plain version in test_torch_cuda.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.kernels.epilogue import _xla_epilogue, modconv_epilogue as jax_epilogue
from maua_tpu_torch.kernels import epilogue as E

SQRT2 = math.sqrt(2.0)


def _inputs(seed=0, B=2, H=8, W=8, C=128, G=4):
    rs = np.random.RandomState(seed)
    return dict(
        z=rs.randn(B, H, W, C).astype(np.float32),
        post=rs.rand(B, C).astype(np.float32) + 0.5,
        noise=rs.randn(B, H, W, G).astype(np.float32) * 0.1,
        bias=rs.randn(C).astype(np.float32) * 0.1,
        pre=rs.rand(B, C).astype(np.float32) + 0.5,
    )


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("noise_kind", ["per_sample", "shared", "none"])
@pytest.mark.parametrize("groups", [1, 8])
@pytest.mark.parametrize("use_pre", [True, False])
@pytest.mark.parametrize("clamp", [256.0, 0.5, None])
def test_epilogue_plain_matches_jax(noise_kind, groups, use_pre, clamp):
    d = _inputs(G=groups)
    noise = {"per_sample": d["noise"], "shared": d["noise"][:1], "none": None}[noise_kind]
    pre = d["pre"] if use_pre else None
    full_noise = None if noise is None else np.broadcast_to(noise, d["noise"].shape)
    ref = np.asarray(_xla_epilogue(jnp.asarray(d["z"]), jnp.asarray(d["post"]),
                                   None if noise is None else jnp.asarray(full_noise), jnp.asarray(d["bias"]),
                                   0.2, SQRT2, clamp, None if pre is None else jnp.asarray(pre)))
    out = E.modconv_epilogue(_nchw(d["z"]), torch.from_numpy(d["post"]),
                             None if noise is None else _nchw(noise), torch.from_numpy(d["bias"]),
                             clamp=clamp, pre_next=None if pre is None else torch.from_numpy(pre))
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("noise_kind", ["per_sample", "shared", "none"])
def test_epilogue_plain_matches_pallas_interpret(noise_kind):
    d = _inputs(seed=1)
    noise = {"per_sample": d["noise"], "shared": d["noise"][:1], "none": None}[noise_kind]
    ref = np.asarray(jax_epilogue(jnp.asarray(d["z"]), jnp.asarray(d["post"]),
                                  None if noise is None else jnp.asarray(noise), jnp.asarray(d["bias"]),
                                  pre_next=jnp.asarray(d["pre"]), interpret=True))
    out = E.modconv_epilogue(_nchw(d["z"]), torch.from_numpy(d["post"]),
                             None if noise is None else _nchw(noise), torch.from_numpy(d["bias"]),
                             pre_next=torch.from_numpy(d["pre"]))
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), ref, rtol=0, atol=1e-5)


def test_epilogue_cpu_path_does_not_count_launches():
    d = _inputs()
    E.reset_launches()
    E.modconv_epilogue(_nchw(d["z"]), torch.from_numpy(d["post"]), None, torch.from_numpy(d["bias"]))
    assert E.launches == 0


def test_epilogue_bf16_plain_rounds_once():
    d = _inputs(seed=2)
    z = _nchw(d["z"]).to(torch.bfloat16)
    args = (torch.from_numpy(d["post"]), _nchw(d["noise"]), torch.from_numpy(d["bias"]))
    out = E.modconv_epilogue(z, *args)
    ref = E.modconv_epilogue(z.float(), *args).to(torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, ref)


@pytest.mark.parametrize("bad", ["post", "bias", "noise_hw", "noise_groups", "pre", "rank"])
def test_epilogue_rejects_bad_shapes(bad):
    d = _inputs()
    z, post, bias = _nchw(d["z"]), torch.from_numpy(d["post"]), torch.from_numpy(d["bias"])
    noise, pre = _nchw(d["noise"]), torch.from_numpy(d["pre"])
    if bad == "post":
        post = post[:, :-1]
    elif bad == "bias":
        bias = bias[:-1]
    elif bad == "noise_hw":
        noise = noise[:, :, :-1]
    elif bad == "noise_groups":
        noise = torch.zeros(2, 3, 8, 8)
    elif bad == "pre":
        pre = pre[:1]
    else:
        z = z[0]
    with pytest.raises(ValueError):
        E.modconv_epilogue(z, post, noise, bias, pre_next=pre)
