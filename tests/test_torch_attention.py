"""The port's attention against maua_tpu's, on the CPU.

The plain formulations and the flash kernel's plain version
(`flash_attention_fused` on CPU tensors) against `attention_xla`,
`attention_packed` and the Pallas kernel in interpret mode, on both of
its bodies: the single-shot one at (2, 4, 256, 64) and the blocked
online-softmax one at q (1, 1, 256, 512), k/v (1, 1, 2304, 512), where
nk * d > 1,048,576. Inputs are numpy draws from a seed.

Tolerances: f32 1e-5 absolute on outputs of magnitude ~1 (summation
order). bf16 2^-8 absolute, one bf16 ulp of the outputs here (magnitude
< 1): both sides round p to bf16 before the p.v product, but against
different row maxima (the blocked body's running one, the plain
version's final one) and with another exp, so an output may land one
ulp apart (measured 2^-10 against both Pallas bodies).

The routing table holds the port's `route` against where maua_tpu's
dispatcher sends each shape of an SD 1.x image at 512^2 and 256^2 and of
its VAE (found by spying on the JAX functions, as if on a TPU).

The kernel route's gradient (`FlashAttention`) against `jax.grad` of
maua_tpu's `attention_xla`, which is what JAX differentiates off the TPU
(its Pallas kernel has no reverse-mode rule): f32, 1e-5 absolute on
gradients of magnitude ~1 (the same products summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.kernels import attention as J
from maua_tpu_torch.kernels import attention as T

F32_TOL = 1e-5
BF16_TOL = 2.0**-8


def _qkv(shape_q, shape_kv, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(*shape_q).astype(np.float32), rs.randn(*shape_kv).astype(np.float32),
            rs.randn(*shape_kv).astype(np.float32))


def _both(arrays, dtype):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    return [jnp.asarray(a, jdt) for a in arrays], [torch.from_numpy(a).to(tdt) for a in arrays]


def _close(port, ref, dtype):
    port = port.float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert port.shape == ref.shape
    err = np.abs(port - ref).max()
    assert err <= (BF16_TOL if dtype == "bf16" else F32_TOL), err


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape_q,shape_kv", [((2, 4, 256, 64), (2, 4, 256, 64)),
                                              ((2, 8, 77, 40), (2, 8, 16, 40)),
                                              ((1, 2, 100, 24), (1, 2, 100, 24))])
def test_attention_xla_matches(dtype, shape_q, shape_kv):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(shape_q, shape_kv, 0), dtype)
    _close(T.attention_xla(tq, tk, tv), J.attention_xla(jq, jk, jv), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 8, 64, 40), (1, 5, 128, 16)])
def test_attention_packed_matches(dtype, shape):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(shape, shape, 1), dtype)
    _close(T.attention_packed(tq, tk, tv), J.attention_packed(jq, jk, jv), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("body,shape_q,shape_kv", [
    ("single", (2, 4, 256, 64), (2, 4, 256, 64)),
    ("blocked", (1, 1, 256, 512), (1, 1, 2304, 512)),
])
def test_flash_plain_matches_pallas_interpret(dtype, body, shape_q, shape_kv):
    nk, d = shape_kv[2], shape_kv[3]
    assert (nk * d > 1_048_576) == (body == "blocked")  # the JAX wrapper's choice between its two bodies
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(shape_q, shape_kv, 2), dtype)
    ref = J.flash_attention(jq, jk, jv, interpret=True)
    T.reset_launches()
    out = T.flash_attention_fused(tq, tk, tv)
    assert T.launches == 0  # CPU tensors take the plain version
    assert out.dtype == tq.dtype
    _close(out, ref, dtype)


def _jax_route(q, k, monkeypatch):
    """Where maua_tpu's dispatcher sends q, k on a TPU: spies on its three
    formulations (pallas_call stands for the kernel) that compute nothing."""
    calls = []

    def zeros(*args, **kwargs):
        return jnp.zeros(args[0].shape, args[0].dtype)

    def fake_pallas_call(kernel, out_shape, **kwargs):
        calls.append("kernel")
        return lambda *a: jnp.zeros(out_shape.shape, out_shape.dtype)

    monkeypatch.setattr(J, "attention_packed", lambda *a, **kw: calls.append("packed") or zeros(*a))
    monkeypatch.setattr(J, "attention_xla", lambda *a, **kw: calls.append("plain") or zeros(*a))
    monkeypatch.setattr(J.pl, "pallas_call", fake_pallas_call)
    monkeypatch.setattr(J.jax, "default_backend", lambda: "tpu")
    J.attention(q, k, k)
    assert len(calls) == 1, calls
    return calls[0]


# (q shape, k shape, route): SD 1.x at 512^2 and 256^2 with CFG batch 2 and 8 heads, and its VAE
ROUTES = [
    ((2, 8, 4096, 40), (2, 8, 4096, 40), "packed"),  # 512^2, level 0 self-attention
    ((2, 8, 4096, 40), (2, 8, 77, 40), "plain"),  # level 0 cross-attention
    ((2, 8, 1024, 80), (2, 8, 1024, 80), "kernel"),  # level 1 self-attention
    ((2, 8, 1024, 80), (2, 8, 77, 80), "plain"),
    ((2, 8, 256, 160), (2, 8, 256, 160), "kernel"),  # level 2 self-attention
    ((2, 8, 256, 160), (2, 8, 77, 160), "plain"),
    ((2, 8, 64, 160), (2, 8, 64, 160), "plain"),  # mid block
    ((2, 8, 64, 160), (2, 8, 77, 160), "plain"),
    ((1, 1, 4096, 512), (1, 1, 4096, 512), "kernel"),  # VAE mid attention at 64^2 latents
    ((2, 8, 1024, 40), (2, 8, 1024, 40), "packed"),  # 256^2, level 0
    ((2, 8, 256, 80), (2, 8, 256, 80), "kernel"),  # level 1
    ((2, 8, 64, 160), (2, 8, 64, 160), "plain"),  # level 2
    ((2, 8, 16, 160), (2, 8, 16, 160), "plain"),  # mid block
    ((1, 1, 1024, 512), (1, 1, 1024, 512), "kernel"),  # VAE at 32^2 latents
    ((1, 2, 8192, 40), (1, 2, 8192, 40), "kernel"),  # past the packed route's 4096
    ((1, 1, 512, 40), (1, 1, 512, 40), "kernel"),  # one head: not packed
    ((1, 2, 512, 44), (1, 2, 512, 44), "packed"),
    ((1, 1, 512, 44), (1, 1, 512, 44), "plain"),  # D % 8
]


@pytest.mark.parametrize("q_shape,k_shape,expected", ROUTES)
def test_routing_matches_maua_tpu(q_shape, k_shape, expected, monkeypatch):
    q = jnp.zeros(q_shape, jnp.float32)
    k = jnp.zeros(k_shape, jnp.float32)
    assert _jax_route(q, k, monkeypatch) == expected
    assert T.route(q_shape, k_shape) == expected


def test_dispatcher_takes_the_route(monkeypatch):
    seen = []
    for name in ("attention_packed", "attention_xla", "flash_attention_fused"):
        monkeypatch.setattr(T, name, lambda *a, _n=name, **kw: seen.append(_n) or a[0])
    for q_shape, k_shape, expected in ROUTES[:4]:
        seen.clear()
        T.attention(torch.zeros(q_shape), torch.zeros(k_shape), torch.zeros(k_shape))
        assert seen == [{"packed": "attention_packed", "plain": "attention_xla",
                         "kernel": "flash_attention_fused"}[expected]]


def test_flash_plain_handles_strided_inputs():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 256, 2, 64), (1, 256, 2, 64), 3))
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, N, D) views, not contiguous
    assert T.route(q.shape, k.shape) == "kernel"
    out = T.attention(q, k, v)
    ref = T.attention_xla(q, k, v)
    assert (out - ref).abs().max() <= F32_TOL


def test_flash_wrapper_rejects_bad_shapes():
    q = torch.zeros(1, 2, 256, 64)
    with pytest.raises(ValueError):
        T.flash_attention_fused(q, torch.zeros(1, 2, 256, 32), torch.zeros(1, 2, 256, 32))
    with pytest.raises(ValueError):
        T.flash_attention_fused(q[0], q[0], q[0])


@pytest.mark.parametrize("dtype,row_stride,takes", [(torch.bfloat16, 4, False), (torch.bfloat16, 12, False),
                                                    (torch.bfloat16, 8, True), (torch.float32, 4, True),
                                                    (torch.float32, 12, True)])
def test_kernel_layout_check_counts_bytes(dtype, row_stride, takes):
    """The kernel copies rows in 16-byte pieces: a row stride of 4 elements is 16 bytes in f32, 8 in bf16.
    On the route (D a multiple of 8) the dispatcher makes what the kernel does not take contiguous, and
    leaves the rest in place."""
    d = 4 if row_stride == 4 else 8
    t = torch.zeros(1, 1, 256, row_stride, dtype=dtype)[..., :d]
    assert t.stride(2) == row_stride
    assert (T._layout(t) is not None) is takes
    if d % 8 == 0:
        laid = T._kernel_layout(t)
        assert torch.equal(laid, t) and T._layout(laid) is not None
        assert (laid.data_ptr() == t.data_ptr()) is takes


GRAD_SHAPES = [((1, 2, 256, 64), (1, 2, 256, 64)), ((2, 1, 256, 80), (2, 1, 512, 80))]


@pytest.mark.parametrize("shape_q,shape_kv", GRAD_SHAPES)
def test_kernel_route_gradient_matches_jax_grad_of_attention_xla(shape_q, shape_kv):
    arrays = _qkv(shape_q, shape_kv, 4)
    do = np.random.RandomState(5).randn(*shape_q).astype(np.float32)
    want = jax.grad(lambda q, k, v: jnp.sum(J.attention_xla(q, k, v) * do), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in arrays))
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrays)
    assert T.route(q.shape, k.shape) == "kernel"
    T.reset_launches()
    out = T.attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(torch.from_numpy(do))
    assert T.launches == 0  # the CPU forward is the plain version
    for got, ref in zip((q.grad, k.grad, v.grad), want):
        _close(got, ref, "f32")


def test_kernel_route_without_autograd_saves_nothing():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 256, 64), (1, 2, 256, 64), 6))
    with torch.no_grad():
        out = T.attention(q.requires_grad_(True), k, v)
    assert out.grad_fn is None
    assert T.attention(q.detach(), k, v).grad_fn is None
    torch.testing.assert_close(out, T.flash_attention_plain(q.detach(), k, v), rtol=0, atol=0)


def test_maua_tpu_flash_kernel_has_no_reverse_mode_gradient():
    """The reference's fault this route works around (ROADMAP C8): its Pallas kernel cannot be
    differentiated, so guided sampling on a TPU fails at the first kernel-routed attention."""
    q = jnp.asarray(_qkv((1, 1, 256, 64), (1, 1, 256, 64), 7)[0])
    with pytest.raises(Exception, match="reverse-mode"):
        jax.grad(lambda q: jnp.sum(J.flash_attention(q, q, q, interpret=True)))(q)
