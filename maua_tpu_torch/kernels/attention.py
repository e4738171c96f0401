"""Attention: the plain formulations, the flash-attention CUDA kernel and the dispatcher.

Port of `maua_tpu/kernels/attention.py`. q is (B, H, Nq, D), k and v are
(B, H, Nk, D). The dispatcher `attention` keeps the reference's routes
exactly:

- packed: D < 64, at least 2 heads, Nq == Nk <= 4096 -> `attention_packed`
  (the TPU packed small heads into one matrix-unit tile; the function is
  the same, so here it is plain per-head attention with the reference's
  bf16 rounding of the scores);
- kernel: Nq and Nk multiples of 256 and D a multiple of 8 ->
  `flash_attention`, which launches `flash_attention_fused` (the CUDA
  kernel takes D up to 512 and raises beyond; no caller of the port goes
  past 512), through the autograd Function `FlashAttention` where autograd
  records (guided sampling differentiates the UNet and the VAE decoder).
  The kernel reads strided views such as the UNet's (B, N, H, D) linears
  in place; inputs without a unit stride along D, such as the VAE's
  channel-first maps, are made contiguous first;
- everything else -> `attention_xla`.

`flash_attention_fused` launches the hand-written CUDA kernels
(`maua_tpu_torch/csrc/attention.cu`: f32 on the CUDA cores, bf16 on the
tensor cores) for CUDA tensors and raises on what it does not take; CPU
tensors take its plain PyTorch version,
`flash_attention_plain`, which computes what the TPU kernel's bodies
compute: f32 scores and row sums, p = exp(s - max) rounded to the input
dtype before the p.v product, the output in q's dtype. Both go through the
custom op `torch.ops.maua_tpu_torch.flash_attention`
(`flash_attention_op`), so a `torch.export` graph calls the kernel.

The kernel computes the forward only. `FlashAttention`'s backward
recomputes P = softmax(q k^T s) in f32 and returns the gradients of the
plain formulation, `attention_xla`'s, with `torch.matmul`; its forward-mode
rule (KLMC2's Hessian-vector products through the UNet) recomputes P the
same way and returns the plain formulation's tangent. (maua_tpu's
Pallas kernel has no backward at all, so on a TPU its guided sampling
cannot differentiate through it; JAX off the TPU differentiates
`attention_xla`, which these gradients equal.)
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import plain_on_cpu
from . import transformed as _transformed

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 512
# attention_packed materialises full (B, N, N) score matrices per head;
# above this sequence length the reference sends self-attention to the flash kernel
_PACKED_MAX_SEQ = 4096

_STRIDES = ctypes.c_longlong * 12  # batch, head and row strides of q, k, v and o
# launches of the CUDA kernel since the last reset (the plain path does not count)
launches = 0
_fn = None


def reset_launches() -> None:
    global launches
    launches = 0


def _kernel():
    global _fn
    if _fn is None:
        from .build import load

        fn = load("attention").maua_flash_attention
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def attention_xla(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """Plain softmax attention: f32 scores, probabilities in q's dtype."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _scale(q, scale)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def attention_packed(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """The reference's packed-heads route, per head: scores in q's dtype,
    scaled by the scale rounded to that dtype (JAX's weak-typed scalar),
    softmax in f32, probabilities back in q's dtype."""
    s = torch.matmul(q, k.transpose(-1, -2)) * torch.tensor(_scale(q, scale), dtype=q.dtype)
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.matmul(p, v)


def flash_attention_plain(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """What the flash kernel computes, in plain PyTorch ops."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _scale(q, scale)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / p.sum(dim=-1, keepdim=True)).to(q.dtype)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be (B, H, N, D), got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape != v.shape or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v {tuple(v.shape)} do not match")


def _layout(t: torch.Tensor, at_pointer: bool = True):
    """Batch, head and row strides in elements (0 along a dimension of size 1, whose stride is never used)
    where the kernel takes t's layout, else None. The kernel copies rows in 16-byte pieces: D at unit
    stride, other strides in multiples of 16 bytes (4 f32 or 8 bf16 elements; rows under 2^24 elements
    apart), from 16-byte aligned storage. Without `at_pointer` the alignment is read from the storage
    offset (the allocator's blocks are aligned), which a traced tensor without storage also has."""
    n0, n1, n2, _ = t.shape
    s0, s1, s2, s3 = t.stride()
    strides = (0 if n0 == 1 else s0, 0 if n1 == 1 else s1, 0 if n2 == 1 else s2)
    e = t.element_size()
    offset = t.data_ptr() if at_pointer else t.storage_offset() * e
    if s3 != 1 or strides[0] * e % 16 or strides[1] * e % 16 or strides[2] * e % 16 or strides[2] >= 2**24 \
            or offset % 16:
        return None
    return strides


def flash_attention_fused(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v through the CUDA kernel (CPU tensors: the plain version).

    q, k and v may be strided views, such as (B, N, H, D) viewed as
    (B, H, N, D), as long as D has unit stride; the output has q's layout."""
    _check(q, k, v)
    if q.device.type == "cpu" and plain_on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, scale)
    return flash_attention_op(q, k, v, _scale(q, scale))


@torch.library.custom_op("maua_tpu_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Flash attention as a custom op: the plain version for a CPU q, the kernel for a CUDA q."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    return _launch(q, k, v, scale)


@flash_attention_op.register_fake
def _(q, k, v, scale):
    return torch.empty_like(q)


def _launch(q, k, v, scale: float) -> torch.Tensor:
    """The kernel's launch into a new tensor, for CUDA q, k and v."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash attention runs on one cuda device or on the cpu, got {q.device}, {k.device}, "
                         f"{v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes float32 or bfloat16 q, k, v of one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if nq % 256 or nk % 256 or d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"flash attention takes Nq, Nk multiples of 256 and D a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}, got Nq {nq}, Nk {nk}, D {d}")
    if b * h > 65535:
        raise ValueError(f"flash attention takes at most 65535 batch-heads, got {b * h}")
    layouts = [_layout(t) for t in (q, k, v)]
    for name, t, lay in zip("qkv", (q, k, v), layouts):
        if lay is None:
            raise ValueError(f"{name} must have unit stride along D, other strides in multiples of 16 bytes, rows "
                             f"under 2^24 elements apart and 16-byte aligned storage, got strides {t.stride()}")
    o = torch.empty_like(q)  # keeps q's strides where q is a permuted dense tensor
    lay = _layout(o)
    if lay is None:
        o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        lay = _layout(o)
    strides = _STRIDES(*layouts[0], *layouts[1], *layouts[2], *lay)
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _DTYPES[q.dtype], b, h, nq, nk, d,
                    scale, strides, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: error {err}")
    global launches
    launches += 1
    return o


def route(q_shape, k_shape) -> str:
    """'packed', 'kernel' or 'plain': where `attention` sends these shapes."""
    _, h, nq, d = q_shape
    nk = k_shape[2]
    if d < 64 and h >= 2 and nq == nk and nq <= _PACKED_MAX_SEQ:
        return "packed"
    if not (nq % 256 or nk % 256 or d % 8):
        return "kernel"
    return "plain"


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    if _layout(t, at_pointer=False) is not None:
        return t
    t = t.contiguous()
    return t if t.storage_offset() * t.element_size() % 16 == 0 else t.clone()


class FlashAttention(torch.autograd.Function):
    """`flash_attention_fused` forward (the kernel on the card, its plain
    version on the CPU), on q, k and v laid out as the kernel takes them.
    Backward from q, k and v saved in the forward: P recomputed in f32, then
    dv = P^T do, dS = P * (do v^T - rowsum(P * do v^T)), dq = dS k s and
    dk = dS^T q s, each in its input's dtype. Forward mode (`jvp`, for
    `torch.func.jvp` and `torch.autograd.forward_ad`): P recomputed in f32,
    dS = s (dq k^T + q dk^T), dP = P * (dS - rowsum(P * dS)) and
    dO = dP v + P dv, in q's dtype."""

    @staticmethod
    def forward(q, k, v, scale):
        return flash_attention_fused(_kernel_layout(q), _kernel_layout(k), _kernel_layout(v), scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, scale = inputs
        ctx.save_for_backward(q, k, v)
        ctx.save_for_forward(q, k, v)
        ctx.scale = _scale(q, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
        p = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * ctx.scale, dim=-1)
        dv = torch.matmul(p.transpose(-1, -2), dof)
        dp = torch.matmul(dof, vf.transpose(-1, -2))
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * ctx.scale
        dq = torch.matmul(ds, kf)
        dk = torch.matmul(ds.transpose(-1, -2), qf)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None

    @staticmethod
    def jvp(ctx, dq, dk, dv, _):
        q, k, v = ctx.saved_tensors
        qf, kf, vf = q.float(), k.float(), v.float()
        p = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * ctx.scale, dim=-1)
        ds = torch.zeros_like(p)
        if dq is not None:
            ds = ds + torch.matmul(dq.float(), kf.transpose(-1, -2))
        if dk is not None:
            ds = ds + torch.matmul(qf, dk.float().transpose(-1, -2))
        ds = ds * ctx.scale
        dp = p * (ds - (p * ds).sum(dim=-1, keepdim=True))
        do = torch.matmul(dp, vf)
        if dv is not None:
            do = do + torch.matmul(p, dv.float())
        return do.to(q.dtype)


def flash_attention(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """The kernel route: `flash_attention_fused`, through `FlashAttention` where
    autograd records (grad enabled and an input that requires grad) or a
    forward-mode transform carries tangents; otherwise the wrapper alone,
    which saves nothing."""
    if (torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)) or _transformed(q, k, v):
        return FlashAttention.apply(q, k, v, scale)
    return flash_attention_fused(q, k, v, scale)


def attention(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """Dispatcher used by the UNet's and the VAE's attention layers."""
    r = route(q.shape, k.shape)
    if r == "packed":
        return attention_packed(q, k, v, scale)
    if r == "kernel":
        if _transformed(q, k, v):  # a torch.func wrapper has no storage: FlashAttention.forward lays out its inputs
            return FlashAttention.apply(q, k, v, scale)
        return flash_attention(_kernel_layout(q), _kernel_layout(k), _kernel_layout(v), scale)
    return attention_xla(q, k, v, scale)
