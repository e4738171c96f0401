"""Fused modulated-conv epilogue: a hand-written CUDA kernel and its plain twin.

Port of the Pallas TPU kernel `maua_tpu/kernels/epilogue.py`
(`modconv_epilogue`; kernel body `_kernel`, reference chain
`_xla_epilogue`), in NCHW. For the conv output z (B, C, H, W):

    y = z * post[b, c] + noise[b|0, g(c), h, w] + bias[c]
    y = lrelu(y, alpha) * gain, clipped to +-clamp, times pre_next[b, c]

where noise (B|1, G, H, W) covers channels [g*C/G, (g+1)*C/G) with group
g. StyleGAN2's synthesis layers call it with per-pixel noise (G = 1) and
no pre_next.

The CUDA source is `maua_tpu_torch/csrc/epilogue.cu`: one pass over z,
bound by memory bytes (read z, write y). `modconv_epilogue` launches it
for CUDA tensors and raises on what it does not take; CPU tensors take
the plain PyTorch version, `modconv_epilogue_plain`, which is also what
the kernel is held against on the card. Where autograd records, the call
goes through `ModconvEpilogue`: the same forward (the launch writes an
output with no `grad_fn`) and the plain version's autograd as its
backward, recomputed in f32 from the saved inputs; under create_graph that
backward records its own graph, so a double backward (R1, path length) is
the plain version's.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

_SQRT2 = math.sqrt(2.0)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

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

        fn = load("epilogue").maua_modconv_epilogue
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def modconv_epilogue_plain(z, post, noise, bias, alpha=0.2, gain=_SQRT2, clamp=256.0, pre_next=None):
    """The same function in plain PyTorch ops, in f32, cast back to z's dtype."""
    b, c, h, w = z.shape
    y = z.float() * post.float()[:, :, None, None]
    if noise is not None:
        g = noise.shape[1]
        y = (y.view(b, g, c // g, h, w) + noise.float()[:, :, None]).view(b, c, h, w)
    y = y + bias.float()[None, :, None, None]
    y = torch.where(y >= 0, y, y * alpha) * gain
    if clamp is not None and clamp >= 0:
        y = _clip(y, clamp)
    if pre_next is not None:
        y = y * pre_next.float()[:, :, None, None]
    return y.to(z.dtype)


def _clip(y, clamp: float):
    """y clipped to +-clamp as jnp.clip is, min(max(y, -c), c): autograd halves the gradient
    at a bound (torch.maximum / minimum split it at ties, as JAX's do; torch.clamp passes it)."""
    return torch.minimum(torch.maximum(y, y.new_full((), -clamp)), y.new_full((), clamp))  # filled on y's device


def _check(z, post, noise, bias, pre_next):
    if z.dim() != 4:
        raise ValueError(f"z must be (B, C, H, W), got {tuple(z.shape)}")
    b, c, h, w = z.shape
    if post.shape != (b, c):
        raise ValueError(f"post must be {(b, c)}, got {tuple(post.shape)}")
    if bias.shape != (c,):
        raise ValueError(f"bias must be {(c,)}, got {tuple(bias.shape)}")
    if pre_next is not None and pre_next.shape != (b, c):
        raise ValueError(f"pre_next must be {(b, c)}, got {tuple(pre_next.shape)}")
    if noise is not None:
        if noise.dim() != 4 or noise.shape[0] not in (1, b) or noise.shape[2:] != (h, w):
            raise ValueError(f"noise must be (1|{b}, G, {h}, {w}), got {tuple(noise.shape)}")
        if c % noise.shape[1]:
            raise ValueError(f"noise groups {noise.shape[1]} must divide channels {c}")


class ModconvEpilogue(torch.autograd.Function):
    """`modconv_epilogue`'s forward (the kernel on the card, its plain version
    under no_grad on the CPU) with the plain version's autograd as its
    backward, recomputed in f32 from the saved inputs. The clamp takes
    maua_tpu's rule (`_xla_epilogue`'s jnp.clip, whose min / max split a tie):
    the gradient passes inside, halves at exactly +-clamp and stops outside.
    Under create_graph the backward is itself differentiable (the plain ops on
    the saved tensors), so a gradient penalty's second-order terms pass through."""

    @staticmethod
    def forward(z, post, noise, bias, pre_next, alpha, gain, clamp):
        if z.device.type == "cpu":
            return modconv_epilogue_plain(z, post, noise, bias, alpha, gain, clamp, pre_next)
        return _launch(z, post, noise, bias, alpha, gain, clamp, pre_next)

    @staticmethod
    def setup_context(ctx, inputs, output):
        z, post, noise, bias, pre_next, alpha, gain, clamp = inputs
        ctx.save_for_backward(z, post, noise, bias, pre_next)
        ctx.alpha, ctx.gain, ctx.clamp = alpha, gain, clamp

    @staticmethod
    def backward(ctx, g):
        # Grad is enabled here only when the caller asked for create_graph: the gradients then carry a graph
        # back to the saved tensors and to g (a gradient penalty differentiates them once more).
        create_graph = torch.is_grad_enabled()
        saved, need = ctx.saved_tensors, ctx.needs_input_grad[:5]
        wanted = [t for t, n in zip(saved, need) if t is not None and n]
        with torch.enable_grad():
            z, post, noise, bias, pre_next = saved
            y = modconv_epilogue_plain(z, post, noise, bias, ctx.alpha, ctx.gain, ctx.clamp, pre_next)
            grads = iter(torch.autograd.grad(y, wanted, g, create_graph=create_graph))
        return (*(next(grads) if t is not None and n else None for t, n in zip(saved, need)), None, None, None)


def modconv_epilogue(
    z: torch.Tensor,  # (B, C, H, W) conv output, f32 or bf16
    post: torch.Tensor,  # (B, C) demodulation scale
    noise: Optional[torch.Tensor],  # (B|1, G, H, W)
    bias: torch.Tensor,  # (C,)
    alpha: float = 0.2,
    gain: float = _SQRT2,
    clamp: Optional[float] = 256.0,
    pre_next: Optional[torch.Tensor] = None,  # (B, C) next layer's input scale
) -> torch.Tensor:
    """demod * z + grouped noise + bias -> lrelu * gain -> clamp [-> * pre_next]; through
    `ModconvEpilogue` where autograd records (grad enabled and an input that requires grad)."""
    _check(z, post, noise, bias, pre_next)
    inputs = [t for t in (z, post, noise, bias, pre_next) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return ModconvEpilogue.apply(z, post, noise, bias, pre_next, alpha, gain, clamp)
    if z.device.type == "cpu":
        return modconv_epilogue_plain(z, post, noise, bias, alpha, gain, clamp, pre_next)
    return _launch(z, post, noise, bias, alpha, gain, clamp, pre_next)


def _launch(z, post, noise, bias, alpha, gain, clamp, pre_next):
    """The kernel's launch into a new tensor, for a CUDA z."""
    if z.device.type != "cuda":
        raise ValueError(f"modconv_epilogue runs on cuda or cpu tensors, got {z.device}")
    if z.dtype not in _DTYPES:
        raise TypeError(f"modconv_epilogue takes float32 or bfloat16, got {z.dtype}")
    if clamp is not None and clamp < 0:
        raise ValueError("clamp must be None or >= 0")
    if not z.is_contiguous():
        raise ValueError("z must be contiguous NCHW")
    small = [t for t in (post, noise, bias, pre_next) if t is not None]
    if any(t.device != z.device for t in small):
        raise ValueError("all tensors must be on the device of z")
    # the per-channel vectors and the noise are small next to z: f32, contiguous
    post32 = post.float().contiguous()
    bias32 = bias.float().contiguous()
    pre32 = None if pre_next is None else pre_next.float().contiguous()
    noise32 = None if noise is None else noise.float().contiguous()
    b, c, h, w = z.shape
    y = torch.empty_like(z)
    err = _kernel()(
        z.data_ptr(), y.data_ptr(), _DTYPES[z.dtype],
        post32.data_ptr(), 0 if noise32 is None else noise32.data_ptr(),
        bias32.data_ptr(), 0 if pre32 is None else pre32.data_ptr(),
        b, c, h * w, 1 if noise32 is None else noise32.shape[1],
        int(noise32 is not None and noise32.shape[0] == b and b > 1),
        float(alpha), float(gain), 0.0 if clamp is None else float(clamp), int(clamp is not None),
        torch.cuda.current_stream(z.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"modconv_epilogue kernel launch failed: cudaError {err}")
    global launches
    launches += 1
    return y
