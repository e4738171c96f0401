"""int8 x int8 -> int32 convolution with an f32 output: a hand-written CUDA
kernel and its plain twin.

The counterpart of the XLA int8 convolutions in the JAX package's W8A8
plans: `maua_tpu/gan/fast_synthesis.py` `_conv_i8` (the s2d tail) and the
conv of `maua_tpu/gan/stylegan3.py` `_modconv_int8` (the trunk), each
`conv_general_dilated(..., preferred_element_type=int32).astype(float32)`.
They are XLA ops, not Pallas kernels; PyTorch has no int8 convolution on
CUDA, so the port runs them through its own kernel. For x int8 (B, Ci, H,
W) and w int8 (Co, Ci, k, k):

    y = f32(sum over taps and Ci of x w)     SAME padding, stride 1

exact in int32, converted with round-to-nearest-even. (An even k pads one
more before than after, as the JAX package's padding does; the kernel takes
k of 1 and 3, the sizes the plans hold.)

The CUDA source is `maua_tpu_torch/csrc/conv_i8.cu`: an implicit GEMM on
the tensor cores (wgmma m64nNk32 s8, both operands in shared memory) in a
persistent block of three warpgroups. A producer warpgroup stages each
32-channel slab of the NCHW activations asynchronously, two chunks ahead in
a ring of three stages (one TMA box where W % 16 == 0, else 16-byte
cp.async), transposes it once in shared memory into channel-contiguous
pixels, and loads the chunk's weight tile, in the layout that
`pack_weights` makes (one small copy per call), by one bulk copy; two
consumer warpgroups run the wgmmas of up to 256 output channels on the
same staged halo and store the f32 result through shared memory as
16-byte pieces of NCHW rows. At the plans' shapes it is bound by the bytes
of its f32 output, or by its operations at the widest layers. `conv_i8`
launches it for CUDA tensors and raises on what it does not take; CPU
tensors take the plain version, `conv_i8_plain` (`F.conv2d` in float64 of
the int8 values, exact, then int32 and f32), which is also what the kernel
is held against on the card, bit for bit. int8 has no gradient: the wrapper
refuses autograd.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import refuse_autograd

TILE_CI = 32  # input channels per step of the kernel, for each tap

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

        fn = load("conv_i8").maua_conv_i8
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _route():
    from .build import load

    fn = load("conv_i8").maua_conv_i8_route
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def wide_patches(width: int) -> bool:
    """Whether the kernel takes 1 x 64 pixel patches (whole 256-byte pieces of each output row) for an image of
    this width, in place of 8 x 8 ones: where W % 64 == 0 or W >= 256 (the csrc's `wide_patches`)."""
    return width % 64 == 0 or width >= 256


def tile_co(co: int, wide: bool) -> int:
    """The kernel's output channels per block (the csrc's `tile_co`): 32, 64 or 128 up to those widths; past
    128, 128 with wide patches, else 256 unless 128-wide tiles pad Co less (323 -> 3 x 128, not 2 x 256)."""
    for t in (32, 64, 128):
        if co <= t:
            return t
    return 128 if wide or -(-co // 128) * 128 < -(-co // 256) * 256 else 256


def pack_weights(w: torch.Tensor, wide: bool) -> torch.Tensor:
    """OIHW int8 (Co, Ci, k, k) -> (ceil(Co / T), ceil(Ci / 32), k * k, 2, T, 16), zero-padded, T = tile_co(Co,
    wide): tile [n, c, tap, h, j, i] is w[T n + j, 32 c + 16 h + i, tap // k, tap % k]. The slice [n, c] is the
    kernel's weight stage for output tile n and input chunk c, whole and contiguous; each [n, c, tap] is wgmma's
    B operand for that tap, K-major without swizzle: 16-byte rows of 16 input channels, the two halves of the
    chunk T rows apart."""
    co, ci, kh, kw = w.shape
    t = tile_co(co, wide)
    nci, nco = -(-ci // TILE_CI), -(-co // t)
    wp = torch.zeros(nco * t, nci * TILE_CI, kh * kw, dtype=torch.int8, device=w.device)
    wp[:co, :ci] = w.reshape(co, ci, kh * kw)
    return wp.view(nco, t, nci, 2, TILE_CI // 2, kh * kw).permute(0, 2, 5, 3, 1, 4).contiguous()


def staging_route(x: torch.Tensor) -> str:
    """How the kernel stages x: "tma" (one tensor-map box a chunk) where W % 16 == 0 and x is 16-byte aligned,
    else "cp.async" (16-byte copies of the aligned units around each row). The kernel's own rule, read from the
    library: it needs the card's build."""
    return "tma" if _route()(x.data_ptr(), x.shape[3]) else "cp.async"


def conv_i8_int32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact int32 sums: F.conv2d in float64 of the int8 values (each product and partial sum an integer
    far below 2^53), rounded and cast."""
    kh, kw = w.shape[2], w.shape[3]
    xd = F.pad(x.double(), [kw // 2, (kw - 1) // 2, kh // 2, (kh - 1) // 2])
    return F.conv2d(xd, w.double()).round().to(torch.int32)


def conv_i8_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch ops: the exact int32 sums converted to f32 (round to nearest even)."""
    return conv_i8_int32(x, w).float()


def _check(x, w):
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"x must be (B, Ci, H, W) and w (Co, Ci, k, k), got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"conv_i8 takes int8 x and w, got {x.dtype} and {w.dtype}")
    if w.shape[1] != x.shape[1]:
        raise ValueError(f"w must have {x.shape[1]} input channels, got {tuple(w.shape)}")


def conv_i8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME-padded stride-1 correlation of int8 x (B, Ci, H, W) with int8 w (Co, Ci, k, k): the exact int32
    sums as f32 (B, Co, H, W)."""
    _check(x, w)
    if x.device.type == "cpu":
        return conv_i8_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"conv_i8 runs on cuda or cpu tensors, got {x.device}")
    refuse_autograd("conv_i8", x, w)
    if w.device != x.device:
        raise ValueError("w must be on the device of x")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NCHW")
    co, _, kh, kw = w.shape
    if kh != kw or kh not in (1, 3):
        raise ValueError(f"the conv_i8 kernel takes 1x1 and 3x3 kernels, got {kh}x{kw}")
    b, ci, h, wd = x.shape
    wk = pack_weights(w, wide_patches(wd))
    y = torch.empty(b, co, h, wd, dtype=torch.float32, device=x.device)
    err = _kernel()(x.data_ptr(), wk.data_ptr(), y.data_ptr(), b, ci, h, wd, co, kh,
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv_i8 kernel launch failed: error {err}")
    global launches
    launches += 1
    return y
