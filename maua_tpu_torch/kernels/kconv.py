"""3x3 convolution with a fused modulated-conv epilogue: a hand-written
CUDA kernel and its plain twin.

Port of the Pallas TPU kernel `maua_tpu/kernels/kconv.py` (`kconv3x3` ->
`_kconv`), in its layout: NHWC input, HWIO weights, SAME padding, stride
1. For x (B, H, W, Ci) and w (3, 3, Ci, Co):

    y = conv(x * style[b, ci], w) * demod[b, co] + bias[co]
    y = lrelu(y, alpha) * gain                 (only when alpha is given)

with each of style, demod and bias optional, f32 or bf16 storage and f32
accumulation, the output in x's dtype. The input style product is rounded
to x's dtype and the weights are cast to it, as the TPU kernel does.

The CUDA source is `maua_tpu_torch/csrc/kconv.cu`: an implicit GEMM, in
f32 on the CUDA cores (exact f32 products) and in bf16 on the tensor
cores, each reading its weights in the tile layout that `pack_weights`
makes for it (one small copy per call).
`kconv3x3` launches it for CUDA tensors and raises on what it does not
take; CPU tensors take the plain PyTorch version, `kconv3x3_plain` (an f32 `F.conv2d` of the
styled input, then the epilogue), which is also what the kernel is held
against on the card. The TPU's tiling knobs (`band_r`, `interpret`,
`MAUA_KCONV_R`) have no counterpart. No module of the port calls it: it
is the counterpart of a TPU kernel that nothing in maua_tpu calls either.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import refuse_autograd

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

        fn = load("kconv").maua_kconv3x3
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                                                                   ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


TILE_CI = 16  # the bf16 kernel's input channels per step, for each of the nine taps
F32_TILE_CI = 8  # the f32 kernel's


def tile_co(co: int) -> int:
    """Either kernel's output channels per block: 32 where Co <= 32, else 64."""
    return 32 if co <= 32 else 64


def pack_weights(w: torch.Tensor, dtype: torch.dtype, tile_ci: int = TILE_CI) -> torch.Tensor:
    """HWIO (3, 3, Ci, Co) -> (ceil(Co / T), ceil(Ci / K), 9, K, T) in `dtype`, zero-padded, K = tile_ci,
    T = tile_co(Co): tile [n, c, tap, i, j] is w[tap // 3, tap % 3, K c + i, T n + j], a kernel's weight
    slice for output tile n and input chunk c, whole and contiguous. K is TILE_CI for the bf16 kernel,
    F32_TILE_CI for the f32 one."""
    _, _, ci, co = w.shape
    t = tile_co(co)
    nci, nco = -(-ci // tile_ci), -(-co // t)
    wp = torch.zeros(9, nci * tile_ci, nco * t, dtype=dtype, device=w.device)
    wp[:, :ci, :co] = w.reshape(9, ci, co).to(dtype)
    return wp.view(9, nci, tile_ci, nco, t).permute(3, 1, 0, 2, 4).contiguous()


def kconv3x3_plain(x, w, bias=None, style=None, demod=None, alpha=None, gain=1.0):
    """The same function in plain PyTorch ops, in f32, cast back to x's dtype."""
    if style is not None:
        x = x * style.to(x.dtype)[:, None, None, :]
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), w.to(x.dtype).float().permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1)
    if demod is not None:
        y = y * demod.float()[:, None, None, :]
    if bias is not None:
        y = y + bias.float()
    if alpha is not None:
        y = torch.where(y >= 0, y, y * alpha) * gain
    return y.to(x.dtype)


def _check(x, w, bias, style, demod):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, Ci), got {tuple(x.shape)}")
    b, _, _, ci = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, ci):
        raise ValueError(f"w must be (3, 3, {ci}, Co), got {tuple(w.shape)}")
    co = w.shape[3]
    for name, t, shape in (("bias", bias, (co,)), ("style", style, (b, ci)), ("demod", demod, (b, co))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")


def kconv3x3(
    x: torch.Tensor,  # (B, H, W, Ci)
    w: torch.Tensor,  # (3, 3, Ci, Co) HWIO
    bias: Optional[torch.Tensor] = None,  # (Co,)
    style: Optional[torch.Tensor] = None,  # (B, Ci) input scale (modulation)
    demod: Optional[torch.Tensor] = None,  # (B, Co) output scale (demodulation)
    alpha: Optional[float] = None,  # leaky-relu slope (None = linear)
    gain: float = 1.0,
) -> torch.Tensor:
    """SAME-padded stride-1 3x3 conv with the optional fused epilogue,
    (B, H, W, Co) in x's dtype."""
    _check(x, w, bias, style, demod)
    if x.device.type == "cpu":
        return kconv3x3_plain(x, w, bias, style, demod, alpha, gain)
    if x.device.type != "cuda":
        raise ValueError(f"kconv3x3 runs on cuda or cpu tensors, got {x.device}")
    refuse_autograd("kconv3x3", x, w, bias, style, demod)
    if x.dtype not in _DTYPES:
        raise TypeError(f"kconv3x3 takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC")
    if any(t is not None and t.device != x.device for t in (w, bias, style, demod)):
        raise ValueError("all tensors must be on the device of x")
    b, h, wd, ci = x.shape
    co = w.shape[3]
    # the weights in x's dtype, in the kernel's tiles; the per-channel vectors in f32, the style rounded to
    # x's dtype first
    wk = pack_weights(w, x.dtype, TILE_CI if x.dtype == torch.bfloat16 else F32_TILE_CI)
    bias32 = None if bias is None else bias.float().contiguous()
    style32 = None if style is None else style.to(x.dtype).float().contiguous()
    demod32 = None if demod is None else demod.float().contiguous()
    y = torch.empty(b, h, wd, co, dtype=x.dtype, device=x.device)
    ptr = [0 if t is None else t.data_ptr() for t in (bias32, style32, demod32)]
    err = _kernel()(x.data_ptr(), wk.data_ptr(), *ptr, y.data_ptr(), _DTYPES[x.dtype], b, h, wd, ci, co,
                    0.0 if alpha is None else float(alpha), float(gain), int(alpha is not None),
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kconv3x3 kernel launch failed: error {err}")
    global launches
    launches += 1
    return y
