"""StyleGAN3's filtered leaky ReLU: a hand-written CUDA kernel and its plain twin.

Port of the Pallas TPU kernel `maua_tpu/kernels/filtered_lrelu.py`
(`filtered_lrelu_pallas` -> `_flrelu_bchw`), in NCHW, with the semantics
of `maua_tpu/gan/stylegan3.py` `_filtered_lrelu_direct` and the affines
of `_filtered_lrelu`. For x (B, C, H, W):

    x' = x * pre_scale[b, c] + pre_add[b, c]
    t  = upfirdn2d(x', up_f, up, 'same' odd-centred padding, gain up^2)
    t  = lrelu(t, 0.2) * sqrt(2)
    y  = upfirdn2d(t, down_f, down, 'same' padding) * post_scale[b, c]

giving (B, C, H*up/down, W*up/down), or the window `crop` = (top, left,
height, width) of it. StyleGAN3's synthesis passes the preceding conv's
demodulation as pre_scale, its bias as pre_add and the next conv's style
as post_scale, and the centre of the next layer's canvas as the crop.

The CUDA source is `maua_tpu_torch/csrc/filtered_lrelu.cu`: one pass
that reads x once and writes the kept window of y once, the oversampled
grid held only in registers and shared memory, for up in {2, 4}, down 2,
6*up up-taps and 12 down-taps (a crop at up 4 starts on even rows and
columns).
`filtered_lrelu` launches it for CUDA tensors and raises on what it does
not take; CPU tensors take the plain PyTorch version,
`filtered_lrelu_plain`, which is also what the kernel is held against on
the card.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..gan import ops
from . import refuse_autograd

_SQRT2 = math.sqrt(2.0)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DOWN_TAPS = 12

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

        fn = load("filtered_lrelu").maua_filtered_lrelu
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _plane_scale(v: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if v is None else v.float()[:, :, None, None]


def filtered_lrelu_plain(x, up_f, down_f, up: int, down: int, pre_scale=None, pre_add=None, post_scale=None,
                         crop=None):
    """The same function in plain PyTorch ops, in f32, cast back to x's dtype
    (the `crop` window of it, contiguous)."""
    y = x.float()
    if pre_scale is not None:
        y = y * _plane_scale(pre_scale)
    if pre_add is not None:
        y = y + _plane_scale(pre_add)
    if up > 1:
        ut = len(up_f)
        pt = (ut - 1) // 2
        y = ops.upfirdn2d(y, np.asarray(up_f, np.float32), up=up, padding=(pt, ut - 1 - pt, pt, ut - 1 - pt),
                          gain=up * up)
    y = F.leaky_relu(y, 0.2).mul_(_SQRT2)
    if down > 1:
        dt = len(down_f)
        pt = (dt - 1) // 2
        y = ops.upfirdn2d(y, np.asarray(down_f, np.float32), down=down, padding=(pt, dt - 1 - pt, pt, dt - 1 - pt))
    if post_scale is not None:
        y = y * _plane_scale(post_scale)
    if crop is not None:
        top, left, h, w = crop
        y = y[:, :, top : top + h, left : left + w]
    return y.to(x.dtype).contiguous()


def _check(x, up_f, down_f, up, down, planes, crop):
    if up not in (2, 4) or down != 2:
        raise ValueError(f"filtered_lrelu takes up in (2, 4) and down 2, got up {up}, down {down}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got {tuple(x.shape)}")
    if np.shape(up_f) != (6 * up,) or np.shape(down_f) != (DOWN_TAPS,):
        raise ValueError(f"filtered_lrelu takes {6 * up} up-taps and {DOWN_TAPS} down-taps, "
                         f"got {np.shape(up_f)} and {np.shape(down_f)}")
    b, c = x.shape[:2]
    for name, v in planes.items():
        if v is not None and tuple(v.shape) != (b, c):
            raise ValueError(f"{name} must be {(b, c)}, got {tuple(v.shape)}")
    if crop is not None:
        top, left, h, w = crop
        ho, wo = x.shape[2] * up // down, x.shape[3] * up // down
        if min(top, left) < 0 or min(h, w) < 1 or top + h > ho or left + w > wo:
            raise ValueError(f"crop {tuple(crop)} is not a window of the {(ho, wo)} output")


def filtered_lrelu(
    x: torch.Tensor,  # (B, C, H, W), f32 or bf16
    up_f: np.ndarray,  # (6 * up,) kaiser lowpass at the tmp rate
    down_f: np.ndarray,  # (12,)
    up: int,
    down: int,
    pre_scale: Optional[torch.Tensor] = None,  # (B, C) the conv's demodulation
    pre_add: Optional[torch.Tensor] = None,  # (B, C) the conv's bias
    post_scale: Optional[torch.Tensor] = None,  # (B, C) the next conv's style
    crop: Optional[Tuple[int, int, int, int]] = None,  # (top, left, height, width) of the output to keep
) -> torch.Tensor:
    """pre affine -> up-FIR -> lrelu * sqrt(2) -> FIR-down -> post scale [-> crop]."""
    planes = {"pre_scale": pre_scale, "pre_add": pre_add, "post_scale": post_scale}
    _check(x, up_f, down_f, up, down, planes, crop)
    if x.device.type == "cpu":
        return filtered_lrelu_plain(x, up_f, down_f, up, down, pre_scale, pre_add, post_scale, crop)
    if x.device.type != "cuda":
        raise ValueError(f"filtered_lrelu runs on cuda or cpu tensors, got {x.device}")
    refuse_autograd("filtered_lrelu", x, pre_scale, pre_add, post_scale)
    if x.dtype not in _DTYPES:
        raise TypeError(f"filtered_lrelu takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NCHW")
    if any(v is not None and v.device != x.device for v in planes.values()):
        raise ValueError("pre_scale, pre_add and post_scale must be on the device of x")
    # the per-plane scalars are small next to x: f32, contiguous, one per (b, c)
    ps, pa, po = (None if v is None else v.float().contiguous() for v in planes.values())
    b, c, h, w = x.shape
    top, left, ho, wo = crop if crop is not None else (0, 0, h * up // down, w * up // down)
    if up == 4 and (top % 2 or left % 2):
        raise ValueError(f"the kernel's crop at up 4 starts on even rows and columns, got {tuple(crop)}")
    y = torch.empty((b, c, ho, wo), dtype=x.dtype, device=x.device)
    uf = np.ascontiguousarray(up_f, np.float32)
    df = np.ascontiguousarray(down_f, np.float32)
    err = _kernel()(
        x.data_ptr(), y.data_ptr(), _DTYPES[x.dtype], up,
        uf.ctypes.data, uf.size, df.ctypes.data, df.size,
        0 if ps is None else ps.data_ptr(), 0 if pa is None else pa.data_ptr(),
        0 if po is None else po.data_ptr(),
        b * c, h, w, top, left, ho, wo, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"filtered_lrelu kernel launch failed: cudaError {err}")
    global launches
    launches += 1
    return y
