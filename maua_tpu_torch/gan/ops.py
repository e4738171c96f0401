"""StyleGAN primitive ops in PyTorch, NCHW activations and OIHW weights.

Port of `maua_tpu/gan/ops.py` (bias_act, setup_filter, upfirdn2d,
upsample2d/downsample2d, conv2d_resample, normalize_2nd_moment,
modulated_conv2d). The semantics, padding algebra included, are those of
the JAX functions; only the layout differs (channels on axis 1).

`modulated_conv2d` keeps the JAX package's reformulation: the style
scales the input, one conv shared by the batch runs, and the f32
demodulation scales the output, so no per-sample weights exist.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_SQRT2 = math.sqrt(2.0)


def activate(x: torch.Tensor, act: str, alpha: float = 0.2) -> torch.Tensor:
    if act == "linear":
        return x
    if act == "relu":
        return F.relu(x)
    if act == "lrelu":
        return torch.where(x >= 0, x, x * alpha)
    if act == "tanh":
        return torch.tanh(x)
    if act == "sigmoid":
        return torch.sigmoid(x)
    if act == "elu":
        return F.elu(x)
    if act == "selu":
        return F.selu(x)
    if act == "softplus":
        return F.softplus(x)
    if act == "swish":
        return torch.sigmoid(x) * x
    raise ValueError(f"unknown activation {act}")


def activation_gain(act: str) -> float:
    return _SQRT2 if act in ("relu", "lrelu", "swish") else 1.0


def bias_act(
    x: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    act: str = "linear",
    alpha: Optional[float] = None,
    gain: Optional[float] = None,
    clamp: Optional[float] = None,
) -> torch.Tensor:
    """Bias + activation + gain + clamp; the channel axis is axis 1."""
    alpha = 0.2 if alpha is None else alpha
    gain = activation_gain(act) if gain is None else gain
    if b is not None:
        x = x + b.to(x.dtype).reshape((1, -1) + (1,) * (x.dim() - 2))
    x = activate(x, act, alpha)
    if gain != 1:
        x = x * gain
    if clamp is not None and clamp >= 0:
        x = x.clamp(-clamp, clamp)
    return x


def setup_filter(
    f: Optional[Sequence[float]],
    normalize: bool = True,
    gain: float = 1.0,
    separable: Optional[bool] = None,
) -> np.ndarray:
    """FIR filter preparation: a 2-D numpy filter (outer product when the
    1-D tap count is < 8 and separable is not forced)."""
    if f is None:
        f = [1.0]
    f = np.asarray(f, dtype=np.float32)
    if f.ndim == 0:
        f = f[None]
    if separable is None:
        separable = f.ndim == 1 and f.size >= 8
    if f.ndim == 1 and not separable:
        f = np.outer(f, f)
    if normalize:
        f = f / f.sum()
    f = f * (gain ** (f.ndim / 2))
    return f


def _zero_insert(x: torch.Tensor, up_h: int, up_w: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, H*up_h, W*up_w) with each sample followed by zeros."""
    if up_h == 1 and up_w == 1:
        return x
    b, c, h, w = x.shape
    out = x.new_zeros(b, c, h, up_h, w, up_w)
    out[:, :, :, 0, :, 0] = x
    return out.reshape(b, c, h * up_h, w * up_w)


class _FIR(torch.autograd.Function):
    """The depthwise FIR y = conv2d(x, w, stride, groups=C) with a filter that takes no gradient. Its
    backward is _FIRTranspose and that one's is _FIR, so every order of differentiation (R1 and path
    length take two) runs depthwise convs forward; PyTorch's own double backward of a grouped conv
    loops over the groups, a conv each (seconds per layer at 512 channels)."""

    @staticmethod
    def forward(x, w, stride):
        return F.conv2d(x, w, stride=stride, groups=w.shape[0])

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, stride = inputs
        ctx.save_for_backward(w)
        ctx.stride, ctx.in_size = stride, x.shape[2:]

    @staticmethod
    def backward(ctx, gy):
        (w,) = ctx.saved_tensors
        (sh, sw), (kh, kw) = ctx.stride, w.shape[2:]
        pad = (ctx.in_size[0] - (gy.shape[2] - 1) * sh - kh, ctx.in_size[1] - (gy.shape[3] - 1) * sw - kw)
        return _fir_transpose(gy, w, ctx.stride, pad), None, None


class _FIRTranspose(torch.autograd.Function):
    """conv_transpose2d(g, w, stride, output_padding, groups=C), _FIR's backward; its backward is _FIR."""

    @staticmethod
    def forward(g, w, stride, output_padding):
        return F.conv_transpose2d(g, w, stride=stride, output_padding=output_padding, groups=w.shape[0])

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[1])
        ctx.stride = inputs[2]

    @staticmethod
    def backward(ctx, gx):
        (w,) = ctx.saved_tensors
        return _fir(gx, w, ctx.stride), None, None, None


def _fir(x: torch.Tensor, w: torch.Tensor, stride) -> torch.Tensor:
    stride = (stride, stride) if isinstance(stride, int) else tuple(stride)
    if torch.is_grad_enabled() and x.requires_grad:
        return _FIR.apply(x, w, stride)
    return F.conv2d(x, w, stride=stride, groups=w.shape[0])


def _fir_transpose(g, w, stride, output_padding):
    if torch.is_grad_enabled() and g.requires_grad:
        return _FIRTranspose.apply(g, w, stride, output_padding)
    return F.conv_transpose2d(g, w, stride=stride, output_padding=output_padding, groups=w.shape[0])


def upfirdn2d(
    x: torch.Tensor,
    f: Optional[np.ndarray],
    up: int = 1,
    down: int = 1,
    padding: Tuple[int, int, int, int] = (0, 0, 0, 0),
    gain: float = 1.0,
) -> torch.Tensor:
    """Zero-insert upsample, pad or crop, FIR correlation, stride downsample.

    x: NCHW; f: numpy filter from `setup_filter` (2-D, or 1-D separable);
    padding: (padx0, padx1, pady0, pady1) on the upsampled image, negative
    values crop."""
    if f is None:
        f = np.ones((1, 1), dtype=np.float32)
    padx0, padx1, pady0, pady1 = padding
    c = x.shape[1]
    if f.ndim == 1:
        f1 = torch.as_tensor((f * (gain ** 0.5)).astype(np.float32), dtype=x.dtype, device=x.device)
        y = F.pad(_zero_insert(x, up, 1), [0, 0, pady0, pady1])
        y = _fir(y, f1.view(1, 1, -1, 1).repeat(c, 1, 1, 1), (down, 1))
        y = F.pad(_zero_insert(y, 1, up), [padx0, padx1, 0, 0])
        return _fir(y, f1.view(1, 1, 1, -1).repeat(c, 1, 1, 1), (1, down))
    fg = torch.as_tensor((f * (gain ** (f.ndim / 2))).astype(np.float32), dtype=x.dtype, device=x.device)
    y = F.pad(_zero_insert(x, up, up), [padx0, padx1, pady0, pady1])
    return _fir(y, fg[None, None].repeat(c, 1, 1, 1), down)


def _filter_size(f: Optional[np.ndarray]) -> Tuple[int, int]:
    if f is None:
        return 1, 1
    return f.shape[-1], f.shape[0]


def upsample2d(x: torch.Tensor, f: np.ndarray, up: int = 2, padding: int = 0, gain: float = 1.0) -> torch.Tensor:
    fw, fh = _filter_size(f)
    p = (
        padding + (fw + up - 1) // 2,
        padding + (fw - up) // 2,
        padding + (fh + up - 1) // 2,
        padding + (fh - up) // 2,
    )
    return upfirdn2d(x, f, up=up, padding=p, gain=gain * up * up)


def downsample2d(x: torch.Tensor, f: np.ndarray, down: int = 2, padding: int = 0, gain: float = 1.0) -> torch.Tensor:
    fw, fh = _filter_size(f)
    p = (
        padding + (fw - down + 1) // 2,
        padding + (fw - down) // 2,
        padding + (fh - down + 1) // 2,
        padding + (fh - down) // 2,
    )
    return upfirdn2d(x, f, down=down, padding=p)


def normalize_2nd_moment(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + eps)


def conv2d_resample(
    x: torch.Tensor,
    w: torch.Tensor,
    f: Optional[np.ndarray] = None,
    up: int = 1,
    down: int = 1,
    padding: int = 0,
) -> torch.Tensor:
    """2-D conv with optional FIR up/downsampling. x: NCHW, w: OIHW.

    up > 1 is a transposed conv followed by the FIR, with the JAX
    function's padding algebra."""
    kh, kw = w.shape[2], w.shape[3]
    fw, fh = _filter_size(f)
    px0 = px1 = py0 = py1 = padding
    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2

    if up > 1:
        px0 -= kw - 1
        px1 -= kw - up
        py0 -= kh - 1
        py1 -= kh - up
        pxt = max(min(-px0, -px1), 0)
        pyt = max(min(-py0, -py1), 0)
        y = F.conv_transpose2d(x, w.transpose(0, 1), stride=up, padding=(pyt, pxt))
        y = upfirdn2d(y, f, padding=(px0 + pxt, px1 + pxt, py0 + pyt, py1 + pyt), gain=up**2)
        if down > 1:
            y = upfirdn2d(y, f, down=down)
        return y

    if down > 1:
        y = upfirdn2d(x, f, padding=(px0, px1, py0, py1))
        return F.conv2d(y, w, stride=down)

    if px0 == px1 and py0 == py1:
        return F.conv2d(x, w, padding=(py0, px0))
    return F.conv2d(F.pad(x, [px0, px1, py0, py1]), w)


def demodulation(weight: torch.Tensor, styles: torch.Tensor) -> torch.Tensor:
    """f32 demodulation scale (B, Co) = rsqrt(styles^2 @ sum_hw W^2 + 1e-8)."""
    w2 = weight.float().square().sum(dim=(2, 3))  # (Co, Ci)
    return torch.rsqrt(styles.float().square() @ w2.t() + 1e-8)


def modulated_conv(
    x: torch.Tensor,
    weight: torch.Tensor,
    styles: torch.Tensor,
    up: int = 1,
    down: int = 1,
    padding: int = 0,
    resample_filter: Optional[np.ndarray] = None,
) -> torch.Tensor:
    """The conv of `modulated_conv2d` before demodulation and noise:
    input times style, then one conv with the shared weight."""
    x = x * styles.to(x.dtype)[:, :, None, None]
    w = weight.to(x.dtype)
    if w.shape[2:] == (1, 1) and up == 1 and down == 1 and padding == 0:
        return torch.einsum("bihw,oi->bohw", x, w[:, :, 0, 0])
    return conv2d_resample(x, w, f=resample_filter, up=up, down=down, padding=padding)


def modulated_conv2d(
    x: torch.Tensor,  # (B, Ci, H, W)
    weight: torch.Tensor,  # (Co, Ci, kh, kw)
    styles: torch.Tensor,  # (B, Ci)
    noise: Optional[torch.Tensor] = None,
    up: int = 1,
    down: int = 1,
    padding: int = 0,
    resample_filter: Optional[np.ndarray] = None,
    demodulate: bool = True,
) -> torch.Tensor:
    """Style-modulated conv: input-scale -> shared conv -> f32 demod (-> + noise)."""
    y = modulated_conv(x, weight, styles, up, down, padding, resample_filter)
    if demodulate:
        y = y * demodulation(weight, styles).to(y.dtype)[:, :, None, None]
    if noise is not None:
        y = y + noise.to(y.dtype)
    return y
