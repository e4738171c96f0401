"""StyleGAN2 / ADA discriminator in PyTorch, as plain functions over a parameter dict.

Port of `maua_tpu/gan/discriminator.py` (D2Config, init_params,
minibatch_stddev, discriminator): resnet blocks, minibatch standard
deviation and the epilogue FCs, over NCHW activations. Parameters keep
the JAX package's names in PyTorch layouts: conv weights OIHW, fc weights
(out, in). The b4 FC reads the (C, H, W) flatten of its input, as an ADA
checkpoint stores it; `maua_tpu_torch.bridge.d_params_to_torch` permutes
the JAX package's (H, W, C) order into it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from . import ops


@dataclasses.dataclass(frozen=True)
class D2Config:
    img_resolution: int = 256
    img_channels: int = 3
    channel_base: int = 32768
    channel_max: int = 512
    mbstd_group_size: int = 4
    mbstd_num_channels: int = 1
    resample_filter: Tuple[int, ...] = (1, 3, 3, 1)
    dtype: str = "float32"

    @property
    def block_resolutions(self) -> Tuple[int, ...]:
        log2 = int(math.log2(self.img_resolution))
        return tuple(2**i for i in range(log2, 2, -1))  # img_res ... 8

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)


def init_params(cfg: D2Config, gen: torch.Generator) -> Dict:
    """Random parameters with the JAX package's init distributions (unit normal
    weights, zero biases), drawn from `gen` on its device."""

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=gen.device)

    def zeros(n):
        return torch.zeros(n, device=gen.device)

    c_in = cfg.channels(cfg.img_resolution)
    params = {"fromrgb": {"weight": randn(c_in, cfg.img_channels, 1, 1), "bias": zeros(c_in)}}
    for res in cfg.block_resolutions:
        ci, co = cfg.channels(res), cfg.channels(res // 2)
        params[f"b{res}"] = {
            "conv0": {"weight": randn(ci, ci, 3, 3), "bias": zeros(ci)},
            "conv1": {"weight": randn(co, ci, 3, 3), "bias": zeros(co)},
            "skip": {"weight": randn(co, ci, 1, 1)},
        }
    c4 = cfg.channels(4)
    params["b4"] = {
        "conv": {"weight": randn(c4, c4 + cfg.mbstd_num_channels, 3, 3), "bias": zeros(c4)},
        "fc": {"w": randn(c4, c4 * 16), "b": zeros(c4)},
        "out": {"w": randn(1, c4), "b": zeros(1)},
    }
    return params


def _conv(x, w, bias=None, act="lrelu", down=1, rfilter=None, gain=1.0):
    """Equalized-lr conv in x's dtype, then bias, activation and gain."""
    wg = 1.0 / math.sqrt(math.prod(w.shape[1:]))
    y = ops.conv2d_resample(x, (w * wg).to(x.dtype), f=rfilter, down=down, padding=w.shape[-1] // 2)
    return ops.bias_act(y, None if bias is None else bias.to(x.dtype), act=act,
                        gain=ops.activation_gain(act) * gain if act != "linear" else gain)


def minibatch_stddev(x: torch.Tensor, group_size: int, num_channels: int) -> torch.Tensor:
    """Append per-group feature stddev channels (ADA epilogue). The group
    shrinks until it divides the batch; sample i reads group statistic i mod
    (batch / group)."""
    n, c, h, w = x.shape
    g = min(group_size, n)
    while n % g != 0:
        g -= 1
    f = num_channels
    y = x.reshape(g, n // g, f, c // f, h, w).float()
    y = y - y.mean(dim=0, keepdim=True)
    y = torch.sqrt(y.square().mean(dim=0) + 1e-8)
    y = y.mean(dim=(2, 3, 4))  # (n // g, f)
    y = y.repeat(g, 1)[:, :, None, None].expand(n, f, h, w)
    return torch.cat([x, y.to(x.dtype)], dim=1)


def discriminator(params: Dict, img: torch.Tensor, cfg: D2Config) -> torch.Tensor:
    """img (B, C, H, W) in [-1, 1] -> logits (B, 1)."""
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    rfilter = ops.setup_filter(list(cfg.resample_filter))
    x = _conv(img.to(dtype), params["fromrgb"]["weight"], params["fromrgb"]["bias"], act="lrelu")
    for res in cfg.block_resolutions:
        b = params[f"b{res}"]
        y = _conv(x, b["skip"]["weight"], act="linear", down=2, rfilter=rfilter, gain=math.sqrt(0.5))
        x = _conv(x, b["conv0"]["weight"], b["conv0"]["bias"], act="lrelu")
        x = _conv(x, b["conv1"]["weight"], b["conv1"]["bias"], act="lrelu", down=2, rfilter=rfilter,
                  gain=math.sqrt(0.5))
        x = x + y
    x = minibatch_stddev(x.float(), cfg.mbstd_group_size, cfg.mbstd_num_channels)
    b4 = params["b4"]
    x = _conv(x, b4["conv"]["weight"], b4["conv"]["bias"], act="lrelu")
    x = x.flatten(1)
    x = ops.bias_act(x @ (b4["fc"]["w"] * (1.0 / math.sqrt(b4["fc"]["w"].shape[1]))).t(), b4["fc"]["b"], act="lrelu")
    return x @ (b4["out"]["w"] * (1.0 / math.sqrt(b4["out"]["w"].shape[1]))).t() + b4["out"]["b"]
