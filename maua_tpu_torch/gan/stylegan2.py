"""StyleGAN2 generator in PyTorch, as plain functions over a parameter dict.

Port of `maua_tpu/gan/stylegan2.py` (SG2Config, mapping, synthesis_layer,
torgb_layer, synthesis, generator). Parameters are nested dicts of
tensors in PyTorch layouts (conv OIHW, fc (out, in), const (C, H, W));
`maua_tpu_torch.bridge` converts the JAX package's pytree into this form.

Every synthesis layer runs its conv in the layer's compute dtype and
hands the demodulation, the noise, the bias, lrelu * gain and the clamp
to one launch of the fused epilogue kernel (`kernels/epilogue.py`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..kernels.epilogue import modconv_epilogue
from ..utility import resolve_device
from . import ops


@dataclasses.dataclass(frozen=True)
class SG2Config:
    z_dim: int = 512
    c_dim: int = 0
    w_dim: int = 512
    img_resolution: int = 1024
    img_channels: int = 3
    channel_base: int = 32768
    channel_max: int = 512
    num_fp16_res: int = 4
    architecture: str = "skip"  # 'orig' | 'skip' | 'resnet'
    resample_filter: Tuple[int, ...] = (1, 3, 3, 1)
    conv_clamp: Optional[float] = 256.0
    mapping_layers: int = 8
    mapping_lr_multiplier: float = 0.01
    w_avg_beta: float = 0.998
    dtype: str = "float32"  # synthesis compute dtype ('bfloat16' for perf)

    @property
    def block_resolutions(self) -> Tuple[int, ...]:
        log2 = int(math.log2(self.img_resolution))
        return tuple(2**i for i in range(2, log2 + 1))

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    @property
    def num_ws(self) -> int:
        n = 0
        for res in self.block_resolutions:
            n += 1 if res == 4 else 2
        n += 1  # last block's torgb
        return n

    def block_num_conv(self, res: int) -> int:
        return 1 if res == 4 else 2

    def block_use_fp16(self, res: int) -> bool:
        log2 = int(math.log2(self.img_resolution))
        fp16_resolution = max(2 ** (log2 + 1 - self.num_fp16_res), 8)
        return res >= fp16_resolution

    def compute_dtype(self, res: int) -> torch.dtype:
        if self.dtype == "bfloat16" and self.block_use_fp16(res):
            return torch.bfloat16
        return torch.float32


# ------------------------------------------------------------------ init
def _randn(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.randn(*shape, generator=gen, device=gen.device, dtype=torch.float32)


def _init_fc(gen, in_f, out_f, lr_multiplier=1.0, bias_init=0.0):
    return {
        "w": _randn(gen, out_f, in_f) / lr_multiplier,
        "b": torch.full((out_f,), float(bias_init), device=gen.device),
    }


def _init_synthesis_layer(gen, ci, co, w_dim, res, kernel_size=3):
    return {
        "affine": _init_fc(gen, w_dim, ci, bias_init=1.0),
        "weight": _randn(gen, co, ci, kernel_size, kernel_size),
        "bias": torch.zeros(co, device=gen.device),
        "noise_const": _randn(gen, res, res),
        "noise_strength": torch.ones((), device=gen.device),
    }


def _init_torgb(gen, ci, co, w_dim):
    return {
        "affine": _init_fc(gen, w_dim, ci, bias_init=1.0),
        "weight": _randn(gen, co, ci, 1, 1),
        "bias": torch.zeros(co, device=gen.device),
    }


def init_params(cfg: SG2Config, gen: torch.Generator) -> Dict:
    """Random parameters with the JAX package's init distributions, drawn
    from `gen` on its device (the numbers differ from JAX's)."""
    feats = [cfg.z_dim + (cfg.w_dim if cfg.c_dim > 0 else 0)] + [cfg.w_dim] * cfg.mapping_layers
    mapping_p = {}
    for i in range(cfg.mapping_layers):
        mapping_p[f"fc{i}"] = _init_fc(gen, feats[i], feats[i + 1], lr_multiplier=cfg.mapping_lr_multiplier)
    if cfg.c_dim > 0:
        mapping_p["embed"] = _init_fc(gen, cfg.c_dim, cfg.w_dim)
    mapping_p["w_avg"] = torch.zeros(cfg.w_dim, device=gen.device)

    synthesis_p = {}
    for res in cfg.block_resolutions:
        co = cfg.channels(res)
        block = {}
        if res == 4:
            block["const"] = _randn(gen, co, res, res)
            block["conv1"] = _init_synthesis_layer(gen, co, co, cfg.w_dim, res)
        else:
            ci = cfg.channels(res // 2)
            block["conv0"] = _init_synthesis_layer(gen, ci, co, cfg.w_dim, res)
            block["conv1"] = _init_synthesis_layer(gen, co, co, cfg.w_dim, res)
            if cfg.architecture == "resnet":
                block["skip"] = {"weight": _randn(gen, co, ci, 1, 1)}
        if res == cfg.img_resolution or cfg.architecture == "skip":
            block["torgb"] = _init_torgb(gen, co, cfg.img_channels, cfg.w_dim)
        synthesis_p[f"b{res}"] = block
    return {"mapping": mapping_p, "synthesis": synthesis_p}


def fc_forward(p: Dict, x: torch.Tensor, activation: str = "linear", lr_multiplier: float = 1.0) -> torch.Tensor:
    """FullyConnectedLayer. p["w"] is (out, in). Like the JAX function (and
    the reference net it mirrors), a square non-linear layer contracts
    against the transposed weight."""
    out_f, in_f = p["w"].shape
    gain = lr_multiplier / math.sqrt(in_f)
    b = (p["b"] * lr_multiplier).to(x.dtype)
    if activation == "linear":
        return x @ (p["w"] * gain).to(x.dtype).t() + b
    w = p["w"].t() if in_f == out_f else p["w"]
    x = x @ (w * gain).to(x.dtype).t()
    return ops.bias_act(x, b, act=activation)


# -------------------------------------------------------------- mapping
def mapping(
    params: Dict,
    z: torch.Tensor,
    cfg: SG2Config,
    c: Optional[torch.Tensor] = None,
    truncation_psi: float = 1.0,
    truncation_cutoff: Optional[int] = None,
) -> torch.Tensor:
    """z (B, z_dim) -> ws (B, num_ws, w_dim) with truncation."""
    p = params["mapping"]
    x = None
    if cfg.z_dim > 0:
        x = ops.normalize_2nd_moment(z.float())
    if cfg.c_dim > 0:
        y = ops.normalize_2nd_moment(fc_forward(p["embed"], c.float()))
        x = torch.cat([x, y], dim=1) if x is not None else y
    for i in range(cfg.mapping_layers):
        x = fc_forward(p[f"fc{i}"], x, activation="lrelu", lr_multiplier=cfg.mapping_lr_multiplier)
    ws = x[:, None, :].repeat(1, cfg.num_ws, 1)
    w_avg = p["w_avg"]
    if truncation_cutoff is None:
        return w_avg + truncation_psi * (ws - w_avg)
    trunc = w_avg + truncation_psi * (ws[:, :truncation_cutoff] - w_avg)
    return torch.cat([trunc, ws[:, truncation_cutoff:]], dim=1)


# ------------------------------------------------------------- synthesis
def layer_noise_input(n: torch.Tensor) -> torch.Tensor:
    """A noise map as (B|1, 1, H, W): accepts (H, W), (B, H, W) or (B, 1, H, W)."""
    if n.dim() == 2:
        return n[None, None]
    if n.dim() == 3:
        return n[:, None]
    return n


def synthesis_layer(
    p: Dict,
    x: torch.Tensor,
    w: torch.Tensor,
    up: int,
    rfilter: np.ndarray,
    cfg: SG2Config,
    noise: Optional[torch.Tensor],
    gain: float = 1.0,
) -> torch.Tensor:
    """SynthesisLayer: modulated conv in x's dtype, then the fused epilogue
    (demod, per-pixel noise, bias, lrelu * sqrt(2) * gain, clamp)."""
    styles = fc_forward(p["affine"], w.float())
    if noise is not None:
        noise = layer_noise_input(noise) * p.get("noise_strength", 1.0)
    z = ops.modulated_conv(x, p["weight"], styles, up=up, padding=p["weight"].shape[-1] // 2,
                           resample_filter=rfilter if up > 1 else None)
    clamp = cfg.conv_clamp * gain if cfg.conv_clamp is not None else None
    return modconv_epilogue(z.contiguous(), ops.demodulation(p["weight"], styles), noise,
                            p["bias"], gain=math.sqrt(2.0) * gain, clamp=clamp)


def torgb_layer(p: Dict, x: torch.Tensor, w: torch.Tensor, cfg: SG2Config) -> torch.Tensor:
    ci = p["weight"].shape[1]
    k = p["weight"].shape[-1]
    styles = fc_forward(p["affine"], w.float()) * (1.0 / math.sqrt(ci * k * k))
    x = ops.modulated_conv2d(x, p["weight"], styles, demodulate=False)
    return ops.bias_act(x, p["bias"], clamp=cfg.conv_clamp)


def _layer_noise(layer_params, name, res, batch, noise_mode, noises, gen, device):
    if noise_mode == "none":
        return None
    if noises is not None and name in noises:
        return layer_noise_input(noises[name])
    if noise_mode == "random":
        return torch.randn(batch, 1, res, res, generator=gen, device=device)
    return layer_params["noise_const"][None, None]


def synthesis(
    params: Dict,
    ws: torch.Tensor,
    cfg: SG2Config,
    noise_mode: str = "const",
    noises: Optional[Dict] = None,
    gen: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """ws (B, num_ws, w_dim) -> image (B, C, H, W) in [-1, 1].

    `noises` maps "b{res}.conv{i}" to explicit noise maps; noise_mode
    "random" draws from `gen`."""
    syn = params["synthesis"]
    rfilter = ops.setup_filter(list(cfg.resample_filter))
    batch = ws.shape[0]
    x = img = None
    w_idx = 0
    for res in cfg.block_resolutions:
        block = syn[f"b{res}"]
        dtype = cfg.compute_dtype(res)
        num_conv = cfg.block_num_conv(res)
        block_ws = ws[:, w_idx : w_idx + num_conv + 1]

        def noise(name):
            return _layer_noise(block[name], f"b{res}.{name}", res, batch, noise_mode, noises, gen, ws.device)

        if res == 4:
            x = block["const"][None].to(dtype).repeat(batch, 1, 1, 1)
            x = synthesis_layer(block["conv1"], x, block_ws[:, 0], 1, rfilter, cfg, noise("conv1"))
        else:
            x = x.to(dtype)
            if cfg.architecture == "resnet":
                skip_w = block["skip"]["weight"]
                skip_gain = 1.0 / math.sqrt(skip_w.shape[1])
                y = ops.conv2d_resample(x, (skip_w * skip_gain).to(dtype), f=rfilter, up=2) * math.sqrt(0.5)
                x = synthesis_layer(block["conv0"], x, block_ws[:, 0], 2, rfilter, cfg, noise("conv0"))
                x = synthesis_layer(block["conv1"], x, block_ws[:, 1], 1, rfilter, cfg, noise("conv1"),
                                    gain=math.sqrt(0.5))
                x = y + x
            else:
                x = synthesis_layer(block["conv0"], x, block_ws[:, 0], 2, rfilter, cfg, noise("conv0"))
                x = synthesis_layer(block["conv1"], x, block_ws[:, 1], 1, rfilter, cfg, noise("conv1"))

        if img is not None:
            img = ops.upsample2d(img, rfilter)
        if res == cfg.img_resolution or cfg.architecture == "skip":
            y = torgb_layer(block["torgb"], x, block_ws[:, num_conv], cfg)
            img = img + y.to(img.dtype) if img is not None else y.float()
        w_idx += num_conv
    return img.float()


def generator(
    params: Dict,
    z: torch.Tensor,
    cfg: SG2Config,
    c: Optional[torch.Tensor] = None,
    truncation_psi: float = 1.0,
    truncation_cutoff: Optional[int] = None,
    noise_mode: str = "const",
    noises: Optional[Dict] = None,
    gen: Optional[torch.Generator] = None,
) -> torch.Tensor:
    ws = mapping(params, z, cfg, c, truncation_psi, truncation_cutoff)
    return synthesis(params, ws, cfg, noise_mode=noise_mode, noises=noises, gen=gen)


class Generator:
    """The object facade over the functions (maua_tpu's `Generator`): `cfg`, `params`,
    `num_ws`, `mapping`, `synthesis` and the whole forward. Without `params` it draws them
    from `gen` (seed 0 on `device`, cuda unless told otherwise); bridged maua_tpu params
    (`bridge.params_to_torch`) or a loaded checkpoint's are taken as they are."""

    def __init__(self, cfg: SG2Config, params: Optional[Dict] = None, gen: Optional[torch.Generator] = None,
                 device=None):
        self.cfg = cfg
        if params is None:
            gen = gen if gen is not None else torch.Generator(device=resolve_device(device)).manual_seed(0)
            params = init_params(cfg, gen)
        self.params = params

    @property
    def num_ws(self) -> int:
        return self.cfg.num_ws

    def mapping(self, z, c=None, truncation_psi: float = 1.0, truncation_cutoff: Optional[int] = None):
        return mapping(self.params, z, self.cfg, c, truncation_psi, truncation_cutoff)

    def synthesis(self, ws, **kw):
        """ws (B, num_ws, w_dim) -> image (B, C, H, W) in [-1, 1]."""
        return synthesis(self.params, ws, self.cfg, **kw)

    def __call__(self, z, c=None, truncation_psi: float = 1.0, truncation_cutoff: Optional[int] = None,
                 noise_mode: str = "const", gen: Optional[torch.Generator] = None):
        return generator(self.params, z, self.cfg, c, truncation_psi, truncation_cutoff, noise_mode, gen=gen)
