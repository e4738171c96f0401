"""Video ViT features and gram-matched video style transfer.

Port of `maua_tpu/style/video_vit.py`: a spatio-temporal patch ViT
(tubelet embedding, joint space-time attention over every token of the
clip) whose block features drive gram-matrix style optimisation of a
whole clip, so the style statistics match across space and time. The
attention is a plain softmax product in f32 (maua_tpu computes it in XLA,
not in a Pallas kernel); gelu is the tanh approximation (jax.nn.gelu's
default). Videos are (T, H, W, 3) in [-1, 1]; linear weights (out, in).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..diffusion.models.unet import _linear, _norm_init, layer_norm, linear
from ..loss import gram_matrix, scaled_mse_loss, tv_loss
from ..optimizers import Adam
from ..parameterizations import clip
from ..utility import resolve_device, to_device


@dataclasses.dataclass(frozen=True)
class VideoViTConfig:
    image_size: int = 64
    patch_size: int = 8
    tubelet: int = 2  # frames per temporal patch
    width: int = 128
    layers: int = 4
    heads: int = 4


def init_params(gen: torch.Generator, cfg: VideoViTConfig) -> Dict:
    """Random parameters with maua_tpu's distributions, drawn from `gen` on its device."""
    w = cfg.width
    patch_dim = cfg.tubelet * cfg.patch_size * cfg.patch_size * 3
    n_space = (cfg.image_size // cfg.patch_size) ** 2
    p = {
        "patch_proj": _linear(gen, patch_dim, w),
        "pos_space": torch.randn(n_space, w, generator=gen, device=gen.device) * 0.02,
        "pos_time": torch.randn(64, w, generator=gen, device=gen.device) * 0.02,
        "blocks": [],
    }
    for _ in range(cfg.layers):
        p["blocks"].append({"ln1": _norm_init(w, gen.device), "qkv": _linear(gen, w, 3 * w),
                            "proj": _linear(gen, w, w), "ln2": _norm_init(w, gen.device),
                            "fc1": _linear(gen, w, 4 * w), "fc2": _linear(gen, 4 * w, w)})
    return p


def _tubelets(video: torch.Tensor, cfg: VideoViTConfig) -> torch.Tensor:
    """(T, H, W, 3) -> (n_time, n_space, patch_dim), each tubelet flattened (tt, ps, ps, c)."""
    t, h, w, c = video.shape
    tt, ps = cfg.tubelet, cfg.patch_size
    nt, gh, gw = t // tt, h // ps, w // ps
    v = video[: nt * tt].reshape(nt, tt, gh, ps, gw, ps, c).permute(0, 2, 4, 1, 3, 5, 6)
    return v.reshape(nt, gh * gw, tt * ps * ps * c)


def features(params: Dict, video: torch.Tensor, cfg: VideoViTConfig) -> List[torch.Tensor]:
    """Per-block token features (n_time, n_space, width), joint space-time attention."""
    tok = linear(params["patch_proj"], _tubelets(video, cfg))
    nt, ns, w = tok.shape
    tok = tok + params["pos_space"][None, :ns] + params["pos_time"][:nt, None]
    x = tok.reshape(1, nt * ns, w)
    hd = w // cfg.heads
    feats = []
    for blk in params["blocks"]:
        q, k, v = linear(blk["qkv"], layer_norm(blk["ln1"], x)).split(w, dim=-1)
        q, k, v = (a.reshape(1, -1, cfg.heads, hd).transpose(1, 2) for a in (q, k, v))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
        att = torch.matmul(torch.softmax(logits, -1).to(x.dtype), v)
        x = x + linear(blk["proj"], att.transpose(1, 2).reshape(1, -1, w))
        x = x + linear(blk["fc2"], F.gelu(linear(blk["fc1"], layer_norm(blk["ln2"], x)), approximate="tanh"))
        feats.append(x.reshape(nt, ns, w))
    return feats


def _gram(f: torch.Tensor) -> torch.Tensor:
    """The gram over every space-time token: the (n_time, n_space, width) features as a
    (1, 1, N, width) NHWC map."""
    return gram_matrix(f.reshape(1, 1, -1, f.shape[-1]))


def video_style_transfer(
    content_video,  # (T, H, W, 3) in [-1, 1]
    style_video,  # (T', H, W, 3)
    cfg: Optional[VideoViTConfig] = None,
    n_iters: int = 100,
    lr: float = 0.05,
    content_weight: float = 1.0,
    style_weight: float = 20.0,
    tv_weight: float = 5.0,
    gen: Optional[torch.Generator] = None,
    verbose: bool = True,
    params: Optional[Dict] = None,
    device=None,
    stats: Optional[Dict] = None,
) -> np.ndarray:
    """Gram-matched video style transfer through the video ViT: the whole clip is the optimisation
    variable (optax's Adam), the grams pool over space-time tokens. The ViT's weights are `params`
    or drawn from `gen` (seed 0 on `device`, cuda unless told otherwise). Returns the clip clipped
    to [-1, 1] as numpy. `stats`, when given, receives the loop's seconds."""
    device = resolve_device(device)
    content_video = torch.as_tensor(np.asarray(content_video, np.float32), device=device)
    style_video = torch.as_tensor(np.asarray(style_video, np.float32), device=device)
    cfg = cfg or VideoViTConfig(image_size=content_video.shape[1])
    if params is None:
        gen = gen if gen is not None else torch.Generator(device=device).manual_seed(0)
        params = init_params(gen, cfg)
    params = to_device(params, device)

    with torch.no_grad():
        content_feats = features(params, content_video, cfg)
        style_grams = [_gram(f) for f in features(params, style_video, cfg)]
        content_target = content_feats[len(content_feats) // 2]

    def loss_fn(video):
        v = clip(video, -1.0, 1.0)  # jnp.clip: the gradient halved at +-1, which the content holds exactly
        feats = features(params, v, cfg)
        loss = tv_weight * tv_loss(v)
        loss = loss + content_weight * (feats[len(feats) // 2] - content_target).square().mean()
        for f, g in zip(feats, style_grams):
            loss = loss + style_weight * scaled_mse_loss(_gram(f), g)
        return loss

    video = content_video.clone().requires_grad_(True)
    opt = Adam([video], lr)
    t0 = time.perf_counter()
    for i in range(n_iters):
        opt.zero_grad()
        v = loss_fn(video)
        v.backward()
        opt.step()
        if verbose and i % max(n_iters // 5, 1) == 0:
            print(f"video style iter {i}/{n_iters} loss {float(v):.4f}")
    if stats is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stats["loop_seconds"] = time.perf_counter() - t0
    return clip(video.detach(), -1.0, 1.0).cpu().numpy()
