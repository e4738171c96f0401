"""The experimental GAN families of the training registry, in PyTorch.

Port of `maua_tpu/gan/models_experimental.py`: DCGAN G and D, the
StyleHyperMixer-style generator, the involution G and D and the p4m
(dihedral D4) group-equivariant steerable G and D, as plain functions
over parameter dicts, NCHW. Conv kernels are OIHW, linear weights
(out, in), the steerable's group kernels (8, Co, Ci, K, K);
`maua_tpu_torch.bridge.experimental_params_to_torch` converts the JAX
package's trees. The `init_*` functions draw from a torch.Generator with
maua_tpu's distributions. GELU is the tanh approximation (jax.nn.gelu's
default) and resizes are jax.image.resize's (`ops/warp.resize`).

The emerging convolutions (`masked_emerging_weight`, `emerging_conv`,
`emerging_conv_inverse`) serve no family; their inverse needs the native
extension, and they wait for its port.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from ..ops.warp import resize


def _randn(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.randn(*shape, generator=gen, device=gen.device)


def _zeros(gen: torch.Generator, n: int) -> torch.Tensor:
    return torch.zeros(n, device=gen.device)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _up2(x: torch.Tensor, method: str) -> torch.Tensor:
    if method == "nearest":
        return F.interpolate(x, scale_factor=2, mode="nearest")
    return resize(x, (x.shape[2] * 2, x.shape[3] * 2), method)


# ------------------------------------------------------------- DCGAN
def _convt_init(gen, k, ci, co):
    return {"w": _randn(gen, co, ci, k, k) * 0.02, "b": _zeros(gen, co)}


def init_dcgan_g(gen: torch.Generator, z_dim: int = 100, base: int = 64, resolution: int = 64) -> Dict:
    n_up = int(math.log2(resolution // 4))
    chans = [base * 2**i for i in range(n_up, -1, -1)]
    p = {"proj": _convt_init(gen, 4, z_dim, chans[0]), "ups": []}
    for i in range(n_up):
        p["ups"].append(_convt_init(gen, 4, chans[i], chans[i + 1] if i < n_up - 1 else base))
    p["out"] = _convt_init(gen, 3, base, 3)
    return p


def dcgan_g(params: Dict, z: torch.Tensor) -> torch.Tensor:
    """z (B, z_dim) -> (B, 3, R, R) in [-1, 1]."""
    x = F.relu(F.conv2d(z[:, :, None, None], params["proj"]["w"], params["proj"]["b"], padding=3))
    for p in params["ups"]:
        x = F.relu(F.conv2d(F.pad(_up2(x, "nearest"), [1, 2, 1, 2]), p["w"], p["b"]))
    return torch.tanh(F.conv2d(x, params["out"]["w"], params["out"]["b"], padding=1))


def init_dcgan_d(gen: torch.Generator, base: int = 64, resolution: int = 64) -> Dict:
    n_down = int(math.log2(resolution // 4))
    p = {"inp": _convt_init(gen, 4, 3, base), "downs": []}
    ch = base
    for _ in range(n_down - 1):
        p["downs"].append(_convt_init(gen, 4, ch, ch * 2))
        ch *= 2
    p["out"] = _convt_init(gen, 4, ch, 1)
    return p


def dcgan_d(params: Dict, img: torch.Tensor) -> torch.Tensor:
    """img (B, 3, R, R) -> logits (B, 1)."""
    x = F.leaky_relu(F.conv2d(img, params["inp"]["w"], params["inp"]["b"], stride=2, padding=1), 0.2)
    for p in params["downs"]:
        x = F.leaky_relu(F.conv2d(x, p["w"], p["b"], stride=2, padding=1), 0.2)
    return F.conv2d(x, params["out"]["w"], params["out"]["b"], padding=1).mean(dim=(2, 3))


# -------------------------------------------------- StyleHyperMixer
def init_hypermixer_g(gen: torch.Generator, z_dim: int = 64, dim: int = 128, grid: int = 8, depth: int = 4,
                      resolution: int = 32) -> Dict:
    """Token-mixing MLPs over a latent feature grid whose mixing weights a hypernetwork makes from the
    style vector, then upsampling convs to pixels."""
    n_tok = grid * grid
    p = {
        "seed": _randn(gen, n_tok, dim) * 0.1,
        "style": {"w": _randn(gen, dim, z_dim) / math.sqrt(z_dim), "b": _zeros(gen, dim)},
        "blocks": [],
    }
    for _ in range(depth):
        p["blocks"].append({
            "hyper": {"w": _randn(gen, n_tok * 8, dim) / math.sqrt(dim), "b": _zeros(gen, n_tok * 8)},
            "mix_proj": {"w": _randn(gen, n_tok, 8) / math.sqrt(8.0)},
            "channel": {"w": _randn(gen, dim, dim) / math.sqrt(dim), "b": _zeros(gen, dim)},
        })
    n_up = int(math.log2(resolution // grid))
    p["ups"] = [_convt_init(gen, 3, dim if i == 0 else 64, 64) for i in range(n_up)]
    p["out"] = _convt_init(gen, 3, 64 if n_up else dim, 3)
    return p


def hypermixer_g(params: Dict, z: torch.Tensor, grid: int = 8) -> torch.Tensor:
    b = z.shape[0]
    style = torch.tanh(z @ params["style"]["w"].t() + params["style"]["b"])  # (B, dim)
    x = params["seed"][None] + style[:, None, :]
    n_tok = x.shape[1]
    for blk in params["blocks"]:
        h = style @ blk["hyper"]["w"].t() + blk["hyper"]["b"]  # (B, n_tok * 8)
        mix = torch.tanh(h.reshape(b, n_tok, 8) @ blk["mix_proj"]["w"].t())  # (B, n_tok, n_tok)
        x = x + torch.softmax(mix, dim=-1) @ x
        x = x + _gelu(x @ blk["channel"]["w"].t() + blk["channel"]["b"])
    img = x.reshape(b, grid, grid, -1).permute(0, 3, 1, 2)
    for p in params["ups"]:
        img = F.relu(F.conv2d(_up2(img, "nearest"), p["w"], p["b"], padding=1))
    return torch.tanh(F.conv2d(img, params["out"]["w"], params["out"]["b"], padding=1))


# ------------------------------------------------------- involution
def _inv_init(gen, ci: int, co: int, groups: int, ksize: int, reduce: int = 4) -> Dict:
    """One involution layer: a 1x1 channel map and a per-pixel kernel-generating path (1x1 reduce,
    norm, GELU, 1x1 span to groups * K * K taps)."""
    mid = max(co // reduce, 4)
    return {
        "chan": {"w": _randn(gen, co, ci, 1, 1) * 0.02, "b": _zeros(gen, co)},
        "reduce": {"w": _randn(gen, mid, co, 1, 1) * 0.02, "b": _zeros(gen, mid)},
        "span": {"w": _randn(gen, groups * ksize * ksize, mid, 1, 1) * 0.02, "b": _zeros(gen, groups * ksize * ksize)},
        "ln_g": torch.ones(co, device=gen.device), "ln_b": _zeros(gen, co),
    }


def _channel_norm(x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(dim=1, keepdim=True)
    return (x - mu) / torch.sqrt((x - mu).square().mean(dim=1, keepdim=True) + 1e-6)


def involution2d(p: Dict, x: torch.Tensor, groups: int = 4, ksize: int = 3, stride: int = 1) -> torch.Tensor:
    """Involution: spatial mixing with kernels generated per output pixel from the feature map
    (spatial-specific, channel-shared)."""
    b = x.shape[0]
    x = F.conv2d(x, p["chan"]["w"], p["chan"]["b"])
    co = x.shape[1]
    h = _gelu(_channel_norm(F.conv2d(x, p["reduce"]["w"], p["reduce"]["b"], stride=stride)))
    kernels = F.conv2d(h, p["span"]["w"], p["span"]["b"])  # (B, G * K * K, H', W')
    hh, ww = kernels.shape[2:]
    kernels = kernels.view(b, groups, 1, ksize * ksize, hh, ww)
    patches = F.unfold(x, ksize, padding=ksize // 2, stride=stride)  # (B, C * K * K, H' W'), (C, kh, kw) order
    patches = patches.view(b, groups, co // groups, ksize * ksize, hh, ww)
    out = (patches * kernels).sum(dim=3).reshape(b, co, hh, ww)
    return p["ln_g"][None, :, None, None] * _channel_norm(out) + p["ln_b"][None, :, None, None]


def init_involution_g(gen: torch.Generator, z_dim: int = 100, base: int = 64, resolution: int = 64) -> Dict:
    nb = int(math.log2(resolution))
    chans = [min(base * 2**i, base * 8) for i in range(nb)][::-1]
    p = {"blocks": []}
    ci = z_dim
    for i, c in enumerate(chans):
        p["blocks"].append({
            "a": _inv_init(gen, ci, c, groups=4, ksize=3),
            "b": _inv_init(gen, c, 3 if i == nb - 1 else c, groups=1 if i == nb - 1 else 4, ksize=3),
        })
        ci = 3 if i == nb - 1 else c
    return p


def involution_g(params: Dict, z: torch.Tensor) -> torch.Tensor:
    x = z[:, :, None, None]  # a 1x1 spatial seed
    n = len(params["blocks"])
    for i, blk in enumerate(params["blocks"]):
        x = _up2(_gelu(involution2d(blk["a"], x, groups=4)), "bilinear")
        x = involution2d(blk["b"], x, groups=1 if i == n - 1 else 4)
        if i < n - 1:
            x = _gelu(x)
    return torch.tanh(x)


def init_involution_d(gen: torch.Generator, base: int = 64, resolution: int = 64) -> Dict:
    nb = int(math.log2(resolution))
    chans = [min(base * 2**i, base * 8) for i in range(nb)]
    p = {"blocks": [], "out": {"w": _randn(gen, 1, chans[-1]) * 0.02, "b": _zeros(gen, 1)}}
    ci = 3
    for c in chans:
        p["blocks"].append({"a": _inv_init(gen, ci, c, groups=4, ksize=3),
                            "b": _inv_init(gen, c, c, groups=4, ksize=3)})
        ci = c
    return p


def involution_d(params: Dict, img: torch.Tensor) -> torch.Tensor:
    x = img
    for blk in params["blocks"]:
        x = _gelu(involution2d(blk["a"], x, groups=4))
        x = _gelu(involution2d(blk["b"], x, groups=4, stride=2))
    x = x.mean(dim=(2, 3))
    return (x @ params["out"]["w"].t() + params["out"]["b"])[:, 0]


# ------------------------------------------- p4m group-equivariant
# Exact dihedral D4 group convolutions: kernel orbits assembled into one dense
# conv kernel, the group dimension riding as extra channels.
_D4 = [(m, r) for m in (0, 1) for r in range(4)]  # g = flip^m . rot^r


def _d4_compose(i: int, j: int) -> int:
    (m1, r1), (m2, r2) = _D4[i], _D4[j]
    m = m1 ^ m2
    r = ((r1 if m2 == 0 else -r1) + r2) % 4
    return _D4.index((m, r))


def _d4_inverse(i: int) -> int:
    m, r = _D4[i]
    return _D4.index((m, (-(r if m == 0 else -r)) % 4))


def _d4_transform(w: torch.Tensor, i: int) -> torch.Tensor:
    """Spatial action of group element i on a (..., K, K) kernel."""
    m, r = _D4[i]
    w = torch.rot90(w, r, dims=(-2, -1))
    return torch.flip(w, dims=(-1,)) if m else w


def _lift_kernel(w: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, K, K) -> (8 Co, Ci, K, K): scalar field -> group field."""
    return torch.cat([_d4_transform(w, g) for g in range(8)], dim=0)


def _group_kernel(w: torch.Tensor) -> torch.Tensor:
    """(8, Co, Ci, K, K) -> (8 Co, 8 Ci, K, K): output block g over input block h uses T_g(w[g^-1 h])."""
    rows = [torch.cat([_d4_transform(w[_d4_compose(_d4_inverse(g), h)], g) for h in range(8)], dim=1)
            for g in range(8)]
    return torch.cat(rows, dim=0)


def _gconv(x, kern):
    return F.conv2d(x, kern, padding=kern.shape[-1] // 2)


def _gnorm(x, g, b):
    """Positionwise norm over the whole (group x channel) feature vector, which commutes with D4."""
    return g[None, :, None, None] * _channel_norm(x) + b[None, :, None, None]


def init_steerable_g(gen: torch.Generator, z_dim: int = 128, base: int = 16, resolution: int = 32,
                     depth: int = 4) -> Dict:
    return {
        "map": {"w": _randn(gen, z_dim, z_dim) / math.sqrt(z_dim), "b": _zeros(gen, z_dim)},
        "lift": _randn(gen, base, z_dim, 3, 3) * 0.1,
        "blocks": [{"w": _randn(gen, 8, base, base, 3, 3) * 0.1, "g": torch.ones(8 * base, device=gen.device),
                    "b": _zeros(gen, 8 * base)} for _ in range(depth)],
        "out": _randn(gen, 8, 3, base, 3, 3) * 0.1,
    }


def steerable_g(params: Dict, z: torch.Tensor, rotation: int = 0, flip: bool = False) -> torch.Tensor:
    """z (B, z_dim) -> (B, 3, R, R). `rotation` (quarter turns) and `flip` pick the D4 element applied
    to the output field: steerable_g(z, r) equals rot90^r(steerable_g(z, 0))."""
    w = torch.tanh(z @ params["map"]["w"].t() + params["map"]["b"])
    b = w.shape[0]
    x = _gconv(w[:, :, None, None].expand(b, w.shape[1], 4, 4), _lift_kernel(params["lift"]))
    depth = len(params["blocks"])
    for i, blk in enumerate(params["blocks"]):
        x = _gelu(_gnorm(_gconv(x, _group_kernel(blk["w"])), blk["g"], blk["b"]))
        if i < depth and x.shape[2] * 2 <= 4 * 2**depth:
            x = _up2(x, "bilinear")
    x = _gconv(x, _group_kernel(params["out"]))  # (B, 8 * 3, R, R)
    gi = _D4.index((int(flip), rotation % 4))
    return x.view(b, 8, 3, x.shape[2], x.shape[3])[:, gi]


def init_steerable_d(gen: torch.Generator, base: int = 16, resolution: int = 32, depth: int = 4) -> Dict:
    return {
        "lift": _randn(gen, base, 3, 3, 3) * 0.1,
        "blocks": [{"w": _randn(gen, 8, base, base, 3, 3) * 0.1, "g": torch.ones(8 * base, device=gen.device),
                    "b": _zeros(gen, 8 * base)} for _ in range(depth)],
        "head": {"w": _randn(gen, 1, base) * 0.1, "b": _zeros(gen, 1)},
    }


def steerable_d(params: Dict, img: torch.Tensor) -> torch.Tensor:
    """Rotation- and reflection-invariant discriminator: group conv stack with symmetric 2x2 average
    pools (a strided conv would anchor at even pixels and break invariance), then the group and spatial
    mean."""
    x = _gconv(img, _lift_kernel(params["lift"]))
    for blk in params["blocks"]:
        x = F.avg_pool2d(_gelu(_gnorm(_gconv(x, _group_kernel(blk["w"])), blk["g"], blk["b"])), 2)
    b = x.shape[0]
    x = x.view(b, 8, -1, x.shape[2], x.shape[3]).mean(dim=(1, 3, 4))
    return (x @ params["head"]["w"].t() + params["head"]["b"])[:, 0]
