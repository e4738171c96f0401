"""Convert StyleGAN2, StyleGAN3 and diffusion (UNet, VAE, CLIP text)
parameters between the JAX package's pytree and the port.

The JAX pytree (numpy arrays, as `maua_tpu.gan.stylegan2.init_params`
and `maua_tpu.gan.stylegan3.init_params` make them and `jax.device_get`
returns them) keeps conv weights HWIO, fc weights (in, out) and the 4x4
const (H, W, C). The port keeps conv weights OIHW, fc weights (out, in)
and the const (C, H, W). Everything else carries over unchanged: noise
buffers (`noise_const` (H, W), `noise_strength` ()), biases, `w_avg`,
and StyleGAN3's `freqs` (C, 2), `phases`, `transform` (3, 3) and
`magnitude_ema` (). StyleGAN3's `layers` is a list of layer dicts and
stays a list. The diffusion trees convert by rank (see
`diffusion_params_to_torch`), and so do the super-resolution and RIFE
trees (see `super_params_to_torch`), the guidance networks' (see
`guidance_params_to_torch`) and BERT's (see `bert_params_to_torch`). Neither direction imports JAX.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

# leaf name -> axis permutation from the JAX layout to the port's
_TO_TORCH = {"weight": (3, 2, 0, 1), "w": (1, 0), "const": (2, 0, 1)}


def _walk(tree, fn, name: Optional[str] = None):
    """Apply fn(leaf name, leaf) over nested dicts and lists; a list's
    items keep the name of the list's own key."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, fn, name) for v in tree]
    return fn(name, tree)


def params_to_torch(jax_params: Dict, device: Optional[torch.device | str] = None) -> Dict:
    """JAX SG2 or SG3 pytree (numpy or array-likes) -> the port's dict of f32 tensors."""

    def conv(name, v):
        a = np.asarray(v, dtype=np.float32)
        if name in _TO_TORCH:
            a = a.transpose(_TO_TORCH[name])
        return torch.from_numpy(np.array(a, order="C")).to(device)

    return _walk(jax_params, conv)


def params_to_jax(torch_params: Dict) -> Dict:
    """The port's dict of tensors -> a JAX-layout pytree of numpy arrays."""

    def conv(name, v):
        a = v.detach().float().cpu().numpy()
        if name in _TO_TORCH:
            a = a.transpose(np.argsort(_TO_TORCH[name]))
        return np.array(a, order="C")

    return _walk(torch_params, conv)


# The diffusion trees (UNet, VAE, CLIP text) name both linear (in, out) and
# conv (k, k, ci, co) weights "w", so they convert by rank, not by name.
_DIFFUSION_TO_TORCH = {2: (1, 0), 4: (3, 2, 0, 1)}


def diffusion_params_to_torch(jax_params: Dict, device: Optional[torch.device | str] = None) -> Dict:
    """JAX UNet / VAE / CLIP-text pytree -> the port's dict of f32 tensors
    (linear weights (out, in), conv weights OIHW)."""

    def conv(name, v):
        a = np.asarray(v, dtype=np.float32)
        if name == "w":
            a = a.transpose(_DIFFUSION_TO_TORCH[a.ndim])
        return torch.from_numpy(np.array(a, order="C")).to(device)

    return _walk(jax_params, conv)


def bert_params_to_torch(jax_params: Dict, device: Optional[torch.device | str] = None) -> Dict:
    """JAX BERT pytree (`maua_tpu.text.bert`) -> the port's (`maua_tpu_torch.text.bert`): linear
    weights (in, out) -> (out, in); the embeddings, biases and norms unchanged."""
    return diffusion_params_to_torch(jax_params, device)


def diffusion_params_to_jax(torch_params: Dict) -> Dict:
    """The port's diffusion dict of tensors -> a JAX-layout pytree of numpy arrays."""

    def conv(name, v):
        a = v.detach().float().cpu().numpy()
        if name == "w":
            a = a.transpose(np.argsort(_DIFFUSION_TO_TORCH[a.ndim]))
        return np.array(a, order="C")

    return _walk(torch_params, conv)


def guidance_params_to_torch(jax_params, device: Optional[torch.device | str] = None):
    """A JAX guidance tree -> the port's: the CLIP image tower (`patch_embed`
    HWIO -> OIHW, linear weights (in, out) -> (out, in); `proj`, the
    embeddings and the norms unchanged), the VGG list and the LPIPS tree
    (conv weights HWIO -> OIHW; the lin weights unchanged) and the secondary
    model (conv weights HWIO -> OIHW; `timestep_embed` unchanged)."""

    def conv(name, v):
        a = np.asarray(v, dtype=np.float32)
        if name == "w":
            a = a.transpose(_DIFFUSION_TO_TORCH[a.ndim])
        elif name == "patch_embed":
            a = a.transpose(3, 2, 0, 1)
        return torch.from_numpy(np.array(a, order="C")).to(device)

    return _walk(jax_params, conv)


def super_params_to_torch(jax_params: Dict, device: Optional[torch.device | str] = None) -> Dict:
    """JAX super-resolution (RRDBNet, SRVGG, SwinIR, UpConv7, CARN) or RIFE
    pytree -> the port's dict of f32 tensors: conv weights HWIO -> OIHW,
    UpConv7's transposed conv (kh, kw, in, out) -> (in, out, kh, kw), linear
    weights (in, out) -> (out, in); biases, norms, PReLU slopes and SwinIR's
    relative-position tables unchanged."""

    def conv(v, perm):
        a = np.asarray(v, dtype=np.float32)
        if perm is not None:
            a = a.transpose(perm)
        return torch.from_numpy(np.array(a, order="C")).to(device)

    def walk(tree, name=None, deconv=False):
        if isinstance(tree, dict):
            return {k: walk(v, k, deconv or k == "deconv") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, name, deconv) for v in tree]
        perm = None
        if name == "w":
            perm = (2, 3, 0, 1) if deconv else _DIFFUSION_TO_TORCH[np.ndim(tree)]
        return conv(tree, perm)

    return walk(jax_params)


# transposed convs of the flow estimators: a dict under one of these names holds one whose "w" maua_tpu
# keeps spatially flipped in HWIO (kh, kw, in, out) for an lhs-dilated conv; liteflownet's grouped ones
# ("upflow", "upcorr" as bare (4, 4, 1, C) arrays) hold one channel a group
_FLOW_DECONV = ("upflow", "upfeat", "upcorr")


def _is_flow_deconv(name: Optional[str]) -> bool:
    return isinstance(name, str) and (name in _FLOW_DECONV or name.startswith(("up_", "upflow_")))


def flow_params_to_torch(name: str, jax_params, device: Optional[torch.device | str] = None):
    """A JAX neural flow estimator's tree (`maua_tpu.flow.{spynet,pwc,liteflownet,unflow,raft}`;
    `name` is its registry name) -> the port's: conv weights HWIO -> OIHW, the transposed convs
    unflipped into (in, out, kh, kw), liteflownet's grouped ones into (C, 1, 4, 4); biases, norms
    (the folded frozen ones keep their "frozen" mark), GMA's gamma and PWC's refiner dilations
    unchanged."""
    if name not in ("spynet", "pwc", "pwcnet", "liteflownet", "unflow", "raft", "raft_large", "gma"):
        raise ValueError(f"unknown flow estimator {name!r}")

    def leaf(a, perm=None, flip=False):
        a = np.asarray(a, dtype=np.float32)
        if flip:
            a = a[::-1, ::-1]
        if perm is not None:
            a = a.transpose(perm)
        return torch.from_numpy(np.array(a, order="C")).to(device)

    def walk(tree, key=None):
        if isinstance(tree, dict):
            if "w" in tree and not isinstance(tree["w"], dict):
                deconv = _is_flow_deconv(key)
                return {k: leaf(v, ((2, 3, 0, 1) if deconv else (3, 2, 0, 1)), deconv) if k == "w" else leaf(v)
                        for k, v in tree.items()}
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, key) for v in tree]
        if isinstance(tree, tuple):  # PWC's refiner dilations
            return tuple(tree)
        if key in ("upflow", "upcorr"):  # liteflownet's grouped transposed convs, (4, 4, 1, C)
            return leaf(tree, (3, 2, 0, 1), flip=True)
        return leaf(tree)

    return walk(jax_params)


def pgg_params_to_torch(jax_params, device: Optional[torch.device | str] = None):
    """A JAX caffe-zoo list (`maua_tpu.perceptors.pgg`: VGG16/19, pruned VGG16 or NIN) -> the
    port's (`perceptors/pgg.py`): conv weights HWIO -> OIHW, biases unchanged."""
    return guidance_params_to_torch(jax_params, device)


def nima_params_to_torch(jax_params: Dict, device: Optional[torch.device | str] = None) -> Dict:
    """A JAX NIMA tree (`maua_tpu.perceptors.nima`) -> the port's: the VGG16 convs HWIO -> OIHW,
    the head's (25088, 10) -> (10, 25088)."""
    return diffusion_params_to_torch(jax_params, device)


def video_vit_params_to_torch(jax_params: Dict, device: Optional[torch.device | str] = None) -> Dict:
    """A JAX video ViT tree (`maua_tpu.style.video_vit`) -> the port's: linear weights (in, out) ->
    (out, in); `pos_space`, `pos_time`, biases and layer norms unchanged."""
    return diffusion_params_to_torch(jax_params, device)


def nca_params_to_torch(jax_params: Dict, device: Optional[torch.device | str] = None) -> Dict:
    """A JAX texture-NCA tree (`maua_tpu.nca`) -> the port's: the 1x1 convs `w1`, `w2` HWIO -> OIHW,
    `b1` unchanged."""
    return {k: torch.from_numpy(np.array(np.asarray(v, np.float32).transpose(3, 2, 0, 1) if v.ndim == 4
                                         else np.asarray(v, np.float32), order="C")).to(device)
            for k, v in ((k, np.asarray(v)) for k, v in jax_params.items())}


def _d_fc_hwc_to_chw(w: np.ndarray) -> np.ndarray:
    """The b4 FC's (out, 16 * C) weight from the (H, W, C) flatten order to (C, H, W)."""
    co, n = w.shape
    return w.reshape(co, 4, 4, n // 16).transpose(0, 3, 1, 2).reshape(co, n)


def _d_fc_chw_to_hwc(w: np.ndarray) -> np.ndarray:
    co, n = w.shape
    return w.reshape(co, n // 16, 4, 4).transpose(0, 2, 3, 1).reshape(co, n)


def d_params_to_torch(jax_params: Dict, device: Optional[torch.device | str] = None) -> Dict:
    """A JAX StyleGAN2 discriminator tree (`maua_tpu.gan.discriminator`) -> the port's: conv weights
    HWIO -> OIHW, fc weights (in, out) -> (out, in), and the b4 FC's input re-permuted from the JAX
    package's (H, W, C) flatten to the port's (C, H, W) one, which is an ADA checkpoint's."""
    out = params_to_torch(jax_params)
    fc = out["b4"]["fc"]
    fc["w"] = torch.from_numpy(np.array(_d_fc_hwc_to_chw(fc["w"].numpy()), order="C"))
    return _walk(out, lambda name, v: v.to(device))


def d_params_to_jax(torch_params: Dict) -> Dict:
    """The port's discriminator tree -> the JAX package's layout (numpy arrays)."""
    out = params_to_jax(torch_params)
    out["b4"]["fc"]["w"] = np.array(_d_fc_chw_to_hwc(out["b4"]["fc"]["w"].T).T, order="C")
    return out


# The experimental families' conv kernels: HWIO -> OIHW, and the steerable group kernels
# (K, K, 8, Ci, Co) -> (8, Co, Ci, K, K)
_EXPERIMENTAL_TO_TORCH = {4: (3, 2, 0, 1), 5: (2, 4, 3, 0, 1)}


def experimental_params_to_torch(jax_params: Dict, device: Optional[torch.device | str] = None) -> Dict:
    """A JAX tree of an experimental family (`maua_tpu.gan.models_experimental`: dcgan, hypermixer,
    involution, steerable; G or D) -> the port's: every 4-D conv kernel HWIO -> OIHW, every 5-D group
    kernel (K, K, 8, Ci, Co) -> (8, Co, Ci, K, K), linear weights `w` (in, out) -> (out, in); the
    hypermixer's `seed` tokens, biases and norms unchanged."""

    def conv(name, v):
        a = np.asarray(v, dtype=np.float32)
        if a.ndim in _EXPERIMENTAL_TO_TORCH:
            a = a.transpose(_EXPERIMENTAL_TO_TORCH[a.ndim])
        elif a.ndim == 2 and name == "w":
            a = a.T
        return torch.from_numpy(np.array(a, order="C")).to(device)

    return _walk(jax_params, conv)


def experimental_params_to_jax(torch_params: Dict) -> Dict:
    """The port's tree of an experimental family -> the JAX package's layout (numpy arrays)."""

    def conv(name, v):
        a = v.detach().float().cpu().numpy()
        if a.ndim in _EXPERIMENTAL_TO_TORCH:
            a = a.transpose(np.argsort(_EXPERIMENTAL_TO_TORCH[a.ndim]))
        elif a.ndim == 2 and name == "w":
            a = a.T
        return np.array(a, order="C")

    return _walk(torch_params, conv)


def _tree_leaves(tree) -> list:
    """The leaves in JAX's order (dict keys sorted), which is also the port's train state's."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def train_state_to_torch(jax_state: Dict, g_convert, d_convert, device: Optional[torch.device | str] = None) -> Dict:
    """A JAX GAN train state (`maua_tpu.gan.training.init_train_state`, after any steps) -> the port's
    (`maua_tpu_torch.gan.training`): both networks and the EMA through their converters (`params_to_torch`,
    `d_params_to_torch` or `experimental_params_to_torch`), each optax Adam state's moments through the
    same converter and flattened in the port's parameter order, `pl_mean` a tensor and `step` an int."""

    def opt(state, convert):
        adam = state[0]
        moments = {k: [t.to(device) for t in _tree_leaves(convert(getattr(adam, k)))] for k in ("mu", "nu")}
        return [{"count": int(np.asarray(adam.count)), **moments}, ()]

    return {
        "g_params": g_convert(jax_state["g_params"], device),
        "d_params": d_convert(jax_state["d_params"], device),
        "g_ema": g_convert(jax_state["g_ema"], device),
        "g_opt": opt(jax_state["g_opt"], lambda t: g_convert(t)),
        "d_opt": opt(jax_state["d_opt"], lambda t: d_convert(t)),
        "pl_mean": torch.tensor(float(np.asarray(jax_state["pl_mean"])), device=device),
        "step": int(np.asarray(jax_state["step"])),
    }


def resnet_extractor_params_to_torch(jax_params: Dict, device: Optional[torch.device | str] = None) -> Dict:
    """The params of maua_tpu's metric stand-in (`maua_tpu.gan.metrics.ResNetExtractor`) -> the port's
    (`gan/metrics.ResNetExtractor(params=...)`): convs HWIO -> OIHW, the head (ch, feat) -> (feat, ch);
    a block's `stride` and a missing `skip` (None) kept."""
    return _walk(jax_params, lambda name, v: v if v is None or isinstance(v, int)
                 else experimental_params_to_torch({name: v}, device)[name])


def biggan_params_to_torch(jax_params: Dict, device: Optional[torch.device | str] = None) -> Dict:
    """JAX BigGAN pytree (`maua_tpu.gan.biggan`) -> the port's (`maua_tpu_torch.gan.biggan`): linear weights
    (in, out) -> (out, in), conv weights HWIO -> OIHW; the class table, norms' statistics and gamma unchanged."""
    return diffusion_params_to_torch(jax_params, device)


def ar_params_to_torch(jax_params: Dict, device: Optional[torch.device | str] = None) -> Dict:
    """JAX autoregressive transformer pytree (`maua_tpu.autoregressive.transformer`) -> the port's: the same
    layout (linear weights (in, out)), f32 tensors; the block list stays a list."""
    return _walk(jax_params, lambda name, v: torch.from_numpy(np.array(v, np.float32, order="C")).to(device))


def ar_params_to_jax(torch_params: Dict) -> Dict:
    """The port's autoregressive transformer dict -> a JAX-layout pytree of numpy arrays."""
    return _walk(torch_params, lambda name, v: np.array(v.detach().float().cpu().numpy(), order="C"))
