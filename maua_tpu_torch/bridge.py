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
