"""NIMA neural image assessment scoring.

Port of `maua_tpu/perceptors/nima.py`: a torchvision VGG16 trunk (a max
pool after every block, the last included: 224 -> a 7x7x512 map) ->
flatten in torch's CHW order -> a linear head to a 10-bin quality
distribution (softmax); score = sum(p_i i) and its std. Input: [0, 1] RGB
NHWC, resized bilinearly (as jax.image.resize, antialiased when it
shrinks) so its short side is 224, centre-cropped, ImageNet-normalised.
Parameters: {"vgg": the VGG16 list ({"w": OIHW, "b"}), "head": {"w":
(10, 25088), "b"}}.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.warp import resize
from ..utility import resolve_device
from . import vgg as vgg_mod


def init_params(gen: Optional[torch.Generator] = None, seed: int = 0, device=None) -> Dict:
    """The VGG16 trunk from `gen` (seed `seed` on `device`, cuda unless told otherwise); the head
    from numpy's default_rng(seed), as maua_tpu draws it (the same numbers)."""
    gen = gen if gen is not None else torch.Generator(device=resolve_device(device)).manual_seed(seed)
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((512 * 7 * 7, 10)) / np.sqrt(512 * 7 * 7)).astype(np.float32)
    return {"vgg": vgg_mod.init_params(gen, "vgg16"),
            "head": {"w": torch.from_numpy(np.ascontiguousarray(w.T)).to(gen.device),
                     "b": torch.zeros(10, device=gen.device)}}


def params_from_torch(sd: Dict) -> Dict:
    """A NIMA checkpoint (VGG16 `features.*`, optionally under `base_model.`, and a (10, N)
    classifier linear under any key, found by shape) -> params."""
    sd = {k: np.asarray(v, np.float32) for k, v in sd.items()}
    feats = {k[len("base_model."):] if k.startswith("base_model.") else k: v for k, v in sd.items()}
    head_w = head_b = None
    for k, v in feats.items():
        if v.ndim == 2 and v.shape[0] == 10:
            head_w = v
            head_b = feats.get(k.replace("weight", "bias"), np.zeros(10, np.float32))
    if head_w is None:
        raise KeyError("no (10, N) classifier linear found in state dict")
    return {"vgg": vgg_mod.params_from_torch(feats, "vgg16"),
            "head": {"w": torch.from_numpy(np.ascontiguousarray(head_w)), "b": torch.from_numpy(head_b)}}


def _preprocess(img: torch.Tensor) -> torch.Tensor:
    """[0, 1] RGB (B, H, W, 3) -> the ImageNet-normalised 224 centre crop, NCHW."""
    b, h, w, c = img.shape
    s = 224 / min(h, w)
    nh, nw = int(round(h * s)), int(round(w * s))
    x = resize(img.permute(0, 3, 1, 2), (nh, nw), "bilinear")
    top, left = (nh - 224) // 2, (nw - 224) // 2
    x = x[:, :, top:top + 224, left:left + 224]
    mean = torch.tensor(vgg_mod._IMAGENET_MEAN, dtype=x.dtype, device=x.device)[:, None, None]
    std = torch.tensor(vgg_mod._IMAGENET_STD, dtype=x.dtype, device=x.device)[:, None, None]
    return (x - mean) / std


def distribution(params: Dict, img: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, 3) in [0, 1] -> the (B, 10) quality distribution."""
    x = _preprocess(img)
    i = 0
    for n_convs in vgg_mod.VGG16_LAYOUT:
        for _ in range(n_convs):
            x = vgg_mod.conv_relu(params["vgg"][i], x)
            i += 1
        x = F.max_pool2d(x, 2)  # torchvision's VGG pools after every block
    flat = x.reshape(x.shape[0], -1)  # NCHW flattens in torch's CHW order
    return torch.softmax(F.linear(flat, params["head"]["w"], params["head"]["b"]), dim=-1)


def nima_score(img, params: Optional[Dict] = None, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """img in [0, 1] -> (score, std): the batch means of E[i] and of sqrt(E[(i - E[i])^2]).
    Without `params`, seed-0 weights on `device` (cuda unless told otherwise)."""
    params = params if params is not None else init_params(device=device)
    dev = params["head"]["w"].device
    probs = distribution(params, torch.as_tensor(np.asarray(img, np.float32) if not isinstance(img, torch.Tensor)
                                                 else img, device=dev).float())
    idxs = torch.arange(10, dtype=torch.float32, device=dev)
    means = (probs * idxs).sum(-1)
    stds = torch.sqrt((probs * (idxs[None] - means[:, None]) ** 2).sum(-1))
    return means.mean(), stds.mean()
