"""Palette-constrained pixel-art parameterization (the PyTTI Pixel image).

Port of `maua_tpu/parameterizations/pixel.py`: a brightness `value` map
(h, w), pallet-selection logits `tensor` (n_pallets, h, w) and a `pallet`
(pallet_size, n_pallets, 3) of luma-sorted colour ramps. Decoding mixes a
discrete render (rounded value, argmax pallet) with a continuous one
(lerped, softmax-weighted) through a straight-through estimator, then
upsamples by `scale` (nearest). With the palette losses (`palette_loss`,
`hdr_loss`) and the closed-form `encode`. `torch.round` rounds half to
even, as `jnp.round` does. (maua_tpu's pallet locking and post-step clamps
have no caller there and are not ported.)
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..loss import replace_grad
from ..ops.warp import resize
from ..utility import resolve_device
from . import Parameterization, clip

# https://alienryderflex.com/hsp.html luma weights
_MAGIC_COLOR = np.asarray([0.299, 0.587, 0.114], np.float32)


def _magic(like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(_MAGIC_COLOR, device=like.device)


def sort_pallet(pallet: torch.Tensor, pallet_inertia: float = 2.0) -> torch.Tensor:
    """Luma-sort each pallet's ramp: pallet (S, P, 3) -> sorted, clamped to [0, 1]."""
    p = clip(pallet / pallet_inertia, 0.0, 1.0)
    luma = (p.square() * _magic(p)).sum(dim=-1)  # (S, P)
    order = torch.argsort(luma, dim=0, stable=True)
    return torch.gather(p, 0, order[:, :, None].expand(-1, -1, 3))


class Pixel(Parameterization):
    def __init__(self, height: int, width: int, tensor=None, n_colors: int = 8, n_pallets: int = 2, scale: int = 1,
                 gamma: float = 1.0, hdr_weight: float = 0.5, norm_weight: float = 0.1, hard: bool = False,
                 ema: bool = False, gen: Optional[torch.Generator] = None, device=None):
        """The pallet logits are 0.1 N(0, 1) drawn from `gen` (seed 0 on `device`, cuda unless told
        otherwise); `tensor`, an NHWC image in [-1, 1], is encoded when given."""
        gen = gen if gen is not None else torch.Generator(device=resolve_device(device)).manual_seed(0)
        dev = gen.device
        self.pallet_size = self.n_colors = n_colors
        self.n_pallets = n_pallets
        self.scale = scale
        self.gamma = gamma
        self.hdr_weight = hdr_weight
        self.norm_weight = norm_weight
        self.hard = hard
        self.pallet_inertia = 2.0
        h, w = height // scale, width // scale
        # gamma-spaced grey ramps repeated per pallet
        ramp = torch.linspace(0, self.pallet_inertia, n_colors, device=dev) ** gamma
        params = {"value": torch.zeros((h, w), device=dev),
                  "tensor": torch.randn((n_pallets, h, w), generator=gen, device=dev) * 0.1,
                  "pallet": ramp.reshape(n_colors, 1, 1) * torch.ones((1, n_pallets, 3), device=dev)}
        super().__init__(height, width, params, ema=ema)
        if tensor is not None:
            self.encode(tensor)

    def _sorted_pallet(self, p=None):
        return sort_pallet((self.tensor if p is None else p)["pallet"], self.pallet_inertia)

    def decode(self, tensor=None):
        """The straight-through mix of the discrete and continuous renders, upsampled by `scale`; [-1, 1]."""
        p = self.tensor if tensor is None else tensor
        pallet = self._sorted_pallet(p)
        top = self.pallet_size - 1
        values = clip(p["value"], 0.0, 1.0) * top
        floors = torch.floor(values).long().clamp(0, top)
        ceils = torch.ceil(values).long().clamp(0, top)
        rounds = torch.round(values).long().clamp(0, top)
        fracs = (values - torch.floor(values))[..., None, None]
        weights = p["tensor"].permute(1, 2, 0)  # (h, w, P)
        hard_w = torch.nn.functional.one_hot(weights.argmax(-1), self.n_pallets).to(weights.dtype)[..., None]
        soft_w = torch.softmax(weights, -1)[..., None]
        colors_disc = (pallet[rounds] * hard_w).sum(dim=2)  # (h, w, 3)
        colors_cont = ((pallet[floors] * (1 - fracs) + pallet[ceils] * fracs) * soft_w).sum(dim=2)
        if self.hard:
            out = replace_grad(colors_disc, colors_cont)
        else:
            out = replace_grad(colors_disc, colors_cont * 0.5 + colors_disc * 0.5)
        if self.scale > 1:
            out = out.repeat_interleave(self.scale, 0).repeat_interleave(self.scale, 1)
        return out[None] * 2.0 - 1.0

    def palette_loss(self) -> torch.Tensor:
        """Anticorrelate pallet usage across pixels and maximize the within-pallet variance."""
        t = torch.softmax(self.tensor["tensor"].permute(1, 2, 0).reshape(-1, self.n_pallets), dim=-1)
        n = t.shape[0]
        mu = t.mean(dim=0, keepdim=True)
        sigma = t.std(dim=0, keepdim=True, unbiased=False) + 1e-8
        c = t - mu
        S = (c.T @ c) / (sigma * sigma.T * n)
        S = S - torch.diag(torch.diag(S))
        return (S.mean() + (1.0 / (sigma * n)).mean()) * self.norm_weight

    def hdr_loss(self) -> torch.Tensor:
        """Pallet luma matched to a gamma-spaced ramp."""
        pallet = self._sorted_pallet()
        if self.hdr_weight == 0:
            return torch.zeros((), device=pallet.device)
        comp = (torch.linspace(0, 1, self.pallet_size, device=pallet.device) ** 2.5)[:, None] * \
            torch.ones((1, self.n_pallets), device=pallet.device)
        color_norms = torch.linalg.vector_norm(pallet * _magic(pallet).sqrt(), dim=-1)
        return (color_norms - comp).square().mean() * self.hdr_weight

    def encode(self, img):
        """The closed-form image fit: value from HSP luma; pallet ramps from luma-quantile colours
        (with numpy's seed-0 jitter); pallet logits from colour distances."""
        dev = self.tensor["value"].device
        x = (torch.as_tensor(img, device=dev).float() + 1.0) / 2.0
        if x.ndim == 4:
            x = x[0]
        h, w = self.tensor["value"].shape
        x = resize(x.permute(2, 0, 1)[None], (h, w), "bilinear")[0].permute(1, 2, 0)
        magic = _magic(x)
        value = torch.clamp(torch.linalg.vector_norm(x * magic.sqrt(), dim=-1), 0, 1)
        flat = x.reshape(-1, 3)
        order = torch.argsort((flat * magic).sum(-1), stable=True)
        qidx = torch.as_tensor(np.linspace(0, flat.shape[0] - 1, self.pallet_size).astype(np.float32).astype(np.int64),
                               device=dev)
        ramp = flat[order[qidx]]  # (S, 3) luma-sorted representative colours
        jitter = np.random.default_rng(0).normal(0, 0.02, (self.pallet_size, self.n_pallets, 3))
        pallet = torch.clamp(ramp[:, None, :] + torch.as_tensor(jitter, dtype=torch.float32, device=dev), 0, 1)
        pallet = pallet * self.pallet_inertia
        idx = torch.round(value * (self.pallet_size - 1)).long().clamp(0, self.pallet_size - 1)
        cand = sort_pallet(pallet, self.pallet_inertia)[idx.reshape(-1)]  # (N, P, 3)
        d = (cand - flat[:, None, :]).square().sum(-1)  # (N, P)
        tensor = (-d * 10.0).reshape(h, w, self.n_pallets).permute(2, 0, 1)
        self.set_params({"value": value, "tensor": tensor, "pallet": pallet})
