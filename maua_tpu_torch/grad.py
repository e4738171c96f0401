"""Pluggable guidance-gradient modules for diffusion.

Port of `maua_tpu/grad.py` (GradModule, differentiable_histogram,
ColorMatchGrads, LossGrads, RangeGrads, TVGrads, CLIPGrads, VGGGrads,
ContentGrads, LPIPSGrads, ssim, LatentSSIMGrads). Each module takes its
targets from the prompts (`set_targets`) and maps an image (B, H, W, C)
to d(loss)/d(image) x scale (`__call__(img, t)`), the gradient taken by
`torch.autograd.grad` under `torch.enable_grad()`, so a caller under
`torch.no_grad()` gets it too. Targets live on the module's perceptor's
device, or follow the image.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .loss import gram_matrix, range_loss, scaled_mse_loss, spherical_dist_loss, tv_loss
from .prompt import ContentPrompt, ImagePrompt, StylePrompt, TextPrompt


def _grad(loss_fn: Callable, img: torch.Tensor) -> torch.Tensor:
    with torch.enable_grad():
        x = img.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss_fn(x), x)
    return g


def _image(p, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(p.img, np.float32), device=device)


def _style_images(prompts):
    """The style (or plain image) prompts, not the content ones."""
    return [p for p in prompts if isinstance(p, (StylePrompt, ImagePrompt)) and not isinstance(p, ContentPrompt)]


class GradModule:
    scale: float = 1.0

    def __init__(self, scale: float = 1.0):
        self.scale = scale

    def set_targets(self, prompts: Sequence):
        pass

    def __call__(self, img: torch.Tensor, t) -> torch.Tensor:
        raise NotImplementedError


def differentiable_histogram(x: torch.Tensor, bins: int = 255, min: float = 0.0, max: float = 1.0) -> torch.Tensor:
    """Soft histogram with triangular kernels: x (B, H, W, C) -> (B, bins, C).

    (maua_tpu's docstring says (B, C, bins), but it swaps the axes to (B,
    bins, C), so ColorMatchGrads normalises each bin over the channels; the
    port computes what maua_tpu computes.)"""
    delta = (max - min) / bins
    centers = min + delta * (torch.arange(bins, dtype=torch.float32, device=x.device) + 0.5)
    xf = x.reshape(x.shape[0], -1, x.shape[-1])
    weights = (1.0 - (xf[:, :, :, None] - centers).abs() / delta).clamp(0.0, 1.0)
    return weights.sum(dim=1).transpose(1, 2)


class ColorMatchGrads(GradModule):
    """Pull the colour histograms towards the last style image's.

    The target histogram is built on `device` in `set_targets`; without a
    device, at the first call on the image's device (and again only when
    a later image lies on another)."""

    def __init__(self, scale: float = 1.0, bins: int = 64, device=None):
        super().__init__(scale)
        self.bins = bins
        self.device = None if device is None else torch.device(device)
        self.target_prompt = self.target_hist = None

    def set_targets(self, prompts):
        styles = _style_images(prompts)
        if styles:
            self.target_prompt, self.target_hist = styles[-1], None
            if self.device is not None:
                self._target(self.device)

    def _target(self, device) -> torch.Tensor:
        if self.target_hist is None or self.target_hist.device != device:
            with torch.no_grad():
                hist = differentiable_histogram((_image(self.target_prompt, device) + 1) / 2, self.bins)
            self.target_hist = hist / hist.sum(-1, keepdim=True).clamp_min(1e-8)
        return self.target_hist

    def __call__(self, img, t):
        if self.target_prompt is None:
            return torch.zeros_like(img)
        ht = self._target(img.device)

        def loss(im):
            hist = differentiable_histogram((im + 1) / 2, self.bins)
            h = hist / hist.sum(-1, keepdim=True).clamp_min(1e-8)
            return (h - ht).square().mean()

        return _grad(loss, img) * self.scale


class LossGrads(GradModule):
    """Guidance by any image loss."""

    def __init__(self, loss_fn: Callable, scale: float = 1.0):
        super().__init__(scale)
        self.loss_fn = loss_fn

    def __call__(self, img, t):
        return _grad(lambda im: self.loss_fn(im).sum(), img) * self.scale


class RangeGrads(LossGrads):
    def __init__(self, scale: float = 1.0):
        super().__init__(range_loss, scale)


class TVGrads(LossGrads):
    def __init__(self, scale: float = 1.0):
        super().__init__(tv_loss, scale)


class CLIPGrads(GradModule):
    """CLIP guidance: the spherical distance of n_cutouts random crops' image
    embeddings to the text prompts' (weighted) and the image prompts'.

    Each call cuts new crops: drawn from the module's own generator
    (seeded with `seed` on the perceptor's device), or taken in order from
    `draws`, a list of (sizes, y0s, x0s), one for each call, when it is set."""

    def __init__(self, perceptor=None, scale: float = 1.0, n_cutouts: int = 16, device=None, seed: int = 0,
                 draws: Optional[List] = None):
        super().__init__(scale)
        if perceptor is None:
            from .perceptors.clip import CLIPPerceptor

            perceptor = CLIPPerceptor(device=device, seed=seed)
        self.perceptor = perceptor
        self.n_cutouts = n_cutouts
        self.gen = torch.Generator(device=perceptor.device).manual_seed(seed)
        self.draws = draws
        self.text_embeds = self.text_weights = self.img_embeds = None

    def set_targets(self, prompts):
        texts, weights, img_embeds = [], [], []
        dev = self.perceptor.device
        with torch.no_grad():
            for p in prompts:
                if isinstance(p, TextPrompt):
                    texts.append(p.text)
                    weights.append(p.weight)
                elif isinstance(p, ImagePrompt) and not isinstance(p, ContentPrompt):
                    img_embeds.append(self.perceptor.encode_image(_image(p, dev)))
            if texts:
                self.text_embeds = self.perceptor.encode_text(texts)
                self.text_weights = torch.tensor(weights, dtype=torch.float32, device=dev)
            if img_embeds:
                self.img_embeds = torch.cat(img_embeds)

    def __call__(self, img, t):
        if self.text_embeds is None and self.img_embeds is None:
            return torch.zeros_like(img)
        from .ops.cutouts import random_cutouts

        draws = self.draws.pop(0) if self.draws else None

        def loss(im):
            cuts = random_cutouts(im, self.perceptor.image_size, self.n_cutouts, gen=self.gen, draws=draws)
            embeds = self.perceptor.encode_image(cuts)
            total = 0.0
            if self.text_embeds is not None:
                total = total + (spherical_dist_loss(embeds[:, None], self.text_embeds[None])
                                 * self.text_weights[None]).sum()
            if self.img_embeds is not None:
                total = total + spherical_dist_loss(embeds[:, None], self.img_embeds[None]).sum()
            return total / self.n_cutouts

        return _grad(loss, img) * self.scale


class VGGGrads(GradModule):
    """Style guidance: the Gram matrices of every VGG feature towards the last style image's."""

    def __init__(self, perceptor=None, scale: float = 1.0, device=None, seed: int = 0):
        super().__init__(scale)
        if perceptor is None:
            from .perceptors.vgg import VGGPerceptor

            perceptor = VGGPerceptor(device=device, seed=seed)
        self.perceptor = perceptor
        self.target_grams = None

    def set_targets(self, prompts):
        with torch.no_grad():
            for p in _style_images(prompts):
                feats = self.perceptor.get_features(_image(p, self.perceptor.device))
                self.target_grams = [gram_matrix(f) for f in feats]

    def __call__(self, img, t):
        if self.target_grams is None:
            return torch.zeros_like(img)

        def loss(im):
            feats = self.perceptor.get_features(im)
            return sum(scaled_mse_loss(gram_matrix(f), g) for f, g in zip(feats, self.target_grams))

        return _grad(loss, img) * self.scale


class ContentGrads(GradModule):
    """Content guidance: every perceptor feature towards the content image's."""

    def __init__(self, perceptor=None, scale: float = 1.0, device=None, seed: int = 0):
        super().__init__(scale)
        if perceptor is None:
            from .perceptors.vgg import VGGPerceptor

            perceptor = VGGPerceptor(device=device, seed=seed)
        self.perceptor = perceptor
        self.target_feats = None

    def set_targets(self, prompts):
        with torch.no_grad():
            for p in prompts:
                if isinstance(p, ContentPrompt):
                    self.target_feats = self.perceptor.get_features(_image(p, self.perceptor.device))

    def __call__(self, img, t):
        if self.target_feats is None:
            return torch.zeros_like(img)

        def loss(im):
            return sum((f - tf).square().mean() for f, tf in zip(self.perceptor.get_features(im), self.target_feats))

        return _grad(loss, img) * self.scale


class LPIPSGrads(GradModule):
    """LPIPS content guidance: both images lanczos-resampled to 256^2 and
    scored by lpips-vgg (`perceptors/lpips.py`); random weights from `seed`
    unless `params` are given."""

    def __init__(self, scale: float = 1.0, params=None, device=None, seed: int = 0):
        super().__init__(scale)
        from .perceptors.lpips import LPIPSPerceptor

        self.perceptor = LPIPSPerceptor(params, device=device, seed=seed)
        self.target = None

    def set_targets(self, prompts):
        for p in prompts:
            if isinstance(p, ContentPrompt):
                self.target = _image(p, self.perceptor.device)

    def __call__(self, img, t):
        if self.target is None:
            return torch.zeros_like(img)
        from .ops.image import resample

        tgt = resample(self.target, (256, 256))
        return _grad(lambda im: self.perceptor(resample(im, (256, 256)), tgt).sum(), img) * self.scale


def ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 10.0, win_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM of (B, H, W, C) maps with a separable gaussian window (valid borders)."""
    half = win_size // 2
    g = torch.exp(-0.5 * ((torch.arange(win_size, dtype=torch.float32, device=x.device) - half) / sigma) ** 2)
    g = g / g.sum()
    c = x.shape[-1]
    kh = g.reshape(1, 1, win_size, 1).repeat(c, 1, 1, 1)
    kw = g.reshape(1, 1, 1, win_size).repeat(c, 1, 1, 1)

    def blur(im):
        im = im.permute(0, 3, 1, 2)
        return F.conv2d(F.conv2d(im, kh, groups=c), kw, groups=c)

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mx, my = blur(x), blur(y)
    mxx, myy, mxy = blur(x * x), blur(y * y), blur(x * y)
    vx = mxx - mx * mx
    vy = myy - my * my
    cov = mxy - mx * my
    return (((2 * mx * my + c1) * (2 * cov + c2)) / ((mx * mx + my * my + c1) * (vx + vy + c2))).mean()


class LatentSSIMGrads(GradModule):
    """Structural content guidance in latent space: the content image
    encoded once by `encode_fn` (NHWC image -> NHWC latent), and the running
    latent pulled towards it by 1 - SSIM (data_range 10)."""

    def __init__(self, scale: float = 1.0, encode_fn: Callable = None):
        super().__init__(scale)
        self.encode_fn = encode_fn
        self.target = None

    def set_targets(self, prompts):
        for p in prompts:
            if isinstance(p, ContentPrompt) and self.encode_fn is not None:
                with torch.no_grad():
                    self.target = self.encode_fn(torch.as_tensor(np.asarray(p.img, np.float32)))

    def __call__(self, x, t):
        if self.target is None:
            return torch.zeros_like(x)
        target = self.target.to(x.device)
        return _grad(lambda lat: 1.0 - ssim(lat, target, data_range=10.0), x) * self.scale
