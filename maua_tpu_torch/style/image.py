"""Neural style transfer (Gatys-style optimization) of one image.

Port of `maua_tpu/style/image.py` (`transfer`): a parameterization decoded
through a perceptor, the content features of the content image and the
grams of the style images (averaged) as targets, total variation, and the
optimizer loop: L-BFGS steps with its zoom linesearch (the linesearch's
last value and gradient reused, as `optax.value_and_grad_from_state`
does) or first-order steps; an optional EMA decode at the end.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..loss import gram_matrix, scaled_mse_loss, tv_loss
from ..ops.image import match_histogram, resample
from ..ops.io import load_images
from ..optimizers import LBFGS, load_optimizer
from ..parameterizations import load_parameterization
from ..perceptors import load_perceptor
from ..utility import resolve_device


def to_image(a, device) -> torch.Tensor:
    """A [0, 1] NHWC array (or tensor) as an f32 tensor in [-1, 1] on `device`."""
    return torch.as_tensor(np.array(a, np.float32) if not isinstance(a, torch.Tensor) else a,
                           device=device).float() * 2 - 1


def build_perceptor(perceptor: str, perceptor_kwargs: Optional[Dict], device):
    return load_perceptor(perceptor)(**{"device": device, **(perceptor_kwargs or {})})


def style_targets(percept, styles: List[torch.Tensor]) -> List[torch.Tensor]:
    """The grams of each style image at the perceptor's style layers, averaged over the images."""
    targets = None
    with torch.no_grad():
        for s in styles:
            feats = percept.get_features(s)
            grams = [gram_matrix(feats[i]) / len(styles) for i in percept.style_layers]
            targets = grams if targets is None else [t + g for t, g in zip(targets, grams)]
    return targets


def transfer(
    content_img,
    style_imgs,
    init_img=None,
    init_type: str = "content",
    match_hist: str = "avg",
    size: int = 512,
    parameterization: str = "rgb",
    perceptor: str = "kbc-vgg19",
    perceptor_kwargs: Optional[Dict] = None,
    optimizer: str = "lbfgs",
    lr: float = 0.5,
    optimizer_kwargs: Optional[Dict] = None,
    n_iters: int = 512,
    content_weight: float = 1.0,
    style_weight: float = 50.0,
    tv_weight: float = 100.0,
    style_scale: float = 1.0,
    ema: bool = False,
    verbose: bool = True,
    gen: Optional[torch.Generator] = None,
    device=None,
    stats: Optional[Dict] = None,
) -> torch.Tensor:
    """The stylized image (1, H, W, 3) in [-1, 1], on `device` (cuda unless told otherwise).
    Random draws (a parameterization's initial tensor) come from `gen` (seed 0 on `device`).
    `stats`, when given, receives the iterations, the loss evaluations (more than the
    iterations under L-BFGS: its linesearch) and the optimization loop's seconds."""
    device = resolve_device(device)
    gen = gen if gen is not None else torch.Generator(device=device).manual_seed(0)
    content_img, style_list, init_img = load_images(content_img, style_imgs, init_img)
    if not isinstance(style_list, list):
        style_list = [style_list]

    content = resample(to_image(content_img, device), size)
    styles = [resample(to_image(im, device), int(size * style_scale)) for im in style_list]
    content = match_histogram(content, styles, mode=match_hist)

    if init_img is not None:
        init_tensor = to_image(init_img, device)
    elif init_type == "content":
        init_tensor = content
    else:
        init_tensor = None
    if init_tensor is not None and parameterization.lower() in ("vqgan", "fourier"):
        # maua_tpu hands the image to these as their latent / spectrum and fails on its shape
        raise ValueError(f"the {parameterization} parameterization starts from its own latent, not an image: "
                         f"use init_type='random'")

    h, w = content.shape[1], content.shape[2]
    pastiche = load_parameterization(parameterization)(h, w, tensor=init_tensor, ema=ema, gen=gen, device=device)
    percept = build_perceptor(perceptor, perceptor_kwargs, device)
    with torch.no_grad():
        content_feats = percept.get_features(content)
        content_targets = [content_feats[i] for i in percept.content_layers]
    targets = style_targets(percept, styles)

    factory, niter = load_optimizer(optimizer, lr, optimizer_kwargs, n_iters)
    opt = factory(pastiche.params())

    def closure():
        opt.zero_grad()
        img = pastiche.decode()
        feats = percept.get_features(img)
        loss = 0.0
        for i, t in zip(percept.content_layers, content_targets):
            loss = loss + content_weight * scaled_mse_loss(feats[i], t)
        for i, t in zip(percept.style_layers, targets):
            loss = loss + style_weight * scaled_mse_loss(gram_matrix(feats[i]), t)
        if tv_weight > 0:
            loss = loss + tv_weight * tv_loss(img)
        loss.backward()
        return loss

    evaluations = 0
    t0 = time.perf_counter()
    for it in range(niter):
        if isinstance(opt, LBFGS):
            value = opt.step(closure)
        else:
            value = closure()
            opt.step()
            evaluations += 1
        pastiche.update_ema()
        if verbose and it % max(niter // 10, 1) == 0:
            print(f"iter {it}/{niter} loss {float(value):.4f}")
    if stats is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stats.update(iterations=niter, evaluations=opt.evaluations if isinstance(opt, LBFGS) else evaluations,
                     loop_seconds=time.perf_counter() - t0)
    with torch.no_grad():
        return pastiche.decode_average()
