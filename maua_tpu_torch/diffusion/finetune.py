"""Stable Diffusion finetuning on an image / caption set.

Port of `maua_tpu/diffusion/finetune.py`: a train step over the
eps-prediction objective (`q_sample`, the UNet under autograd, AdamW with
optax's formulas from `transforms.adamw`), EMA weights, checkpoint and
resume as one `torch.save` file, and a validation-sample hook that samples
with the EMA weights. On a card the UNet's attention runs the kernel
forward under autograd through `kernels/attention.FlashAttention`, whose
recomputed backward carries the gradient. (maua_tpu differentiates its
UNet through a Pallas kernel that has no reverse-mode rule, so on a TPU its
step cannot run; JAX off the TPU differentiates the XLA attention, which
the tests hold this step against.)

The step takes the timesteps, noise and batch indices explicitly;
`finetune` draws them from a torch.Generator unless `draws` gives them.
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from .. import transforms as T
from ..gan.training import _adam_step, _with_grad, tree_leaves, tree_map, tree_unflatten
from ..text.clip_text import encode_text, tokenize
from ..utility import to_device
from .models import unet as unet_mod
from .processors.stable import _to_nchw
from .samplers import q_sample


def train_step(unet_params, opt_state, tx: T.GradientTransformation, latents: torch.Tensor, context: torch.Tensor,
               t: torch.Tensor, noise: torch.Tensor, alphas_cumprod, unet_cfg):
    """One AdamW step on mean((unet(q_sample(latents, t, noise), t, context) - noise)^2). latents and noise
    are NCHW, t (B,) integer timesteps. Returns (params, opt_state, loss)."""
    ac = torch.as_tensor(np.asarray(alphas_cumprod, np.float32), device=latents.device)
    x_t = q_sample(latents, ac[t], noise)
    params, leaves = _with_grad(unet_params)
    eps = unet_mod.forward(params, x_t, t.float(), unet_cfg, context)
    loss = torch.mean(torch.square(eps - noise))
    new, opt_state = _adam_step(tx, opt_state, leaves, loss)
    return tree_unflatten(unet_params, new), opt_state, loss.detach()


def ema_update(ema, params, decay: float):
    return tree_map(lambda e, q: decay * e + (1 - decay) * q, ema, params)


def save_checkpoint(path: str, state) -> None:
    """The finetune state ({params, ema, opt, step}) as one torch.save file, tensors on the CPU; the
    directory is made if missing."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(to_device(state, "cpu"), path)


def load_checkpoint(path: str, device=None):
    return to_device(torch.load(path, map_location="cpu", weights_only=False), torch.device(device or "cpu"))


def finetune(diffusion, images: np.ndarray, captions, n_steps: int = 1000, batch_size: int = 4, lr: float = 1e-5,
             ema_decay: float = 0.999, save_every: int = 0, checkpoint_dir: Optional[str] = None, resume: bool = False,
             sample_every: int = 0, sample_hook: Optional[Callable] = None, sample_text: Optional[str] = None,
             gen: Optional[torch.Generator] = None, draws: Optional[Iterator] = None, verbose: bool = True):
    """Finetune the UNet of a StableDiffusion processor on (image, caption) pairs: images (N, H, W, 3) in
    [-1, 1]. Each step takes (batch indices, timesteps, NCHW noise) from `draws` where given, else draws
    them from `gen` (seed 0 on the processor's device). The state is saved to
    `checkpoint_dir/finetune_last.pt` every `save_every` steps and at the end, and read back there with
    `resume`; `sample_hook(step, images NHWC)` gets an image sampled with the EMA weights every
    `sample_every` steps. Returns (params, ema); the processor is left holding the EMA weights."""
    device = diffusion.device
    gen = gen if gen is not None else torch.Generator(device=device).manual_seed(0)
    tx = T.adamw(lr)
    state = {"params": diffusion.unet_params, "ema": tree_map(torch.clone, diffusion.unet_params),
             "opt": tx.init(tree_leaves(diffusion.unet_params)), "step": 0}
    ckpt_path = os.path.join(checkpoint_dir, "finetune_last.pt") if checkpoint_dir else None
    if resume and ckpt_path and os.path.exists(ckpt_path):
        state = load_checkpoint(ckpt_path, device)
        if verbose:
            print(f"resumed finetune at step {state['step']}")

    # latents and text embeddings once
    with torch.no_grad():
        latents = torch.cat([diffusion.encode(_to_nchw(images[i: i + batch_size], device))
                             for i in range(0, len(images), batch_size)])
        cl = diffusion.text_cfg.context_length
        contexts = torch.cat([encode_text(diffusion.text_params, tokenize(c, cl), diffusion.text_cfg)
                              for c in captions])

    def maybe_sample(step):
        if sample_hook is None or sample_every <= 0 or step % sample_every:
            return
        from ..prompt import TextPrompt

        prev, diffusion.unet_params = diffusion.unet_params, state["ema"]
        prompts = [TextPrompt(sample_text or (captions[0] if len(captions) else ""))]
        imgs = diffusion.forward(np.zeros((1, diffusion.image_size, diffusion.image_size, 3), np.float32), prompts,
                                 t_start=0.0, verbose=False)
        diffusion.unet_params = prev
        sample_hook(step, imgs.cpu().numpy())

    n = latents.shape[0]
    b = min(batch_size, n)
    for step in range(state["step"], n_steps):
        if draws is not None:
            idx, t, noise = (torch.as_tensor(np.asarray(a), device=device) for a in next(draws))
        else:
            idx = torch.randint(0, n, (b,), generator=gen, device=device)
            t = torch.randint(0, len(diffusion.alphas_cumprod), (b,), generator=gen, device=device)
            noise = torch.randn((b,) + tuple(latents.shape[1:]), generator=gen, device=device)
        params, opt, loss = train_step(state["params"], state["opt"], tx, latents[idx.long()], contexts[idx.long()],
                                       t.long(), noise.float(), diffusion.alphas_cumprod, diffusion.unet_cfg)
        state = {"params": params, "ema": ema_update(state["ema"], params, ema_decay), "opt": opt, "step": step + 1}
        if verbose and step % max(n_steps // 10, 1) == 0:
            print(f"finetune step {step}/{n_steps} loss {float(loss):.5f}")
        if ckpt_path and save_every > 0 and (step + 1) % save_every == 0:
            save_checkpoint(ckpt_path, state)
        maybe_sample(step + 1)

    if ckpt_path:
        save_checkpoint(ckpt_path, state)
    diffusion.unet_params = state["ema"]
    return state["params"], state["ema"]
