"""GAN training fit loop: EWMA logging, periodic evaluation, metric-gated LR decay,
early stopping and scored checkpoints.

Port of `maua_tpu/gan/train_loop.py`. A checkpoint is one `torch.save`
file of the whole train state (both networks, the EMA, both Adam states,
`pl_mean`, `step`), moved to the CPU; `load_checkpoint` puts it back on a
device. The fit's random draws (the ADA augmentation's, the train step's,
the evaluation latents) come from one torch.Generator.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Dict, Optional

import numpy as np
import torch

from ..utility import to_device
from . import stylegan2 as sg2
from . import training as tr
from .data import ImageDataset, augment_batch
from .discriminator import D2Config
from .metrics import compute_metrics


def save_checkpoint(path: str, state: Dict) -> None:
    """The whole train state as one torch.save file at `path` (tensors on the CPU)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(to_device(state, "cpu"), path)


def load_checkpoint(path: str, device=None) -> Dict:
    """A train state written by save_checkpoint, its tensors on `device` (the CPU unless given)."""
    return to_device(torch.load(path, map_location="cpu", weights_only=False), torch.device(device or "cpu"))


@dataclass
class FitConfig:
    total_steps: int = 10_000
    eval_every: int = 1_000
    log_every: int = 50
    ewma_beta: float = 0.9
    lr_decay_factor: float = 0.5
    lr_patience: int = 3  # evals without improvement before decay
    early_stop_patience: int = 10
    n_eval_images: int = 64
    out_dir: str = "workspace/gan_training"
    augment_p: float = 0.2
    ckpt_every: int = 0  # periodic scored checkpoints (0 = best / final only)
    ckpt_top_k: int = 10  # periodic checkpoints kept
    monitor_metric: str = "fid"  # the metric (lower is better) gating lr decay, early stop and top-k


def fit(
    dataset: ImageDataset,
    g_cfg: sg2.SG2Config,
    d_cfg: D2Config,
    t_cfg: tr.TrainConfig = tr.TrainConfig(),
    fit_cfg: FitConfig = FitConfig(),
    state: Optional[Dict] = None,
    gen: Optional[torch.Generator] = None,
    verbose: bool = True,
) -> Dict:
    """Train on the dataset's device until total_steps or an early stop; returns the final state. The
    first n_eval_images of one epoch are the evaluation's reals; every eval_every steps (and at the last)
    the EMA generator's images are scored (compute_metrics), a grid of 16 is written, the monitor metric
    gates the LR decay, early stop and top-k periodic checkpoints, and `ckpt_best.pt` follows the best;
    `ckpt_final.pt` is written at the end."""
    device = dataset.device
    gen = gen if gen is not None else torch.Generator(device=device).manual_seed(0)
    if state is None:
        state = tr.init_train_state(g_cfg, d_cfg, t_cfg, gen)
    state = to_device(state, device)
    os.makedirs(fit_cfg.out_dir, exist_ok=True)

    ewma: Dict[str, float] = {}
    best_score = float("inf")
    evals_since_best = 0
    lr_scale = 1.0
    kept_ckpts = []  # (monitor score, path) of periodic checkpoints, lower is better
    step = int(state["step"])
    data_iter = iter(dataset)

    reals = []
    for batch in dataset:
        reals.append(batch)
        if sum(r.shape[0] for r in reals) >= fit_cfg.n_eval_images:
            break
    reals = torch.cat(reals)[: fit_cfg.n_eval_images]

    while step < fit_cfg.total_steps:
        try:
            batch = next(data_iter)
        except StopIteration:
            data_iter = iter(dataset)
            batch = next(data_iter)
        if fit_cfg.augment_p > 0:
            batch = augment_batch(gen, batch, p_translate=fit_cfg.augment_p)

        state, metrics = tr.train_step(state, batch, g_cfg, d_cfg, t_cfg, gen=gen)
        step += 1

        if step % fit_cfg.log_every == 0:
            for k, v in metrics.items():
                v = float(v)
                ewma[k] = v if k not in ewma else fit_cfg.ewma_beta * ewma[k] + (1 - fit_cfg.ewma_beta) * v
            if verbose:
                msg = " ".join(f"{k}={v:.4f}" for k, v in ewma.items())
                print(f"step {step}: {msg} lr_scale={lr_scale:.3f}")

        if step % fit_cfg.eval_every == 0 or step == fit_cfg.total_steps:
            z = torch.randn(fit_cfg.n_eval_images, g_cfg.z_dim, generator=gen, device=gen.device).to(device)
            with torch.no_grad():
                fakes = torch.cat([tr.generate(state["g_ema"], z[i : i + 16], g_cfg)
                                   for i in range(0, fit_cfg.n_eval_images, 16)])
            scores = compute_metrics(reals, fakes, batch=16, device=device)
            if verbose:
                print(f"eval @ {step}: " + " ".join(f"{k}={v:.4f}" for k, v in scores.items()))

            from ..ops.io import tensor2img

            n = min(16, len(fakes))
            side = int(np.ceil(np.sqrt(n)))
            imgs = ((fakes[:n].float().permute(0, 2, 3, 1) + 1) / 2).cpu().numpy()
            h, w = imgs.shape[1:3]
            grid = np.zeros((side * h, side * w, 3), np.float32)
            for i in range(n):
                r, c = divmod(i, side)
                grid[r * h : (r + 1) * h, c * w : (c + 1) * w] = imgs[i]
            tensor2img(np.clip(grid, 0, 1)[None]).save(f"{fit_cfg.out_dir}/grid_{step:07d}.png")

            monitor = scores.get(fit_cfg.monitor_metric, scores["fid"])
            if fit_cfg.ckpt_every > 0 and step % fit_cfg.ckpt_every == 0:
                path = f"{fit_cfg.out_dir}/ckpt_{step:07d}.pt"
                save_checkpoint(path, state)
                kept_ckpts.append((monitor, path))
                kept_ckpts.sort(key=lambda sp: sp[0])
                while len(kept_ckpts) > fit_cfg.ckpt_top_k:
                    _, worst = kept_ckpts.pop()
                    if os.path.exists(worst):
                        os.remove(worst)

            if monitor < best_score:
                best_score = monitor
                evals_since_best = 0
                save_checkpoint(f"{fit_cfg.out_dir}/ckpt_best.pt", state)
            else:
                evals_since_best += 1
                if evals_since_best % fit_cfg.lr_patience == 0:
                    lr_scale *= fit_cfg.lr_decay_factor
                    t_cfg = replace(t_cfg, g_lr=t_cfg.g_lr * fit_cfg.lr_decay_factor,
                                    d_lr=t_cfg.d_lr * fit_cfg.lr_decay_factor)
                if evals_since_best >= fit_cfg.early_stop_patience:
                    if verbose:
                        print(f"early stop at step {step} (best {fit_cfg.monitor_metric} {best_score:.3f})")
                    break
    save_checkpoint(f"{fit_cfg.out_dir}/ckpt_final.pt", state)
    return state
