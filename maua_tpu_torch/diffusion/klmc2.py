"""KLMC2 animation: kinetic Langevin MCMC over the diffusion score field.

Port of `maua_tpu/diffusion/klmc2.py` (score_from_denoiser,
sample_mcmc_klmc2, klmc2_animation, main): second-order (underdamped)
Langevin dynamics in latent space driven by the denoiser's score,
score(x) = (denoised(x, sigma) - x) / sigma^2, minus `alpha` x with the
quadratic penalty. With `use_hvp` each step adds half a step of the score's
Hessian-vector product with the velocity, taken in forward mode by
`torch.func.jvp` (the reference's `jax.jvp`); through the UNet that reaches
the flash-attention kernel's forward-mode rule (`kernels/attention.py`),
the kernel's forward with a recomputed f32 tangent. The injected noise is
drawn from a generator, or given (`noises`, one standard normal latent per
step).

    python -m maua_tpu_torch diffusion klmc2 "a lighthouse" --n 120 --size 512,512
"""

from __future__ import annotations

import argparse
import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch


def score_from_denoiser(denoiser: Callable, sigma: float) -> Callable:
    """score(x) = (denoised - x) / sigma^2."""

    def score(x):
        s = sigma * torch.ones(x.shape[0], device=x.device)
        return (denoiser(x, s) - x) / sigma**2

    return score


def sample_mcmc_klmc2(
    denoiser: Callable,  # (x, sigma_batch) -> denoised
    x0: torch.Tensor,
    sigma: float = 1.0,
    n_steps: int = 100,
    step_size: float = 0.05,
    friction: float = 1.0,
    alpha: float = 0.0,
    tau: float = 1.0,
    use_hvp: bool = True,
    gen: Optional[torch.Generator] = None,
    noises: Optional[Sequence] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x'' = score(x) - gamma x' + sqrt(2 gamma tau) noise, integrated with a
    second-order scheme: v <- v e^(-gamma h) + h (score + h/2 H v) +
    sqrt(1 - e^(-2 gamma h)) sqrt(tau) noise; x <- x + h v. `alpha` adds the
    quadratic penalty (score -= alpha x), `tau` scales the noise's
    temperature. Returns (final x, trajectory (n_steps, ...))."""
    base_score = score_from_denoiser(denoiser, sigma)
    score = (lambda x: base_score(x) - alpha * x) if alpha > 0 else base_score
    h = step_size
    decay, kick = math.exp(-friction * h), math.sqrt(1 - math.exp(-2 * friction * h))
    x, v = x0, torch.zeros_like(x0)
    traj = []
    for i in range(n_steps):
        if use_hvp:  # d score / dt = H v, in forward mode
            s, hvp = torch.func.jvp(score, (x,), (v,))
            s = s + 0.5 * h * hvp
        else:
            s = score(x)
        if noises is not None:
            noise = torch.as_tensor(np.array(noises[i]), dtype=x.dtype, device=x.device)
        else:
            noise = torch.randn(x.shape, generator=gen, device=x.device)
        v = v * decay + h * s + kick * (noise * math.sqrt(tau))
        x = x + h * v
        traj.append(x)
    return x, torch.stack(traj)


@torch.no_grad()
def klmc2_animation(
    diffusion,
    shape: Tuple[int, int] = (64, 64),
    n_frames: int = 64,
    sigma: float = 1.0,
    step_size: float = 0.05,
    batch_decode: int = 8,
    text: Optional[str] = None,
    cond_scale: float = 1.0,
    friction: float = 1.0,
    alpha: float = 0.0,
    tau: float = 1.0,
    use_hvp: bool = True,
    gen: Optional[torch.Generator] = None,
    x0=None,
    noises: Optional[Sequence] = None,
) -> np.ndarray:
    """A latent KLMC2 trajectory through the Stable Diffusion processor's
    score field (its CFG denoiser for `text` at `cond_scale`), one frame per
    step, decoded in batches. The start is sigma times a standard normal
    latent, `x0` (NCHW) or a draw from `gen`. Returns (n_frames, H, W, 3) in
    [-1, 1]."""
    from ..prompt import TextPrompt
    from .wrappers import cfg_denoiser

    dev = diffusion.device
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    ds = diffusion.vae_cfg.downscale
    if x0 is None:
        x0 = torch.randn((1, diffusion.vae_cfg.z_channels, shape[0] // ds, shape[1] // ds), generator=gen, device=dev)
    x0 = torch.as_tensor(np.array(x0) if not isinstance(x0, torch.Tensor) else x0, device=dev).float() * sigma
    cond, uncond = diffusion.conditioning([TextPrompt(text)] if text else [])
    model_fn = cfg_denoiser(diffusion.denoiser, cond, uncond, cond_scale)
    _, traj = sample_mcmc_klmc2(model_fn, x0, sigma=sigma, n_steps=n_frames, step_size=step_size, friction=friction,
                                alpha=alpha, tau=tau, use_hvp=use_hvp, gen=gen, noises=noises)
    frames = []
    for i in range(0, n_frames, batch_decode):
        frames.append(diffusion.decode(traj[i : i + batch_decode, 0]).permute(0, 2, 3, 1).float().cpu().numpy())
    return np.concatenate(frames)


def main(args=None):
    from ..ops.video import write_video
    from .image import get_diffusion_model

    parser = argparse.ArgumentParser(description="KLMC2 latent-space animation",
                                     formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("prompt", type=str)
    parser.add_argument("--cond_scale", type=float, default=5.0, help="prompt conditioning strength")
    parser.add_argument("--n", default=120, type=int, help="frames to sample")
    parser.add_argument("--fps", default=20, type=int)
    parser.add_argument("--sigma", default=0.75, type=float, help="noise level to sample at")
    parser.add_argument("--h", default=0.2, type=float, help="step size (0 to 1)")
    parser.add_argument("--gamma", default=0.5, type=float, help="friction (lower -> smoother)")
    parser.add_argument("--alpha", default=1e-3, type=float, help="quadratic penalty (weight decay) strength")
    parser.add_argument("--tau", default=1.0, type=float, help="temperature (noise added per step)")
    parser.add_argument("--hvp_method", default="forward", choices=["forward", "zero"],
                        help="'forward' = real jvp Hessian-vector products, 'zero' = first-order KLMC")
    parser.add_argument("--model_path", default=None, type=str,
                        help="custom stable-diffusion checkpoint to load (CompVis format)")
    parser.add_argument("--size", default="512,512", type=str)
    parser.add_argument("--seed", default=0, type=int, help="seed of the random weights and of the chain")
    parser.add_argument("--device", default=None, type=str, help='default "cuda"; "cpu" runs the plain versions')
    parser.add_argument("--out_dir", default="output/", type=str)
    args = parser.parse_args(args)

    from pathlib import Path

    weights = {}
    if args.model_path is not None:  # (the reference passes the path where a processor name goes, and raises)
        from .load import load_stable_diffusion

        weights = dict(zip(("unet_params", "vae_params", "text_params"), load_stable_diffusion(args.model_path)))
    diffusion = get_diffusion_model("stable", timesteps=50, device=args.device, seed=args.seed, **weights)
    shape = tuple(int(s) for s in args.size.split(","))
    frames = klmc2_animation(
        diffusion, shape=shape, n_frames=args.n, sigma=args.sigma, step_size=args.h, text=args.prompt,
        cond_scale=args.cond_scale, friction=args.gamma, alpha=args.alpha, tau=args.tau,
        use_hvp=args.hvp_method == "forward", gen=torch.Generator(device=diffusion.device).manual_seed(args.seed),
    )
    Path(args.out_dir).mkdir(parents=True, exist_ok=True)
    out_file = f"{args.out_dir}/{args.prompt.replace(' ', '_')}_klmc2.mp4"
    write_video(frames, out_file, fps=args.fps, value_range=(-1, 1))
    print(out_file)
    return 0


if __name__ == "__main__":
    main()
