"""Texture neural cellular automata.

Port of `maua_tpu/nca/nca.py`: per-channel identity, Sobel x / y and
Laplacian perception with wrap padding, a 1x1 conv MLP update applied
through a random per-cell mask, rollouts, VGG16-gram style-matched
training with a sample pool (per-parameter gradient normalisation, optax's
Adam) and the evolution video. States are NHWC (B, H, W, chn); the convs
run NCHW. Parameters: {"w1": (hidden, 4 chn, 1, 1), "b1", "w2": (chn,
hidden, 1, 1)}. Random draws (the update masks' uniforms, the pool
indices, the rollout lengths) come from a torch.Generator, or are handed
in (`masks`, `draws`) so that both packages can be fed the same numbers.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parameterizations import clip
from ..utility import resolve_device

_IDENT = np.array([[0, 0, 0], [0, 1, 0], [0, 0, 0]], np.float32)
_SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
_LAP = np.array([[1, 2, 1], [2, -12, 2], [1, 2, 1]], np.float32)

CA_PARAMS_INIT = dict(chn=12, hidden_n=96)


def perception(x: torch.Tensor) -> torch.Tensor:
    """[identity, sobel_x, sobel_y, laplacian] of each channel with wrap padding: (B, H, W, C) ->
    (B, H, W, 4C), output channel g*4 + f the filter f of channel g (a depthwise conv, multiplier 4)."""
    c = x.shape[-1]
    filters = torch.as_tensor(np.stack([_IDENT, _SOBEL_X, _SOBEL_X.T, _LAP]), dtype=x.dtype, device=x.device)
    kern = filters.repeat(c, 1, 1)[:, None]  # (4C, 1, 3, 3)
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="circular")
    return F.conv2d(xp, kern, groups=c).permute(0, 2, 3, 1)


def init_params(gen: torch.Generator, chn: int = 12, hidden_n: int = 96) -> Dict:
    """maua_tpu's init drawn from `gen`: w1 ~ N(0, 1) / sqrt(4 chn), b1 ~ U(+-1 / sqrt(4 chn)) (a
    nonzero bias keeps the all-zero seed trainable), w2 zero."""
    scale = 1.0 / np.sqrt(chn * 4)
    dev = gen.device
    return {"w1": torch.randn(hidden_n, chn * 4, 1, 1, generator=gen, device=dev) * scale,
            "b1": (torch.rand(hidden_n, generator=gen, device=dev) * 2 - 1) * scale,
            "w2": torch.zeros(chn, hidden_n, 1, 1, device=dev)}


def ca_step(params: Dict, x: torch.Tensor, update_rate: float = 0.5, gen: Optional[torch.Generator] = None,
            u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One CA update: x + MLP(perception(x)) * floor(u + update_rate), u (B, H, W, 1) uniform from
    `gen` unless given."""
    y = perception(x).permute(0, 3, 1, 2)
    y = F.relu(F.conv2d(y, params["w1"].to(y.dtype), params["b1"].to(y.dtype)))
    y = F.conv2d(y, params["w2"].to(y.dtype)).permute(0, 2, 3, 1)
    if u is None:
        u = torch.rand(x.shape[:3] + (1,), generator=gen, device=x.device, dtype=x.dtype)
    return x + y * torch.floor(torch.as_tensor(u, device=x.device, dtype=x.dtype) + update_rate)


def seed(n: int, chn: int = 12, sz: int = 128, device=None) -> torch.Tensor:
    return torch.zeros(n, sz, sz, chn, device=device)


def to_rgb(x: torch.Tensor) -> torch.Tensor:
    return x[..., :3]


def rollout(params: Dict, x: torch.Tensor, n_steps: int, update_rate: float = 0.5,
            gen: Optional[torch.Generator] = None, masks=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """n_steps updates: (the final state, the rgb frames (n_steps, B, H, W, 3)); `masks` (n_steps,
    B, H, W, 1) holds each step's uniforms, else they come from `gen`."""
    frames = []
    for i in range(n_steps):
        x = ca_step(params, x, update_rate, gen, None if masks is None else masks[i])
        frames.append(to_rgb(x))
    return x, torch.stack(frames)


def train_nca(
    style_img,  # (1, H, W, 3) in [-1, 1]
    n_steps: int = 2000,
    rollout_steps: Tuple[int, int] = (32, 64),
    batch: int = 4,
    size: int = 128,
    lr: float = 2e-3,
    chn: int = 12,
    hidden_n: int = 96,
    pool_size: int = 256,
    gen: Optional[torch.Generator] = None,
    verbose: bool = True,
    params: Optional[Dict] = None,
    perceptor=None,
    draws: Optional[Callable] = None,
    device=None,
    stats: Optional[Dict] = None,
) -> Dict:
    """VGG16-gram style-matched NCA training with a sample pool: each step draws `batch` pool
    states without replacement (the first reset to the seed), rolls them out a random number of
    steps in [rollout_steps), matches the grams of their clipped rgb to the style image's,
    normalises each parameter's gradient, takes an Adam step and writes the states back.
    Randomness: `gen` (seed 0 on `device`, cuda unless told otherwise) draws the initial params,
    the indices, the lengths and the masks; `draws(i)` -> (indices, n_roll, masks) replaces the
    last three at step i. The perceptor is a VGGPerceptor(vgg16) from seed 0 unless given.
    `stats`, when given, receives the loop's seconds and each step's rollout length, loss, the
    largest magnitude of its rolled-out states and the share of their rgb at or past +-1 (clipped)."""
    from ..loss import gram_matrix, scaled_mse_loss
    from ..optimizers import Adam
    from ..perceptors.vgg import VGGPerceptor

    device = resolve_device(device)
    gen = gen if gen is not None else torch.Generator(device=device).manual_seed(0)
    percept = perceptor if perceptor is not None else VGGPerceptor(arch="vgg16", device=device)
    style_img = torch.as_tensor(np.asarray(style_img, np.float32) if not isinstance(style_img, torch.Tensor)
                                else style_img, device=device).float()
    with torch.no_grad():
        feats = percept.get_features(style_img)
        target_grams = [gram_matrix(feats[i]) for i in percept.style_layers]

    params = init_params(gen, chn, hidden_n) if params is None else params
    names = ("w1", "b1", "w2")
    leaves = [params[k].to(device).float().clone().requires_grad_(True) for k in names]
    opt = Adam(leaves, lr)
    pool = seed(pool_size, chn, size, device)
    rolls, losses, peaks, clipped = [], [], [], []
    t0 = time.perf_counter()
    for i in range(n_steps):
        if draws is not None:
            idx, n_roll, masks = draws(i)
            idx = torch.as_tensor(np.asarray(idx), device=device, dtype=torch.long)
        else:
            idx = torch.randperm(pool_size, generator=gen, device=gen.device)[:batch].to(device)
            n_roll = int(torch.randint(rollout_steps[0], rollout_steps[1], (), generator=gen, device=gen.device))
            masks = None
        x0 = pool[idx].clone()
        x0[0] = 0.0  # the first sample restarts from the seed
        p = dict(zip(names, leaves))
        x, _ = rollout(p, x0, int(n_roll), gen=gen, masks=masks)
        img = clip(to_rgb(x), -1.0, 1.0)
        f = percept.get_features(img)
        loss = sum(scaled_mse_loss(gram_matrix(f[j]), t.expand(img.shape[0], -1, -1))
                   for j, t in zip(percept.style_layers, target_grams))
        opt.zero_grad()
        loss.backward()
        with torch.no_grad():
            for leaf in leaves:  # per-parameter gradient normalisation
                leaf.grad /= torch.linalg.vector_norm(leaf.grad) + 1e-8
        opt.step()
        pool[idx] = x.detach()
        rolls.append(int(n_roll))
        losses.append(loss.detach())
        peaks.append(x.detach().abs().amax())
        clipped.append((to_rgb(x.detach()).abs() >= 1).float().mean())
        if verbose and i % max(n_steps // 10, 1) == 0:
            print(f"nca step {i}/{n_steps} loss {float(loss):.4f}")
    if stats is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stats.update(loop_seconds=time.perf_counter() - t0, rollouts=rolls, losses=[float(v) for v in losses],
                     state_peaks=[float(v) for v in peaks], clipped=[float(v) for v in clipped])
    return {k: v.detach() for k, v in zip(names, leaves)}


def generate_video(params: Dict, output_file: str, size: int = 256, num_frames: int = 600, chn: int = 12,
                   gen: Optional[torch.Generator] = None, masks: Optional[Callable] = None, device=None) -> str:
    """The NCA's evolution from the seed state, one frame per rollout of min(2^(k // 30), 32)
    steps, written at 24 fps. `masks(k, n)` -> the (n, 1, size, size, 1) uniforms of frame k, else
    they come from `gen` (seed 0 on `device`, cuda unless told otherwise)."""
    from ..ops.video import VideoWriter

    device = resolve_device(device)
    gen = gen if gen is not None else torch.Generator(device=device).manual_seed(0)
    params = {k: torch.as_tensor(v, device=device).float() for k, v in params.items()}
    x = seed(1, chn, size, device)
    with torch.no_grad(), VideoWriter(output_file, (size, size), fps=24, value_range=(-1, 1)) as vid:
        for k in range(num_frames):
            step_n = min(2 ** (k // 30), 32)
            x, _ = rollout(params, x, step_n, gen=gen, masks=None if masks is None else masks(k, step_n))
            vid.write(to_rgb(x[0]).clamp(-1, 1).cpu().numpy())
    return output_file


def params_to_file_layout(params: Dict) -> Dict:
    """The port's params as maua_tpu saves them: numpy, the 1x1 convs HWIO."""
    return {k: v.detach().cpu().numpy().transpose(2, 3, 1, 0) if v.dim() == 4 else v.detach().cpu().numpy()
            for k, v in params.items()}


def main(args=None):
    """Train a texture NCA on a style image and render its evolution, or render from a saved
    params file (maua_tpu's pickle: numpy arrays, HWIO convs)."""
    import argparse
    import pickle
    from pathlib import Path

    from ..bridge import nca_params_to_torch
    from ..ops.io import load_image

    parser = argparse.ArgumentParser(description="texture neural cellular automata")
    parser.add_argument("--style", type=str, default=None, help="style image to train on")
    parser.add_argument("--params", type=str, default=None, help="load trained params instead of training")
    parser.add_argument("--n_steps", default=2000, type=int)
    parser.add_argument("--train_size", default=128, type=int)
    parser.add_argument("--size", default=256, type=int, help="render resolution")
    parser.add_argument("--num_frames", default=600, type=int)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--out_dir", default="output/", type=str)
    parser.add_argument("--device", default=None, type=str, help="cuda unless told otherwise")
    args = parser.parse_args(args)

    device = resolve_device(args.device)
    Path(args.out_dir).mkdir(parents=True, exist_ok=True)
    if args.params is not None:
        with open(args.params, "rb") as f:
            params = nca_params_to_torch(pickle.load(f), device)
        stem = Path(args.params).stem
    elif args.style is not None:
        img = load_image(args.style) * 2.0 - 1.0
        params = train_nca(img, n_steps=args.n_steps, size=args.train_size,
                           gen=torch.Generator(device=device).manual_seed(args.seed), device=device)
        stem = Path(args.style).stem
        with open(f"{args.out_dir}/{stem}_nca.pkl", "wb") as f:
            pickle.dump(params_to_file_layout(params), f)
    else:
        parser.error("pass --style (train) or --params (render)")

    out_file = generate_video(params, f"{args.out_dir}/{stem}_nca.mp4", size=args.size, num_frames=args.num_frames,
                              gen=torch.Generator(device=device).manual_seed(args.seed), device=device)
    print(out_file)
    return 0


if __name__ == "__main__":
    main()
