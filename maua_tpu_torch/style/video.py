"""Flow-consistent video style transfer (Ruder et al.'s multi-pass method).

Port of `maua_tpu/style/video.py`: every frame optimized in passes of
alternating direction; on the middle passes the previous frame's output,
warped along the optical flow, is blended into the frame's start where the
flow is consistent, and after pass `temporal_loss_after` a temporal loss
holds the frame to it. `n_iters` is each frame's total, split over the
passes. Flows come from `preprocess_optical_flow` (cached in
`utility.WORKSPACE`) with any of `get_flow_model`'s estimators. A seeded
`np.random.RandomState(0)` picks each pass's start frame when
`start_random_frame`.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..flow.lib import flow_warp_map, preprocess_optical_flow
from ..flow.models import get_flow_model
from ..loss import gram_matrix, scaled_mse_loss, tv_loss
from ..ops.image import match_histogram, resample
from ..ops.io import load_images
from ..ops.warp import grid_sample, resize
from ..optimizers import load_optimizer
from ..parameterizations import load_parameterization
from ..utility import resolve_device
from .image import build_perceptor, style_targets, to_image


def transfer(
    video_file: str,
    style_imgs: List,
    size: int = 256,
    n_passes: int = 4,
    n_iters: int = 64,
    temporal_weight: float = 50.0,
    content_weight: float = 1.0,
    style_weight: float = 50.0,
    tv_weight: float = 10.0,
    parameterization: str = "rgb",
    perceptor: str = "kbc-vgg19",
    perceptor_kwargs=None,
    optimizer: str = "adam",
    optimizer_kwargs=None,
    lr: float = 0.05,
    flow_models=("farneback",),
    max_frames: Optional[int] = None,
    init_type: str = "content",
    init_video=None,
    match_hist: str = "False",
    style_scale: float = 1.0,
    temporal_loss_after: int = -1,
    blend_factor: float = 1.0,
    start_random_frame: bool = False,
    save_intermediate: Optional[str] = None,
    fps: float = 24.0,
    verbose: bool = True,
    gen: Optional[torch.Generator] = None,
    device=None,
    stage_times: Optional[Dict[str, float]] = None,
) -> np.ndarray:
    """Stylized frames (T, H, W, 3) in [-1, 1], computed on `device` (cuda unless told otherwise;
    Farneback flow on the host). Random draws (the parameterization's, a random start) come from
    `gen` (seed 0 on `device`). `stage_times`, when given, receives the seconds of the flow
    ("flow") and of the passes ("passes")."""
    device = resolve_device(device)
    gen = gen if gen is not None else torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    frames, forward, backward, reliable = preprocess_optical_flow(
        video_file, get_flow_model(flow_models, device=device), max_frames=max_frames)
    t_flow = time.perf_counter() - t0
    n = len(frames)
    (styles,) = load_images(list(style_imgs))
    styles = [resample(to_image(im, device), int(size * style_scale)) for im in styles]

    percept = build_perceptor(perceptor, perceptor_kwargs, device)
    targets = style_targets(percept, styles)
    contents = [resample(to_image(f[None], device), size) for f in np.asarray(frames)]
    h, w = contents[0].shape[1], contents[0].shape[2]

    def fit_flow(fl):
        fl = torch.as_tensor(np.asarray(fl, np.float32), device=device)
        scale = torch.tensor([w / fl.shape[1], h / fl.shape[0]], device=device)
        return resize(fl.permute(2, 0, 1)[None], (h, w), "bilinear")[0].permute(1, 2, 0) * scale

    def fit_mask(m):
        m = torch.as_tensor(np.asarray(m, np.float32), device=device)
        return resize(m[None, None], (h, w), "bilinear")[0].permute(1, 2, 0)  # (h, w, 1)

    def hist(img):
        return match_histogram(img, styles, mode=match_hist) if match_hist not in ("False", False) else img

    # n_iters is each frame's total, split evenly across the passes
    factory, niter = load_optimizer(optimizer, lr, optimizer_kwargs, max(n_iters // n_passes, 1))
    # one pastiche for every frame, re-encoded from each frame's start
    pastiche = load_parameterization(parameterization)(h, w, gen=gen, device=device)

    def optimize(content_targets, temporal_target, temporal_mask, t_weight):
        opt = factory(pastiche.params())

        def closure():
            opt.zero_grad()
            img = pastiche.decode()
            feats = percept.get_features(img)
            loss = tv_weight * tv_loss(img)
            for i, t in zip(percept.content_layers, content_targets):
                loss = loss + content_weight * scaled_mse_loss(feats[i], t)
            for i, t in zip(percept.style_layers, targets):
                loss = loss + style_weight * scaled_mse_loss(gram_matrix(feats[i]), t)
            loss = loss + t_weight * (temporal_mask * (img - temporal_target).square()).mean()
            loss.backward()
            return loss

        for _ in range(niter):
            if getattr(opt, "closure_step", False):
                opt.step(closure)
            else:
                closure()
                opt.step()
        with torch.no_grad():
            return torch.clamp(pastiche.decode(), -1, 1)

    def content_targets_of(content):
        with torch.no_grad():
            feats = percept.get_features(content)
        return [feats[i] for i in percept.content_layers]

    # the frames' starts
    if init_type == "random":
        outputs = [torch.rand(c.shape, generator=gen, device=device) * 0.2 - 1.0 for c in contents]
    elif init_type == "init_video" and init_video is not None:
        if isinstance(init_video, str):
            from ..ops.video import read_video

            init_video, _ = read_video(init_video, max_frames=n)
        outputs = [resample(to_image(np.asarray(init_video)[i][None], device), size) for i in range(n)]
    else:  # content and prev_warped start from the content
        outputs = list(contents)

    rng = np.random.RandomState(0)
    zero_t = torch.zeros_like(contents[0])
    zero_m = torch.zeros((1, h, w, 1), device=device)
    t0 = time.perf_counter()
    for pass_n in range(n_passes):
        forward_dir = pass_n % 2 == 0
        order = list(range(n)) if forward_dir else list(range(n - 1, -1, -1))
        if start_random_frame:
            si = rng.randint(n)
            order = order[si:] + order[:si]
        using_blending = blend_factor > 0 and 0 < pass_n < n_passes - 1
        using_temporal = temporal_weight > 0 and pass_n > temporal_loss_after
        for f_i in order:
            prev_i = (f_i - 1) % n if forward_dir else (f_i + 1) % n
            if using_blending or using_temporal or init_type == "prev_warped":
                # pull the previous output into this frame along the flow sampled at this frame
                # towards the previous one: backward[prev_i] forward, forward[f_i] backward
                flow = backward[prev_i] if forward_dir else forward[f_i]
                rel = reliable[prev_i] if forward_dir else reliable[f_i]
                warp = flow_warp_map(fit_flow(flow)).to(device)
                warped_prev = grid_sample(outputs[prev_i].permute(0, 3, 1, 2), warp,
                                          padding_mode="border").permute(0, 2, 3, 1)
                mask = torch.clamp(fit_mask(rel), 0, 1)
            else:
                warped_prev, mask = zero_t, zero_m
            init = warped_prev if init_type == "prev_warped" else outputs[f_i]
            if using_blending:
                blend_mask = blend_factor * mask
                init = (init + blend_mask * warped_prev) / (1 + blend_mask)
            pastiche.encode(hist(init))
            t_w = temporal_weight if using_temporal else 0.0
            outputs[f_i] = hist(optimize(content_targets_of(contents[f_i]), warped_prev, mask, t_w))
        if verbose:
            print(f"pass {pass_n + 1}/{n_passes} done")
        if save_intermediate:
            from ..ops.video import write_video

            write_video(np.concatenate([o.cpu().numpy() for o in outputs]), save_intermediate, fps=fps)
    if stage_times is not None:
        stage_times.update(flow=t_flow, passes=time.perf_counter() - t0)
    return np.concatenate([o.cpu().numpy() for o in outputs])


def main(args=None):
    """`python -m maua_tpu_torch style video --video_file clip.mp4 --styles s.png`: writes
    {out_dir}/{video}_{style}.mp4."""
    import argparse
    from pathlib import Path

    from ..ops.video import write_video
    from ..utility import parse_kwarg_list

    # fmt: off
    parser = argparse.ArgumentParser(description="flow-consistent video style transfer")
    parser.add_argument("--video_file", "--content", dest="video_file", required=True, type=str)
    parser.add_argument("--styles", required=True, nargs="+", type=str)
    parser.add_argument("--init_type", default="content", choices=["content", "random", "prev_warped", "init_video"])
    parser.add_argument("--init_video", default=None, type=str)
    parser.add_argument("--match_hist", default="avg", type=str)
    parser.add_argument("--size", default=256, type=int)
    parser.add_argument("--n_passes", default=4, type=int)
    parser.add_argument("--n_iters", default=64, type=int)
    parser.add_argument("--temporal_loss_after", default=-1, type=int)
    parser.add_argument("--blend_factor", default=1.0, type=float)
    parser.add_argument("--temporal_weight", default=50.0, type=float)
    parser.add_argument("--content_weight", default=1.0, type=float)
    parser.add_argument("--style_weight", default=50.0, type=float)
    parser.add_argument("--tv_weight", default=10.0, type=float)
    parser.add_argument("--parameterization", default="rgb", type=str)
    parser.add_argument("--style_scale", default=1.0, type=float)
    parser.add_argument("--perceptor", default="kbc-vgg19", type=str)
    parser.add_argument("--perceptor_kwargs", nargs="*", default=[])
    parser.add_argument("--flow_models", nargs="+", default=["farneback"])
    parser.add_argument("--optimizer", default="adam", type=str)
    parser.add_argument("--optimizer_kwargs", nargs="*", default=[])
    parser.add_argument("--lr", default=0.05, type=float)
    parser.add_argument("--max_frames", default=None, type=int)
    parser.add_argument("--start_random_frame", action="store_true")
    parser.add_argument("--save_intermediate", action="store_true")
    parser.add_argument("--fps", default=24, type=float)
    parser.add_argument("--out_dir", default="output/", type=str)
    parser.add_argument("--device", default=None, type=str, help="cuda unless told otherwise")
    args = parser.parse_args(args)
    # fmt: on

    out_file = f"{args.out_dir}/{Path(args.video_file).stem}_{Path(args.styles[0]).stem}.mp4"
    Path(args.out_dir).mkdir(parents=True, exist_ok=True)
    video = transfer(
        args.video_file, args.styles, size=args.size, n_passes=args.n_passes, n_iters=args.n_iters,
        temporal_weight=args.temporal_weight, content_weight=args.content_weight, style_weight=args.style_weight,
        tv_weight=args.tv_weight, parameterization=args.parameterization, perceptor=args.perceptor,
        perceptor_kwargs=parse_kwarg_list(args.perceptor_kwargs), optimizer=args.optimizer,
        optimizer_kwargs=parse_kwarg_list(args.optimizer_kwargs), lr=args.lr, max_frames=args.max_frames,
        flow_models=tuple(args.flow_models), init_type=args.init_type, init_video=args.init_video,
        match_hist=args.match_hist, style_scale=args.style_scale, temporal_loss_after=args.temporal_loss_after,
        blend_factor=args.blend_factor, start_random_frame=args.start_random_frame,
        save_intermediate=out_file.replace(".mp4", "_intermediate.mp4") if args.save_intermediate else None,
        fps=args.fps, device=args.device)
    write_video(video, out_file, fps=args.fps)
    print(out_file)
    return 0
