"""Direct multi-pass diffusion video loop.

Port of `maua_tpu/diffusion/loop_direct.py` (_warp, _blend_init,
loop_direct_sample, main): instead of one flow-warped pass, the whole video
is partially denoised in passes of `blend_every` steps each. Between passes
each frame's init is blended with the flow-warped previous output, weighted
by the consistency mask; the direction alternates (forward, then backward
flow) and each pass starts at a random frame (the reference's
`np.roll(frame_range, randint)`), so that consistency errors do not gather
at a fixed seam. `turbo` diffuses every turbo'th frame and warps the rest.
Images are NHWC in [-1, 1] on the processor's device.

    python -m maua_tpu_torch diffusion loop --init clip.mp4 --text "an oil painting" --blend_every 0.1
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from .. import utility
from ..flow.lib import flow_warp_map, get_consistency_map, preprocess_optical_flow
from ..flow.models import get_flow_model
from ..ops.warp import grid_sample, resize
from ..prompt import ContentPrompt, StylePrompt, TextPrompt


def _warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp img (1, H, W, C) by pixel flow (H, W, 2), border padded."""
    return grid_sample(img.permute(0, 3, 1, 2), flow_warp_map(flow), padding_mode="border").permute(0, 2, 3, 1)


def _blend_init(init_img, prev_img, flow, reliable, consistency_trust: float, blend: float) -> torch.Tensor:
    """init' = (init + mask warp(prev)) / (1 + mask), with
    mask = (reliable trust + 1 - trust) blend."""
    mask = (reliable[None, :, :, None] * consistency_trust + (1.0 - consistency_trust)) * blend
    return (init_img + mask * _warp(prev_img, flow)) / (1.0 + mask)


def loop_direct_sample(
    diffusion,
    video_file: str,
    text: Optional[str] = None,
    style_img: Optional[str] = None,
    size=(256, 256),
    timesteps: int = 100,
    skip: float = 0.4,
    blend_every: Optional[float] = None,
    blend: float = 2.0,
    consistency_trust: float = 0.75,
    turbo: int = 1,
    flow_models=("farneback",),
    max_frames: Optional[int] = None,
    write_intermediate: bool = False,
    fps: float = 12,
    out_file: Optional[str] = None,
    verbose: bool = True,
    seed: int = 0,
    rolls: Optional[Sequence[int]] = None,
    frame_noises: Optional[Sequence] = None,
    stage_times: Optional[dict] = None,
) -> np.ndarray:
    """Multi-pass flow-consistent video diffusion. Returns (N, H, W, 3)
    frames in [-1, 1] (and writes `out_file` when given). `blend_every` < 1
    is a fraction of `timesteps`, >= 1 a step count, None one pass over all
    round((1 - skip) timesteps) steps. Each pass's starting roll (in
    [1, max(N, 2))) and the processor's draws come from a generator seeded
    with `seed`; `rolls` (one per pass) and `frame_noises` (each diffused
    frame's processor `noise`, in call order) replace them. `stage_times`
    collects the flow's seconds ("flow")."""
    dev = diffusion.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, w = size
    turbo = max(1, int(turbo))
    n_steps = round((1.0 - skip) * timesteps)
    if blend_every is None:
        blend_every = n_steps
    elif blend_every < 1:
        blend_every = max(1, round(blend_every * timesteps))
    else:
        blend_every = int(blend_every)

    clock = utility.StageClock(dev, stage_times)

    def flows():
        frames, forward, backward, reliable_fwd = preprocess_optical_flow(
            video_file, get_flow_model(flow_models, device=dev), max_frames=max_frames)
        # the reliability of the backward transitions (occlusions differ by direction)
        reliable_bwd = np.stack([get_consistency_map(np.asarray(b), np.asarray(f)).cpu().numpy()
                                 for f, b in zip(forward, backward)]).astype(np.float32)
        return frames, forward, backward, reliable_fwd, reliable_bwd

    frames, forward, backward, reliable_fwd, reliable_bwd = clock.stage("flow", flows)
    n = len(frames)

    def fit(x):  # (H', W', C) host array -> (h, w, C) on the device, bilinear
        x = torch.as_tensor(np.array(x, np.float32), device=dev)
        return resize(x.permute(2, 0, 1)[None], (h, w), "bilinear")[0].permute(1, 2, 0)

    def fit_flow(fl):
        return fit(fl) * torch.tensor([w / fl.shape[1], h / fl.shape[0]], dtype=torch.float32, device=dev)

    content = [fit(f)[None] * 2.0 - 1.0 for f in frames]
    old = list(content)
    style_prompt = StylePrompt(path=style_img, size=(h, w)) if style_img else None
    n_calls = 0

    direction = 1
    for pass_i, step in enumerate(range(0, n_steps, blend_every)):
        steps_this = min(blend_every, n_steps - step)
        # t indexes the descending-noise schedule (t = 0 full noise): this pass denoises the levels
        # [n_steps - step, n_steps - step - steps_this)
        t_start = 1.0 - (n_steps - step) / timesteps
        t_end = min(1.0, 1.0 - (n_steps - step - steps_this) / timesteps)

        roll = rolls[pass_i] if rolls is not None else \
            int(torch.randint(1, max(n, 2), (), generator=gen, device=dev))
        frame_range = np.roll(np.arange(n) if direction > 0 else np.flip(np.arange(n)), roll)

        new = [None] * n
        out_img = None
        for f_i, f_n in enumerate(frame_range):
            f_n = int(f_n)
            # the flow into f_n in this direction: forward[i] maps i -> i + 1, so arriving forward is
            # transition (f_n - 1) % n; backward[i] maps i + 1 -> i, so arriving backward is transition f_n
            if direction == 1:
                flow = fit_flow(forward[(f_n - 1) % n])
                rel = fit(reliable_fwd[(f_n - 1) % n][..., None])[..., 0]
            else:
                flow = fit_flow(backward[f_n % n])
                rel = fit(reliable_bwd[f_n % n][..., None])[..., 0]

            if f_i % turbo != 0 and out_img is not None:
                out_img = _warp(out_img, flow)
                new[f_n] = out_img
                continue

            init_img = old[f_n]
            if blend > 0:
                prev_img = old[(f_n - direction) % n] if f_i == 0 else out_img
                init_img = _blend_init(init_img, prev_img, flow, rel.clamp(0, 1), consistency_trust, blend)

            prompts = [ContentPrompt(img=((content[f_n] + 1) / 2).cpu().numpy())]
            if text is not None:
                prompts.append(TextPrompt(text))
            if style_prompt is not None:
                prompts.append(style_prompt)
            kw = {} if frame_noises is None else {"noise": frame_noises[n_calls]}
            out_img = diffusion(init_img, prompts, t_start, t_end, verbose=False, gen=gen, **kw)
            n_calls += 1
            new[f_n] = out_img

        old = new
        direction = -direction  # the flow weighting reverses next pass
        if verbose:
            print(f"loop_direct pass {pass_i + 1}: steps {step + 1}-{step + steps_this} of {n_steps}")
        if write_intermediate:
            _write(old, video_file, fps, suffix=f"_{step + steps_this}")

    video = np.concatenate([f.float().cpu().numpy() for f in old])
    if out_file:
        from ..ops.video import write_video

        write_video(video, out_file, fps=fps)  # [-1, 1] (the reference writes [0, 1] frames as [-1, 1])
    return video


def _write(frames, video_file, fps, suffix=""):
    from ..ops.video import write_video

    write_video(np.concatenate([f.float().cpu().numpy() for f in frames]),
                f"{utility.WORKSPACE}/{Path(video_file).stem}_loop_direct{suffix}.mp4", fps=fps)


def main(args=None):
    from .image import get_diffusion_model

    parser = argparse.ArgumentParser(description="direct multi-pass diffusion video loop")
    parser.add_argument("--init", required=True, type=str, help="input video")
    parser.add_argument("--text", default=None, type=str)
    parser.add_argument("--style", default=None, type=str)
    parser.add_argument("--size", default="256,256", type=str)
    parser.add_argument("--diffusion", default="stable", type=str)
    parser.add_argument("--sampler", default="ddim", type=str)
    parser.add_argument("--timesteps", default=100, type=int)
    parser.add_argument("--skip", default=0.4, type=float)
    parser.add_argument("--blend_every", default=None, type=float,
                        help="steps per pass (<1: fraction of timesteps; default: one pass)")
    parser.add_argument("--blend", default=2.0, type=float)
    parser.add_argument("--consistency_trust", default=0.75, type=float)
    parser.add_argument("--turbo", default=1, type=int)
    parser.add_argument("--flow_models", default="farneback", type=str,
                        help="comma-separated: farneback, hs, spynet, pwc, liteflownet, unflow, raft, gma")
    parser.add_argument("--cfg_scale", default=3.0, type=float)
    parser.add_argument("--max_frames", default=None, type=int)
    parser.add_argument("--fps", default=12, type=float)
    parser.add_argument("--write_intermediate", action="store_true")
    parser.add_argument("--seed", default=0, type=int, help="seed of the random weights and of the draws")
    parser.add_argument("--device", default=None, type=str, help='default "cuda"; "cpu" runs the plain versions')
    parser.add_argument("--out_file", default=None, type=str)
    args = parser.parse_args(args)

    diffusion = get_diffusion_model(args.diffusion, timesteps=args.timesteps, sampler=args.sampler,
                                    cfg_scale=args.cfg_scale, device=args.device, seed=args.seed)
    out_file = args.out_file or f"output/{Path(args.init).stem}_loop_direct.mp4"
    Path(out_file).parent.mkdir(parents=True, exist_ok=True)
    loop_direct_sample(
        diffusion, args.init, text=args.text, style_img=args.style, size=tuple(int(s) for s in args.size.split(",")),
        timesteps=args.timesteps, skip=args.skip, blend_every=args.blend_every, blend=args.blend,
        consistency_trust=args.consistency_trust, turbo=args.turbo, flow_models=tuple(args.flow_models.split(",")),
        max_frames=args.max_frames, write_intermediate=args.write_intermediate, fps=args.fps, out_file=out_file,
        seed=args.seed,
    )
    print(out_file)
    return 0


if __name__ == "__main__":
    main()
