"""Flow-warped video diffusion.

Port of `maua_tpu/diffusion/video.py` (FramesOnDisk,
VideoFlowDiffusionProcessor, video_sample, main): per frame, the previous
output is warped along the optical flow, blended into the frame by the
consistency mask, optionally histogram-matched and noised, partially
denoised by the processor, and stored. The options of the reference:
first_skip / first_frame_init, turbo (diffuse every turbo'th frame and
warp-and-cross-fade the rest), wrap_around (extra frames that fade, by a
square-root curve, into the first pass's frames for a seamless loop),
flow_exaggeration, loop_fade, hist_persist, noise_injection, constant_seed,
preview, and the pre and post hooks (histogram match to the style image,
sharpening). Images are NHWC in [-1, 1] on the processor's device.

Flow index convention: `preprocess_optical_flow` returns arrays indexed by
transition i -> i + 1 (circular), where `backward[i]` is the pull map that
warps frame i into frame i + 1. The reference indexes its flow cache by
destination frame (its flow[f] warps f - 1 into f), so its index f is
index (f - 1) % N here.

    python -m maua_tpu_torch diffusion video --video_file clip.mp4 --text "an oil painting" --size 512,512
"""

from __future__ import annotations

import argparse
import os
import queue
import threading
from functools import partial, reduce
from pathlib import Path
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from .. import utility
from ..flow.lib import flow_warp_map, preprocess_optical_flow
from ..flow.models import get_flow_model
from ..ops.image import match_histogram, sharpen
from ..ops.warp import grid_sample, resize
from ..prompt import ContentPrompt, ImagePrompt, StylePrompt, TextPrompt


class FramesOnDisk:
    """Append-only store of frames, each also saved as `{path}_{index:06d}.npy`
    by a background writer thread; `close` waits for the writes."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._frames = []
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                break
            idx, arr = item
            np.save(f"{self.path}_{idx:06d}.npy", arr)

    def append(self, frame):
        arr = np.asarray(frame)
        self._frames.append(arr)
        self._q.put((len(self._frames) - 1, arr))

    def __getitem__(self, i):
        return self._frames[i % len(self._frames)]

    def __len__(self):
        return len(self._frames)

    def close(self):
        self._q.put(None)
        self._thread.join()


def _warp(img: torch.Tensor, warp_map: torch.Tensor) -> torch.Tensor:
    """NHWC image pulled through a (B, H, W, 2) normalized map, border padded."""
    return grid_sample(img.permute(0, 3, 1, 2), warp_map, padding_mode="border").permute(0, 2, 3, 1)


class VideoFlowDiffusionProcessor:
    """Stylizes a video frame by frame through a diffusion processor."""

    def __call__(
        self,
        diffusion,
        video_file: str,
        init_type: str = "content",
        text: Optional[str] = None,
        image: Optional[str] = None,
        style: Optional[str] = None,
        size=(256, 256),
        t_start: Optional[float] = None,  # historical alias for `skip`
        skip: float = 0.7,
        first_skip: float = 0.4,
        first_frame_init: Optional[str] = None,
        t_end: float = 1.0,
        blend: float = 2.0,
        consistency_trust: float = 0.75,
        wrap_around: int = 0,
        turbo: int = 1,
        noise_injection: float = 0.02,
        flow_exaggeration: float = 1.0,
        loop_fade: float = 0.0,
        pre_hook: Optional[Callable] = None,
        post_hook: Optional[Callable] = None,
        hist_persist: bool = False,
        constant_seed: Optional[int] = None,
        max_frames: Optional[int] = None,
        flow_models=("farneback",),
        preview: bool = False,
        verbose: bool = True,
        seed: int = 0,
        draws: Optional[Iterator] = None,
        frame_noises: Optional[Sequence] = None,
        stage_times: Optional[dict] = None,
    ) -> np.ndarray:
        """Returns the (N + wrapped, H, W, 3) frames in [-1, 1] (also saved
        through a FramesOnDisk store in WORKSPACE). Draws come from a
        generator seeded with `seed`: each diffused frame's processor draws
        from it too, or, with `constant_seed`, from a generator seeded with
        that at every frame. `draws` replaces them in order (standard normal
        arrays: the random init's, then each frame's noise injection);
        `frame_noises` gives each diffused frame's processor call its
        `noise`. `stage_times` collects the flow's seconds ("flow")."""
        dev = diffusion.device
        gen = torch.Generator(device=dev).manual_seed(seed)

        def normal(shape):
            if draws is not None:
                return torch.as_tensor(np.asarray(next(draws)), dtype=torch.float32, device=dev).reshape(shape)
            return torch.randn(shape, generator=gen, device=dev)

        if t_start is not None:
            skip = t_start
        clock = utility.StageClock(dev, stage_times)
        frames, _forward, backward, reliable = clock.stage("flow", lambda: preprocess_optical_flow(
            video_file, get_flow_model(flow_models, device=dev), max_frames=max_frames))
        n_frames = len(frames)
        h, w = size
        turbo = max(1, int(turbo))
        wrap_around = int(wrap_around)

        def fit(x):  # (1, H', W', C) host array -> (1, h, w, C) on the device, bilinear
            x = torch.as_tensor(np.array(x, np.float32), device=dev)
            return resize(x.permute(0, 3, 1, 2), (h, w), "bilinear").permute(0, 2, 3, 1)

        def content_at(f):
            return fit(frames[f % n_frames][None]) * 2.0 - 1.0

        def warp_map_at(f):
            # the pull map warping frame f - 1 into frame f, resized and scaled to the synthesis size
            fl = backward[(f - 1) % n_frames]
            scale = torch.tensor([w / fl.shape[1], h / fl.shape[0]], dtype=torch.float32, device=dev)
            return flow_warp_map(fit(fl[None])[0] * scale * flow_exaggeration)

        def consistency_at(f):
            return fit(np.asarray(reliable[(f - 1) % n_frames])[None, :, :, None]).clamp(0, 1)

        out_store = FramesOnDisk(f"{utility.WORKSPACE}/{Path(video_file).stem}_diffused")
        cache = [None] * n_frames
        hist_img = out_img = None
        if first_frame_init is not None:
            out_img = torch.as_tensor(ImagePrompt(path=first_frame_init, size=(h, w)).img, device=dev)  # [-1, 1]
            cache[0] = hist_img = out_img

        fade = np.sqrt(np.linspace(1, 0, wrap_around)) if wrap_around > 0 else None
        turbo_blend = np.linspace(0, 1, turbo + 1)[1:]
        turbo_prev = turbo_next = None
        n_diffused = 0

        for f_n in range(0, n_frames + wrap_around + turbo, turbo):
            if f_n >= n_frames + wrap_around:
                if cache[f_n % n_frames] is None:
                    break  # no wrapped frame to close the loop onto
                turbo_next = cache[f_n % n_frames]

            if f_n > 0:
                # the turbo - 1 frames in between: the last two diffused keyframes warped along the flow and
                # cross-faded
                for t, f_t in enumerate(range(f_n - turbo, f_n)):
                    wm = warp_map_at(f_t)
                    if turbo_prev is not None:
                        turbo_prev = _warp(turbo_prev, wm)
                    if t != 0 and f_n < n_frames + wrap_around:
                        turbo_next = _warp(turbo_next, wm)
                    img = turbo_prev * (1.0 - turbo_blend[t]) + turbo_next * turbo_blend[t] \
                        if turbo_prev is not None else turbo_next
                    if 0 <= f_t < n_frames + wrap_around or cache[f_t % n_frames] is not None:
                        cache[f_t % n_frames] = img
                out_img = turbo_next

            if f_n >= n_frames + wrap_around:
                break  # the loop-closing fill only; nothing more to diffuse

            content = content_at(f_n)
            init_img = content
            if out_img is None and init_type == "random":
                init_img = normal(tuple(content.shape))

            if blend > 0:
                mask = consistency_at(f_n) * consistency_trust + (1 - consistency_trust) if consistency_trust > 0 \
                    else torch.ones_like(init_img)
                mask = mask * blend
                prev_img = content_at(f_n - 1) if f_n == 0 else out_img
                init_img = (init_img + mask * _warp(prev_img, warp_map_at(f_n))) / (1 + mask)

            if f_n >= n_frames and fade is not None:
                a = fade[f_n % n_frames] if f_n % n_frames < len(fade) else 0.0
                init_img = a * init_img + (1 - a) * cache[f_n % n_frames]

            # the legacy in-pass loop fade: towards the first output over the last fraction
            if loop_fade > 0 and cache[0] is not None and f_n > (1 - loop_fade) * n_frames:
                alpha = (f_n - (1 - loop_fade) * n_frames) / (loop_fade * n_frames)
                init_img = (1 - alpha) * init_img + alpha * cache[0]

            if pre_hook is not None:
                init_img = pre_hook(init_img)
            if hist_persist and f_n > 0 and hist_img is not None:
                init_img = match_histogram(init_img, hist_img)
            if noise_injection > 0:
                init_img = init_img + noise_injection * normal(tuple(init_img.shape))

            prompts = [ContentPrompt(img=((content + 1) / 2).cpu().numpy())]
            if style is not None:
                prompts.append(StylePrompt(path=style, size=size))
            if text is not None:
                prompts.append(TextPrompt(text))
            if image is not None:
                prompts.append(ImagePrompt(path=image))

            frame_gen = torch.Generator(device=dev).manual_seed(constant_seed) if constant_seed is not None else gen
            kw = {} if frame_noises is None else {"noise": frame_noises[n_diffused]}
            out_img = diffusion(init_img, prompts, first_skip if f_n == 0 else skip, t_end, verbose=False,
                                gen=frame_gen, **kw)
            n_diffused += 1

            if hist_persist and f_n == 0:
                hist_img = out_img
            if post_hook is not None:
                out_img = post_hook(out_img)
            if preview:  # headless preview: a PNG beside the frame store
                from ..ops.io import save_image

                ppath = f"{utility.WORKSPACE}/{Path(video_file).stem}_preview.png"
                save_image(out_img[:1], ppath)
                print(f"preview -> {ppath}")

            cache[f_n % n_frames] = out_img
            turbo_prev, turbo_next = turbo_next, out_img
            if verbose:
                print(f"frame {f_n + 1}/{n_frames + wrap_around}")

        outs = [c[0].float().cpu().numpy() for c in cache if c is not None]
        for o in outs:
            out_store.append(o)
        out_store.close()
        return np.stack(outs)


def video_sample(diffusion, video_file: str, out_file: Optional[str] = None, fps: float = 24, match_hist: bool = False,
                 sharpness: float = 1.0, style: Optional[str] = None, **kwargs) -> str:
    """VideoFlowDiffusionProcessor with the pre hook (`match_hist`: histogram
    match to the style image) and the post hook (sharpening when `sharpness`
    is not 1), written to `out_file` (default output/{stem}_diffused.mp4)."""
    from ..ops.video import write_video

    pre_hook = None
    if match_hist and style is not None:
        style_img = torch.as_tensor(StylePrompt(path=style).img, device=diffusion.device)  # already [-1, 1]
        pre_hook = lambda img: match_histogram(img, style_img)  # noqa: E731
    post_fns = [partial(sharpen, strength=sharpness)] if sharpness != 1.0 else []
    post_hook = (lambda img: reduce(lambda i, f: f(i), post_fns, img)) if post_fns else None
    video = VideoFlowDiffusionProcessor()(diffusion, video_file, style=style, pre_hook=pre_hook, post_hook=post_hook,
                                          **kwargs)
    out_file = out_file or f"output/{Path(video_file).stem}_diffused.mp4"
    os.makedirs(os.path.dirname(out_file) or ".", exist_ok=True)
    write_video(video, out_file, fps=fps)
    return out_file


def main(args=None):
    from .image import get_diffusion_model

    # fmt: off
    parser = argparse.ArgumentParser(description="flow-warped diffusion video stylization")
    parser.add_argument("--video_file", "--init", required=True, type=str, dest="video_file")
    parser.add_argument("--text", default=None, type=str)
    parser.add_argument("--image", default=None, type=str)
    parser.add_argument("--style", default=None, type=str)
    parser.add_argument("--init_type", default="content", choices=["content", "random"])
    parser.add_argument("--diffusion", default="stable", type=str)
    parser.add_argument("--timesteps", default=25, type=int)
    parser.add_argument("--sampler", default="lms", type=str)
    parser.add_argument("--size", default="256,256", type=str)
    parser.add_argument("--skip", "--t_start", default=0.7, type=float, dest="skip",
                        help="fraction of the diffusion schedule to skip per frame (higher = closer to input)")
    parser.add_argument("--first_skip", default=0.4, type=float, help="separate skip fraction for the first frame")
    parser.add_argument("--first_frame_init", default=None, type=str,
                        help="image file to initialize the first frame with")
    parser.add_argument("--blend", default=2.0, type=float)
    parser.add_argument("--consistency_trust", default=0.75, type=float)
    parser.add_argument("--wrap_around", default=0, type=int,
                        help="extra frames looping back to the start for a seamless loop")
    parser.add_argument("--turbo", default=1, type=int, help="diffuse every turbo'th frame, flow-interpolate the rest")
    parser.add_argument("--noise_injection", default=0.02, type=float)
    parser.add_argument("--flow_exaggeration", default=1.0, type=float)
    parser.add_argument("--flow_models", default="farneback", type=str,
                        help="comma-separated: farneback, hs, spynet, pwc, liteflownet, unflow, raft, gma")
    parser.add_argument("--guidance_speed", default="fast", choices=["regular", "fast"])
    parser.add_argument("--clip_scale", default=0.0, type=float)
    parser.add_argument("--lpips_scale", default=0.0, type=float)
    parser.add_argument("--style_scale", default=0.0, type=float)
    parser.add_argument("--color_match_scale", default=0.0, type=float)
    parser.add_argument("--cfg_scale", default=7.5, type=float)
    parser.add_argument("--match_hist", action="store_true",
                        help="histogram-match the init to the --style image before diffusion")
    parser.add_argument("--hist_persist", action="store_true",
                        help="histogram-match subsequent frames to the first diffused frame")
    parser.add_argument("--sharpness", default=1.0, type=float)
    parser.add_argument("--loop_fade", default=0.0, type=float)
    parser.add_argument("--constant_seed", default=None, type=int)
    parser.add_argument("--max_frames", default=None, type=int)
    parser.add_argument("--preview", action="store_true")
    parser.add_argument("--fps", default=24, type=float)
    parser.add_argument("--seed", default=0, type=int, help="seed of the random weights and of the draws")
    parser.add_argument("--device", default=None, type=str, help='default "cuda"; "cpu" runs the plain versions')
    parser.add_argument("--out_file", "--out-dir", default=None, type=str, dest="out_file")
    args = parser.parse_args(args)
    # fmt: on

    diffusion = get_diffusion_model(
        args.diffusion, timesteps=args.timesteps, sampler=args.sampler, guidance_speed=args.guidance_speed,
        clip_scale=args.clip_scale, lpips_scale=args.lpips_scale, style_scale=args.style_scale,
        color_match_scale=args.color_match_scale, cfg_scale=args.cfg_scale, image=args.image, device=args.device,
        seed=args.seed,
    )
    out = video_sample(
        diffusion, args.video_file, out_file=args.out_file, fps=args.fps, init_type=args.init_type, text=args.text,
        image=args.image, style=args.style, size=tuple(int(s) for s in args.size.split(",")), skip=args.skip,
        first_skip=args.first_skip, first_frame_init=args.first_frame_init, blend=args.blend,
        consistency_trust=args.consistency_trust, wrap_around=args.wrap_around, turbo=args.turbo,
        noise_injection=args.noise_injection, flow_exaggeration=args.flow_exaggeration,
        flow_models=tuple(args.flow_models.split(",")), match_hist=args.match_hist, hist_persist=args.hist_persist,
        sharpness=args.sharpness, loop_fade=args.loop_fade, constant_seed=args.constant_seed,
        max_frames=args.max_frames, preview=args.preview, seed=args.seed,
    )
    print(out)
    return 0


if __name__ == "__main__":
    main()
