"""`python -m maua_tpu_torch autoregressive video --text "..."`: two-stage text-to-video.

Port of `maua_tpu/autoregressive/video_cli.py`: stage-1 keyframes, stage-2
dyadic interpolation, the VQ decode, then PNG frames and an mp4 (the port's
writer falls back to OpenCV without ffmpeg; a failure to write raises). The
transformer and decoder are random at the reference's CLI configuration
from `--seed` (seed + 1 for the decoder) unless checkpoints are given.
Prompts are tokenized with CRC-32 of each word (see `cli.py`); `--guidance_alpha`
other than 1 mixes in the generic guider prompt "video". Runs on the card
unless `--device cpu`.
"""

from __future__ import annotations

import argparse


def main(args=None):
    parser = argparse.ArgumentParser(description="two-stage autoregressive text-to-video")
    parser.add_argument("--text", required=True, type=str)
    parser.add_argument("--n_keyframes", default=3, type=int)
    parser.add_argument("--interpolation_rounds", default=1, type=int)
    parser.add_argument("--guidance_alpha", default=1.0, type=float,
                        help="token-level CFG vs a generic guider prompt (>1 strengthens the text)")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--top_k", default=64, type=int)
    parser.add_argument("--temperature", default=1.0, type=float)
    parser.add_argument("--fps", default=4.0, type=float)
    parser.add_argument("--checkpoint", default=None, type=str, help="transformer params .npz")
    parser.add_argument("--vq_checkpoint", default=None, type=str, help="taming VQGAN .ckpt/.pth")
    parser.add_argument("--out_dir", default="output/ar_video", type=str)
    parser.add_argument("--device", default=None, type=str, help="cuda (the default) or cpu")
    args = parser.parse_args(args)

    import os

    import numpy as np
    import torch

    from ..ops.io import tensor2img
    from ..ops.video import write_video
    from ..utility import resolve_device
    from . import video as video_mod
    from . import vq
    from .cli import word_id
    from .finetune import restore_checkpoint
    from .transformer import ARConfig, init_params

    device = resolve_device(args.device)
    cfg = ARConfig(width=128, layers=2, heads=4, image_rows=8, image_cols=8, text_length=16, max_frames=5)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(args.seed))
    if args.checkpoint:
        params = restore_checkpoint(args.checkpoint, {"params": params})["params"]
    vq_cfg = vq.VQConfig(codebook_size=cfg.vocab_size, base_channels=32, channel_mult=(1, 2, 4))
    if args.vq_checkpoint:
        from ..utility import to_device

        sd = torch.load(args.vq_checkpoint, map_location="cpu", weights_only=False)
        vq_params = to_device(vq.params_from_torch(sd.get("state_dict", sd), vq_cfg), device)
    else:
        vq_params = vq.init_params(vq_cfg, torch.Generator(device=device).manual_seed(args.seed + 1))

    def tokenize(text):
        ids = [word_id(w, cfg.text_vocab_size - 1) for w in text.split()[: cfg.text_length]]
        return np.asarray([ids + [0] * (cfg.text_length - len(ids))], np.int64)

    guider = tokenize("video") if args.guidance_alpha != 1.0 else None
    frames = video_mod.generate_video(
        params, tokenize(args.text), cfg, vq_params, vq_cfg, n_keyframes=args.n_keyframes,
        interpolation_rounds=args.interpolation_rounds, gen=torch.Generator(device=device).manual_seed(args.seed),
        guider_text_tokens=guider, guidance_alpha=args.guidance_alpha, temperature=args.temperature, top_k=args.top_k,
    )  # (F, B, H, W, 3) uint8

    os.makedirs(args.out_dir, exist_ok=True)
    for f in range(frames.shape[0]):
        tensor2img(frames[f, 0][None].astype(np.float32) / 255.0).save(f"{args.out_dir}/frame_{f:04d}.png")
    write_video(frames[:, 0], f"{args.out_dir}/video.mp4", fps=args.fps, value_range=(0, 255))
    print(args.out_dir)
