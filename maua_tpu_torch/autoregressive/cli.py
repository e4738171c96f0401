"""`python -m maua_tpu_torch autoregressive generate [generate | finetune | api | min | rq] ...`.

Port of `maua_tpu/autoregressive/cli.py`, with its flags and defaults:
generate (oversampled decode for sizes wider than the native grid, optional
CLIP rerank and RealESRGAN upscale), finetune (int8 blockwise Adam with
`--adam8bit`), api (the Kandinsky request; `--dry_run`, the default, prints
the payload), min and rq (sample candidates, CLIP-rerank; rq decodes depth-D
residual codes). Without a subcommand the arguments go to generate. The
transformer and the VQ decoder are random at the reference's small CLI
configurations, from `--seed` (and seed 1 for the decoder) unless
`--checkpoint` gives finetuned parameters. Everything runs on the card
unless `--device cpu`.

Prompts are tokenized word by word with CRC-32 of the UTF-8 word, so that a
seed reproduces its image. (maua_tpu uses Python's `hash`, which is salted
per process for strings.)
"""

from __future__ import annotations

import argparse
import zlib

import numpy as np
import torch

SUBCOMMANDS = ("generate", "finetune", "api", "min", "rq")


def word_id(word: str, vocab: int) -> int:
    """A stable id of a word in [0, vocab)."""
    return zlib.crc32(word.encode("utf-8")) % vocab


def _text_tokens(text: str, cfg, device=None) -> torch.Tensor:
    words = text.split()[: cfg.text_length]
    ids = [word_id(w, cfg.text_vocab_size) for w in words] + [0] * (cfg.text_length - len(words))
    return torch.tensor([ids], dtype=torch.long, device=device)


def _build(seed: int, device, checkpoint=None, depth: int = 1):
    from .finetune import restore_checkpoint
    from .transformer import ARConfig, init_params

    # depth > 1: the token grid is (rows, cols, depth) flattened in raster-depth order (RQ)
    cfg = ARConfig(width=128, layers=2, heads=4, image_rows=8, image_cols=8 * depth, text_length=16)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed))
    if checkpoint:
        params = restore_checkpoint(checkpoint, {"params": params})["params"]
    return params, cfg


def _vq_decoder(cfg, device):
    from . import vq

    vq_cfg = vq.VQConfig(codebook_size=cfg.vocab_size)
    vq_params = vq.init_params(vq_cfg, torch.Generator(device=device).manual_seed(1))

    def decode(toks):
        cols = toks.shape[-1] if toks.dim() == 3 else cfg.image_cols
        return vq.decode_tokens(vq_params, toks.reshape(len(toks), -1), vq_cfg, cfg.image_rows, cols)

    return decode, vq_params, vq_cfg


def _save_images(imgs: torch.Tensor, args, stem: str) -> int:
    """PNGs of (B, 3, H, W) images in [-1, 1]: optional RealESRGAN upscale (`--upscale`), optional
    stretch to `--stretch_size`, and with `--make_grid` a grid of all of them."""
    import os

    from ..ops.io import tensor2img

    imgs = ((imgs.float().permute(0, 2, 3, 1) + 1) / 2).cpu().numpy()
    upscale = getattr(args, "upscale", 1)
    if upscale > 1:
        from ..ops.image import resample
        from ..super.image import Upscaler

        model = Upscaler("RealESRGAN-x4plus", device=args.device)
        out = []
        for im in imgs:
            up = model(im[None])
            if upscale == 8:
                up = model(up)
            target = im.shape[0] * upscale
            if up.shape[1] != target:  # the x4 net against a requested x2 or x8
                up = resample(up, target)
            out.append(np.clip(up[0].cpu().numpy(), 0, 1))
        imgs = out

    stretch = getattr(args, "stretch_size", None)
    os.makedirs(args.output_dir, exist_ok=True)
    for i, im in enumerate(imgs):
        pil = tensor2img(im[None])
        if stretch:
            w, h = (int(v) for v in str(stretch).split(","))
            pil = pil.resize((w, h))
        pil.save(f"{args.output_dir}/{stem}_{i}.png")
    if getattr(args, "make_grid", False) and len(imgs) > 0:
        import math

        cols = math.ceil(math.sqrt(len(imgs)))
        rows = math.ceil(len(imgs) / cols)
        h, w = imgs[0].shape[:2]
        grid = np.zeros((rows * h, cols * w, imgs[0].shape[2]), np.float32)
        for i, im in enumerate(imgs):
            r, c = divmod(i, cols)
            grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = im
        tensor2img(grid[None]).save(f"{args.output_dir}/{stem}_grid.png")
    print(args.output_dir)
    return 0


def _chunks(n: int, bs: int):
    return [min(bs, n - i) for i in range(0, n, bs)]


def _gen(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def generate(args):
    from ..utility import resolve_device
    from .oversample import oversample_generate
    from .transformer import generate_tokens

    device = resolve_device(args.device)
    params, cfg = _build(args.seed, device, args.checkpoint)
    text_tokens = _text_tokens(args.text, cfg, device)
    decode, _, _ = _vq_decoder(cfg, device)

    width, height = (int(v) for v in args.size.split(","))
    target_cols = max(round(cfg.image_cols * width / max(height, 1)), cfg.image_cols)

    imgs = []
    for ci, bs in enumerate(_chunks(args.num_outputs, args.batch_size)):
        gen = _gen(device, args.seed + ci)
        batched = text_tokens.repeat(bs, 1)
        if target_cols > cfg.image_cols and not args.no_oversample:
            # non-native aspect ratio: the sliding-window oversampled decode
            grid = oversample_generate(params, batched, cfg, target_cols=target_cols, temperature=args.temperature,
                                       top_k=args.top_k, gen=gen)
            imgs.append(decode(grid))
        else:
            toks = generate_tokens(params, batched, cfg, gen, temperature=args.temperature, top_k=args.top_k,
                                   top_p=args.top_p)
            imgs.append(decode(toks.reshape(bs, cfg.image_rows, cfg.image_cols)))
    imgs = torch.cat(imgs)

    if args.rerank and args.rerank < len(imgs):
        from .rerank import clip_rerank

        imgs = imgs[torch.as_tensor(clip_rerank(imgs, args.text, top_n=args.rerank), device=imgs.device)]
    return _save_images(imgs, args, args.output_name or "ar")


def finetune_cmd(args):
    import glob
    import os

    from ..ops.image import resample
    from ..ops.io import load_image
    from ..utility import resolve_device
    from . import vq
    from .finetune import FinetuneConfig, finetune, save_checkpoint

    device = resolve_device(args.device)
    params, cfg = _build(args.seed, device, args.checkpoint)
    paths = list(args.images or [])
    if args.input_dir:
        paths += sorted(sum((glob.glob(f"{args.input_dir}/*.{e}") for e in ("png", "jpg", "jpeg")), []))
    if args.num_examples:
        paths = paths[: args.num_examples]
    if not paths:
        raise SystemExit("no training images: pass --input_dir or --images")
    if args.captions and len(args.captions) != len(paths):
        raise SystemExit(f"{len(args.captions)} captions for {len(paths)} images")

    decode, vq_params, vq_cfg = _vq_decoder(cfg, device)
    size = cfg.image_rows * vq_cfg.upscale
    captions = args.captions or [args.input_text] * len(paths)

    imgs = [np.asarray(load_image(p)) * 2 - 1 for p in paths]  # (1, H, W, 3) each
    first_size = (imgs[0].shape[2], imgs[0].shape[1])  # (W, H) before the squash
    texts = [_text_tokens(c, cfg).numpy() for c in captions]

    def tokenize(img):
        img = resample(torch.as_tensor(img, device=device), size).permute(0, 3, 1, 2)
        return vq.encode_tokens(vq_params, img, vq_cfg).cpu().numpy() + cfg.text_vocab_size

    rs = np.random.RandomState(args.seed)

    def example(i):
        img = imgs[i]
        if args.random_crop and min(img.shape[1], img.shape[2]) > args.random_crop:
            c = args.random_crop
            y = rs.randint(img.shape[1] - c + 1)
            x = rs.randint(img.shape[2] - c + 1)
            img = img[:, y: y + c, x: x + c]
        return np.concatenate([texts[i], tokenize(img)], axis=1)

    if args.random_crop:
        # the crops differ per draw: tokenize inside the batch loop
        def batches():
            while True:
                idx = rs.randint(len(paths), size=min(args.train_batch_size, len(paths)))
                yield np.concatenate([example(i) for i in idx])
    else:
        data = np.concatenate([example(i) for i in range(len(paths))])

        def batches():
            while True:
                yield data[rs.randint(len(data), size=min(args.train_batch_size, len(data)))]

    ft_cfg = FinetuneConfig(steps=args.steps, lr=args.lr, adam8bit=args.adam8bit,
                            gradient_checkpointing=args.low_memory)
    new_params, losses = finetune(params, batches(), cfg, ft_cfg, save_path=None)

    # a parameters-only checkpoint, so that `--checkpoint` restores into a fresh model
    model_name = args.model_name or (os.path.basename(os.path.normpath(args.input_dir)) if args.input_dir
                                     else os.path.splitext(os.path.basename(paths[0]))[0])
    save_path = args.save_path or os.path.join(args.save_dir, f"{model_name}.npz")
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    save_checkpoint(save_path, {"params": new_params})
    print(f"{len(losses)} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}; saved {save_path}")

    if args.num_outputs > 0:
        from .transformer import generate_tokens

        sampled = []
        for ci, bs in enumerate(_chunks(args.num_outputs, args.inference_batch_size)):
            toks = generate_tokens(new_params, _text_tokens(args.input_text or captions[0], cfg, device).repeat(bs, 1),
                                   cfg, _gen(device, args.seed + 100 + ci), top_p=args.top_p)
            sampled.append(decode(toks.reshape(bs, cfg.image_rows, cfg.image_cols)))
        if args.stretch:
            args.stretch_size = f"{first_size[0]},{first_size[1]}"
        return _save_images(torch.cat(sampled), args, model_name)
    return 0


def api_cmd(args):
    from .api import build_request_payload, request_kandinsky

    if args.dry_run:
        print(build_request_payload(args.text, top_k=args.top_k, top_p=args.top_p, images_num=args.num_outputs,
                                    rerank_top=args.rerank_top))
        return 0
    imgs = request_kandinsky(args.text, args.url, top_k=args.top_k, top_p=args.top_p, images_num=args.num_outputs,
                             rerank_top=args.rerank_top, verbose=args.verbose)
    if args.rerank_top and args.rerank_top < len(imgs):
        from ..utility import resolve_device
        from .rerank import clip_rerank

        arr = torch.as_tensor(np.stack([np.asarray(im, np.float32) / 127.5 - 1 for im in imgs]),
                              device=resolve_device(args.device)).permute(0, 3, 1, 2)
        imgs = [imgs[i] for i in clip_rerank(arr, args.text, top_n=args.rerank_top)]
    for i, img in enumerate(imgs):
        img.save(f"{args.output_dir}/kandinsky_{i}.png")
    return 0


def rerank_cmd(args):
    """minDALLE / RQ-transformer role: sample num_candidates, CLIP-rerank, keep the best num_outputs. rq
    samples depth-D residual codes per position in raster-depth order and decodes their summed
    embeddings."""
    from ..utility import resolve_device
    from .rerank import generate_and_rerank

    if getattr(args, "prompt_flag", None):
        args.prompt = args.prompt_flag
    if args.prompt is None:
        raise SystemExit("a prompt is required (positional or --text_prompts)")
    if getattr(args, "sampling_ratio", None):
        args.num_outputs = max(1, round(args.num_candidates * args.sampling_ratio))
    if getattr(args, "clip_model", None):
        print(f"note: --clip_model {args.clip_model} accepted for parity; reranking uses the in-tree CLIP tower "
              "(converted zoo weights are not available)")

    device = resolve_device(args.device)
    depth = max(int(getattr(args, "rq_depth", 1)), 1) if args.cmd == "rq" else 1
    params, cfg = _build(args.seed, device, args.checkpoint, depth=depth)
    decode, vq_params, vq_cfg = _vq_decoder(cfg, device)
    if depth > 1:
        from . import vq

        rows, cols = cfg.image_rows, cfg.image_cols // depth

        def decode_fn(t):
            return vq.decode_rq_tokens(vq_params, t.reshape(len(t), -1), vq_cfg, rows, cols, depth)
    else:
        def decode_fn(t):
            return decode(t.reshape(len(t), cfg.image_rows, cfg.image_cols))
    best = generate_and_rerank(params, cfg, _text_tokens(args.prompt, cfg, device), args.prompt, decode_fn,
                               n_candidates=args.num_candidates, top_n=args.num_outputs, gen=_gen(device, args.seed),
                               temperature=args.temperature, top_k=int(args.top_k), top_p=args.top_p or 0.0,
                               batch_size=getattr(args, "batch_size", 0))
    stem = args.prompt.replace(" ", "_")[:64] + ("_mindalle" if args.cmd == "min" else "_rq")
    return _save_images(best, args, stem)


def main(args=None):
    parser = argparse.ArgumentParser(description="autoregressive text-to-image")
    sub = parser.add_subparsers(dest="cmd")

    # fmt: off
    g = sub.add_parser("generate", help="sample images (oversampled decode for non-native sizes)")
    g.add_argument("--text", "--input_text", dest="text", required=True, type=str)
    g.add_argument("--num_outputs", "--n_candidates", dest="num_outputs", default=4, type=int)
    g.add_argument("--batch_size", default=8, type=int, help="candidates sampled per chunk")
    g.add_argument("--size", default="256,256", type=str, help="width,height (wider than native -> oversampling)")
    g.add_argument("--stretch_size", default=None, type=str, help="width,height to stretch outputs to")
    g.add_argument("--no_oversample", action="store_true")
    g.add_argument("--upscale", default=1, type=int, choices=[1, 2, 4, 8], help="RealESRGAN upscale of outputs")
    g.add_argument("--seed", default=0, type=int)
    g.add_argument("--top_k", default=64, type=int)
    g.add_argument("--top_p", default=0.0, type=float)
    g.add_argument("--temperature", default=1.0, type=float)
    g.add_argument("--rerank", default=0, type=int, help="keep top-N by CLIP similarity")
    g.add_argument("--checkpoint", default=None, type=str)
    g.add_argument("--output_name", default=None, type=str)
    g.add_argument("--output_dir", "--out_dir", dest="output_dir", default="output/", type=str)
    g.set_defaults(func=generate)

    f = sub.add_parser("finetune", help="finetune on images (int8 blockwise Adam)")
    f.add_argument("--input_dir", default=None, type=str)
    f.add_argument("--images", nargs="*", default=[])
    f.add_argument("--captions", nargs="*", default=[], help="one caption per image")
    f.add_argument("--input_text", default="", type=str, help="prompt for post-finetune sampling")
    f.add_argument("--num_examples", default=None, type=int)
    f.add_argument("--num_outputs", default=0, type=int, help="images to sample after finetuning")
    f.add_argument("--steps", default=100, type=int)
    f.add_argument("--lr", default=1e-4, type=float)
    f.add_argument("--train_batch_size", "--batch_size", dest="train_batch_size", default=1, type=int)
    f.add_argument("--inference_batch_size", default=8, type=int)
    f.add_argument("--random_crop", default=None, type=int, help="random-crop sections of this size during training")
    f.add_argument("--stretch", action="store_true", help="stretch sampled outputs back to the first image's size")
    f.add_argument("--upscale", default=1, type=int, choices=[1, 2, 4, 8])
    f.add_argument("--top_p", default=0.99, type=float)
    f.add_argument("--adam8bit", action="store_true", help="int8 blockwise Adam moments")
    f.add_argument("--low_memory", action="store_true", help="gradient checkpointing")
    f.add_argument("--seed", default=0, type=int)
    f.add_argument("--checkpoint", default=None, type=str)
    f.add_argument("--save_dir", default="modelzoo/", type=str)
    f.add_argument("--model_name", default=None, type=str)
    f.add_argument("--save_path", default=None, type=str, help="overrides --save_dir/--model_name")
    f.add_argument("--output_dir", default="output/", type=str)
    f.set_defaults(func=finetune_cmd)

    a = sub.add_parser("api", help="Sbercloud Kandinsky API request (dry-run prints the payload)")
    a.add_argument("--text", required=True, type=str)
    a.add_argument("--url", default="", type=str)
    a.add_argument("--dry_run", action="store_true", default=True)
    a.add_argument("--no_dry_run", dest="dry_run", action="store_false")
    a.add_argument("--top_k", default=1500, type=int)
    a.add_argument("--top_p", default=0.99, type=float)
    a.add_argument("--num_outputs", "--images_num", dest="num_outputs", default=4, type=int)
    a.add_argument("--rerank_top", default=4, type=int)
    a.add_argument("--verbose", action="store_true")
    a.add_argument("--output_dir", "--out_dir", dest="output_dir", default="output/", type=str)
    a.set_defaults(func=api_cmd)

    for name, help_ in (("min", "minDALLE-role sampling + CLIP rerank"),
                        ("rq", "RQ-transformer-role sampling + CLIP rerank")):
        r = sub.add_parser(name, help=help_)
        r.add_argument("prompt", type=str, nargs="?", default=None)
        r.add_argument("--text_prompts", dest="prompt_flag", default=None, type=str,
                       help="alternative to the positional prompt (reference rq_dalle flag)")
        r.add_argument("--num_candidates", "--num_samples", dest="num_candidates", default=8, type=int)
        r.add_argument("--num_outputs", default=4, type=int)
        r.add_argument("--sampling_ratio", default=None, type=float,
                       help="keep this fraction of candidates by CLIP score (overrides --num_outputs)")
        r.add_argument("--batch_size", default=0, type=int,
                       help="sample candidates in chunks of this size (0 = all at once)")
        r.add_argument("--top_k", default=64, type=float)
        r.add_argument("--top_p", default=None, type=float)
        r.add_argument("--temperature", default=1.0, type=float)
        r.add_argument("--seed", default=0, type=int)
        r.add_argument("--checkpoint", "--checkpoint_dir", dest="checkpoint", default=None, type=str)
        r.add_argument("--clip_model", default=None, type=str,
                       help="reranker CLIP weights (accepted for reference parity; ignored)")
        r.add_argument("--make_grid", action="store_true", help="also save all outputs as one grid PNG")
        r.add_argument("--upscale", default=1, type=int, choices=[1, 2, 4, 8])
        r.add_argument("--rq_depth", default=4 if name == "rq" else 1, type=int,
                       help="residual quantization depth (codes per position; rq only)")
        r.add_argument("--output_dir", "--out_dir", dest="output_dir", default="output/", type=str)
        r.set_defaults(func=rerank_cmd)
    for p in (g, f, a, *(sub.choices[n] for n in ("min", "rq"))):
        p.add_argument("--device", default=None, type=str, help="cuda (the default) or cpu")
    # fmt: on

    import sys

    argv = list(sys.argv[1:] if args is None else args)
    if not argv or argv[0] not in SUBCOMMANDS:
        # the bare flag-style invocation: generate
        argv = ["generate"] + argv
    ns = parser.parse_args(argv)
    return ns.func(ns)
