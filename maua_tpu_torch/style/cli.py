"""`python -m maua_tpu_torch style image --content c.png --styles s.png`: neural style transfer of an
image, written to {out_dir}/{content}_{styles}.png. Port of `maua_tpu/style/cli.py`."""

from __future__ import annotations

import argparse
from pathlib import Path


def main(args=None):
    # fmt: off
    parser = argparse.ArgumentParser(description="neural style transfer")
    parser.add_argument("--content", required=True, type=str)
    parser.add_argument("--styles", required=True, nargs="+", type=str)
    parser.add_argument("--init", "--init_img", dest="init", default=None, type=str)
    parser.add_argument("--init_type", default="content", choices=["content", "random", "init_img"])
    parser.add_argument("--match_hist", default="avg", type=str)
    parser.add_argument("--size", default=512, type=int)
    parser.add_argument("--parameterization", default="rgb", type=str)
    parser.add_argument("--perceptor", default="kbc-vgg19", type=str)
    parser.add_argument("--perceptor_kwargs", nargs="*", default=[])
    parser.add_argument("--optimizer", default="lbfgs", type=str)
    parser.add_argument("--optimizer_kwargs", nargs="*", default=[])
    parser.add_argument("--lr", default=0.5, type=float)
    parser.add_argument("--n_iters", default=512, type=int)
    parser.add_argument("--content_weight", default=1.0, type=float)
    parser.add_argument("--style_weight", default=50.0, type=float)
    parser.add_argument("--tv_weight", default=100.0, type=float)
    parser.add_argument("--style_scale", default=1.0, type=float)
    parser.add_argument("--out_dir", default="output/", type=str)
    parser.add_argument("--device", default=None, type=str, help="cuda unless told otherwise")
    args = parser.parse_args(args)
    # fmt: on

    from ..ops.io import save_image
    from ..utility import parse_kwarg_list
    from .image import transfer

    out = transfer(
        args.content, args.styles, init_img=args.init, init_type=args.init_type, match_hist=args.match_hist,
        size=args.size, parameterization=args.parameterization, perceptor=args.perceptor,
        perceptor_kwargs=parse_kwarg_list(args.perceptor_kwargs), optimizer=args.optimizer,
        optimizer_kwargs=parse_kwarg_list(args.optimizer_kwargs), lr=args.lr, n_iters=args.n_iters,
        content_weight=args.content_weight, style_weight=args.style_weight, tv_weight=args.tv_weight,
        style_scale=args.style_scale, device=args.device)
    Path(args.out_dir).mkdir(parents=True, exist_ok=True)
    name = f"{Path(args.content).stem}_{'_'.join(Path(s).stem for s in args.styles)}.png"
    save_image(out, f"{args.out_dir}/{name}")
    print(f"{args.out_dir}/{name}")
