"""`python -m maua_tpu_torch gan generate`: StyleGAN images from seeds.

Port of `maua_tpu/gan/cli.py`, with its flags and `--device` (default
cuda; `--device cpu` runs the plain versions of the kernels).
"""

from __future__ import annotations

import argparse


def main(args=None):
    # fmt: off
    parser = argparse.ArgumentParser(description="StyleGAN image generation")
    parser.add_argument("--model_file", default=None, type=str)
    parser.add_argument("--architecture", default="stylegan2", choices=["stylegan", "stylegan2", "stylegan3"])
    parser.add_argument("--seeds", default="0-8", type=str)
    parser.add_argument("--class_idx", default=None, type=int, help="class index for conditional models")
    parser.add_argument("--truncation", default=1.0, type=float)
    parser.add_argument("--batch_size", default=8, type=int)
    parser.add_argument("--out_size", default=None, type=str, help="w,h output size")
    parser.add_argument("--resize_strategy", default="stretch", type=str)
    parser.add_argument("--resize_layer", default=0, type=int)
    parser.add_argument("--sampling", "--latent_sampling", dest="sampling", default="random",
                        choices=["random", "standard", "langevin", "polarity", "jacnorm", "jacobian"],
                        help="'standard'/'jacobian' are the reference spellings of 'random'/'jacnorm'")
    parser.add_argument("--langevin_critic", default="discriminator", type=str,
                        help="'discriminator' for DDLS, or a text prompt for CLIP-guided langevin")
    parser.add_argument("--translation", default=None, type=str, help="x,y latent-space translation (stylegan3)")
    parser.add_argument("--rotation", default=None, type=float, help="latent-space rotation (stylegan3)")
    parser.add_argument("--grid", action="store_true")
    parser.add_argument("--out_dir", default="output/", type=str)
    parser.add_argument("--device", default=None, type=str, help='default "cuda"; "cpu" runs on the CPU')
    args = parser.parse_args(args)
    # fmt: on

    from .analysis import generate_images
    from .wrappers import get_generator_class

    sampling = {"standard": "random", "jacobian": "jacnorm"}.get(args.sampling, args.sampling)
    out_size = tuple(int(v) for v in args.out_size.split(",")) if args.out_size else None
    translation = tuple(float(v) for v in args.translation.split(",")) if args.translation else None
    gan = get_generator_class(args.architecture)(
        model_file=args.model_file, output_size=out_size, strategy=args.resize_strategy, layer=args.resize_layer,
        device=args.device,
    )
    generate_images(
        gan, seeds=args.seeds, truncation=args.truncation, batch_size=args.batch_size, out_dir=args.out_dir,
        grid=args.grid, sampling_strategy=sampling, class_idx=args.class_idx, translation=translation,
        rotation=args.rotation, langevin_critic=args.langevin_critic,
    )
    print(args.out_dir)
