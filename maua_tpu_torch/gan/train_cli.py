"""`python -m maua_tpu_torch gan train`: GAN training with a plugin registry.

Port of `maua_tpu/gan/train_cli.py`: the component registry (losses,
models, augmentation), each component contributing its flags and a
build function, the full flag surface (input data, data loading, kimg-based
durations, per-network optimization, the component selectors with their
plugin flags), the experimental gate, and `--device` (default cuda;
`--device cpu` runs the plain versions of the kernels). `main` returns the
final train state.
"""

from __future__ import annotations

import argparse
from typing import Dict


class Component:
    """Plugin interface: add_model_specific_args(parser) and build(args)."""

    name: str = "base"

    @staticmethod
    def add_model_specific_args(parser: argparse.ArgumentParser):
        return parser

    @staticmethod
    def build(args):
        raise NotImplementedError


REGISTRY: Dict[str, Dict[str, type]] = {"losses": {}, "models": {}, "augmentation": {}}


def register(kind: str):
    def deco(cls):
        REGISTRY[kind][cls.name] = cls
        return cls

    return deco


@register("losses")
class SoftplusLoss(Component):
    name = "softplus"

    @staticmethod
    def build(args):
        return "logistic"


@register("losses")
class BCELoss(Component):
    name = "cross_entropy"

    @staticmethod
    def build(args):
        return "bce"


@register("models")
class StyleGAN2Model(Component):
    name = "stylegan2"

    @staticmethod
    def add_model_specific_args(parser):
        parser.add_argument("--channel_base", default=32768, type=int)
        parser.add_argument("--channel_max", default=512, type=int)
        return parser

    @staticmethod
    def build(args):
        from .discriminator import D2Config
        from .stylegan2 import SG2Config

        zw = {}
        if getattr(args, "z_dim", 0):
            zw["z_dim"] = args.z_dim
        if getattr(args, "w_dim", 0):
            zw["w_dim"] = args.w_dim
        g = SG2Config(img_resolution=args.resolution, channel_base=args.channel_base,
                      channel_max=args.channel_max, num_fp16_res=0, **zw)
        d = D2Config(img_resolution=args.resolution, channel_base=args.channel_base,
                     channel_max=args.channel_max)
        return g, d


def build_by_name(kind: str, name: str, args):
    if name not in REGISTRY[kind]:
        raise ValueError(f"unknown {kind} component {name!r}; options: {sorted(REGISTRY[kind])}")
    return REGISTRY[kind][name].build(args)


EXPERIMENTAL_MODELS = {"stylehypermixer", "deepinvolutional", "steerable"}
REG_LOSSES = {"r1_penalty", "path_length_regularization"}  # loss plugins that map to regularizers


def main(args=None):
    """Parse the flags, build the components, cache the image folder and fit; returns the final state."""
    import math

    model_choices = sorted(REGISTRY["models"])
    loss_choices = sorted(set(REGISTRY["losses"]) | REG_LOSSES)
    parser = argparse.ArgumentParser(description="GAN training",
                                     formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-e", "--experimental", action="store_true",
                        help="enable experimental network options")

    grp = parser.add_argument_group("Input data")
    grp.add_argument("--input_dir", required=True, type=str)
    grp.add_argument("--resolution", "--image_size", dest="resolution", default=64, type=int)
    grp.add_argument("--preprocess_image_size", default=0, type=int,
                     help="cache images at this size (>= resolution) so random crops keep pixel density; 0 = resolution")
    grp.add_argument("--hflip", action="store_true", help="random horizontal flips (visible in output data)")
    grp.add_argument("--vflip", action="store_true", help="random vertical flips")
    grp.add_argument("--random_crop", action="store_true", help="random resized crops while training")
    grp.add_argument("--random_crop_zoom", default=float(math.sqrt(2)), type=float)
    grp.add_argument("--random_crop_ratio", default=0.1, type=float)
    grp.add_argument("--random_rotate", action="store_true")
    grp.add_argument("--random_rotate_degrees", default=360.0, type=float)

    grp = parser.add_argument_group("Dataloading")
    grp.add_argument("--batch_size", default=8, type=int)
    grp.add_argument("--num_workers", default=2, type=int,
                     help="prefetch depth of the background loader thread")
    grp.add_argument("--jpeg_quality", default=0, type=int,
                     help="round-trip cached images through JPEG at this quality (0 = lossless)")
    grp.add_argument("--cache_dir", default=None, type=str)

    grp = parser.add_argument_group("Training")
    grp.add_argument("--total_steps", default=0, type=int, help="overrides --kimg when > 0")
    grp.add_argument("--kimg", default=80, type=int, help="thousands of images to train on in total")
    grp.add_argument("--epoch_kimg", default=10, type=int, help="(accepted; epochs are implicit in the step loop)")
    grp.add_argument("--ckpt_kimg", default=10, type=int, help="kimg between scored checkpoints")
    grp.add_argument("--ckpt_top_k", default=10, type=int, help="checkpoints to keep (best monitor metric)")
    grp.add_argument("--test_kimg", default=8, type=int, help="kimg between metric evaluations")
    grp.add_argument("--eval_every", default=0, type=int, help="overrides --test_kimg when > 0")
    grp.add_argument("--monitor_metric", default="fid", type=str,
                     help="metric gating lr decay / early stop / top-k (lower = better)")
    grp.add_argument("--out_dir", default="workspace/gan_training", type=str)
    grp.add_argument("--device", default=None, type=str, help='default "cuda"; "cpu" runs on the CPU')

    grp = parser.add_argument_group("Optimization")
    grp.add_argument("--lr", default=2.5e-3, type=float, help="default for both networks")
    grp.add_argument("--lr_G", default=None, type=float)
    grp.add_argument("--lr_D", default=None, type=float)
    grp.add_argument("--n_D_steps", default=1, type=int, help="discriminator steps per generator step")

    grp = parser.add_argument_group("Components")
    grp.add_argument("--model", default=None, choices=model_choices,
                     help="set generator AND discriminator family at once")
    grp.add_argument("-G", "--generator", default="stylegan2", choices=model_choices)
    grp.add_argument("-D", "--discriminator", default=None, choices=model_choices,
                     help="defaults to the generator's family")
    grp.add_argument("-L", "--latent_distribution", default="normal", choices=["normal", "uniform"])
    grp.add_argument("-EMA", "--ema_decay", default=0.999, type=float)
    grp.add_argument("-GL", "--generator_losses", nargs="+", default=["softplus"], choices=loss_choices)
    grp.add_argument("-DL", "--discriminator_losses", nargs="+",
                     default=["softplus", "r1_penalty"], choices=loss_choices)
    grp.add_argument("-A", "--augmentations", nargs="+", default=["initial_blur"],
                     choices=sorted(set(REGISTRY["augmentation"]) | {"blur"}),
                     help='"blur" is the reference name for initial_blur')
    grp.add_argument("--loss", default=None, choices=sorted(REGISTRY["losses"]),
                     help="shorthand for setting the adversarial loss of both networks")

    grp = parser.add_argument_group("Loss settings (r1_penalty / path_length_regularization)")
    grp.add_argument("--r1_gamma", default=10.0, type=float)
    grp.add_argument("--r1_interval", default=16, type=int)
    grp.add_argument("--pl_weight", default=2.0, type=float)
    grp.add_argument("--pl_interval", default=4, type=int)
    grp.add_argument("--pl_decay", default=0.01, type=float)
    grp.add_argument("--pl_batch_shrink", default=2, type=int)

    grp = parser.add_argument_group("Model settings (generic families)")
    grp.add_argument("--z_dim", default=0, type=int, help="latent dim (0 = family default)")
    grp.add_argument("--w_dim", default=0, type=int, help="hypermixer token width (0 = default)")
    grp.add_argument("--ngf", default=0, type=int, help="generator base width (0 = default)")
    grp.add_argument("--ndf", default=0, type=int, help="discriminator base width (0 = ngf)")

    # plugin flags (reflection role)
    for kind in REGISTRY.values():
        for comp in kind.values():
            comp.add_model_specific_args(parser)
    args = parser.parse_args(args)

    from . import training as tr
    from .data import ImageDataset, build_cache, make_data_augment
    from .train_loop import FitConfig, fit

    g_name = args.model or args.generator
    d_name = args.model or args.discriminator or g_name
    for name in {g_name, d_name}:
        if name in EXPERIMENTAL_MODELS and not args.experimental:
            raise SystemExit(f"{name} is experimental; pass -e/--experimental to enable it")

    g_cfg, _ = build_by_name("models", g_name, args)
    _, d_cfg = build_by_name("models", d_name, args)

    # adversarial loss: first non-regularizer entry; r1/pl plugins in
    # the -DL/-GL lists toggle the corresponding regularizer intervals
    adv = args.loss or next((l for l in args.discriminator_losses if l not in REG_LOSSES), "softplus")
    loss = build_by_name("losses", adv, args)
    use_r1 = "r1_penalty" in args.discriminator_losses or args.loss is not None
    use_pl = "path_length_regularization" in (args.generator_losses + args.discriminator_losses)
    lr_g = args.lr_G if args.lr_G is not None else args.lr
    lr_d = args.lr_D if args.lr_D is not None else args.lr
    t_cfg = tr.TrainConfig(
        g_lr=lr_g, d_lr=lr_d, loss=loss, latent=args.latent_distribution,
        ema_beta=args.ema_decay, n_d_steps=args.n_D_steps,
        r1_gamma=args.r1_gamma if use_r1 else 0.0, r1_interval=args.r1_interval,
        pl_weight=args.pl_weight if use_pl or g_name == "stylegan2" else 0.0,
        pl_interval=args.pl_interval, pl_decay=args.pl_decay,
        pl_batch_shrink=args.pl_batch_shrink,
        blur_init_sigma=(getattr(args, "blur_init_sigma", 0.0)
                         if {"initial_blur", "blur"} & set(args.augmentations) else 0.0),
        blur_fade_kimg=getattr(args, "blur_fade_kimg", 200.0),
    )

    pre_size = max(args.preprocess_image_size, args.resolution)
    cache = build_cache(args.input_dir, pre_size, cache_dir=args.cache_dir,
                        jpeg_quality=args.jpeg_quality)
    needs_aug = (args.hflip or args.vflip or args.random_crop or args.random_rotate
                 or pre_size != args.resolution)
    data_aug = make_data_augment(
        args.resolution, hflip=args.hflip, vflip=args.vflip, random_crop=args.random_crop,
        crop_zoom=args.random_crop_zoom, crop_ratio=args.random_crop_ratio,
        random_rotate=args.random_rotate, rotate_degrees=args.random_rotate_degrees,
    ) if needs_aug else None
    dataset = ImageDataset(cache, args.batch_size, prefetch=max(args.num_workers, 0),
                           data_augment=data_aug, device=args.device)

    steps_per_kimg = max(1000 // args.batch_size, 1)
    total_steps = args.total_steps or args.kimg * steps_per_kimg
    eval_every = args.eval_every or max(args.test_kimg * steps_per_kimg, 1)
    return fit(dataset, g_cfg, d_cfg, t_cfg,
        FitConfig(total_steps=total_steps, eval_every=eval_every, out_dir=args.out_dir,
                  ckpt_every=args.ckpt_kimg * steps_per_kimg, ckpt_top_k=args.ckpt_top_k,
                  monitor_metric=args.monitor_metric,
                  augment_p=(getattr(args, "augment_p", 0.2)
                             if "ada" in args.augmentations else 0.0)))



@register("models")
class DCGANModel(Component):
    name = "deepconvolutional"

    @staticmethod
    def add_model_specific_args(parser):
        parser.add_argument("--dcgan_base", default=64, type=int)
        return parser

    @staticmethod
    def build(args):
        from .training import GenericModel

        m = GenericModel("dcgan", args.resolution,
                         z_dim=getattr(args, "z_dim", 0) or 100,
                         base=getattr(args, "ngf", 0) or getattr(args, "dcgan_base", 64),
                         d_base=getattr(args, "ndf", 0))
        return m, m


@register("models")
class HyperMixerModel(Component):
    name = "stylehypermixer"

    @staticmethod
    def build(args):
        from .training import GenericModel

        m = GenericModel("hypermixer", args.resolution,
                         z_dim=getattr(args, "z_dim", 0) or 64,
                         d_base=getattr(args, "ndf", 0),
                         dim=getattr(args, "w_dim", 0))
        return m, m


@register("models")
class DeepInvolutionalModel(Component):
    name = "deepinvolutional"

    @staticmethod
    def add_model_specific_args(parser):
        parser.add_argument("--involution_base", default=32, type=int)
        return parser

    @staticmethod
    def build(args):
        from .training import GenericModel

        m = GenericModel("involution", args.resolution,
                         z_dim=getattr(args, "z_dim", 0) or 100,
                         base=getattr(args, "ngf", 0) or getattr(args, "involution_base", 32),
                         d_base=getattr(args, "ndf", 0))
        return m, m


@register("models")
class SteerableModel(Component):
    name = "steerable"

    @staticmethod
    def build(args):
        from .training import GenericModel

        m = GenericModel("steerable", args.resolution,
                         z_dim=getattr(args, "z_dim", 0) or 128,
                         base=getattr(args, "ngf", 0) or 16,
                         d_base=getattr(args, "ndf", 0))
        return m, m


@register("augmentation")
class InitialBlur(Component):
    """Fade-out blur on D inputs."""

    name = "initial_blur"

    @staticmethod
    def add_model_specific_args(parser):
        parser.add_argument("--blur_init_sigma", default=10.0, type=float,
                            help="strength of the initial blur at the start of training (0 disables)")
        parser.add_argument("--blur_fade_kimg", default=200.0, type=float,
                            help="kimg over which the blur fades out")
        return parser

    @staticmethod
    def build(args):
        return (getattr(args, "blur_init_sigma", 0.0), getattr(args, "blur_fade_kimg", 200.0))


@register("augmentation")
class ADAAugment(Component):
    name = "ada"

    @staticmethod
    def add_model_specific_args(parser):
        parser.add_argument("--augment_p", default=0.2, type=float)
        return parser

    @staticmethod
    def build(args):
        return getattr(args, "augment_p", 0.2)


if __name__ == "__main__":
    main()
