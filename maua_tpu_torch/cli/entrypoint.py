"""CLI tree: `python -m maua_tpu_torch <command> <subcommand> [args...]`.

Port of `maua_tpu/cli/entrypoint.py`: an argparse-free dispatch to each
subcommand module's own `main`, which gets the remaining arguments, so
every pipeline also runs as `python -m maua_tpu_torch.<module>`. A
subcommand that is not one of its command's passes as the first argument
of the command's first subcommand (`autoregressive finetune ...` reaches
`autoregressive generate`'s own `finetune`). `MAUA_PLATFORM=cpu` asks for
the CPU: `--device cpu` is added where the arguments name no device (the
entry points run on the card otherwise). XLA's compilation cache
(`MAUA_COMPILE_CACHE` in maua_tpu) has no counterpart here.
"""

from __future__ import annotations

import importlib
import os
import sys

COMMANDS = {
    "diffusion": {
        "image": ("maua_tpu_torch.diffusion.image", "Multi-resolution (guided) diffusion image synthesis"),
        "video": ("maua_tpu_torch.diffusion.video", "Flow-warped diffusion video stylization"),
        "interpolate": ("maua_tpu_torch.diffusion.interpolate", "Latent interpolation video between input images"),
        "klmc2": ("maua_tpu_torch.diffusion.klmc2", "KLMC2 latent-space animation"),
        "outpaint": ("maua_tpu_torch.diffusion.outpaint", "Diffusion outpainting"),
        "loop": ("maua_tpu_torch.diffusion.loop_direct", "Direct multi-pass diffusion video loop"),
    },
    "dataset": {
        "retrieve": ("maua_tpu_torch.dataset.laion_clip_retrieval", "LAION CLIP-retrieval image scraper"),
    },
    "super": {
        "image": ("maua_tpu_torch.super.image", "Image super-resolution (RealESRGAN-class models)"),
        "video": ("maua_tpu_torch.super.video", "Video super-resolution / RIFE frame interpolation"),
    },
    "style": {
        "image": ("maua_tpu_torch.style.cli", "Neural style transfer"),
        "video": ("maua_tpu_torch.style.video", "Flow-consistent video style transfer"),
    },
    "audiovisual": {
        "generate": ("maua_tpu_torch.audiovisual.generate", "Audio-reactive GAN video synthesis"),
        "interactive": ("maua_tpu_torch.audiovisual.interactive", "Interactive per-section patch evolution REPL"),
        "selfsupervised": ("maua_tpu_torch.audiovisual.selfsupervised.sample",
                           "Self-supervised audio-reactive generation"),
    },
    "gan": {
        "generate": ("maua_tpu_torch.gan.cli", "StyleGAN image generation"),
        "train": ("maua_tpu_torch.gan.train_cli", "GAN training (plugin registry of models/losses/augs)"),
    },
    "autoregressive": {
        "generate": ("maua_tpu_torch.autoregressive.cli", "Autoregressive text-to-image generation"),
        "video": ("maua_tpu_torch.autoregressive.video_cli", "Two-stage autoregressive text-to-video"),
    },
    "nca": {
        "run": ("maua_tpu_torch.nca.nca", "Texture NCA: train on a style image / render evolution video"),
    },
    "serve": {
        "http": ("maua_tpu_torch.serve", "Warm-model inference server (micro-batched, HTTP)"),
    },
}

# commands whose modules run no model and take no --device
NO_DEVICE = ("dataset",)


def usage():
    print("usage: python -m maua_tpu_torch <command> <subcommand> [args...]\n")
    for cmd, subs in COMMANDS.items():
        for sub, (_, desc) in subs.items():
            print(f"  {cmd} {sub:<14} {desc}")


def resolve(argv):
    """(module path, the module's arguments) of an argument list that starts with a known command."""
    subs = COMMANDS[argv[0]]
    if len(argv) > 1 and argv[1] in subs:
        return subs[argv[1]][0], argv[2:]
    return next(iter(subs.values()))[0], argv[1:]


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 1 or argv[0] in ("-h", "--help"):
        usage()
        return 0
    if argv[0] not in COMMANDS:
        print(f"unknown command {argv[0]!r}\n")
        usage()
        return 1
    module_path, rest = resolve(argv)
    plat = os.environ.get("MAUA_PLATFORM")
    if plat and argv[0] not in NO_DEVICE and not any(a == "--device" or a.startswith("--device=") for a in rest):
        rest = rest + ["--device", "cpu" if plat == "cpu" else "cuda"]
    return importlib.import_module(module_path).main(rest)


if __name__ == "__main__":
    sys.exit(main())
