"""`python -m maua_tpu_torch <command> <subcommand> [options]`: audiovisual
generate, audiovisual interactive, audiovisual selfsupervised, diffusion
image, diffusion video, diffusion interpolate, diffusion klmc2, diffusion
outpaint, diffusion loop, gan generate, style image, style video, super image,
super video."""

import importlib
import sys

COMMANDS = {
    ("audiovisual", "generate"): "maua_tpu_torch.audiovisual.generate",
    ("audiovisual", "interactive"): "maua_tpu_torch.audiovisual.interactive",
    ("audiovisual", "selfsupervised"): "maua_tpu_torch.audiovisual.selfsupervised.sample",
    ("diffusion", "image"): "maua_tpu_torch.diffusion.image",
    ("diffusion", "video"): "maua_tpu_torch.diffusion.video",
    ("diffusion", "interpolate"): "maua_tpu_torch.diffusion.interpolate",
    ("diffusion", "klmc2"): "maua_tpu_torch.diffusion.klmc2",
    ("diffusion", "outpaint"): "maua_tpu_torch.diffusion.outpaint",
    ("diffusion", "loop"): "maua_tpu_torch.diffusion.loop_direct",
    ("gan", "generate"): "maua_tpu_torch.gan.cli",
    ("style", "image"): "maua_tpu_torch.style.cli",
    ("style", "video"): "maua_tpu_torch.style.video",
    ("super", "image"): "maua_tpu_torch.super.image",
    ("super", "video"): "maua_tpu_torch.super.video",
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    module = COMMANDS.get(tuple(argv[:2]))
    if module is None:
        sys.exit("usage: python -m maua_tpu_torch {" + " | ".join(" ".join(c) for c in COMMANDS) + "} [options]")
    importlib.import_module(module).main(argv[2:])


if __name__ == "__main__":
    main()
