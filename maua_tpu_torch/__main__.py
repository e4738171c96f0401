"""`python -m maua_tpu_torch <command> <subcommand> [options]`: audiovisual
generate, diffusion image, super image, super video."""

import importlib
import sys

COMMANDS = {
    ("audiovisual", "generate"): "maua_tpu_torch.audiovisual.generate",
    ("diffusion", "image"): "maua_tpu_torch.diffusion.image",
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
