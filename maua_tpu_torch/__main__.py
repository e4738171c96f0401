"""`python -m maua_tpu_torch audiovisual generate ...` and `python -m maua_tpu_torch diffusion image ...`"""

import sys


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:2] == ["audiovisual", "generate"]:
        from .audiovisual.generate import main as generate_main

        generate_main(argv[2:])
    elif argv[:2] == ["diffusion", "image"]:
        from .diffusion.image import main as image_main

        image_main(argv[2:])
    else:
        sys.exit("usage: python -m maua_tpu_torch {audiovisual generate | diffusion image} [options]")


if __name__ == "__main__":
    main()
