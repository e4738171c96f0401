"""`python -m maua_tpu_torch audiovisual generate ...`"""

import sys


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:2] != ["audiovisual", "generate"]:
        sys.exit("usage: python -m maua_tpu_torch audiovisual generate [options]")
    from .audiovisual.generate import main as generate_main

    generate_main(argv[2:])


if __name__ == "__main__":
    main()
