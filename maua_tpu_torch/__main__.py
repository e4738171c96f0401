"""`python -m maua_tpu_torch <command> <subcommand> [options]`: the CLI tree of `cli/entrypoint.py`
(`python -m maua_tpu_torch -h` lists every command).

As in maua_tpu, `autoregressive finetune | api | min | rq ...` reach the
autoregressive generate command's own subcommands."""

import sys

from .cli.entrypoint import COMMANDS as TREE
from .cli.entrypoint import main

# (command, subcommand) -> module
COMMANDS = {(cmd, sub): module for cmd, subs in TREE.items() for sub, (module, _) in subs.items()}

if __name__ == "__main__":
    rc = main()
    sys.exit(rc if isinstance(rc, int) else 0)
