"""Out-of-memory ladders: catch the card running out of memory and retry smaller.

Port of `maua_tpu/oom.py` (is_oom_error, run_with_oom_fallback, shrinking_batches). The
reference walks these ladders at its loop sites (the upscaler's tile
rungs, the diffusion pipeline's skipped super-resolution and halved tile
batches, the GAN renderers' halved batches); the port keeps them as they
are, and every one of them asks `is_oom_error`. An out-of-memory error
is `torch.cuda.OutOfMemoryError`, a message saying "CUDA out of memory",
or the host's `MemoryError`; no other error moves a ladder on.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import torch

_OOM_MESSAGE = "CUDA out of memory"


def is_oom_error(e: BaseException) -> bool:
    if isinstance(e, (torch.cuda.OutOfMemoryError, MemoryError)):
        return True
    return _OOM_MESSAGE in str(e)


def run_with_oom_fallback(attempts: Iterable[Tuple[str, Callable]], verbose: bool = True):
    """Try each (description, thunk) in order; an out-of-memory error moves
    to the next rung, any other error re-raises. Raises the last
    out-of-memory error if every rung fails."""
    last: Optional[BaseException] = None
    for desc, thunk in attempts:
        try:
            return thunk()
        except Exception as e:  # noqa: BLE001 - filtered below
            if not is_oom_error(e):
                raise
            last = e
            if verbose:
                print(f"device OOM at {desc}; retrying smaller")
    raise last  # every rung ran out of memory


def shrinking_batches(n: int, batch_size: int, min_batch: int = 1):
    """Candidate batch sizes batch_size, batch_size // 2, ..., min_batch for halve-and-retry loops."""
    b = batch_size
    while True:
        yield b
        if b <= min_batch:
            return
        b = max(b // 2, min_batch)
