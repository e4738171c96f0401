"""Device selection, prompt parsing and the model directory shared by the
port's entry points."""

from __future__ import annotations

import os

import torch

# where checkpoints are looked up by file name, as in maua_tpu
MODELZOO = os.environ.get("MAUA_MODELZOO", os.path.join(os.getcwd(), "modelzoo"))


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another. Asking for CUDA without a card raises; nothing falls back to
    the CPU on its own."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


def to_device(tree, device):
    """A parameter tree (nested dicts and lists of tensors) on `device`."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def parse_prompt(prompt: str):
    """Split "text:weight" (URL-aware) into (text, weight)."""
    if prompt.startswith("http://") or prompt.startswith("https://"):
        vals = prompt.rsplit(":", 2)
        vals = [vals[0] + ":" + vals[1], *vals[2:]]
    else:
        vals = prompt.rsplit(":", 1)
    vals = vals + ["", "1"][len(vals) :]
    return vals[0], float(vals[1])
