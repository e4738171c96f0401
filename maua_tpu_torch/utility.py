"""Device selection, stage timing, prompt and CLI kwarg parsing, seeding,
hashing and the model directory shared by the port's entry points.

Port of `maua_tpu/utility.py` but its `download` and `fetch` (there is no
network) and `enable_compilation_cache` (XLA's)."""

from __future__ import annotations

import hashlib
import os
import random
import tarfile
import time
import zipfile
from typing import Dict, Optional

import numpy as np
import torch

# where checkpoints are looked up by file name, as in maua_tpu
MODELZOO = os.environ.get("MAUA_MODELZOO", os.path.join(os.getcwd(), "modelzoo"))
# where caches (optical flow, frame stores, video loops) are written, as in maua_tpu
WORKSPACE = os.environ.get("MAUA_WORKSPACE", os.path.join(os.getcwd(), "workspace"))


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another. Asking for CUDA without a card raises; nothing falls back to
    the CPU on its own."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


class StageClock:
    """Seconds of named stages, each ended by a device synchronization, and
    the per-batch parts of a render: host seconds of each part and, on a
    card, `{part}_interval_ms`, the ms between the CUDA event recorded
    where the part ends and the one before it (read at the end, so the
    batches are not synchronized). An interval is the device's progress
    between two host marks, not the part's device time: where the host
    is the slower side, it follows the host's pace."""

    def __init__(self, device: torch.device, times: Optional[Dict[str, float]]):
        self.device, self.times = device, times
        self.events = []

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def stage(self, name: str, fn):
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        if self.times is not None:
            self.times[name] = time.perf_counter() - t0
        return out

    def mark(self, part: Optional[str] = None, since: Optional[float] = None) -> float:
        """Record an event and, with `part`, add the host seconds since
        `since` to it; returns the host clock."""
        now = time.perf_counter()
        if self.times is not None:
            if part is not None:
                self.times[part] = self.times.get(part, 0.0) + now - since
            if self.device.type == "cuda":
                event = torch.cuda.Event(enable_timing=True)
                event.record()
                self.events.append((part, event))
        return now

    def finish(self):
        """Add each part's interval ms (between an event and the one before it)."""
        if self.times is None or not self.events:
            return
        self.sync()
        for (_, start), (part, end) in zip(self.events, self.events[1:]):
            if part is not None:
                key = f"{part}_interval_ms"
                self.times[key] = self.times.get(key, 0.0) + start.elapsed_time(end)


def to_device(tree, device):
    """A parameter tree (nested dicts and lists of tensors) on `device`; other leaves (a tuple of
    dilations) as they are."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def parse_prompt(prompt: str):
    """Split "text:weight" (URL-aware) into (text, weight)."""
    if prompt.startswith("http://") or prompt.startswith("https://"):
        vals = prompt.rsplit(":", 2)
        vals = [vals[0] + ":" + vals[1], *vals[2:]]
    else:
        vals = prompt.rsplit(":", 1)
    vals = vals + ["", "1"][len(vals) :]
    return vals[0], float(vals[1])


def parse_kwarg_list(items) -> dict:
    """A CLI kwarg list as a dict: `key=value` pairs (values read as Python literals where they
    parse) or `key type value` triplets with type str, int, float or bool."""
    import ast

    items = list(items or [])
    if not items:
        return {}
    if all("=" in it for it in items):
        out = {}
        for it in items:
            k, v = it.split("=", 1)
            try:
                out[k] = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                out[k] = v
        return out
    if len(items) % 3 != 0:
        raise ValueError(f"kwarg list must be key=value pairs or 'key type value' triplets, got {items}")
    casts = {"str": str, "int": int, "float": float, "bool": lambda v: v.lower() not in ("false", "0", "")}
    out = {}
    for k, t, v in zip(items[::3], items[1::3], items[2::3]):
        if t not in casts:
            raise ValueError(f"unsupported kwarg type {t!r} (one of {sorted(casts)})")
        out[k] = casts[t](v)
    return out


def name(s: str) -> str:
    """Basename without extension."""
    return s.split("/")[-1].split(".")[0]


def _host(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def info(x, y=None, label=None):
    """Print min / mean / max / shape of one or two arrays or tensors."""
    x = _host(x)
    parts = [] if label is None else [label]
    parts += [f"{x.min():.2f}", f"{float(x.mean()):.2f}", f"{x.max():.2f}", tuple(x.shape)]
    if y is not None:
        y = _host(y)
        parts += [f"{y.min():.2f}", f"{float(y.mean()):.2f}", f"{y.max():.2f}", tuple(y.shape)]
    print(*parts)


def seed_everything(seed: int):
    """Seed Python, numpy and torch's default generators (every device's)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def rng(seed: int, device="cpu") -> torch.Generator:
    """A torch.Generator seeded with `seed` on `device` (the port draws from explicit generators)."""
    return torch.Generator(device=device).manual_seed(seed)


def unzip(file: str, path: str):
    """Extract a .tar.gz, .tar or .zip archive into `path`."""
    if file.endswith("tar.gz"):
        with tarfile.open(file, "r:gz") as tar:
            tar.extractall(path)
    elif file.endswith("tar"):
        with tarfile.open(file, "r:") as tar:
            tar.extractall(path)
    elif file.endswith("zip"):
        with zipfile.ZipFile(file) as zf:
            zf.extractall(path)


def content_hash(*arrays, length: int = 16) -> str:
    """A stable content hash (blake2b) of arrays, tensors and strings, for cache keys: each array's
    shape, dtype and bytes (a tensor's as numpy holds them)."""
    h = hashlib.blake2b(digest_size=length)
    for a in arrays:
        if isinstance(a, (str, bytes)):
            h.update(a.encode() if isinstance(a, str) else a)
        else:
            arr = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            h.update(str(arr.shape).encode())
            h.update(str(arr.dtype).encode())
            h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()
