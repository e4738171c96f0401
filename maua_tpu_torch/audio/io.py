"""Host-side audio IO: decoding, workspace caches, Butterworth filtering.

Port of `maua_tpu/audio/io.py` (cache_to_workspace, load_audio, low_pass /
band_pass / high_pass). Decoding uses scipy for wav files and the ffmpeg
binary, when there is one, for anything else. Decoded audio and cached
features go under the workspace (`utility.WORKSPACE`, read at each call)
only when asked: `load_audio(cache=True)`, or a function wrapped by
`cache_to_workspace` (its `cache=` defaults on, as in maua_tpu); the
port's `load_audio` defaults to no cache, where maua_tpu writes one. The filters run `scipy.signal.sosfilt` on the host, as
in JAX; given a tensor they return a tensor on the same device.
"""

from __future__ import annotations

import functools
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from .. import utility


def _ensure_dir(p: str) -> str:
    os.makedirs(p, exist_ok=True)
    return p


def cache_to_workspace(name: str):
    """Disk-cache a feature function under the workspace, keyed on its arguments' contents (numbers,
    strings, arrays, tensors and scalar keyword arguments): the wrapped function takes `cache=` (on by
    default) and returns the cached numpy arrays on a hit."""

    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(*args, cache: bool = True, **kwargs):
            if not cache:
                return fn(*args, **kwargs)
            keyed = [a for a in args if isinstance(a, (int, float, str, bool, np.ndarray, torch.Tensor))]
            scalars = [f"{k}={v}" for k, v in sorted(kwargs.items()) if isinstance(v, (int, float, str, bool))]
            key = utility.content_hash(name, *keyed, *scalars)
            path = os.path.join(_ensure_dir(os.path.join(utility.WORKSPACE, "feature_cache")), f"{name}_{key}.npz")
            if os.path.exists(path):
                with np.load(path, allow_pickle=True) as z:
                    vals = [z[f"arr_{i}"] for i in range(len(z.files))]
                return vals[0] if len(vals) == 1 else tuple(vals)
            out = fn(*args, **kwargs)
            vals = out if isinstance(out, tuple) else (out,)
            np.savez(path, *[v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                             for v in vals])
            return out

        return wrapper

    return decorator


def _decode_ffmpeg(path: str, sr: Optional[int], offset: float, duration: float) -> Tuple[np.ndarray, int]:
    target_sr = sr or 22050
    cmd = ["ffmpeg", "-v", "quiet"]
    if offset:
        cmd += ["-ss", str(offset)]
    cmd += ["-i", path]
    if duration > 0:
        cmd += ["-t", str(duration)]
    cmd += ["-f", "f32le", "-ac", "1", "-ar", str(target_sr), "-"]
    raw = subprocess.run(cmd, capture_output=True, check=True).stdout
    return np.frombuffer(raw, np.float32).copy(), target_sr


def load_audio(audio_file: str, offset: float = 0.0, duration: float = -1.0,
               sr: Optional[int] = None, cache: bool = False) -> Tuple[np.ndarray, int, float]:
    """Load an audio file -> (mono float32 signal, sample rate, duration in s). With `cache` the decoded
    signal is kept under the workspace's audio_cache, named as maua_tpu names it, and read from there."""
    cache_file = None
    if cache:
        stem = Path(audio_file.replace("/", "_")).stem
        cache_file = os.path.join(
            _ensure_dir(os.path.join(utility.WORKSPACE, "audio_cache")),
            stem + ("" if duration == -1 else f"_length{duration}") + ("" if offset == 0 else f"_start{offset}")
            + ("" if sr is None else f"_sr{sr}") + ".npz")
        if os.path.exists(cache_file):
            with np.load(cache_file) as z:
                audio, srate = z["audio"], int(z["sr"])
            return audio, srate, len(audio) / srate
    if Path(audio_file).suffix.lower() == ".wav":
        from scipy.io import wavfile

        srate, data = wavfile.read(audio_file)
        if data.dtype.kind == "i":
            data = data.astype(np.float32) / np.iinfo(data.dtype).max
        elif data.dtype.kind == "u":
            data = (data.astype(np.float32) - 128.0) / 128.0
        else:
            data = data.astype(np.float32)
        if data.ndim == 2:
            data = data.mean(axis=1)
        if offset:
            data = data[int(offset * srate):]
        if duration > 0:
            data = data[: int(duration * srate)]
        audio = np.ascontiguousarray(data, np.float32)
    elif shutil.which("ffmpeg"):
        audio, srate = _decode_ffmpeg(audio_file, sr, offset, duration)
    else:
        raise RuntimeError(f"cannot decode {audio_file}: only .wav is supported without an ffmpeg binary on PATH")
    if cache_file is not None:
        np.savez(cache_file, audio=audio, sr=srate)
    return audio, srate, len(audio) / srate


def _butter(audio, sr: int, kind: str, freqs, db_per_octave: int = 12):
    from scipy import signal as ss

    sos = ss.butter(db_per_octave, freqs, kind, fs=sr, output="sos")
    if isinstance(audio, torch.Tensor):
        out = ss.sosfilt(sos, audio.detach().float().cpu().numpy()).astype(np.float32)
        return torch.from_numpy(out).to(audio.device)
    return ss.sosfilt(sos, np.asarray(audio)).astype(np.float32)


def low_pass(audio, sr, fmax: float = 200.0, db_per_octave: int = 12):
    return _butter(audio, sr, "low", fmax, db_per_octave)


def high_pass(audio, sr, fmin: float = 3000.0, db_per_octave: int = 12):
    return _butter(audio, sr, "high", fmin, db_per_octave)


def band_pass(audio, sr, fmin: float = 200.0, fmax: float = 3000.0, db_per_octave: int = 12):
    return _butter(audio, sr, "band", [fmin, fmax], db_per_octave)
