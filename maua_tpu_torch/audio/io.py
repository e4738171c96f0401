"""Host-side audio IO: wav decoding and Butterworth filtering.

Port of `maua_tpu/audio/io.py` (load_audio, low_pass / band_pass /
high_pass). Decoding uses scipy for wav files and the ffmpeg binary,
when there is one, for anything else. Unlike the JAX package, nothing is
cached on disk. The filters run `scipy.signal.sosfilt` on the host, as
in JAX; given a tensor they return a tensor on the same device.
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch


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
               sr: Optional[int] = None) -> Tuple[np.ndarray, int, float]:
    """Load an audio file -> (mono float32 signal, sample rate, duration in s)."""
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
