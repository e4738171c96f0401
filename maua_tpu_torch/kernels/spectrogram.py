"""Mel spectrogram: a hand-written CUDA kernel and its plain twin.

Port of the Pallas TPU kernel `maua_tpu/kernels/spectrogram.py`
(`melspectrogram_pallas`, kernel `_mel_kernel`; XLA twin
`melspectrogram_mxu`). For signals y (..., L):

    frames  = y centred by n_fft / 2 with numpy's reflect rule, hop apart,
              the last frame dropped (the reference's spectrogram drops it)
    P       = |rfft(frames * periodic Hann)| ** power
    out     = mel_basis @ P                        -> (..., n_mels, T)

with T = L // hop. The CUDA source is `maua_tpu_torch/csrc/spectrogram.cu`:
a frame per warp (or per 16 or 8 lanes below n_fft 2048), a four-step
FFT in registers, and the mel product of a block's frames over each
band's non-zero bins. `melspectrogram` launches it for CUDA
tensors and raises on what it does not take; CPU tensors take the plain
PyTorch version, `melspectrogram_plain`, which is also what the kernel is
held against on the card.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..audio.convert import mel_filterbank
from ..ops.warp import _reflect_index

# launches of the CUDA kernel since the last reset (the plain path does not count)
launches = 0
_fn = None
_DEVICE_TABLES: Dict[tuple, Tuple[torch.Tensor, ...]] = {}


def reset_launches() -> None:
    global launches
    launches = 0


def _kernel():
    global _fn
    if _fn is None:
        from .build import load

        fn = load("spectrogram").maua_melspectrogram
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                               ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


@functools.lru_cache(maxsize=None)
def mel_basis(sr: float, n_fft: int, n_mels: int, fmin: float, fmax: Optional[float]) -> np.ndarray:
    return mel_filterbank(sr, n_fft, n_mels=n_mels, fmin=fmin, fmax=fmax)


@functools.lru_cache(maxsize=None)
def mel_bands(sr: float, n_fft: int, n_mels: int, fmin: float, fmax: Optional[float]):
    """The basis packed for the kernel: each band's first non-zero bin `lo`, its bin count `n` (from the
    first to the last non-zero bin; 0 for an empty band), and the weights band-minor, (max n, n_mels):
    weights[i, m] = basis[m, lo[m] + i] for i < n[m], else 0, so that the threads of neighbouring bands
    read neighbouring weights."""
    basis = mel_basis(sr, n_fft, n_mels, fmin, fmax)
    lo = np.zeros(n_mels, np.int32)
    n = np.zeros(n_mels, np.int32)
    for m, row in enumerate(basis):
        nz = np.flatnonzero(row)
        if len(nz):
            lo[m], n[m] = nz[0], nz[-1] + 1 - nz[0]
    weights = np.zeros((max(int(n.max()), 1), n_mels), np.float32)
    for m in range(n_mels):
        weights[: n[m], m] = basis[m, lo[m] : lo[m] + n[m]]
    return lo, n, weights


@functools.lru_cache(maxsize=None)
def twiddles(n_fft: int) -> np.ndarray:
    """exp(-2 pi i k / n_fft) for k <= n_fft / 2, computed in float64, as (re, im) float32 pairs."""
    ang = -2.0 * np.pi * np.arange(n_fft // 2 + 1) / n_fft
    return np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)


def hann(n_fft: int, device) -> torch.Tensor:
    return torch.hann_window(n_fft, periodic=True, dtype=torch.float32, device=device)


def centered_frames(y: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """(..., L) -> (..., 1 + L // hop, n_fft): frames of y centred by n_fft // 2
    on each side with numpy's reflect rule, which holds at any length."""
    length = y.shape[-1]
    n_frames = 1 + length // hop_length
    idx = (torch.arange(n_frames, device=y.device)[:, None] * hop_length
           + torch.arange(n_fft, device=y.device)[None, :] - n_fft // 2)
    return y[..., _reflect_index(idx, length)]


def melspectrogram_plain(y: torch.Tensor, basis: torch.Tensor, n_fft: int, hop_length: int,
                         power: float = 2.0) -> torch.Tensor:
    """The same function in plain PyTorch ops: centred frames, window,
    rfft, |.|^power, mel product. basis: (n_mels, n_fft // 2 + 1)."""
    frames = centered_frames(y.float(), n_fft, hop_length)[..., :-1, :]
    if frames.shape[-2] == 0:  # shorter than a hop: no frame is left
        return y.new_zeros(*y.shape[:-1], basis.shape[0], 0, dtype=torch.float32)
    spec = torch.fft.rfft(frames * hann(n_fft, y.device), dim=-1)
    p = spec.real.square() + spec.imag.square()
    if power != 2.0:
        p = p ** (power / 2.0)
    return (p @ basis.t()).transpose(-1, -2)


def _device_tables(key, device):
    tables = _DEVICE_TABLES.get((key, device))
    if tables is None:
        tables = (hann(key[1], device), torch.from_numpy(twiddles(key[1])).to(device),
                  *(torch.from_numpy(a).to(device) for a in mel_bands(*key)))
        _DEVICE_TABLES[(key, device)] = tables
    return tables


def melspectrogram(y: torch.Tensor, sr: float, n_fft: int = 2048, hop_length: int = 1024, n_mels: int = 128,
                   power: float = 2.0, fmin: float = 0.0, fmax: Optional[float] = None) -> torch.Tensor:
    """Mel spectrogram (..., n_mels, L // hop) of signals (..., L), the
    last centred frame dropped."""
    key = (float(sr), int(n_fft), int(n_mels), float(fmin), None if fmax is None else float(fmax))
    if y.device.type == "cpu":
        basis = torch.from_numpy(mel_basis(*key))
        return melspectrogram_plain(y, basis, n_fft, hop_length, power)
    if y.device.type != "cuda":
        raise ValueError(f"melspectrogram runs on cuda or cpu tensors, got {y.device}")
    if y.dtype != torch.float32:
        raise TypeError(f"melspectrogram takes float32 signals, got {y.dtype}")
    if not y.is_contiguous():
        raise ValueError("the signal must be contiguous")
    if n_fft < 256 or n_fft > 4096 or n_fft & (n_fft - 1):
        raise ValueError(f"n_fft must be a power of two from 256 to 4096, got {n_fft}")
    if hop_length <= 0 or y.dim() == 0 or y.shape[-1] == 0:
        raise ValueError(f"need a positive hop and a non-empty signal, got hop {hop_length}, shape {tuple(y.shape)}")
    lead, length = y.shape[:-1], y.shape[-1]
    batch = math.prod(lead)
    n_frames = length // hop_length
    out = torch.empty(*lead, n_mels, n_frames, dtype=torch.float32, device=y.device)
    if n_frames == 0 or batch == 0:
        return out
    if batch > 65535:
        raise ValueError(f"at most 65535 signals per call, got {batch}")
    window, twiddle, lo, n, weights = _device_tables(key, y.device)
    err = _kernel()(
        y.data_ptr(), window.data_ptr(), twiddle.data_ptr(), lo.data_ptr(), n.data_ptr(), weights.data_ptr(),
        out.data_ptr(), batch, length, n_fft, hop_length, n_frames, n_mels, float(power),
        torch.cuda.current_stream(y.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"melspectrogram kernel launch failed: error {err}")
    global launches
    launches += 1
    return out
