"""The port's mel spectrogram, its framing and MFCC against maua_tpu's.

Signals are made from a seed with numpy and go through the JAX function
(on the CPU, complex FFT path) and its port. Tolerances: the mel
spectrogram must reach max abs error / max(reference) < 1e-4, the bar of
the JAX package's own mel kernel test (tests/test_kernels.py), against
both the rfft reference `maua_tpu.audio.spectral.melspectrogram` and the
Pallas kernel in interpret mode; STFT magnitudes 1e-6 of their peak (two
FFT libraries); MFCCs 1e-6 of their peak magnitude (log of the mel
power, then an FFT-form DCT); the DCT 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.audio import mir as JM
from maua_tpu.audio import spectral as JS
from maua_tpu.kernels import spectrogram as JK
from maua_tpu_torch.audio import mir as TM
from maua_tpu_torch.audio import spectral as TS
from maua_tpu_torch.kernels import spectrogram as TK

SR = 22050


def signal(n, seed=0):
    rs = np.random.RandomState(seed)
    t = np.arange(n) / SR
    return (0.4 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 3000 * t)
            + 0.05 * rs.randn(n)).astype(np.float32)


Y = signal(2 * SR)


def rel_err(out, ref):
    ref = np.asarray(ref)
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape
    return float(np.abs(out - ref).max()) / max(float(np.abs(ref).max()), 1e-6) if ref.size else 0.0


@pytest.mark.parametrize("n", [300, 1024, 1025, 4000])
def test_short_signals_reflect_like_numpy(n):
    """Centred framing reflects with numpy's rule at any length: a signal
    of at most n_fft // 2 samples is reflected more than once."""
    y = signal(n, seed=n)
    assert rel_err(TS.stft(torch.from_numpy(y), 2048, 512).abs(), np.abs(JS.stft(jnp.asarray(y), 2048, 512))) < 1e-6
    for hop, n_mels in ((512, 128), (1024, 512)):
        out = TS.melspectrogram(torch.from_numpy(y), SR, hop_length=hop, n_mels=n_mels)
        assert rel_err(out, JS.melspectrogram(jnp.asarray(y), SR, hop_length=hop, n_mels=n_mels)) < 1e-4
        assert out.shape == (n_mels, n // hop)
    if n // 512 < 2:  # one STFT frame: the reference's ensemble has no frame pair to reduce, and raises
        with pytest.raises(ValueError):
            JM.onset_ensemble(jnp.asarray(y), SR)
        with pytest.raises(RuntimeError):
            TM.onset_ensemble(torch.from_numpy(y), SR)
    else:
        ref = JM.onset_ensemble(jnp.asarray(y), SR)
        assert rel_err(TM.onset_ensemble(torch.from_numpy(y), SR), ref) < 2e-3


@pytest.mark.parametrize("hop", [512, 1024])
@pytest.mark.parametrize("n_mels", [128, 512])
@pytest.mark.parametrize("power", [1.0, 2.0])
def test_melspectrogram_matches_the_rfft_reference(hop, n_mels, power):
    out = TS.melspectrogram(torch.from_numpy(Y), SR, hop_length=hop, n_mels=n_mels, power=power)
    ref = JS.melspectrogram(jnp.asarray(Y), SR, hop_length=hop, n_mels=n_mels, power=power)
    assert rel_err(out, ref) < 1e-4


@pytest.mark.parametrize("hop", [512, 1024])
@pytest.mark.parametrize("n_mels", [128, 512])
def test_melspectrogram_matches_the_pallas_kernel(hop, n_mels):
    """The TPU kernel computes power 2 only."""
    ref = JK.melspectrogram_pallas(jnp.asarray(Y), SR, hop_length=hop, n_mels=n_mels, interpret=True)
    out = TK.melspectrogram(torch.from_numpy(Y), SR, hop_length=hop, n_mels=n_mels)
    assert rel_err(out, ref) < 1e-4


def test_melspectrogram_batches_leading_axes_and_keeps_fmin_fmax():
    ys = np.stack([signal(SR, seed=s) for s in range(3)])
    out = TS.melspectrogram(torch.from_numpy(ys.reshape(3, 1, SR)), SR, hop_length=512, fmin=50.0, fmax=8000.0)
    assert out.shape == (3, 1, 128, SR // 512)
    for s in range(3):
        ref = JS.melspectrogram(jnp.asarray(ys[s]), SR, hop_length=512, fmin=50.0, fmax=8000.0)
        assert rel_err(out[s, 0], ref) < 1e-4


def test_cpu_tensors_take_the_plain_version():
    TK.reset_launches()
    y = torch.from_numpy(Y)
    out = TK.melspectrogram(y, SR, hop_length=512)
    basis = torch.from_numpy(TK.mel_basis(float(SR), 2048, 128, 0.0, None))
    assert torch.equal(out, TK.melspectrogram_plain(y, basis, 2048, 512))
    assert TK.launches == 0


def test_packed_bands_hold_the_basis():
    """The kernel's packed mel weights (band-minor, each band from its first to its last non-zero bin,
    zero past its count) rebuild the dense basis exactly, empty bands included."""
    for n_fft, n_mels in ((2048, 128), (2048, 512), (256, 32), (512, 512)):
        basis = TK.mel_basis(float(SR), n_fft, n_mels, 0.0, None)
        lo, n, weights = TK.mel_bands(float(SR), n_fft, n_mels, 0.0, None)
        assert weights.shape == (max(n.max(), 1), n_mels) and weights.dtype == np.float32
        dense = np.zeros_like(basis)
        for m in range(n_mels):
            dense[m, lo[m] : lo[m] + n[m]] = weights[: n[m], m]
            assert not weights[n[m]:, m].any()
        np.testing.assert_array_equal(dense, basis)
        assert (n == 0).sum() == (np.abs(basis).sum(1) == 0).sum()


def test_twiddles_and_window():
    tw = TK.twiddles(2048)
    np.testing.assert_allclose(tw[:, 0] + 1j * tw[:, 1], np.exp(-2j * np.pi * np.arange(1025) / 2048), atol=1e-7)
    np.testing.assert_allclose(TK.hann(2048, "cpu").numpy(), np.asarray(JS.hann_window(2048)), atol=1e-7)


@pytest.mark.parametrize("norm", [None, "ortho"])
def test_dct(norm):
    x = np.random.RandomState(1).randn(5, 40).astype(np.float32)
    assert rel_err(TS.dct(torch.from_numpy(x), norm=norm), JS.dct(jnp.asarray(x), norm=norm)) < 1e-6


@pytest.mark.parametrize("n_mfcc,hop", [(20, 512), (13, 1024)])
def test_mfcc(n_mfcc, hop):
    out = TS.mfcc(torch.from_numpy(Y), SR, n_mfcc=n_mfcc, hop_length=hop)
    assert rel_err(out, JS.mfcc(jnp.asarray(Y), SR, n_mfcc=n_mfcc, hop_length=hop)) < 1e-6


def test_spectrogram_drops_the_last_frame():
    out = TS.spectrogram(torch.from_numpy(Y), hop_length=512, power=2.0)
    assert rel_err(out, JS.spectrogram(jnp.asarray(Y), hop_length=512, power=2.0)) < 1e-6


def test_pad_center():
    y = np.arange(5, dtype=np.float32)
    np.testing.assert_array_equal(TS.pad_center(torch.from_numpy(y), 12).numpy(), np.pad(y, 12, mode="reflect"))
    np.testing.assert_array_equal(TS.pad_center(torch.from_numpy(y), 3, "constant").numpy(), np.pad(y, 3))
    with pytest.raises(ValueError):
        TS.pad_center(torch.from_numpy(y), 3, "edge")
