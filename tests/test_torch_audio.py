"""The port's audio features against maua_tpu's, on a synthetic mix.

A 2 s kick / snare / bass / tone mix at 22050 Hz made from a seed goes
through each JAX function (on the CPU, complex FFT path) and its port.
Tolerances, absolute: 1e-5 relative to the signal scale for the
STFT-domain and time-domain signals, 2e-3 for the onset ensemble (its
complex-flux term reads the STFT phase of near-silent bins, where the
two FFT libraries disagree in the last bits), 1e-4 for the other
normalized envelopes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.audio import chroma as JC
from maua_tpu.audio import constantq as JQ
from maua_tpu.audio import latent as JL
from maua_tpu.audio import mir as JM
from maua_tpu.audio import spectral as JS
from maua_tpu.audiovisual import audioreactive as JA
from maua_tpu.ops import signal as JSig
from maua_tpu_torch.audio import chroma as TC
from maua_tpu_torch.audio import constantq as TQ
from maua_tpu_torch.audio import convert as TConv
from maua_tpu_torch.audio import io as TIO
from maua_tpu_torch.audio import latent as TL
from maua_tpu_torch.audio import mir as TM
from maua_tpu_torch.audio import spectral as TS
from maua_tpu_torch.audiovisual import audioreactive as TA
from maua_tpu_torch.ops import signal as TSig

SR = 22050


def synth(seconds=2.0, sr=SR, seed=0):
    rs = np.random.RandomState(seed)
    t = np.arange(int(sr * seconds)) / sr
    y = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 55 * t)
    n = int(0.1 * sr)
    env = np.exp(-np.arange(n) / (0.02 * sr))
    for b in np.arange(0, seconds, 0.5):
        i = int(b * sr)
        y[i : i + n] += 0.8 * np.sin(2 * np.pi * 60 * np.arange(n) / sr) * env
        j = int((b + 0.25) * sr)
        if j + n <= len(y):
            y[j : j + n] += 0.3 * rs.randn(n) * env
    return y.astype(np.float32)


Y = synth()
YT = torch.from_numpy(Y)
YJ = jnp.asarray(Y)


def close(out, ref, atol_rel):
    ref = np.asarray(ref)
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=atol_rel * max(float(np.abs(ref).max()), 1e-6))


@pytest.mark.parametrize("name,jfn,tfn,tol", [
    ("stft", lambda: np.abs(JS.stft(YJ, 2048, 512)), lambda: TS.stft(YT, 2048, 512).abs(), 1e-6),
    ("istft", lambda: JS.istft(JS.stft(YJ, 2048, 512), 2048, 512, length=len(Y)),
     lambda: TS.istft(TS.stft(YT, 2048, 512), 2048, 512, length=len(Y)), 1e-5),
    ("rms", lambda: JS.rms(YJ), lambda: TS.rms(YT), 1e-5),
    ("harmonic", lambda: JS.harmonic(YJ, 3.0), lambda: TS.harmonic(YT, 3.0), 1e-5),
    ("percussive", lambda: JS.percussive(YJ, 2.0), lambda: TS.percussive(YT, 2.0), 1e-5),
    ("decimate2", lambda: JQ.decimate2(YJ), lambda: TQ.decimate2(YT), 1e-5),
    ("cqt", lambda: np.abs(JQ.cqt(YJ, SR, n_bins=84)), lambda: TQ.cqt(YT, SR, n_bins=84).abs(), 1e-5),
    ("chroma_cqt", lambda: JC.chroma_cqt(YJ, sr=SR), lambda: TC.chroma_cqt(YT, sr=SR), 1e-5),
    ("chroma_cens", lambda: JC.chroma_cens(YJ, sr=SR), lambda: TC.chroma_cens(YT, sr=SR), 1e-5),
    ("onset_ensemble", lambda: JM.onset_ensemble(YJ, SR), lambda: TM.onset_ensemble(YT, SR), 2e-3),
    ("mir.chroma", lambda: JM.chroma(YJ, SR, preharmonic=2), lambda: TM.chroma(YT, SR, preharmonic=2), 1e-4),
    ("mir.onsets", lambda: JM.onsets(YJ, SR), lambda: TM.onsets(YT, SR), 2e-3),
])
def test_feature(name, jfn, tfn, tol):
    close(tfn(), jfn(), tol)


def test_hpss_masks():
    S = np.abs(np.asarray(JS.stft(YJ, 2048, 512))).astype(np.float32)
    for margin in (1.0, 3.0):
        for a, b in zip(TS.hpss(torch.from_numpy(S), mask=True, margin=margin),
                        JS.hpss(jnp.asarray(S), mask=True, margin=margin)):
            close(a, b, 1e-6)


@pytest.mark.parametrize("size", [4, 5])
def test_median_filter(size):
    x = np.random.RandomState(1).rand(6, 40).astype(np.float32)
    for dim in (-1, -2):
        close(TS.median_filter_axis(torch.from_numpy(x), size, dim),
              JS._median_filter_axis(jnp.asarray(x), size, dim), 1e-7)


def test_nn_filter_chunked_matches_whole():
    x = np.abs(np.random.RandomState(2).randn(12, 50)).astype(np.float32)
    ref = JC.nn_filter_cosine_median(jnp.asarray(x))
    close(TC.nn_filter_cosine_median(torch.from_numpy(x)), ref, 1e-6)
    close(TC.nn_filter_cosine_median(torch.from_numpy(x), chunk=16), ref, 1e-6)


def test_filterbanks_and_conversions():
    from maua_tpu.audio import convert as JConv

    np.testing.assert_allclose(TConv.cq_to_chroma(84, 36), JConv.cq_to_chroma(84, 36))
    # the JAX filterbank computes the bin octaves in f32, the port in f64
    np.testing.assert_allclose(TConv.chroma_filterbank(SR, 2048), JConv.chroma_filterbank(SR, 2048),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(TConv.cqt_frequencies(24, 32.7, 12), JConv.cqt_frequencies(24, 32.7, 12))
    assert TConv.note_to_hz("C1") == JConv.note_to_hz("C1")
    np.testing.assert_allclose(TM._log_filterbank(float(SR), 2048), JM._log_filterbank(SR, 2048))
    mag = np.abs(np.asarray(JS.stft(YJ, 2048, 512)))
    close(TConv.amplitude_to_db(torch.from_numpy(mag)), JConv.amplitude_to_db(jnp.asarray(mag)), 1e-5)


@pytest.mark.parametrize("fn", ["low_pass", "band_pass", "high_pass"])
def test_filters(fn):
    from maua_tpu.audio import io as JIO

    args = {"low_pass": (100,), "band_pass": (100, 400), "high_pass": (3000,)}[fn]
    ref = getattr(JIO, fn)(Y, SR, *args)
    np.testing.assert_array_equal(getattr(TIO, fn)(Y, SR, *args), ref)
    out = getattr(TIO, fn)(YT, SR, *args)
    assert isinstance(out, torch.Tensor)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("sigma,causal,mode,t", [(2.0, 0.0, "circular", 48), (15.0, None, "circular", 20),
                                                 (5.0, None, "reflect", 48), (1.0, 0.5, "replicate", 7)])
def test_gaussian_filter(sigma, causal, mode, t):
    x = np.random.RandomState(3).randn(t, 3).astype(np.float32)
    close(TSig.gaussian_filter(torch.from_numpy(x), sigma, causal=causal, mode=mode),
          JSig.gaussian_filter(jnp.asarray(x), sigma, causal=causal, mode=mode), 1e-6)


def test_signal_ops():
    rs = np.random.RandomState(4)
    env = np.abs(rs.randn(87)).astype(np.float32)
    mat = np.abs(rs.randn(87, 12)).astype(np.float32)
    close(TSig.resample_1d(torch.from_numpy(mat), 48), JSig.resample_1d(jnp.asarray(mat), 48), 1e-6)
    close(TSig.percentile_clip(torch.from_numpy(env), 95.0), JSig.percentile_clip(jnp.asarray(env), 95.0), 1e-6)
    close(TSig.percentile_clip(torch.from_numpy(mat), 80.0), JSig.percentile_clip(jnp.asarray(mat), 80.0), 1e-6)
    close(TSig.normalize(torch.from_numpy(env)), JSig.normalize(jnp.asarray(env)), 1e-6)
    close(TSig.compress(torch.from_numpy(env), 0.5, 2.0), JSig.compress(jnp.asarray(env), 0.5, 2.0), 1e-6)


def test_latent_loops():
    lat = np.random.RandomState(5).randn(5, 4, 8).astype(np.float32)
    close(TL.spline_loops(torch.from_numpy(lat), 30, 2), JL.spline_loops(jnp.asarray(lat), 30, 2), 1e-5)
    close(TL.slerp_loops(torch.from_numpy(lat), 30, 1), JL.slerp_loops(jnp.asarray(lat), 30, 1), 1e-5)


def test_audioreactive_envelopes():
    n = 48
    close(TA.onsets(YT, SR, n, margin=2, clip=95, smooth=2), JA.onsets(Y, SR, n, margin=2, clip=95, smooth=2), 2e-3)
    close(TA.rms(YT, SR, n, smooth=20, clip=95), JA.rms(Y, SR, n, smooth=20, clip=95), 1e-4)
    close(TA.chroma(YT, SR, n, margin=2), JA.chroma(Y, SR, n, margin=2), 1e-4)
    ch = np.random.RandomState(6).rand(n, 12).astype(np.float32)
    lat = np.random.RandomState(7).randn(12, 3, 8).astype(np.float32)
    close(TA.chroma_weight_latents(torch.from_numpy(ch), torch.from_numpy(lat)),
          JA.chroma_weight_latents(jnp.asarray(ch), jnp.asarray(lat)), 1e-6)


def test_separate_sources():
    for a, b in zip(TA.separate_sources(YT, SR), JA.separate_sources(Y, SR)):
        close(a, b, 1e-5)


def test_load_audio_writes_nothing(tmp_path):
    from scipy.io import wavfile

    wav = tmp_path / "mix.wav"
    y = Y / np.abs(Y).max()
    wavfile.write(wav, SR, (y * 32767).astype(np.int16))
    before = sorted(p.name for p in tmp_path.iterdir())
    audio, sr, duration = TIO.load_audio(str(wav))
    assert sr == SR and audio.dtype == np.float32 and abs(duration - 2.0) < 1e-6
    np.testing.assert_allclose(audio, y, atol=1e-4)
    assert sorted(p.name for p in tmp_path.iterdir()) == before
