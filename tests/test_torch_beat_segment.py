"""The port's mel-based features, segmentation, the rest of the `ar` API,
the latent blends and the patch primitives against maua_tpu's.

Signals are made from a seed with numpy: a 3 s kick / snare / bass / tone
mix (the recipe of tests/test_torch_audio.py), a 4 s 120 BPM click track
(tests/test_audio_mir.py's) and an 8 s click track over two alternating
chords (A B A B, 2 s each), which has structure to segment. Each goes
through the JAX function (CPU, complex FFT path) and its port.

Tolerances, relative to the reference's peak magnitude: 1e-5 for the
envelopes, tempograms, pulses and pitch tracks (f32 FFTs of two
libraries); 1e-4 where the chroma filterbank enters (the JAX package
computes its bin octaves in float32, the port in float64, measured 4.5e-5
on the chroma); 1e-6 for pure array code (latents, recurrence, k-means
centres). Discrete picks must agree exactly on these signals, whose tempo
and structure are unambiguous: tempo in BPM (to 0 BPM), k-means labels,
segment boundaries (to 1e-9 s) and labels up to a permutation. k-means
gets JAX's initial centre indices (`jax.random.choice(PRNGKey(0), ...)`,
which a torch generator cannot reproduce; the segmentation tests inject
them by patching `segment.kmeans`); the noise primitives get the
same standard-normal draws on both sides. The nearest-neighbour chroma
filter is such a pick too: many frames of these tonal mixes are equally
similar up to f32 roundoff, and the two libraries' similarities differ
in the last bits, so the k-th neighbour can fall either way. Its own
test holds the port's pick to JAX's up to those near-ties; the feature
tests hand the port JAX's pick (`jax_nn_choice`) and hold the rest to
the usual bars.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.audio import beat as JB
from maua_tpu.audio import chroma as JC
from maua_tpu.audio import latent as JL
from maua_tpu.audio import mir as JM
from maua_tpu.audio import pitch as JP
from maua_tpu.audio import segment as JSg
from maua_tpu.audiovisual import audioreactive as JA
from maua_tpu.audiovisual.patches import primitives as JPr
from maua_tpu_torch.audio import beat as TB
from maua_tpu_torch.audio import chroma as TC
from maua_tpu_torch.audio import latent as TL
from maua_tpu_torch.audio import mir as TM
from maua_tpu_torch.audio import pitch as TP
from maua_tpu_torch.audio import segment as TSg
from maua_tpu_torch.audiovisual import audioreactive as TA
from maua_tpu_torch.audiovisual.patches import primitives as TPr

SR = 22050


def mix(seconds=3.0, seed=0):
    rs = np.random.RandomState(seed)
    t = np.arange(int(SR * seconds)) / SR
    y = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 55 * t)
    n = int(0.1 * SR)
    env = np.exp(-np.arange(n) / (0.02 * SR))
    for b in np.arange(0, seconds, 0.5):
        i = int(b * SR)
        y[i : i + n] += 0.8 * np.sin(2 * np.pi * 60 * np.arange(n) / SR) * env
        j = int((b + 0.25) * SR)
        if j + n <= len(y):
            y[j : j + n] += 0.3 * rs.randn(n) * env
    return y.astype(np.float32)


def clicks(seconds=4.0, seed=0):
    y = np.zeros(int(SR * seconds), np.float32)
    for i in range(0, len(y), SR // 2):
        y[i : i + 64] += np.hanning(64).astype(np.float32)[: len(y) - i]
    return y + 0.01 * np.random.RandomState(seed).randn(len(y)).astype(np.float32)


def sections(seconds=8.0):
    """Clicks at 120 BPM over chords A (A3 C#4 E4) and B (F3 A3 C4) in turn, 2 s each."""
    y = clicks(seconds)
    t = np.arange(len(y)) / SR
    chords = ([220.0, 277.18, 329.63], [174.61, 220.0, 261.63])
    for s in range(int(seconds // 2)):
        part = slice(int(2 * s * SR), int(2 * (s + 1) * SR))
        y[part] += sum(0.15 * np.sin(2 * np.pi * f * t[part]) for f in chords[s % 2]).astype(np.float32)
    return y


MIX, CLICKS, SECTIONS = mix(), clicks(), sections()


def close(out, ref, tol):
    ref = np.asarray(ref)
    if isinstance(out, torch.Tensor):
        out = out.numpy()
    out = np.asarray(out)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(float(np.abs(ref).max()), 1e-6))


def both(y):
    return torch.from_numpy(y), jnp.asarray(y)


@pytest.mark.parametrize("name", ["mix", "clicks"])
@pytest.mark.parametrize("kw", [{}, {"lag": 2, "max_size": 3}, {"hop_length": 1024, "n_mels": 64}])
def test_onset_strength(name, kw):
    yt, yj = both({"mix": MIX, "clicks": CLICKS}[name])
    close(TB.onset_strength(yt, SR, **kw), JB.onset_strength(yj, SR, **kw), 1e-5)


@pytest.fixture(scope="module")
def envelope():
    oe = np.asarray(JB.onset_strength(jnp.asarray(MIX), SR))
    return torch.from_numpy(oe.copy()), jnp.asarray(oe)


def test_autocorrelate_and_tempograms(envelope):
    ot, oj = envelope
    close(TB.autocorrelate(ot), JB.autocorrelate(oj), 1e-5)
    close(TB.autocorrelate(ot, max_size=50), JB.autocorrelate(oj, max_size=50), 1e-5)
    close(TB.tempogram(ot), JB.tempogram(oj), 1e-5)
    close(TB.tempogram(ot, win_length=64, center=False), JB.tempogram(oj, win_length=64, center=False), 1e-5)
    ft, fj = TB.fourier_tempogram(ot, win_length=128), np.asarray(JB.fourier_tempogram(oj, win_length=128))
    close(ft.real, fj.real, 1e-5)
    close(ft.imag, fj.imag, 1e-5)


@pytest.mark.parametrize("kw", [{}, {"tempo_min": 60.0, "tempo_max": 180.0, "win_length": 128}])
def test_plp(envelope, kw):
    ot, oj = envelope
    close(TB.plp(ot, SR, **kw), JB.plp(oj, SR, **kw), 1e-5)


@pytest.mark.parametrize("name", ["mix", "clicks"])
def test_tempo_is_the_same_bpm(name):
    yt, yj = both({"mix": MIX, "clicks": CLICKS}[name])
    ref = float(JB.tempo(JB.onset_strength(yj, SR), SR))
    out = TB.tempo(TB.onset_strength(yt, SR), SR)
    assert out.dim() == 0 and float(out) == ref
    if name == "clicks":
        assert abs(ref - 120.0) < 5.0


def jax_neighbours(x):
    """The frames `maua_tpu.audio.chroma.nn_filter_cosine_median` picks for
    x (d, T), T within one chunk, by the same ops (so the same bits), and
    the similarities it picks them by."""
    t = x.shape[1]
    k = min(t - 1, int(2 * np.ceil(np.sqrt(t))))
    x = jnp.asarray(x)
    xn = x / jnp.maximum(jnp.linalg.norm(x, axis=0, keepdims=True), 1e-10)
    sim = xn.T @ xn - 2.0 * jnp.eye(t)
    return np.asarray(jax.lax.top_k(sim, k)[1]), np.asarray(sim)


@pytest.fixture
def jax_nn_choice(monkeypatch):
    """The port's nearest-neighbour filter takes the frames that JAX's
    filter picked in the call before it (JAX runs first)."""
    picks = []
    jax_filter = JC.nn_filter_cosine_median

    def recording(x, k=None, chunk=2048):
        assert k is None and x.shape[1] <= chunk
        picks.append(jax_neighbours(x)[0])
        return jax_filter(x, k, chunk)

    def replaying(x, k=None, chunk=2048):
        return torch.from_numpy(picks.pop(0)).long().to(x.device)

    monkeypatch.setattr(JC, "nn_filter_cosine_median", recording)
    monkeypatch.setattr(TC, "nn_neighbours", replaying)
    return picks


def harmonic_chroma(y):
    """The STFT chroma of `mir.chroma(type="stft")`: of the harmonic part at margin 4, as each package computes it."""
    from maua_tpu.audio import spectral as JS
    from maua_tpu_torch.audio import spectral as TS

    return (TC.chroma_stft(TS.harmonic(torch.from_numpy(y), margin=4.0), SR).numpy(),
            np.array(JC.chroma_stft(JS.harmonic(jnp.asarray(y), margin=4.0), SR)))


@pytest.mark.parametrize("which", ["jax", "port"])
def test_nn_neighbours_match_jax_up_to_near_ties(which):
    """On the same chroma, the port picks JAX's neighbours except where the
    similarity at the k-th place ties within f32 roundoff: every frame only
    one of them picks lies within 1e-6 of JAX's k-th similarity. (The mix
    holds frames whose similarity is 1 to the last bit, so ties are many;
    exact ties go to the lower index on both sides.) A random chroma has
    no near-ties, and there the picks are the same."""
    x = dict(zip(["port", "jax"], harmonic_chroma(MIX)))[which]
    nbr_j, sim = jax_neighbours(x)
    nbr_t = TC.nn_neighbours(torch.from_numpy(x)).numpy()
    assert nbr_t.shape == nbr_j.shape
    k = nbr_j.shape[1]
    kth = np.sort(sim, axis=1)[:, ::-1][:, k - 1]
    split = 0
    for r in range(x.shape[1]):
        only = set(nbr_t[r].tolist()) ^ set(nbr_j[r].tolist())
        split += bool(only)
        for i in only:
            assert abs(sim[r, i] - kth[r]) <= 1e-6, (r, i, sim[r, i], kth[r])
    assert split < x.shape[1]
    ch = np.abs(np.random.RandomState(3).randn(12, 40)).astype(np.float32)
    np.testing.assert_array_equal(np.sort(TC.nn_neighbours(torch.from_numpy(ch)).numpy(), 1),
                                  np.sort(jax_neighbours(ch)[0], 1))


def test_tonnetz_without_the_neighbour_filter():
    """The cause of the tonnetz divergence is the neighbour pick: without
    the filter the two packages agree ten times inside the feature's bar."""
    yt, yj = both(MIX)
    ref = JM.tonnetz(yj, SR, type="stft", nearest_neighbor=False)
    close(TM.tonnetz(yt, SR, type="stft", nearest_neighbor=False), ref, 1e-5)


def test_chroma_stft_and_tonnetz():
    yt, yj = both(MIX)
    close(TC.chroma_stft(yt, SR), JC.chroma_stft(yj, SR), 1e-4)
    close(TC.chroma_stft(yt, SR, n_fft=1024, hop_length=256, tuning=0.2),
          JC.chroma_stft(yj, SR, n_fft=1024, hop_length=256, tuning=0.2), 1e-4)
    ch = np.abs(np.random.RandomState(3).randn(12, 40)).astype(np.float32)
    close(TC.tonnetz(torch.from_numpy(ch)), JC.tonnetz(jnp.asarray(ch)), 1e-6)


def test_pitch():
    yt, yj = both(MIX)
    (pt, mt), (pj, mj) = TP.piptrack(yt, SR), JP.piptrack(yj, SR)
    close(pt, pj, 1e-5)
    close(mt, mj, 1e-5)
    assert float(TP.estimate_tuning(yt, SR)) == pytest.approx(float(JP.estimate_tuning(yj, SR)), abs=1e-6)
    close(TP.pitch_track_envelope(yt, SR), JP.pitch_track_envelope(yj, SR), 1e-5)
    # off the bin edges: an edge's last bit differs between jnp.linspace and torch.linspace
    f = np.array([[441.0, 0.0, 452.0], [0.0, 0.0, 0.0]], np.float32)
    assert float(TP.pitch_tuning(torch.from_numpy(f))) == pytest.approx(float(JP.pitch_tuning(jnp.asarray(f))),
                                                                      abs=1e-6)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_recurrence_and_timelag_filter(metric):
    X = np.abs(np.random.RandomState(4).randn(10, 30)).astype(np.float32)
    R = TSg.recurrence_matrix(torch.from_numpy(X), width=3, metric=metric)
    Rj = JSg.recurrence_matrix(jnp.asarray(X), width=3, metric=metric)
    close(R, Rj, 1e-6)
    close(TSg.recurrence_matrix(torch.from_numpy(X), k=4, sym=False, metric=metric),
          JSg.recurrence_matrix(jnp.asarray(X), k=4, sym=False, metric=metric), 1e-6)
    close(TSg.timelag_median_filter(torch.from_numpy(np.array(Rj))), JSg.timelag_median_filter(Rj), 1e-6)


def test_kmeans_and_sync_median():
    X = np.random.RandomState(5).randn(40, 3).astype(np.float32)
    X[:20] += 4.0
    init = np.asarray(jax.random.choice(jax.random.PRNGKey(0), 40, (3,), replace=False))
    labels, centers = TSg.kmeans(torch.from_numpy(X), 3, init_idx=init)
    lj, cj = JSg.kmeans(jnp.asarray(X), 3)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(lj))
    close(centers, cj, 1e-6)
    own, _ = TSg.kmeans(torch.from_numpy(X), 3)  # the default draw: a generator seeded with 0
    seeded = torch.randperm(40, generator=torch.Generator().manual_seed(0))[:3]
    assert torch.equal(own, TSg.kmeans(torch.from_numpy(X), 3, init_idx=seeded)[0])
    bounds = np.array([0, 3, 10, 11])
    close(TSg.sync_median(torch.from_numpy(X.T), bounds, 4), JSg.sync_median(jnp.asarray(X.T), bounds, 4), 1e-6)


@pytest.fixture
def jax_kmeans_init(monkeypatch):
    """Segmentation's k-means starts from the centres JAX draws with PRNGKey(0)."""
    kmeans = TSg.kmeans

    def with_jax_init(X, k, n_iter=50, init_idx=None):
        init = np.asarray(jax.random.choice(jax.random.PRNGKey(0), X.shape[0], (k,), replace=False))
        return kmeans(X, k, n_iter, init_idx=init)

    monkeypatch.setattr(TSg, "kmeans", with_jax_init)


def same_up_to_permutation(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and len(set(zip(a.tolist(), b.tolist()))) == len(set(a.tolist())) == len(set(b.tolist()))


@pytest.mark.parametrize("k", [2, 3])
def test_laplacian_segmentation(k, jax_kmeans_init):
    yt, yj = both(SECTIONS)
    times_j, labels_j = JSg.laplacian_segmentation(yj, SR, k=k)
    times_t, labels_t = TSg.laplacian_segmentation(yt, SR, k=k)
    np.testing.assert_allclose(times_t, times_j, rtol=0, atol=1e-9)
    assert same_up_to_permutation(labels_t, labels_j)


@pytest.mark.parametrize("type,tol", [("rosa", 1e-5), ("mm", 2e-3)])
def test_mir_pulse_and_tempo(type, tol):
    """The "mm" ensemble agrees to 2e-3 (tests/test_torch_audio.py: its
    complex flux reads the phase of near-silent bins), and so its pulse."""
    yt, yj = both(MIX)
    close(TM.pulse(yt, SR, type=type), JM.pulse(yj, SR, type=type), tol)
    assert TM.tempo(yt, SR, type=type) == JM.tempo(yj, SR, type=type)


def test_mir_features(jax_nn_choice):
    """The chroma features take JAX's nearest-neighbour pick (`jax_nn_choice`; JAX runs first)."""
    yt, yj = both(MIX)
    close(TM.spectral_max(yt, SR), JM.spectral_max(yj, SR), 1e-5)
    close(TM.volume(yt, SR), JM.volume(yj, SR), 1e-5)
    close(TM.pitch_track(yt, SR, preharmonic=0), JM.pitch_track(yj, SR, preharmonic=0), 1e-5)
    ref = JM.tonnetz(yj, SR, type="stft")
    close(TM.tonnetz(yt, SR, type="stft"), ref, 1e-4)
    ref = np.asarray(JM.pitch_dominance(yj, SR, type="cqt"))
    np.testing.assert_array_equal(TM.pitch_dominance(yt, SR, type="cqt").numpy(), ref)
    assert not jax_nn_choice  # each of the port's filters took a pick of JAX's
    close(TM.onsets(yt, SR, type="rosa"), JM.onsets(yj, SR, type="rosa"), 1e-5)
    assert TM.round_to_nearest_half(120.3) == JM.round_to_nearest_half(120.3) == 120.5


def test_ar_api():
    n = 36
    yt = torch.from_numpy(MIX)
    close(TA.onsets(yt, SR, n, margin=2, smooth=2, type="rosa"), JA.onsets(MIX, SR, n, margin=2, smooth=2, type="rosa"),
          1e-5)
    close(TA.volume(yt, SR, n, smooth=2), JA.volume(MIX, SR, n, smooth=2), 1e-5)
    close(TA.volume(yt, SR), JA.volume(MIX, SR), 1e-5)
    close(TA.pulse(yt, SR, n, type="rosa"), JA.pulse(MIX, SR, n, type="rosa"), 1e-5)
    for type in ("stft", "cqt"):
        close(TA.chroma(yt, SR, n, type=type), JA.chroma(MIX, SR, n, type=type), 1e-4)
    close(TA.chroma(yt, SR, n, type="stft", notes=5), JA.chroma(MIX, SR, n, type="stft", notes=5), 1e-4)
    assert TA.tempo(yt, SR, type="rosa") == JA.tempo(MIX, SR, type="rosa")


def test_ar_tempo_and_segmentation_on_clicks(jax_kmeans_init):
    yt, yj = both(CLICKS)
    main = TA.tempo(yt, SR, type="rosa")[0]
    assert main == JA.tempo(CLICKS, SR, type="rosa")[0] and abs(main - 120.0) <= 2.5
    times_t, labels_t = TA.laplacian_segmentation(yt, SR)
    times_j, labels_j = JA.laplacian_segmentation(CLICKS, SR)
    np.testing.assert_allclose(times_t, times_j, rtol=0, atol=1e-9)
    assert same_up_to_permutation(labels_t, labels_j)


def test_latent_blends():
    rs = np.random.RandomState(6)
    lat = rs.randn(4, 3, 8).astype(np.float32)
    env = rs.rand(30).astype(np.float32)
    envs = rs.rand(30, 6).astype(np.float32)
    lt, ljx = torch.from_numpy(lat), jnp.asarray(lat)
    close(TL.single_weighted(lt[0], lt[1], torch.from_numpy(env)), JL.single_weighted(ljx[0], ljx[1], jnp.asarray(env)),
          1e-6)
    close(TL.multi_weighted(lt, torch.from_numpy(envs)), JL.multi_weighted(ljx, jnp.asarray(envs)), 1e-6)
    close(TL.select_modulo(lt, torch.from_numpy(env)), JL.select_modulo(ljx, jnp.asarray(env)), 1e-6)
    a, b, t = np.float32(0.7), np.float32(0.2), np.linspace(0, 1, 7).astype(np.float32)
    close(TL.eerp(a, b, torch.from_numpy(t)), JL.eerp(a, b, jnp.asarray(t)), 1e-6)
    close(TL.copeerp(a, b, torch.from_numpy(t)), JL.copeerp(a, b, jnp.asarray(t)), 1e-6)
    for type in ("spline", "slerp"):
        close(TL.tempo_loops(lt, 50, 12.0, 123.0, type=type), JL.tempo_loops(ljx, 50, 12.0, 123.0, type=type), 1e-5)


@pytest.mark.parametrize("type,loop_len", [("spline", 20), ("slerp", 20), ("gaussian", 21), ("constant", 9)])
def test_loop_latents(type, loop_len):
    lat = np.random.RandomState(7).randn(4, 3, 8).astype(np.float32)
    close(TPr.loop_latents(torch.from_numpy(lat), loop_len, type=type),
          JPr.loop_latents(jnp.asarray(lat), loop_len, type=type), 1e-5)
    close(TPr.tempo_loop_latents(120.0, torch.from_numpy(lat), 2, 6.0, type=type),
          JPr.tempo_loop_latents(120.0, jnp.asarray(lat), 2, 6.0, type=type), 1e-5)
    assert TPr.tempo_loop_latents(120.0, torch.from_numpy(lat[:1]), 2, 6.0).shape == (1, 3, 8)


def test_tonal_and_modulated_primitives():
    rs = np.random.RandomState(8)
    lat = rs.randn(5, 3, 8).astype(np.float32)
    ch = rs.rand(20, 12).astype(np.float32)
    mod = rs.rand(20).astype(np.float32)
    pitch = (rs.rand(20) * 400 + 100).astype(np.float32)
    lt, ljx = torch.from_numpy(lat), jnp.asarray(lat)
    close(TPr.pitch_track_latents(torch.from_numpy(pitch), lt), JPr.pitch_track_latents(jnp.asarray(pitch), ljx), 1e-6)
    close(TPr.tonal_latents(torch.from_numpy(ch), lt), JPr.tonal_latents(jnp.asarray(ch), ljx), 1e-6)
    close(TPr.modulated_latents(torch.from_numpy(mod), lt), JPr.modulated_latents(jnp.asarray(mod), ljx), 1e-6)
    base = rs.randn(7, 6, 6, 1).astype(np.float32)
    close(TPr.modulated_noise(torch.from_numpy(mod), torch.from_numpy(base)),
          JPr.modulated_noise(jnp.asarray(mod), jnp.asarray(base)), 1e-6)
    seqs = [(rs.randn(9, 3, 8).astype(np.float32), rs.rand(20).astype(np.float32)) for _ in range(3)]
    out = TPr.modulation_sum([TPr.Modulated(torch.from_numpy(s), torch.from_numpy(m)) for s, m in seqs], 20)
    close(out, JPr.modulation_sum([JPr.Modulated(jnp.asarray(s), jnp.asarray(m)) for s, m in seqs], 20), 1e-6)


def test_noise_primitives_with_the_same_draws(monkeypatch):
    """The port draws from a torch generator; JAX gets those draws in place of jax.random.normal's."""
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    ch = torch.from_numpy(np.random.RandomState(9).rand(15, 12).astype(np.float32))
    draws = {"loop": torch.randn(15, 8, 8, 1, generator=gen()), "tonal": torch.randn(12, 8, 8, 1, generator=gen())}
    for name, out, call in (
        ("loop", TPr.loop_noise(15, 8, 2.0, generator=gen()), lambda: JPr.loop_noise(15, 8, 2.0)),
        ("tonal", TPr.tonal_noise(ch, 8, generator=gen()), lambda: JPr.tonal_noise(jnp.asarray(ch.numpy()), 8)),
    ):
        monkeypatch.setattr(jax.random, "normal", lambda key, shape, d=draws[name].numpy(): jnp.asarray(d))
        close(out, call(), 1e-5)
    monkeypatch.undo()
    assert TPr.tempo_loop_noise(120.0, 1, 4.0, size=4, smooth=1.0, generator=gen()).shape == (8, 4, 4, 1)
