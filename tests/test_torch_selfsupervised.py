"""The port's self-supervised patches (audiovisual/selfsupervised/*)
against maua_tpu, on the CPU.

2 s of synthetic audio: two tones under a crescendo, clicks every 0.25 s
and a noise floor 26 dB below the tones, as music has (the valley of a
spectral-contrast band is its smallest bins; on a bare tone they sit at
the FFT's roundoff, where JAX's FFT and torch's disagree in dB by a
tenth of the feature's range). maua_tpu's features and MIR are computed
once for the module, with ks (2, 4), and handed to its `generate` by
monkeypatching the name in this test. Its random draws are made by JAX
from the keys maua_tpu folds and handed to the port through
`Patch.draws` and `seeded_normal`; its k-means starts from the rows JAX
draws with PRNGKey(0).

Tolerances: f32 features and MIR envelopes <= 1e-4 of the feature's
largest magnitude; the same tempo; segmentations equal up to relabelling;
latents and noise windows <= 1e-5 absolute (values ~1), but 5e-5 for a
window with a Loop in it: a Loop's phase is cos(...) / (sigma / 50), so
the one-ulp difference between XLA's f32 cos and torch's (6e-8) grows up
to 50-fold before the sine (the phase itself is computed as XLA computes
jnp.linspace, to the bit); patch choices,
repr and JSON identical; `generate`'s frames >= 40 dB PSNR against
maua_tpu's (a 32^2 StyleGAN2 in f32 through both s2d routes).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from maua_tpu import utility as jax_utility
from maua_tpu.audio import segment as JSeg
from maua_tpu.audiovisual.selfsupervised import features as JF
from maua_tpu.audiovisual.selfsupervised import latent as JL
from maua_tpu.audiovisual.selfsupervised import mir as JM
from maua_tpu.audiovisual.selfsupervised import noise as JN
from maua_tpu.audiovisual.selfsupervised import patch as JP
from maua_tpu.audiovisual.selfsupervised import sample as JS
from maua_tpu.gan import stylegan2 as J2
from maua_tpu.ops import signal as JSig
from maua_tpu_torch import __main__ as cli_main
from maua_tpu_torch import bridge
from maua_tpu_torch.audio import segment as TSeg
from maua_tpu_torch.audio import spectral as TSpec
from maua_tpu_torch.audiovisual.selfsupervised import features as TF
from maua_tpu_torch.audiovisual.selfsupervised import latent as TL
from maua_tpu_torch.audiovisual.selfsupervised import mir as TM
from maua_tpu_torch.audiovisual.selfsupervised import noise as TN
from maua_tpu_torch.audiovisual.selfsupervised import patch as TP
from maua_tpu_torch.audiovisual.selfsupervised import sample as TS
from maua_tpu_torch.gan import stylegan2 as T2
from maua_tpu_torch.ops import signal as TSig
from test_torch_stylegan2 import random_jax_params

SR = 22050
SECONDS = 2.0
KS = (2, 4)
LOOP_TOL = 5e-5  # a window with a Loop in it (see above)
SG2_KW = dict(img_resolution=32, channel_base=256, channel_max=32, z_dim=32, w_dim=32, mapping_layers=2,
              num_fp16_res=0)


def test_audio(seconds: float = SECONDS, seed: int = 0) -> np.ndarray:
    rs = np.random.RandomState(seed)
    t = np.arange(int(SR * seconds)) / SR
    y = (0.4 * np.sin(2 * np.pi * 330 * t) + 0.2 * np.sin(2 * np.pi * 110 * t) * (1 + np.sin(2 * np.pi * 1.5 * t)))
    y = y * (0.4 + 0.6 * t / seconds)
    for i in range(0, len(y) - 400, SR // 4):
        y[i : i + 400] += rs.randn(400) * np.hanning(400) * 0.5
    return (y + 2e-2 * rs.randn(len(y))).astype(np.float32)


test_audio.__test__ = False  # a helper that other test modules import, not a test


def close_to_max(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err} of the largest magnitude > {tol}"


def same_up_to_relabelling(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and len(set(zip(a.tolist(), b.tolist()))) == len(set(a.tolist())) == len(set(b.tolist()))


def fold(key, path):
    for i in path:
        key = jax.random.fold_in(key, i)
    return key


class JaxDraws:
    """A realization's draws made by JAX from the keys maua_tpu folds for them."""

    def __init__(self, seed, device):
        self.key, self.device = jax.random.PRNGKey(seed), device

    def permutation(self, path, n):
        return torch.from_numpy(np.array(jax.random.permutation(fold(self.key, path), n))).to(self.device)

    def normal(self, path, shape):
        return torch.from_numpy(np.array(jax.random.normal(fold(self.key, path), shape))).to(self.device)


def jax_seeded_normal(seed, shape, device=None):
    return torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(seed), shape))).to(device or "cpu")


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(TP.Patch, "draws", lambda self, device: JaxDraws(self.seed, device))
    monkeypatch.setattr(TP, "seeded_normal", jax_seeded_normal)


@pytest.fixture
def jax_kmeans_init(monkeypatch):
    kmeans = TSeg.kmeans

    def with_jax_init(X, k, n_iter=50, init_idx=None):
        init = np.asarray(jax.random.choice(jax.random.PRNGKey(0), X.shape[0], (k,), replace=False))
        return kmeans(X, k, n_iter, init_idx=init)

    monkeypatch.setattr(TSeg, "kmeans", with_jax_init)


@pytest.fixture(scope="module")
def audio():
    return test_audio()


@pytest.fixture(scope="module")
def jax_raw(audio):
    return {k: np.asarray(v) for k, v in JF.extract_features(audio, SR).items()}


@pytest.fixture(scope="module")
def jax_mir(audio, jax_raw):
    """maua_tpu's (features, segmentations, tempo), its features computed once."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JM, "extract_features", lambda a, sr: {k: jnp.asarray(v) for k, v in jax_raw.items()})
        feats, segs, tempo = JM.retrieve_music_information(audio, SR, ks=KS)
    return {k: np.asarray(v) for k, v in feats.items()}, {k: np.asarray(v) for k, v in segs.items()}, tempo


def torch_mir(jax_mir):
    feats, segs, tempo = jax_mir
    return {k: torch.from_numpy(v.copy()) for k, v in feats.items()}, dict(segs), tempo


@pytest.fixture(scope="module")
def torch_raw(audio):
    return TF.extract_features(torch.from_numpy(audio), SR)


@pytest.mark.parametrize("name", [fn.__name__ for fn in TF.AFEATFNS])
def test_features_match_maua_tpu(torch_raw, jax_raw, name):
    close_to_max(torch_raw[name].numpy(), jax_raw[name], 1e-4, name)


def test_pulse_matches_maua_tpu(audio):
    close_to_max(TF.pulse(torch.from_numpy(audio), SR), JF.pulse(audio, SR), 1e-4, "pulse")


def test_extract_features_cuts_to_one_length(torch_raw):
    feats = torch_raw
    dims = {"chromagram": 12, "tonnetz": 6, "mfcc": 20, "spectral_contrast": 7, "spectral_flatness": 1, "rms": 1,
            "drop_strength": 1, "onsets": 1}
    t = feats["rms"].shape[0]
    assert {k: tuple(v.shape) for k, v in feats.items()} == {k: (t, d) for k, d in dims.items()}


def test_spectral_helpers_and_emphasize(audio):
    from maua_tpu.audio import spectral as JSpec

    y = torch.from_numpy(audio)
    close_to_max(TSpec.spectral_contrast(y, SR, hop_length=512),
                 JSpec.spectral_contrast(jnp.asarray(audio), SR, hop_length=512), 1e-4, "contrast")
    close_to_max(TSpec.spectral_flatness(y, hop_length=512),
                 JSpec.spectral_flatness(jnp.asarray(audio), hop_length=512), 1e-4, "flatness")
    x = np.random.RandomState(1).rand(50, 2).astype(np.float32)
    for p in (50.0, 75.0, 12.5):
        close_to_max(TSig.emphasize(torch.from_numpy(x), 3.0, p), JSig.emphasize(jnp.asarray(x), 3.0, p), 1e-6, p)


@pytest.mark.parametrize("shape", [(43, 1), (200, 1), (300,)])
def test_salience_weighted(shape):
    """Its long smoothing (radius 320) pads short signals past their length:
    numpy's reflect rule, which jnp.pad keeps at any pad size."""
    x = np.random.RandomState(2).rand(*shape).astype(np.float32) + 0.1
    close_to_max(TF.salience_weighted(torch.from_numpy(x)), JF.salience_weighted(jnp.asarray(x)), 1e-5)


def test_mir_matches_maua_tpu(audio, jax_mir, jax_kmeans_init):
    feats, segs, tempo = TM.retrieve_music_information(torch.from_numpy(audio), SR, ks=KS)
    jfeats, jsegs, jtempo = jax_mir
    assert tempo == pytest.approx(jtempo, abs=0)
    assert set(feats) == set(jfeats) and set(segs) == set(jsegs)
    for k in feats:
        close_to_max(feats[k].numpy(), jfeats[k], 1e-4, k)
    for key in segs:
        assert same_up_to_relabelling(segs[key], jsegs[key]), key
        assert segs[key].max() < key[1]


def test_segment_feature_falls_back_to_an_even_grid(jax_kmeans_init):
    feature = np.random.RandomState(3).rand(30, 4).astype(np.float32)
    got = TM.segment_feature(torch.from_numpy(feature), np.array([3, 9]), (2, 3))
    want = JM.segment_feature(jnp.asarray(feature), np.array([3, 9]), (2, 3))
    for g, w in zip(got, want):
        assert same_up_to_relabelling(g, w)


def test_segment_feature_is_its_stages():
    """laplacian_eigen, embedding, kmeans from kmeans_init's rows and
    frame_labels compose to segment_feature, label for label."""
    feature = torch.from_numpy(np.random.RandomState(5).rand(60, 6).astype(np.float32))
    beats = TM.beat_grid(60, 120.0, SR)
    grid, L, evals, evecs = TM.laplacian_eigen(feature, beats, (2, 4))
    assert torch.allclose(L, L.t()) and bool((evals[1:] >= evals[:-1]).all())
    for k, want in zip((2, 4), TM.segment_feature(feature, beats, (2, 4))):
        X = TM.embedding(evecs, k)
        assert torch.allclose(X.norm(dim=1), torch.ones(X.shape[0]), atol=1e-6)
        labels = TSeg.kmeans(X, k, init_idx=TSeg.kmeans_init(X.shape[0], k))[0].numpy()
        np.testing.assert_array_equal(TM.frame_labels(labels, grid, 60), want)


def test_one_channel_feature_links_every_beat():
    """ROADMAP C8, not repaired: the cosine recurrence of a one-channel
    feature (rms, drop_strength, onsets, spectral_flatness) sees one
    direction, so every pair of beats is at distance 0, every beat's k-NN
    ties and both packages link every pair outside the band."""
    X = (np.random.RandomState(6).rand(1, 40) + 0.1).astype(np.float32)
    off_band = np.abs(np.subtract.outer(np.arange(40), np.arange(40))) >= 2
    got = TSeg.recurrence_matrix(torch.from_numpy(X), width=2).numpy()
    want = np.asarray(JSeg.recurrence_matrix(jnp.asarray(X), width=2))
    assert (got[off_band] > 0).all() and (want[off_band] > 0).all()
    assert (got[~off_band] == 0).all() and (want[~off_band] == 0).all()


def test_spline_loop_latents():
    y = np.random.RandomState(4).randn(5, 3, 8).astype(np.float32)
    for n_loops in (1.0, 2.5, 0.25):
        close_to_max(TL.spline_loop_latents(torch.from_numpy(y), 37, n_loops),
                     JL.spline_loop_latents(jnp.asarray(y), 37, n_loops), 1e-5, n_loops)


@pytest.mark.parametrize("patch_type,seq_feat,merge_type,merge_depth", [
    ("segmentation", "mfcc", "average", "low"), ("segmentation", "onsets", "modulate", "all"),
    ("feature", "rms", "modulate", "mid"), ("feature", "mfcc", "average", "lowmid"),
    ("feature", "chromagram", "replace", "midhigh"), ("loop", "tonnetz", "modulate", "high"),
])
def test_latent_patch(jax_mir, patch_type, seq_feat, merge_type, merge_depth):
    feats, segs, tempo = jax_mir
    t = 40
    rs = np.random.RandomState(5)
    latents = rs.randn(t, 18, 16).astype(np.float32)
    palette = rs.randn(12, 18, 16).astype(np.float32)
    key = jax.random.PRNGKey(7)
    kw = dict(tempo=tempo, fps=24.0, patch_type=patch_type, segments=4, loop_bars=4, seq_feat=seq_feat,
              seq_feat_weight=0.8, mod_feat="drop_strength", mod_feat_weight=0.7, merge_type=merge_type,
              merge_depth=merge_depth)
    want = JL.latent_patch(key, jnp.asarray(latents), jnp.asarray(palette), segs, feats, **kw)
    perm = torch.from_numpy(np.array(jax.random.permutation(key, 12)))
    tfeats = {k: torch.from_numpy(v.copy()) for k, v in feats.items()}
    got = TL.latent_patch(perm, torch.from_numpy(latents), torch.from_numpy(palette), segs, tfeats, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_noise_modules_match_and_wrap():
    key = jax.random.PRNGKey(0)
    mod = np.abs(np.random.RandomState(6).randn(20, 3)).astype(np.float32)
    jloop = JN.Loop(key, 20, (8, 6), n_loops=2.5, sigma=3.0)
    jblend = JN.Blend(jax.random.fold_in(key, 1), 20, (8, 6), jnp.asarray(mod))
    jmult = JN.Multiply(jax.random.fold_in(key, 2), 20, (8, 6), jnp.asarray(mod))
    tloop = TN.Loop(torch.from_numpy(np.array(jloop.noise)), 20, n_loops=2.5, sigma=3.0)
    tblend = TN.Blend(torch.from_numpy(np.array(jblend.noise)), 20, torch.from_numpy(mod))
    tmult = TN.Multiply(torch.from_numpy(np.array(jmult.noise)), 20, torch.from_numpy(mod))
    pairs = [(tloop, jloop), (tblend, jblend), (tmult, jmult),
             (TN.Average(tloop, tblend), JN.Average(jloop, jblend)),
             (TN.Modulate(tloop, tmult, torch.from_numpy(mod)), JN.Modulate(jloop, jmult, jnp.asarray(mod))),
             (TN.ScaleBias(TN.Modulate(tloop, tmult, torch.from_numpy(mod)), 2.0, 0.1),
              JN.ScaleBias(JN.Modulate(jloop, jmult, jnp.asarray(mod)), 2.0, 0.1))]
    for n, (t, j) in enumerate(pairs):
        assert t.size == j.size == (8, 6) and t.length == 20
        for i, b in ((0, 8), (3, 8), (12, 8)):
            tol = 1e-5 if n in (1, 2) else LOOP_TOL  # Blend and Multiply alone hold no Loop
            np.testing.assert_allclose(t(i, b).numpy(), np.asarray(j(i, b)), rtol=0, atol=tol,
                                       err_msg=f"{type(t).__name__} {i} {b}")
        # a window past the end continues from the start (each frame as in a window of its own)
        np.testing.assert_allclose(t(18, 5).numpy(), torch.cat([t(18, 2), t(0, 3)]).numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("patch_type,merge_type,merge_depth", [
    ("blend", "average", "low"), ("multiply", "modulate", "midhigh"), ("loop", "modulate", "all"),
    ("blend", "replace", "high"),
])
def test_noise_patch(jax_mir, patch_type, merge_type, merge_depth):
    feats, _, tempo = jax_mir
    t = len(next(iter(feats.values())))
    key = jax.random.PRNGKey(9)
    sizes = [4, 8] * 7  # 14 layers, so that "high" holds some
    kw = dict(tempo=tempo, fps=24.0, patch_type=patch_type, loop_bars=8, seq_feat="chromagram",
              seq_feat_weight=1.3, mod_feat="rms", mod_feat_weight=0.6, merge_type=merge_type,
              merge_depth=merge_depth, noise_mean=0.2, noise_std=0.9)
    jbase = [JN.Loop(jax.random.fold_in(key, 1000 + i), t, (s, s), n_loops=2, sigma=4.0) for i, s in enumerate(sizes)]
    tbase = [TN.Loop(torch.from_numpy(np.array(m.noise)), t, n_loops=2, sigma=4.0) for m in jbase]
    want = JN.noise_patch(key, list(jbase), feats, **kw)
    draws = JaxDraws(0, "cpu")
    draws.key = key
    got = TN.noise_patch(lambda n, shape: draws.normal((n,), shape), list(tbase),
                         {k: torch.from_numpy(v.copy()) for k, v in feats.items()}, **kw)
    for n, (g, w) in enumerate(zip(got, want)):
        assert type(g).__name__ == type(w).__name__
        np.testing.assert_allclose(g(5, 7).numpy(), np.asarray(w(5, 7)), rtol=0, atol=LOOP_TOL, err_msg=str(n))


def test_patch_choices_repr_and_json_both_ways(jax_mir, tmp_path):
    feats, segs, tempo = jax_mir
    tfeats, tsegs, _ = torch_mir(jax_mir)
    for seed in (0, 7, 123):
        jp = JP.Patch(feats, segs, tempo, seed=seed)
        tp = TP.Patch(tfeats, tsegs, tempo, seed=seed)
        assert repr(tp) == repr(jp)
        assert tp.latent_patches == jp.latent_patches and tp.noise_patches == jp.noise_patches
        assert (tp.n_base_latents, tp.sigma_base_noise, tp.loops_base_noise) == (
            jp.n_base_latents, jp.sigma_base_noise, jp.loops_base_noise)
        jp.update_intensity(1.2)
        tp.update_intensity(1.2)
        assert tp.latent_patches == jp.latent_patches and tp.noise_patches == jp.noise_patches
        jp.save(str(tmp_path / "j.json"))
        tp.save(str(tmp_path / "t.json"))
        assert (tmp_path / "j.json").read_text() == (tmp_path / "t.json").read_text()
        # a file saved by maua_tpu loads in the port, and the reverse
        from_j = TP.Patch.load(str(tmp_path / "j.json"), tfeats, tsegs, tempo)
        from_t = JP.Patch.load(str(tmp_path / "t.json"), feats, segs, tempo)
        assert repr(from_j) == repr(from_t) == repr(jp)
        assert json.loads((tmp_path / "j.json").read_text())["seed"] == seed


def generate_inputs(jax_mir, n_frames=24):
    """The features and segmentations `generate` hands its patch for
    `n_frames` frames (fps 12 over the 2 s), in maua_tpu's arrays."""
    feats, segs, tempo = jax_mir
    feats = {k: np.asarray(JSig.resample_1d(jnp.asarray(v), n_frames)) for k, v in feats.items()}
    seg_t = next(iter(segs.values())).shape[0]
    frame_idx = np.clip((np.arange(n_frames) * seg_t / n_frames).astype(int), 0, seg_t - 1)
    return feats, {k: v[frame_idx] for k, v in segs.items()}, tempo


def test_patch_realization_with_jax_draws(jax_mir, jax_draws):
    """The realization test_generate_matches_maua_tpu makes (seed 8: 5 latent
    and 5 noise subpatches of every kind; the 32^2 net's palette and layer
    sizes), so maua_tpu's compiled ops are shared."""
    feats, segs, tempo = generate_inputs(jax_mir)
    palette = np.random.RandomState(8).randn(16, 8, 32).astype(np.float32)
    sizes = [4, 8, 8, 16, 16, 32, 32]
    jlat, jnoise = JP.Patch(feats, segs, tempo, fps=12, seed=8)(jnp.asarray(palette), noise_sizes=sizes)
    tfeats = {k: torch.from_numpy(v.copy()) for k, v in feats.items()}
    tlat, tnoise = TP.Patch(tfeats, segs, tempo, fps=12, seed=8)(torch.from_numpy(palette), noise_sizes=sizes)
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), rtol=0, atol=1e-5)
    for n, (g, w) in enumerate(zip(tnoise, jnoise)):
        assert g.size == w.size
        for i in (0, 8, 16):
            np.testing.assert_allclose(g(i, 8).numpy(), np.asarray(w(i, 8)), rtol=0, atol=LOOP_TOL,
                                       err_msg=f"layer {n} frame {i}")


def test_noise_sizes_follow_aspect_and_downscale():
    feats = {k: torch.rand(10, 2) for k in TF.ALLFEATS}
    segs = {(k, 2): np.arange(10) % 2 for k in TF.ALLFEATS}
    _, noise = TP.Patch(feats, segs, 120.0, seed=1, max_subpatches=3)(torch.randn(6, 4, 8), downscale_factor=2,
                                                                     aspect_ratio=1.5, noise_sizes=[4, 8, 1])
    assert [m.size for m in noise] == [(3, 2), (6, 4), (1, 1)]
    assert [tuple(m(0, 3).shape) for m in noise] == [(3, 3, 2), (3, 6, 4), (3, 1, 1)]


def test_patch_draws_from_its_seed():
    gen = torch.Generator().manual_seed(0)
    names = TF.ALLFEATS
    feats = {k: torch.rand(30, 3, generator=gen) for k in names}
    segs = {(k, 2): np.arange(30) % 2 for k in names}
    palette = torch.randn(6, 4, 8, generator=gen)

    def realize(seed):
        lat, noise = TP.Patch(feats, segs, 120.0, seed=seed, max_subpatches=4)(palette, noise_sizes=[4, 8])
        return [lat] + [m(0, 30) for m in noise]

    a, b, c = realize(5), realize(5), realize(6)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    draws = TP.Draws(5, "cpu")
    again = TP.Draws(5, "cpu")
    assert torch.equal(draws.permutation((0,), 9), again.permutation((0,), 9))
    assert torch.equal(draws.normal((1000,), (2, 3)), again.normal((1000,), (2, 3)))
    assert torch.equal(TP.seeded_normal(3, (4, 5)), TP.seeded_normal(3, (4, 5)))


def psnr(a, b):
    return 10 * np.log10(255.0**2 / max(float(np.mean((a.astype(np.float64) - b) ** 2)), 1e-20))


class FrameRecorder:
    """A VideoWriter that keeps the raw frames it is given."""

    frames = []

    def __init__(self, output_file, output_size, fps, pix_fmt="rgb24", **kw):
        self.size, self.pix_fmt = output_size, pix_fmt
        type(self).frames = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def write(self, data):
        w, h = self.size
        type(self).frames.append(np.frombuffer(data, np.uint8).reshape(h, w, 3))


def test_generate_matches_maua_tpu(audio, jax_mir, jax_draws, tmp_path, monkeypatch):
    monkeypatch.setattr(jax_utility, "WORKSPACE", str(tmp_path))  # maua_tpu caches its s2d plans there
    wav = str(tmp_path / "a.wav")
    wavfile.write(wav, SR, audio)
    jfeats, jsegs, tempo = jax_mir
    monkeypatch.setattr(JS, "retrieve_music_information",
                        lambda a, sr: ({k: jnp.asarray(v) for k, v in jfeats.items()}, jsegs, tempo))
    monkeypatch.setattr(TS, "retrieve_music_information", lambda a, sr: torch_mir(jax_mir))
    cfg = J2.SG2Config(**SG2_KW)
    params = random_jax_params(cfg, 12)
    common = dict(fps=12, seed=8, batch_size=8, verbose=False)

    class JaxRecorder(FrameRecorder):
        pass

    class TorchRecorder(FrameRecorder):
        pass

    monkeypatch.setattr(JS, "VideoWriter", JaxRecorder)
    monkeypatch.setattr(TS, "VideoWriter", TorchRecorder)
    JS.generate(wav, output_file=str(tmp_path / "j.mp4"), stylegan_kwargs={"cfg": cfg, "params": params}, **common)
    stages = {}
    out = TS.generate(wav, output_file=str(tmp_path / "t.mp4"), device="cpu", stage_times=stages,
                      stylegan_kwargs={"cfg": T2.SG2Config(**SG2_KW), "params": bridge.params_to_torch(params)},
                      **common)
    want, got = np.stack(JaxRecorder.frames), np.stack(TorchRecorder.frames)
    assert out == str(tmp_path / "t.mp4")
    assert got.shape == want.shape == (24, 32, 32, 3)
    assert got.std() > 1.0 and not np.array_equal(got[0], got[-1])
    assert psnr(got, want) >= 40.0, psnr(got, want)
    assert set(stages) >= {"mir", "patch", "render", "noise_windows", "synthesis", "write"}


def test_generate_defaults_to_the_card_and_writes_a_video(tmp_path, monkeypatch):
    wav = str(tmp_path / "a.wav")
    wavfile.write(wav, SR, test_audio(1.0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TS.generate(wav)
    from maua_tpu_torch.ops.video import read_video

    cfg = T2.SG2Config(**SG2_KW)
    out = TS.generate(wav, output_file=str(tmp_path / "o.mp4"), fps=6, batch_size=4, verbose=False, device="cpu",
                      stylegan_kwargs={"cfg": cfg, "params": T2.init_params(cfg, torch.Generator().manual_seed(0))})
    video, _ = read_video(out)
    assert video.shape == (6, 32, 32, 3)


def test_cli_parses_the_selfsupervised_command(monkeypatch):
    seen = {}
    monkeypatch.setattr(TS, "generate", lambda *a, **kw: seen.update(args=a, kw=kw) or "out.mp4")
    cli_main.main(["audiovisual", "selfsupervised", "--audio_file", "s.wav", "--fps", "12", "--seed", "3",
                   "--device", "cpu"])
    assert seen["args"][0] == "s.wav" and seen["kw"] == {"fps": 12.0, "seed": 3, "batch_size": 8, "device": "cpu"}
