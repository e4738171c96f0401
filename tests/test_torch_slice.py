"""The whole audio-reactive slice, with StyleGAN2 and with StyleGAN3, the
port against maua_tpu, and the port's isolation from JAX.

A 2 s synthetic wav and a 64^2 StyleGAN2 with narrow channels (random
parameters in the JAX package's pytree, brought over by the bridge) go through
`generate_audiovisual_from_patch` with each package's `ExampleSG2Patch`
and the memmap renderer. The JAX example draws its noise from
`jax.random`; the same draws are injected into the port's example
through its `base_noise` method. Envelopes agree to 2e-3 (onsets) and
1e-4 (loudness, chroma); frames must reach 40 dB PSNR (measured ~68 dB
here, the rest is f32 roundoff and uint8 rounding).

The StyleGAN3 slice runs the same way with each package's
`ExampleSG3Patch` and the 64^2 config of tests/test_stylegan3.py
(parameters from `maua_tpu.gan.stylegan3.init_params`). That recipe
draws no random numbers, so both sides get the same inputs. Frames must
reach 40 dB PSNR. The per-frame latents agree to 5e-3: they blend
latents of magnitude up to ~2 with the onset envelope, which agrees to
2e-3; measured 1.5e-3 here.
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from maua_tpu.gan import stylegan2, stylegan3

REPO = Path(__file__).resolve().parents[1]
KW = dict(img_resolution=64, channel_base=256, channel_max=32, z_dim=32, w_dim=32, mapping_layers=2)
SG3_KW = dict(z_dim=32, w_dim=32, img_resolution=64, channel_base=1024, channel_max=64, num_layers=6,
              mapping_layers=2, margin_size=4)
SR = 22050


def random_jax_params(cfg, seed):
    """Random SG2 parameters in maua_tpu's pytree: the shapes of
    `init_params` (traced abstractly, nothing compiled or drawn by JAX)
    filled from numpy, with nonzero biases, w_avg and noise strengths so
    that every term of a layer is exercised."""
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: stylegan2.init_params(jax.random.PRNGKey(0), cfg))

    def fill(path, leaf):
        keys = [p.key for p in path]
        if keys[-1] == "noise_strength":
            return np.float32(rs.uniform(0.5, 1.5))
        a = rs.randn(*leaf.shape).astype(np.float32)
        if keys[-1] in ("b", "bias", "w_avg"):
            return a * np.float32(0.1) + np.float32(keys[-2] == "affine")
        if keys[0] == "mapping" and keys[-1] == "w":
            return a / np.float32(cfg.mapping_lr_multiplier)
        return a

    return jax.tree_util.tree_map_with_path(fill, shapes)


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
    return (y / np.abs(y).max() * 0.9).astype(np.float32)


INJECTED_PATCH = '''
import numpy as np
import torch

from maua_tpu_torch.audiovisual.patches.examples.stylegan2 import ExampleSG2Patch


class Injected(ExampleSG2Patch):
    instances = []

    def process_audio(self):
        super().process_audio()
        Injected.instances.append(self)

    def base_noise(self, n):
        z = np.load({path!r})
        return [torch.from_numpy(z[k]).to(self.device) for k in ("slow", "fast", "jitter")]
'''


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slice")
    wav = str(tmp / "mix.wav")
    wavfile.write(wav, SR, synth())

    from maua_tpu import utility
    from maua_tpu.audio import io as jax_io
    from maua_tpu.audiovisual import generate as jax_generate
    from maua_tpu.audiovisual.patches import base as jax_base
    from maua_tpu_torch import bridge
    from maua_tpu_torch.audiovisual.generate import generate_audiovisual_from_patch
    from maua_tpu_torch.gan.stylegan2 import SG2Config

    cfg = stylegan2.SG2Config(**KW)
    params = random_jax_params(cfg, 1)

    # the JAX package caches decoded audio and synthesis plans under its
    # workspace: point it at the test's directory
    mp = pytest.MonkeyPatch()
    jax_patches = []
    try:
        mp.setattr(utility, "WORKSPACE", str(tmp))
        mp.setattr(jax_io, "WORKSPACE", str(tmp))
        jax_sg2 = jax_base.StyleGAN2
        mp.setattr(jax_base, "StyleGAN2", lambda *a, **k: jax_sg2(*a, cfg=cfg, params=params, **k))
        get_patch = jax_generate.get_patch_from_file

        def recording_patch(*a, **k):
            cls = get_patch(*a, **k)

            class Recorded(cls):
                def process_audio(self):
                    super().process_audio()
                    jax_patches.append(self)

            return Recorded

        mp.setattr(jax_generate, "get_patch_from_file", recording_patch)
        video_jax, _ = jax_generate.generate_audiovisual_from_patch(
            wav, None, str(REPO / "maua_tpu/audiovisual/patches/examples/stylegan2.py"), renderer="memmap",
            out_size=(64, 64))
    finally:
        mp.undo()

    n = video_jax.shape[0]
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    noise_path = str(tmp / "noise.npz")
    np.savez(noise_path,
             slow=np.asarray(jax.random.normal(k1, (n, 64, 64, 1))).transpose(0, 3, 1, 2),
             fast=np.asarray(jax.random.normal(k2, (n, 64, 64, 1))).transpose(0, 3, 1, 2),
             jitter=np.asarray(jax.random.normal(k3, (n,))))
    patch_file = tmp / "injected.py"
    patch_file.write_text(INJECTED_PATCH.format(path=noise_path))
    stages = {}
    video_torch, (audio, sr) = generate_audiovisual_from_patch(
        wav, None, str(patch_file), patch_name="Injected", renderer="memmap", out_size=(64, 64), device="cpu",
        stylegan_kwargs=dict(cfg=SG2Config(**KW), params=bridge.params_to_torch(params)), stage_times=stages)
    torch_patch = sys.modules["maua_torch_user_patch_injected"].Injected.instances[-1]
    return dict(video_jax=video_jax, video_torch=video_torch, jax_patch=jax_patches[-1], torch_patch=torch_patch,
                stages=stages, audio=audio, sr=sr)


def test_slice_frames_match_jax(slice_runs):
    a = slice_runs["video_jax"].astype(np.float64)
    b = slice_runs["video_torch"]
    assert b.shape == a.shape == (48, 64, 64, 3) and b.dtype == np.uint8
    mse = np.mean((a - b.astype(np.float64)) ** 2)
    psnr = 10 * math.log10(255.0**2 / max(mse, 1e-12))
    assert psnr >= 40.0, psnr
    assert b.min() < b.max()


@pytest.mark.parametrize("name,tol", [("kick_onsets", 2e-3), ("snare_onsets", 2e-3), ("drum_onsets", 2e-3),
                                      ("bass_rms", 1e-4), ("vocal_rms", 1e-4), ("vocal_chroma", 1e-4),
                                      ("other_chroma", 1e-4)])
def test_slice_envelopes_match_jax(slice_runs, name, tol):
    ref = np.asarray(getattr(slice_runs["jax_patch"], name))
    out = getattr(slice_runs["torch_patch"], name).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol)


def test_slice_records_stage_times(slice_runs):
    assert set(slice_runs["stages"]) == {"audio_features", "mapper", "modulation", "render"}
    assert slice_runs["sr"] == SR and isinstance(slice_runs["audio"], torch.Tensor)


def _recording(get_patch, store):
    """Wrap a get_patch_from_file so that the patch classes it returns
    keep their synthesizer inputs."""
    def wrapped(*a, **k):
        cls = get_patch(*a, **k)

        class Recorded(cls):
            def process_synthesizer_inputs(self, latent_w):
                out = super().process_synthesizer_inputs(latent_w)
                store.append(out)
                return out

        return Recorded

    return wrapped


@pytest.fixture(scope="module")
def sg3_slice(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slice_sg3")
    wav = str(tmp / "mix.wav")
    wavfile.write(wav, SR, synth())

    from maua_tpu import utility
    from maua_tpu.audio import io as jax_io
    from maua_tpu.audiovisual import generate as jax_generate
    from maua_tpu_torch import bridge
    from maua_tpu_torch.audiovisual import generate as torch_generate
    from maua_tpu_torch.gan.stylegan3 import SG3Config
    from maua_tpu_torch.kernels import filtered_lrelu as FL

    cfg = stylegan3.SG3Config(**SG3_KW)
    params = jax.device_get(stylegan3.init_params(jax.random.PRNGKey(1), cfg))
    jax_inputs, torch_inputs = [], []
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(utility, "WORKSPACE", str(tmp))
        mp.setattr(jax_io, "WORKSPACE", str(tmp))
        jax_sg3 = stylegan3.StyleGAN3
        mp.setattr(stylegan3, "StyleGAN3", lambda *a, **k: jax_sg3(*a, **{**k, "cfg": cfg, "params": params}))
        mp.setattr(jax_generate, "get_patch_from_file", _recording(jax_generate.get_patch_from_file, jax_inputs))
        mp.setattr(torch_generate, "get_patch_from_file",
                   _recording(torch_generate.get_patch_from_file, torch_inputs))
        video_jax, _ = jax_generate.generate_audiovisual_from_patch(
            wav, None, str(REPO / "maua_tpu/audiovisual/patches/examples/stylegan3.py"), renderer="memmap",
            out_size=(64, 64))
        stages = {}
        FL.reset_launches()
        video_torch, _ = torch_generate.generate_audiovisual_from_patch(
            wav, None, str(REPO / "maua_tpu_torch/audiovisual/patches/examples/stylegan3.py"), renderer="memmap",
            out_size=(64, 64), device="cpu",
            stylegan_kwargs=dict(cfg=SG3Config(**SG3_KW), params=bridge.params_to_torch(params)),
            stage_times=stages)
        launches = FL.launches
    finally:
        mp.undo()
    return dict(video_jax=video_jax, video_torch=video_torch, jax_inputs=jax_inputs[-1],
                torch_inputs=torch_inputs[-1], stages=stages, launches=launches)


def test_sg3_slice_frames_match_jax(sg3_slice):
    a = sg3_slice["video_jax"].astype(np.float64)
    b = sg3_slice["video_torch"]
    assert b.shape == a.shape == (48, 64, 64, 3) and b.dtype == np.uint8
    mse = np.mean((a - b.astype(np.float64)) ** 2)
    psnr = 10 * math.log10(255.0**2 / max(mse, 1e-12))
    assert psnr >= 40.0, psnr
    assert b.min() < b.max() and not np.array_equal(b[0], b[-1])


def test_sg3_slice_synthesizer_inputs_match_jax(sg3_slice):
    ref, out = sg3_slice["jax_inputs"], sg3_slice["torch_inputs"]
    assert set(out) == set(ref) == {"latent_w_plus", "translation", "rotation"}
    for k in ref:
        assert isinstance(out[k], torch.Tensor)
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=0, atol=5e-3)


def test_sg3_slice_runs_the_plain_path_on_the_cpu(sg3_slice):
    assert sg3_slice["launches"] == 0
    assert set(sg3_slice["stages"]) == {"audio_features", "mapper", "modulation", "render"}


JAX_MEL_PATCH_HEADER = """
import numpy as np
import jax.numpy as jnp

from maua_tpu.audiovisual import audioreactive as ar
from maua_tpu.audiovisual.patches import primitives
from maua_tpu.audiovisual.patches.base import StyleGAN2Patch


def asarray(a, like):
    return jnp.asarray(a)
"""


@pytest.fixture(scope="module")
def mel_slice(tmp_path_factory):
    """chip_smoke.py's mel-bearing patch (librosa onsets, tempo, pulse,
    segmentation, volume, STFT chroma; tempo loops and weighted latents)
    over 3 s of the mix with chords changing each second (A B A), at 4 fps:
    12 frames of the 64^2 StyleGAN2 through each package's entry point.
    The port's k-means gets JAX's initial centres (PRNGKey(0))."""
    import chip_smoke
    from maua_tpu import utility
    from maua_tpu.audio import io as jax_io
    from maua_tpu.audiovisual import generate as jax_generate
    from maua_tpu.audiovisual.patches import base as jax_base
    from maua_tpu_torch import bridge
    from maua_tpu_torch.audio import segment as torch_segment
    from maua_tpu_torch.audiovisual import generate as torch_generate
    from maua_tpu_torch.gan.stylegan2 import SG2Config
    from maua_tpu_torch.kernels import spectrogram as M

    tmp = tmp_path_factory.mktemp("slice_mel")
    y = synth(3.0)
    t = np.arange(len(y)) / SR
    for s, chord in enumerate(([220.0, 277.18, 329.63], [174.61, 220.0, 261.63], [220.0, 277.18, 329.63])):
        part = slice(s * SR, (s + 1) * SR)
        y[part] += sum(0.1 * np.sin(2 * np.pi * f * t[part]) for f in chord)
    wav = str(tmp / "mix.wav")
    wavfile.write(wav, SR, (y / np.abs(y).max() * 0.9).astype(np.float32))
    (tmp / "mel_jax.py").write_text(JAX_MEL_PATCH_HEADER + chip_smoke.MEL_PATCH_BODY)
    (tmp / "mel_torch.py").write_text(chip_smoke.MEL_PATCH_HEADER + chip_smoke.MEL_PATCH_BODY)

    cfg = stylegan2.SG2Config(**KW)
    params = random_jax_params(cfg, 1)
    jax_patches, torch_patches = [], []

    def recording(get_patch, store):
        def wrapped(*a, **k):
            cls = get_patch(*a, **k)

            class Recorded(cls):
                def process_audio(self):
                    super().process_audio()
                    store.append(self)

            return Recorded

        return wrapped

    kmeans = torch_segment.kmeans

    def kmeans_with_jax_init(X, k, n_iter=50, init_idx=None):
        init = np.asarray(jax.random.choice(jax.random.PRNGKey(0), X.shape[0], (k,), replace=False))
        return kmeans(X, k, n_iter, init_idx=init)

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(utility, "WORKSPACE", str(tmp))
        mp.setattr(jax_io, "WORKSPACE", str(tmp))
        jax_sg2 = jax_base.StyleGAN2
        mp.setattr(jax_base, "StyleGAN2", lambda *a, **k: jax_sg2(*a, cfg=cfg, params=params, **k))
        mp.setattr(jax_generate, "get_patch_from_file", recording(jax_generate.get_patch_from_file, jax_patches))
        mp.setattr(torch_generate, "get_patch_from_file",
                   recording(torch_generate.get_patch_from_file, torch_patches))
        mp.setattr(torch_segment, "kmeans", kmeans_with_jax_init)
        video_jax, _ = jax_generate.generate_audiovisual_from_patch(
            wav, None, str(tmp / "mel_jax.py"), renderer="memmap", fps=4, out_size=(64, 64))
        M.reset_launches()
        video_torch, _ = torch_generate.generate_audiovisual_from_patch(
            wav, None, str(tmp / "mel_torch.py"), renderer="memmap", fps=4, out_size=(64, 64), device="cpu",
            stylegan_kwargs=dict(cfg=SG2Config(**KW), params=bridge.params_to_torch(params)))
        launches = M.launches
    finally:
        mp.undo()
    return dict(video_jax=video_jax, video_torch=video_torch, jax_patch=jax_patches[-1],
                torch_patch=torch_patches[-1], launches=launches)


def test_mel_slice_frames_match_jax(mel_slice):
    a = mel_slice["video_jax"].astype(np.float64)
    b = mel_slice["video_torch"]
    assert b.shape == a.shape == (12, 64, 64, 3) and b.dtype == np.uint8
    mse = np.mean((a - b.astype(np.float64)) ** 2)
    psnr = 10 * math.log10(255.0**2 / max(mse, 1e-12))
    assert psnr >= 40.0, psnr
    assert b.min() < b.max() and not np.array_equal(b[0], b[-1])
    assert mel_slice["launches"] == 0  # the CPU runs the mel kernel's plain version


# The onsets' bar, from test_mel_slice_onsets_diverge_only_by_roundoff's
# premises: the envelope's 12 frames agree to ONSETS_STAGE_TOL of the
# envelope's peak, they reach at least 1/ONSETS_LEVEL_RATIO of that peak,
# and the post-processing (clip, smoothing, normalisation) moves its output
# at most ONSETS_POST_GAIN times a change of its input relative to the
# frames' peak. Measured: 1.8e-8, 1/1057 and 4.74; the onsets differ by 1.8e-5.
ONSETS_STAGE_TOL, ONSETS_LEVEL_RATIO, ONSETS_POST_GAIN = 1e-6, 1100, 5.0
ONSETS_TOL = ONSETS_STAGE_TOL * ONSETS_LEVEL_RATIO * ONSETS_POST_GAIN


@pytest.mark.parametrize("name,tol", [("onsets", ONSETS_TOL), ("pulse", 1e-5), ("volume", 1e-5), ("chroma", 1e-4),
                                      ("sections", 0.0)])
def test_mel_slice_envelopes_match_jax(mel_slice, name, tol):
    """Envelopes in [0, 1]: 1e-5, and 1e-4 where the chroma filterbank
    enters (float32 octaves in JAX, float64 in the port); the per-frame
    sections exactly; the tempo to the BPM. The onsets take ONSETS_TOL:
    their 12 frames sample the envelope near 1/1000 of its peak, so its
    f32 roundoff is that much larger relative to them, and the
    post-processing adds its gain."""
    ref = np.asarray(getattr(mel_slice["jax_patch"], name))
    out = getattr(mel_slice["torch_patch"], name).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol)
    assert mel_slice["torch_patch"].tempo == mel_slice["jax_patch"].tempo


def test_mel_slice_onsets_diverge_only_by_roundoff(mel_slice):
    """The slice's onsets, `ar.onsets(margin=2, type="rosa")`, stage by
    stage, each stage fed JAX's output of the one before: HPSS's
    percussive part and the onset strength agree to ONSETS_STAGE_TOL of
    their peaks, and the frame-rate post-processing (resample to 12
    frames, percentile clip, smoothing, normalisation) to it of its
    output. Then the premises of ONSETS_TOL: the port's whole chain gives
    the 12 frames to ONSETS_STAGE_TOL of the envelope's peak, the frames
    peak above 1/ONSETS_LEVEL_RATIO of it, and the post-processing's
    first-order gain (the Jacobian's largest row sum, in float64, times the
    frames' peak) is at most ONSETS_POST_GAIN."""
    import jax.numpy as jnp

    from maua_tpu.audio import beat as JB
    from maua_tpu.audio import spectral as JS
    from maua_tpu.audiovisual import audioreactive as JA
    from maua_tpu_torch.audio import beat as TB
    from maua_tpu_torch.audio import spectral as TS
    from maua_tpu_torch.audiovisual import audioreactive as TA

    def agree(out, ref, tol):
        ref = np.asarray(ref)
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=tol * np.abs(ref).max())

    patch = mel_slice["jax_patch"]
    y, sr, n = np.asarray(patch.audio), patch.sr, len(patch.onsets)
    pj = JS.percussive(jnp.asarray(y), margin=2.0)
    pt = TS.percussive(torch.from_numpy(y), margin=2.0)
    agree(pt, pj, ONSETS_STAGE_TOL)
    ej = JB.onset_strength(pj, sr=sr)
    agree(TB.onset_strength(torch.from_numpy(np.array(pj)), sr=sr), ej, ONSETS_STAGE_TOL)
    post = JA._postprocess(ej, n, 95.0, 2.0)
    agree(TA._postprocess(torch.from_numpy(np.array(ej)), n, 95.0, 2.0), post, ONSETS_STAGE_TOL)
    np.testing.assert_allclose(np.asarray(post), np.asarray(patch.onsets), rtol=0, atol=1e-6)  # eager vs jit

    peak = np.abs(np.asarray(ej)).max()
    frames = np.asarray(JA.resample_1d(ej, n))
    frames_t = TA.resample_1d(TB.onset_strength(pt, sr=sr), n).numpy()
    assert np.abs(frames_t - frames).max() <= ONSETS_STAGE_TOL * peak
    assert frames.max() * ONSETS_LEVEL_RATIO >= peak
    jac = torch.autograd.functional.jacobian(lambda f: TA._postprocess(f, None, 95.0, 2.0),
                                             torch.from_numpy(frames.astype(np.float64)))
    assert float(jac.abs().sum(1).max()) * frames.max() <= ONSETS_POST_GAIN


def test_cli_parses_the_reference_flags(tmp_path, monkeypatch, capsys):
    from maua_tpu_torch.__main__ import main
    from maua_tpu_torch.audiovisual import generate
    from maua_tpu_torch.ops import video

    calls = {}

    def fake_generate(**kw):
        calls.update(kw)
        return np.zeros((2, 8, 8, 3), np.uint8), (None, SR)

    monkeypatch.setattr(generate, "generate_audiovisual_from_patch", fake_generate)
    monkeypatch.setattr(video, "write_video", lambda *a, **k: calls.setdefault("written", a[1]))
    main(["audiovisual", "generate", "--audio_file", "song.wav", "--patch_file", "p.py", "--renderer", "memmap",
          "--out_size", "64,32", "--out_dir", str(tmp_path), "--device", "cpu", "--fps", "12"])
    assert calls["device"] == "cpu" and calls["out_size"] == (64, 32) and calls["fps"] == 12
    assert calls["written"].endswith("song_None_stretch_64x32.mp4")
    assert capsys.readouterr().out.strip() == calls["written"]
    with pytest.raises(SystemExit):  # a command the port does not have (gan generate is ported now)
        main(["style", "transfer"])


def test_generate_needs_a_card_unless_told_otherwise(monkeypatch):
    from maua_tpu_torch.audiovisual.generate import generate_audiovisual_from_patch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_audiovisual_from_patch("missing.wav", None, "missing.py", renderer="memmap")


def test_port_imports_neither_jax_nor_maua_tpu():
    """Import every module of the port, and chip_smoke.py, in a fresh
    interpreter; neither jax, optax, orbax nor any maua_tpu module may be loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import maua_tpu_torch\n"
        "for m in pkgutil.walk_packages(maua_tpu_torch.__path__, 'maua_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'maua_tpu', 'optax', 'orbax')]\n"
        "assert not bad, bad\n"
        "print(sum(k.startswith('maua_tpu_torch') for k in sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_port_sources_name_no_jax():
    files = list((REPO / "maua_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for f in files:
        for line in f.read_text().splitlines():
            words = line.strip().split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                root = words[1].split(".")[0]
                assert root not in ("jax", "jaxlib", "flax", "maua_tpu", "optax", "orbax"), f"{f}: {line}"


def test_chip_smoke_fails_without_a_card_or_without_the_package(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    if not torch.cuda.is_available():
        out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and out.stdout == "" and "CUDA" in out.stderr
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == "" and "maua_tpu_torch" in out.stderr
