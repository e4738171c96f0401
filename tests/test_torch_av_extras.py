"""The rest of the port's video path against maua_tpu: 3-D perlin noise,
the noise-parameterization example patch, StyleGAN3's output resize,
`MauaPatch.force_output_size`, the `ar` plotting helpers and the
realtime viewer's random walk.

Small sizes, f32 on the CPU; random draws made by JAX from maua_tpu's keys
and handed to the port where the two packages draw. Tolerances: perlin
volumes 1e-5 (values of magnitude ~1); the patch's latents and noise maps 1e-4
(spline loops, warps and gaussian filters of values ~1-10, f32 order);
resized images 1e-5 and uint8 frames within one level, the realtime walk's
frames too (on maua_tpu's draws).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from maua_tpu.audiovisual import realtime as JR
from maua_tpu.audiovisual.patches.examples import noise_parameterization as JNP
from maua_tpu.gan import stylegan2 as J2
from maua_tpu.gan import stylegan3 as J3
from maua_tpu.ops import noise as JN
from maua_tpu_torch import bridge
from maua_tpu_torch.audiovisual import audioreactive as TAR
from maua_tpu_torch.audiovisual import realtime as TR
from maua_tpu_torch.audiovisual.patches import base as TB
from maua_tpu_torch.audiovisual.patches.examples import noise_parameterization as TNP
from maua_tpu_torch.gan import stylegan2 as T2
from maua_tpu_torch.gan import stylegan3 as T3
from maua_tpu_torch.ops import noise as TN
from test_torch_stylegan2 import random_jax_params as random_sg2_params
from test_torch_stylegan3 import KW as SG3_KW
from test_torch_stylegan3 import random_jax_params as random_sg3_params

SG2_KW = dict(img_resolution=32, channel_base=256, channel_max=32, z_dim=32, w_dim=32, mapping_layers=2,
              num_fp16_res=0)
SR, FPS, SECONDS = 16000, 12, 2.0


def jax_angles(key, shape, res):
    """The gradient angles maua_tpu's perlin_noise draws from `key`."""
    res = tuple(JN.round_to_closest_divisor(shape[i], res[i]) for i in range(3))
    k1, k2 = jax.random.split(key)
    gshape = tuple(r + 1 for r in res)
    return [torch.from_numpy(np.array(2 * jnp.pi * jax.random.uniform(k, gshape))) for k in (k1, k2)]


@pytest.mark.parametrize("shape,res,tileable", [((24, 32, 16), (4, 8, 3), (True, False, False)),
                                                ((12, 16, 16), (3, 4, 4), (False, True, True))])
def test_perlin_noise_with_the_gradients_handed_in(shape, res, tileable):
    key = jax.random.PRNGKey(3)
    want = np.asarray(JN.perlin_noise(key, shape, res, tileable))
    got = TN.perlin_noise_from_angles(*jax_angles(key, shape, res), shape, tileable).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert TN.round_to_closest_divisor(24, 5) == JN.round_to_closest_divisor(24, 5) == 4
    np.testing.assert_array_equal(np.sort(TN.factors(36)), np.sort(JN.factors(36)))
    drawn = TN.perlin_noise(torch.Generator().manual_seed(0), shape, res, tileable)
    assert drawn.shape == shape and bool(drawn.isfinite().all())


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("av") / "mix.wav")
    t = np.arange(int(SR * SECONDS)) / SR
    y = 0.4 * np.sin(2 * np.pi * 220 * t) * (1 + np.sin(2 * np.pi * 2 * t)) + 0.2 * np.sin(2 * np.pi * 55 * t)
    wavfile.write(path, SR, y.astype(np.float32))
    return path


def test_noise_parameterization_latents_and_noise_match(wav):
    """Both patches get the same envelopes and latents; the port's draws are
    the JAX keys' (angles of the two perlin volumes, the three extras)."""
    cfg = J2.SG2Config(**SG2_KW)
    params = random_sg2_params(cfg, 21)
    jpatch = JNP.NoiseParameterization(None, wav, fps=FPS, output_size=(32, 32), cfg=cfg, params=params)
    tpatch = TNP.NoiseParameterization(None, wav, fps=FPS, output_size=(32, 32), device="cpu",
                                       cfg=T2.SG2Config(**SG2_KW), params=bridge.params_to_torch(params))
    n = jpatch.n_frames
    assert tpatch.n_frames == n == 24
    rs = np.random.RandomState(22)
    env = {"onsets": rs.rand(n, 1, 1), "volume": rs.rand(n, 1, 1), "chroma": rs.rand(n, 12)}
    for k, v in env.items():
        setattr(jpatch, k, jnp.asarray(v, jnp.float32))
        setattr(tpatch, k, torch.from_numpy(v.astype(np.float32)))
    latent_w = np.asarray(jpatch.mapper(latent_z=jpatch.stylegan2.get_z_latents("1-40,400-440")))

    def jax_draws(angle_shape, extra_shapes):
        key = jax.random.PRNGKey(JNP.NoiseParameterization.seed)
        angles = []
        for k in jax.random.split(key):
            angles += [torch.from_numpy(np.array(2 * jnp.pi * jax.random.uniform(kk, angle_shape)))
                       for kk in jax.random.split(k)]
        extras = [torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, i), (s[0], s[2], s[3], 1)))
                                   .transpose(0, 3, 1, 2).copy()) for i, s in enumerate(extra_shapes)]
        return angles, extras

    tpatch.noise_draws = jax_draws
    want = jpatch.process_synthesizer_inputs(jnp.asarray(latent_w))
    got = tpatch.process_synthesizer_inputs(torch.from_numpy(latent_w))
    assert list(got) == list(want)
    np.testing.assert_allclose(got["latent_w_plus"].numpy(), np.asarray(want["latent_w_plus"]), rtol=0, atol=1e-4)
    for name in list(want)[1:]:
        np.testing.assert_allclose(got[name].numpy()[:, 0], np.asarray(want[name])[..., 0], rtol=0, atol=1e-4,
                                   err_msg=name)


def test_noise_parameterization_renders_on_the_cpu(wav):
    from maua_tpu_torch.audiovisual.generate import generate_audiovisual_from_patch

    cfg = T2.SG2Config(**SG2_KW)
    video, _ = generate_audiovisual_from_patch(
        wav, None, TNP.__file__, renderer="memmap", fps=FPS, out_size=(32, 32), device="cpu",
        stylegan_kwargs=dict(cfg=cfg, params=T2.init_params(cfg, torch.Generator().manual_seed(0))))
    assert video.shape == (24, 32, 32, 3) and video.dtype == np.uint8 and not np.array_equal(video[0], video[-1])


def test_stylegan3_output_size_matches_jax_linear_resize():
    cfg = J3.SG3Config(**SG3_KW)
    params = random_sg3_params(cfg, 3)
    ws = np.asarray(J3.mapping(params, jnp.asarray(np.random.RandomState(4).randn(3, 32), jnp.float32), cfg))
    want = np.stack(list(J3.StyleGAN3(cfg, params=params, output_size=(48, 40)).render(jnp.asarray(ws), batch_size=3)))
    model = T3.StyleGAN3(cfg=T3.SG3Config(**SG3_KW), params=bridge.params_to_torch(params), output_size=(48, 40),
                         device="cpu")
    got = np.stack(list(model.render(torch.from_numpy(ws), batch_size=3)))
    assert got.shape == want.shape == (3, 40, 48, 3)
    assert np.abs(got.astype(int) - want).max() <= 1


def test_force_output_size_is_antialiased_lanczos3():
    patch = TB.MauaPatch.__new__(TB.MauaPatch)
    video = np.random.RandomState(5).rand(3, 40, 50, 3).astype(np.float32)
    for size in ((32, 24), (80, 60), (50, 40)):
        patch.synthesizer_output_size = size
        got = patch.force_output_size(torch.from_numpy(video)).numpy()
        want = np.asarray(jax.image.resize(jnp.asarray(video), (3, size[1], size[0], 3), "lanczos3", antialias=True))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_plot_helpers_write_files_and_need_no_matplotlib(wav, tmp_path, monkeypatch):
    audio = torch.from_numpy(wavfile.read(wav)[1].copy())
    env = TAR.rms(audio, SR, 24)
    calls = {"plot_signals": ([env, 2 * env],), "plot_spectra": ([torch.rand(24, 12)],),
             "plot_audio": (audio, SR), "plot_chroma_comparison": (audio, SR)}
    for name, args in calls.items():
        path = tmp_path / "plots" / f"{name}.png"
        getattr(TAR, name)(*args, path=str(path))
        assert path.stat().st_size > 1000, name
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import matplotlib now raises ImportError
    for name, args in calls.items():
        assert getattr(TAR, name)(*args, path=str(tmp_path / "none.png")) is None
    assert not (tmp_path / "none.png").exists()


def test_realtime_walk_replays_for_its_generator():
    """The walk on maua_tpu's draws (its key split, then a normal, for the
    start w and for every step) against maua_tpu's RealtimeModule over its
    synthesis, on the same parameters."""
    cfg = J2.SG2Config(**SG2_KW)
    params = random_sg2_params(cfg, 1)
    tcfg, tparams = T2.SG2Config(**SG2_KW), bridge.params_to_torch(params)
    jmodule = JR.RealtimeModule(lambda w: J2.synthesis(params, w, cfg), cfg.num_ws, cfg.w_dim, momentum=0.9,
                                step_size=0.1, key=jax.random.PRNGKey(7))
    want = [jmodule.frame() for _ in range(3)]
    key = [jax.random.PRNGKey(7)]

    def jax_draw(shape):
        key[0], sub = jax.random.split(key[0])
        return torch.from_numpy(np.array(jax.random.normal(sub, shape)))

    def synth(w):
        return T2.synthesis(tparams, w, tcfg)

    module = TR.RealtimeModule(synth, cfg.num_ws, cfg.w_dim, momentum=0.9, step_size=0.1, draw=jax_draw)
    for got, frame in zip((module.frame() for _ in range(3)), want):
        assert got.shape == frame.shape == (32, 32, 3) and got.dtype == np.uint8
        assert np.abs(got.astype(int) - frame).max() <= 1
    assert not np.array_equal(want[0], want[-1])

    seen = []
    assert TR.run_realtime(synth, cfg.num_ws, cfg.w_dim, frame_callback=seen.append, max_frames=5,
                           target_fps=1000.0, device="cpu") == 5
    assert len(seen) == 5 and not np.array_equal(seen[0], seen[-1])

    def broken(w):
        raise RuntimeError("synthesis failed")

    with pytest.raises(RuntimeError, match="synthesis failed"):
        TR.run_realtime(broken, cfg.num_ws, cfg.w_dim, frame_callback=seen.append, max_frames=5, device="cpu")
