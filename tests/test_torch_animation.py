"""The port's diffusion animations against maua_tpu's, on the CPU: latent
interpolation (spline and slerp loops, the open path, renoising), KLMC2
(the sampler on an analytic denoiser, the animation through Stable
Diffusion), the flash-attention route's forward mode, sliced optimal
transport and outpainting, the looped noise and the loop video.

Stable Diffusion at the tiny sizes of tests/test_torch_diffusion.py
(TINY_UNET, TINY_VAE, TINY_TEXT; KLMC2's UNet with one head, so that its
64^2 latent's self-attention takes the kernel route), its parameters numpy
draws in maua_tpu's pytree carried over by the bridge. JAX's draws (the
starting latents, the renoising and sampling noise, the chain's noise, the
transport's directions, the border noise) are handed to the port.

Tolerances, f32: the analytic KLMC2 chain, the attention tangent, the
transport and the looped noise 1e-5 of their largest value; each whole
path's frames PSNR >= 40 dB against maua_tpu (peak 2, the [-1, 1] range;
the max abs error is printed).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.diffusion import interpolate as JI
from maua_tpu.diffusion import klmc2 as JK
from maua_tpu.diffusion import loop as JL
from maua_tpu.diffusion import outpaint as JO
from maua_tpu.diffusion.processors.base import BaseDiffusionProcessor as JaxBase
from maua_tpu.diffusion.processors.stable import StableDiffusion as JaxSD
from maua_tpu.kernels import attention as JA
from maua_tpu_torch import utility
from maua_tpu_torch.diffusion import interpolate as TI
from maua_tpu_torch.diffusion import klmc2 as TK
from maua_tpu_torch.diffusion import loop as TL
from maua_tpu_torch.diffusion import outpaint as TO
from maua_tpu_torch.diffusion.processors.base import BaseDiffusionProcessor
from maua_tpu_torch.diffusion.processors.stable import StableDiffusion
from maua_tpu_torch.kernels import attention as TA
from test_torch_diffusion import _psnr
from test_torch_guided_diffusion import _sd_kwargs, make_sd_params


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), err


def _whole(out, ref, what):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    print(f"{what}: max abs err {np.abs(out - ref).max():.3g}, PSNR {_psnr(out, ref):.1f} dB")
    assert _psnr(out, ref) >= 40.0
    assert np.abs(ref).max() > 0.05


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


@pytest.fixture(scope="module")
def sd_params():
    return make_sd_params()


@pytest.fixture(scope="module")
def sd_pair(sd_params):
    jkw, tkw = _sd_kwargs(sd_params)
    kw = dict(sampler="lms", timesteps=5, cfg_scale=4.0, image_size=32)
    return JaxSD(**jkw, **kw), StableDiffusion(**tkw, **kw)


def _images(n=2, size=32, seed=60):
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:size, 0:size] / size
    return [np.clip(np.stack([x * (i + 1) % 1, y, 1 - x * y], -1)[None] * 0.7 + rs.rand(1, size, size, 3) * 0.3,
                    0, 1).astype(np.float32) for i in range(n)]


# ------------------------------------------------------------------ interpolation
@pytest.mark.parametrize("method,loop,renoise", [("spline", True, None), ("slerp", True, None), ("slerp", False, None),
                                                 ("spline", True, 0.6)])
def test_interpolate_latents_matches(sd_pair, method, loop, renoise):
    jsd, tsd = sd_pair
    images = _images(3 if not loop else 2)
    n_frames, batch = 8, 4  # batches of one size: maua_tpu compiles its decode and its sampler once
    ref = JI.interpolate_latents(jsd, images, n_frames=n_frames, method=method, loop=loop, batch_size=batch,
                                 renoise_t=renoise)
    key = jax.random.PRNGKey(0)  # maua_tpu's default; each batch's renoising draws from fold_in(key, i)
    noises = [np.asarray(jax.random.normal(jax.random.split(jax.random.fold_in(key, i))[0], (batch, 16, 16, 4)))
              for i in range(0, n_frames, batch)]
    out = TI.interpolate_latents(tsd, images, n_frames=n_frames, method=method, loop=loop, batch_size=batch,
                                 renoise_t=renoise, noises=noises)
    _whole(out, ref, f"interpolate {method} loop={loop} renoise={renoise}")
    assert _psnr(out[0], out[n_frames // 2]) < 40.0  # the path moves


# ------------------------------------------------------------------ KLMC2
def _klmc2_draws(key, n_steps, shape):
    return [np.asarray(jax.random.normal(jax.random.split(k)[0], shape)) for k in jax.random.split(key, n_steps)]


@pytest.mark.parametrize("use_hvp,alpha,tau", [(True, 0.0, 1.0), (True, 0.05, 0.5), (False, 0.0, 1.0)])
def test_sample_mcmc_klmc2_matches_on_an_analytic_denoiser(use_hvp, alpha, tau):
    target = np.random.RandomState(61).randn(2, 3, 8, 8).astype(np.float32)

    def jax_den(x, s):
        return x - jnp.tanh(x - jnp.asarray(target)) * s[:, None, None, None] * 0.7

    def torch_den(x, s):
        return x - torch.tanh(x - torch.from_numpy(target)) * s[:, None, None, None] * 0.7

    x0 = np.random.RandomState(62).randn(2, 3, 8, 8).astype(np.float32)
    key = jax.random.PRNGKey(9)
    kw = dict(sigma=0.8, n_steps=6, step_size=0.2, friction=0.5, alpha=alpha, tau=tau, use_hvp=use_hvp)
    want_x, want_traj = JK.sample_mcmc_klmc2(jax_den, jnp.asarray(x0), key=key, **kw)
    got_x, got_traj = TK.sample_mcmc_klmc2(torch_den, torch.from_numpy(x0), noises=_klmc2_draws(key, 6, x0.shape),
                                           **kw)
    _close(got_x, want_x, 1e-5)
    _close(got_traj, want_traj, 1e-5)
    if use_hvp:  # the Hessian-vector term is there: without it the chain moves elsewhere
        no_hvp, _ = TK.sample_mcmc_klmc2(torch_den, torch.from_numpy(x0), noises=_klmc2_draws(key, 6, x0.shape),
                                         **{**kw, "use_hvp": False})
        assert np.abs(no_hvp.numpy() - np.asarray(want_x)).max() > 1e-3


def test_klmc2_animation_matches_through_the_kernel_route(sd_params, monkeypatch):
    jkw, tkw = _sd_kwargs(sd_params)
    jkw["unet_cfg"] = dataclasses.replace(jkw["unet_cfg"], num_heads=1)
    tkw["unet_cfg"] = dataclasses.replace(tkw["unet_cfg"], num_heads=1)
    jsd, tsd = JaxSD(timesteps=5, **jkw), StableDiffusion(timesteps=5, **tkw)
    jvps = []
    real = TA.FlashAttention.jvp
    monkeypatch.setattr(TA.FlashAttention, "jvp", staticmethod(lambda ctx, *t: jvps.append(1) or real(ctx, *t)))
    kw = dict(shape=(64, 64), n_frames=3, sigma=0.75, step_size=0.2, batch_decode=2, text="a red fox", cond_scale=3.0,
              friction=0.5, alpha=1e-3, tau=1.0, use_hvp=True)
    ref = JK.klmc2_animation(jsd, **kw)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    x0 = np.asarray(jax.random.normal(k1, (1, 32, 32, 4)))
    out = TK.klmc2_animation(tsd, x0=_nchw(x0), noises=[_nchw(n) for n in _klmc2_draws(k2, 3, (1, 32, 32, 4))], **kw)
    _whole(out, ref, "klmc2 animation")
    # the four 16^2 self-attentions (down, middle, two up) take the kernel route in each step's jvp
    assert len(jvps) == 4 * 3
    assert _psnr(out[0], out[-1]) < 40.0  # the chain moves


@pytest.mark.parametrize("shape", [(2, 3, 256, 40), (1, 1, 256, 64), (1, 2, 512, 16)])
def test_flash_attention_forward_mode_matches_jax_jvp(shape):
    rs = np.random.RandomState(63)
    q, k, v, dq, dk, dv = (rs.randn(*shape).astype(np.float32) for _ in range(6))
    scale = 1.0 / np.sqrt(shape[-1])
    want_o, want_t = jax.jvp(lambda q, k, v: JA.attention_xla(q, k, v, scale), (q, k, v), (dq, dk, dv))
    t = [torch.from_numpy(a) for a in (q, k, v, dq, dk, dv)]
    calls = []
    real = TA.FlashAttention.jvp

    def counting(ctx, *tangents):
        calls.append(1)
        return real(ctx, *tangents)

    TA.FlashAttention.jvp = staticmethod(counting)
    try:
        got_o, got_t = torch.func.jvp(lambda q, k, v: TA.flash_attention(q, k, v, scale), tuple(t[:3]), tuple(t[3:]))
        with torch.autograd.forward_ad.dual_level():  # the other forward-mode API, one tangent only
            dual = torch.autograd.forward_ad.make_dual(t[0], t[3])
            only_q = torch.autograd.forward_ad.unpack_dual(TA.flash_attention(dual, t[1], t[2], scale)).tangent
    finally:
        TA.FlashAttention.jvp = real
    _close(got_o, want_o, 1e-5)
    _close(got_t, want_t, 1e-5)
    _, want_q = jax.jvp(lambda q: JA.attention_xla(q, k, v, scale), (q,), (dq,))
    _close(only_q, want_q, 1e-5)
    assert len(calls) == 2  # both went through the route's forward-mode rule


# ------------------------------------------------------------------ outpainting
def test_sliced_optimal_transport_matches():
    rs = np.random.RandomState(64)
    src = rs.randn(1, 12, 10, 3).astype(np.float32)
    tgt = (rs.rand(1, 8, 9, 3) * np.array([0.5, 1.0, 0.2]) - 0.3).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = JO.sliced_optimal_transport(jnp.asarray(src), jnp.asarray(tgt), n_slices=16, key=key)
    directions = np.stack([np.asarray(jax.random.normal(k, (3,))) for k in jax.random.split(key, 16)])
    got = TO.sliced_optimal_transport(torch.from_numpy(src), torch.from_numpy(tgt), n_slices=16, directions=directions)
    _close(got, want, 1e-5)
    # the colours move to the target's: each channel's mean within 0.05
    assert np.abs(got.numpy().reshape(-1, 3).mean(0) - tgt.reshape(-1, 3).mean(0)).max() < 0.05


def test_outpaint_matches(sd_pair):
    jsd, tsd = sd_pair
    img = _images(1)[0] * 2 - 1
    key = jax.random.PRNGKey(5)
    ref = np.asarray(JO.outpaint(jsd, jnp.asarray(img), expand=(8, 8, 16, 0), text="a lighthouse", t_start=0.4,
                                 key=key))
    k1, k2, k3 = jax.random.split(key, 3)
    border = np.asarray(jax.random.normal(k1, (1, 48, 48, 3)))
    directions = np.stack([np.asarray(jax.random.normal(k, (3,))) for k in jax.random.split(k2, 32)])
    noise = np.asarray(jax.random.normal(jax.random.split(k3)[0], (1, 24, 24, 4)))
    out = TO.outpaint(tsd, img, expand=(8, 8, 16, 0), text="a lighthouse", t_start=0.4, border_noise=border,
                      directions=directions, noise=noise)
    _whole(out, ref, "outpaint")
    np.testing.assert_array_equal(out[:, 16:48, 8:40].numpy(), img)  # the interior is kept


# ------------------------------------------------------------------ loops
def test_looped_noise_matches():
    key = jax.random.PRNGKey(6)
    want = JL.looped_noise(key, 10, (4, 5, 3), sigma=2.0)
    got = TL.looped_noise(10, (4, 5, 3), sigma=2.0, noise=np.asarray(jax.random.normal(key, (10, 4, 5, 3))))
    _close(got, want, 1e-5)
    np.testing.assert_allclose(got.std(dim=(1, 2, 3), unbiased=False).numpy(), 1.0, rtol=1e-5)


class _JaxStub(JaxBase):
    image_size = 32

    def forward(self, img, prompts, t_start, t_end=1.0, verbose=True, key=None):
        return jnp.clip(img * 0.9 + 0.05, -1, 1)


class _TorchStub(BaseDiffusionProcessor):
    image_size = 32
    device = torch.device("cpu")

    def forward(self, img, prompts, t_start, t_end=1.0, verbose=True, **kw):
        return torch.clamp(img * 0.9 + 0.05, -1, 1)


@pytest.mark.parametrize("latent", [True, False])
def test_loop_video_matches(sd_pair, latent, tmp_path, monkeypatch):
    jsd, tsd = sd_pair if latent else (_JaxStub(), _TorchStub())
    init = _images(1)[0] * 2 - 1
    key = jax.random.PRNGKey(10)
    kw = dict(n_frames=8, t_start=0.6, text="a lighthouse", noise_sigma=2.0, batch_size=4, verbose=False)
    ref = JL.loop_video(jsd, jnp.asarray(init), key=key, **kw)
    k_noise, k_run = jax.random.split(key)
    shape = (16, 16, 4) if latent else (32, 32, 3)
    noise = np.asarray(jax.random.normal(k_noise, (8,) + shape))
    k = jax.random.split(jax.random.fold_in(k_run, 0))[0]
    noises = [np.asarray(jax.random.normal(k, (4,) + shape))] * 2 if latent else None
    monkeypatch.setattr(utility, "WORKSPACE", str(tmp_path))
    out = TL.loop_video(tsd, init, noise=noise, noises=noises, cache_name="fox", **kw)
    _whole(out, ref, f"loop video latent={latent}")
    assert _psnr(out[0], out[3]) < 60.0  # the frames differ
    # the cache: the second call reads the first's frames back
    np.testing.assert_array_equal(TL.loop_video(tsd, np.zeros_like(init), cache_name="fox", **kw), out)
    assert (tmp_path / "fox_loop.npy").exists()


# ------------------------------------------------------------------ the commands
@pytest.mark.parametrize("argv", [["interpolate", "a.png", "b.png"], ["klmc2", "a fox"], ["outpaint", "in.png", "a fox"],
                                  ["video", "--video_file", "clip.mp4"], ["loop", "--init", "clip.mp4"]])
def test_commands_need_a_card_unless_told_otherwise(monkeypatch, capsys, argv):
    from maua_tpu_torch.__main__ import main

    with pytest.raises(SystemExit) as exit_:
        main(["diffusion", argv[0], "--help"])
    assert exit_.value.code == 0 and "--device" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["diffusion"] + argv)
