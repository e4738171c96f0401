"""The port's Stable Diffusion slice against maua_tpu's, on the CPU.

The tiny configurations of tests/test_diffusion_pipeline.py (UNet 32
channels, VAE 16, CLIP text 64 wide), with every parameter of maua_tpu's
pytree drawn with numpy (zero-initialised convs included, so that every
term is exercised) and carried over by the bridge. Inputs and noise are
numpy draws from seeds, or the reference's own draws fed to the port.
On the CPU the port's attention takes the flash kernel's plain version
where maua_tpu takes its XLA path; in f32 the two compute the same
function.

Tolerances, f32: the UNet 1e-4 absolute on outputs of magnitude ~1; the
VAE and the text encoder 1e-4 (twelve or more layers of f32 convs and
matmuls in another summation order; measured ~1e-6); the sigma table
and sigma_to_t 1e-6 relative; the denoiser wrappers 1e-5; the samplers
1e-4 absolute on latents of magnitude ~10. bf16 UNet: 5e-2 absolute on
outputs of magnitude ~1 (bf16 rounds activations at every op in both
packages, at other places). The
whole slice: image PSNR >= 40 dB against maua_tpu (peak 2, the [-1, 1]
range), and the f32 max abs error is printed.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.diffusion import samplers as JS
from maua_tpu.diffusion import wrappers as JW
from maua_tpu.diffusion.image import image_sample as jax_image_sample
from maua_tpu.diffusion.models import unet as JU
from maua_tpu.diffusion.models import vae as JV
from maua_tpu.diffusion.processors.stable import StableDiffusion as JaxSD
from maua_tpu.prompt import TextPrompt as JaxTextPrompt
from maua_tpu.text import clip_text as JT
from maua_tpu.utility import parse_prompt as jax_parse_prompt
from maua_tpu_torch import bridge
from maua_tpu_torch.diffusion import image as TI
from maua_tpu_torch.diffusion import samplers as TS
from maua_tpu_torch.diffusion import wrappers as TW
from maua_tpu_torch.diffusion.models import unet as TU
from maua_tpu_torch.diffusion.models import vae as TV
from maua_tpu_torch.diffusion.processors.stable import StableDiffusion
from maua_tpu_torch.kernels import attention as TA
from maua_tpu_torch.ops import io as TIO
from maua_tpu_torch.prompt import ContentPrompt, ImagePrompt, TextPrompt
from maua_tpu_torch.utility import parse_prompt
from maua_tpu_torch.text import clip_text as TT

TINY_UNET = JU.UNetConfig(
    in_channels=4, out_channels=4, model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
    attention_resolutions=(2,), num_heads=4, context_dim=64, transformer_depth=1,
)
TINY_VAE = JV.VAEConfig(base_channels=16, channel_mult=(1, 2), num_res_blocks=1, z_channels=4)
TINY_TEXT = JT.CLIPTextConfig(width=64, layers=2, heads=4, context_length=16)
TINY_GUIDED = JU.UNetConfig(
    in_channels=3, out_channels=6, model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
    attention_resolutions=(2,), num_head_channels=8, context_dim=None,
    use_scale_shift_norm=True, resblock_updown=True,
)


def port_cfg(cls, cfg, **changes):
    """The port's config of the same name with the JAX config's fields."""
    return cls(**{**dataclasses.asdict(cfg), **changes})


def random_params(init, seed):
    """maua_tpu's pytree shapes (traced abstractly) filled with numpy draws:
    weights at 1/sqrt(fan-in), biases and norm affines near their init."""
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: init(jax.random.PRNGKey(0)))

    def fill(path, leaf):
        name = getattr(path[-1], "key", None)
        a = rs.randn(*leaf.shape).astype(np.float32)
        if name == "w":
            fan_in = leaf.shape[0] if len(leaf.shape) == 2 else int(np.prod(leaf.shape[:3]))
            return a / np.float32(math.sqrt(fan_in))
        if name == "scale":
            return np.float32(1) + a * np.float32(0.1)
        if name in ("b", "bias"):
            return a * np.float32(0.1)
        return a * np.float32(0.02)  # token and positional embeddings

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def unet_params():
    return random_params(lambda k: JU.init_params(k, TINY_UNET), 0)


@pytest.fixture(scope="module")
def vae_params():
    return random_params(lambda k: JV.init_params(k, TINY_VAE), 1)


@pytest.fixture(scope="module")
def text_params():
    return random_params(lambda k: JT.init_params(k, TINY_TEXT), 2)


def test_bridge_round_trip(unet_params, vae_params):
    for tree in (unet_params, vae_params):
        back = bridge.diffusion_params_to_jax(bridge.diffusion_params_to_torch(tree))
        jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b), tree, back)
    ported = bridge.diffusion_params_to_torch(unet_params)
    assert tuple(ported["conv_in"]["w"].shape) == (32, 4, 3, 3)  # OIHW
    assert tuple(ported["time_mlp1"]["w"].shape) == (128, 32)  # (out, in)


@pytest.mark.parametrize("case", ["sd-f32-16", "sd-f32-32-one-head", "sd-bf16-16", "guided-f32-16"])
def test_unet_forward_matches(case, unet_params):
    kind, dtype, size = case.split("-")[:3]
    heads = 1 if case.endswith("one-head") else TINY_UNET.num_heads
    jcfg = dataclasses.replace(TINY_GUIDED if kind == "guided" else TINY_UNET, dtype=
                               "bfloat16" if dtype == "bf16" else "float32", num_heads=heads)
    params = unet_params if kind == "sd" else random_params(lambda k: JU.init_params(k, jcfg), 3)
    rs = np.random.RandomState(4)
    x = rs.randn(2, int(size), int(size), jcfg.in_channels).astype(np.float32)
    t = np.array([3.5, 517.25], np.float32)
    ctx = rs.randn(2, 8, 64).astype(np.float32) if kind == "sd" else None
    ref = np.asarray(JU.forward(params, jnp.asarray(x), jnp.asarray(t), jcfg, None if ctx is None else jnp.asarray(ctx)))
    TA.reset_launches()
    out = TU.forward(bridge.diffusion_params_to_torch(params), _nchw(x), torch.from_numpy(t),
                     port_cfg(TU.UNetConfig, jcfg), None if ctx is None else torch.from_numpy(ctx))
    assert TA.launches == 0
    assert out.dtype == torch.float32
    err = np.abs(_nhwc(out) - ref).max()
    assert err <= (5e-2 if dtype == "bf16" else 1e-4), err
    assert np.abs(ref).max() > 0.1  # not a degenerate net


def test_vae_encode_decode_match(vae_params):
    # 32^2 images: the mid attention runs at 16^2, one head of 32, so it takes the kernel route
    rs = np.random.RandomState(5)
    img = np.tanh(rs.randn(2, 32, 32, 3)).astype(np.float32)
    p = bridge.diffusion_params_to_torch(vae_params)
    tcfg = port_cfg(TV.VAEConfig, TINY_VAE)
    jm, jl = JV.encode_moments(vae_params, jnp.asarray(img), TINY_VAE)
    tm, tl = TV.encode_moments(p, _nchw(img), tcfg)
    assert np.abs(_nhwc(tm) - np.asarray(jm)).max() <= 1e-4
    assert np.abs(_nhwc(tl) - np.asarray(jl)).max() <= 1e-4
    z = rs.randn(2, 16, 16, 4).astype(np.float32)
    ref = np.asarray(JV.decode(vae_params, jnp.asarray(z), TINY_VAE))
    out = _nhwc(TV.decode(p, _nchw(z), tcfg))
    assert out.shape == ref.shape == (2, 32, 32, 3)
    assert np.abs(out - ref).max() <= 1e-4
    enc = TV.encode(p, _nchw(img), tcfg)
    np.testing.assert_allclose(_nhwc(enc), np.asarray(JV.encode(vae_params, jnp.asarray(img), TINY_VAE)), atol=1e-4)


@pytest.mark.parametrize("texts", ["a painting of a lighthouse", ["", "Hello, WORLD!  twice", "x " * 40]])
def test_tokenizer_ids_equal(texts):
    np.testing.assert_array_equal(TT.tokenize(texts, 16), JT.tokenize(texts, 16))
    np.testing.assert_array_equal(TT.tokenize(texts), JT.tokenize(texts))


def test_encode_text_matches(text_params):
    tokens = JT.tokenize(["a red fox in snow", ""], TINY_TEXT.context_length)
    ref = np.asarray(JT.encode_text(text_params, jnp.asarray(tokens), TINY_TEXT))
    out = TT.encode_text(bridge.diffusion_params_to_torch(text_params), tokens, port_cfg(TT.CLIPTextConfig, TINY_TEXT))
    assert out.shape == ref.shape == (2, 16, 64)
    assert np.abs(out.numpy() - ref).max() <= 1e-4


def test_discrete_schedule_matches():
    ac = JS.make_ddpm_schedule(1000)
    np.testing.assert_array_equal(TS.make_ddpm_schedule(1000), ac)
    for kind in ("linear", "cosine"):
        np.testing.assert_array_equal(TS.make_ddpm_schedule(100, schedule=kind), JS.make_ddpm_schedule(100, schedule=kind))
    j, t = JW.DiscreteSchedule(ac), TW.DiscreteSchedule(ac)
    for n in (5, 50):
        np.testing.assert_array_equal(t.get_sigmas(n), j.get_sigmas(n))
    sig = np.concatenate([j.get_sigmas(50)[:-1], [0.0, 1e-3, 20.0, 0.5]]).astype(np.float32)
    np.testing.assert_allclose(t.sigma_to_t(torch.from_numpy(sig)).numpy(), np.asarray(j.sigma_to_t(jnp.asarray(sig))),
                               rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("kind", ["eps", "v"])
def test_denoiser_wrappers_match(kind):
    ac = JS.make_ddpm_schedule(1000)
    x = np.random.RandomState(12).randn(3, 4, 8, 8).astype(np.float32)
    sigma = np.array([14.6, 1.3, 0.03], np.float32)
    jcls, tcls = (JW.EpsDenoiser, TW.EpsDenoiser) if kind == "eps" else (JW.VDenoiser, TW.VDenoiser)
    ref = np.asarray(jcls(lambda xx, t: jnp.sin(xx) * t[:, None, None, None] / 1000, ac)(jnp.asarray(x),
                                                                                         jnp.asarray(sigma)))
    out = tcls(lambda xx, t: torch.sin(xx) * t[:, None, None, None] / 1000, ac)(torch.from_numpy(x),
                                                                                torch.from_numpy(sigma))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def _denoisers():
    """The same analytic denoiser in both frameworks: a pull towards a fixed image."""
    target = np.random.RandomState(6).randn(2, 4, 8, 8).astype(np.float32)

    def jax_den(x, sigma):
        s = sigma[:, None, None, None]
        return (x + s**2 * jnp.asarray(target)) / (1 + s**2) + 0.1 * jnp.tanh(x)

    def torch_den(x, sigma):
        s = sigma[:, None, None, None]
        return (x + s**2 * torch.from_numpy(target)) / (1 + s**2) + 0.1 * torch.tanh(x)

    return jax_den, torch_den


@pytest.mark.parametrize("name", ["euler", "heun", "dpm_2", "lms", "dpmpp_2m", "dpm_fast", "dpm_adaptive"])
def test_deterministic_samplers_match(name):
    jax_den, torch_den = _denoisers()
    sigmas = JW.DiscreteSchedule(JS.make_ddpm_schedule(1000)).get_sigmas(8)
    x = (np.random.RandomState(7).randn(2, 4, 8, 8) * sigmas[0]).astype(np.float32)
    ref = np.asarray(JS.get_sampler(name)(jax_den, jnp.asarray(x), sigmas))
    out = TS.get_sampler(name)(torch_den, torch.from_numpy(x), sigmas).numpy()
    assert np.abs(out - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("name", ["euler_ancestral", "dpm_2_ancestral"])
def test_ancestral_samplers_match_with_the_same_noise(name):
    jax_den, torch_den = _denoisers()
    sigmas = JW.DiscreteSchedule(JS.make_ddpm_schedule(1000)).get_sigmas(6)
    x = (np.random.RandomState(8).randn(2, 4, 8, 8) * sigmas[0]).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(JS.get_sampler(name)(jax_den, jnp.asarray(x), sigmas, key=key))
    noises, k = [], key
    for _ in range(len(sigmas) - 1):  # the reference's draws, step by step
        k, sub = jax.random.split(k)
        noises.append(np.asarray(jax.random.normal(sub, x.shape, jnp.float32)))
    out = TS.get_sampler(name)(torch_den, torch.from_numpy(x), sigmas, noises=noises).numpy()
    assert np.abs(out - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())
    gen = torch.Generator().manual_seed(0)
    drawn = TS.get_sampler(name)(torch_den, torch.from_numpy(x), sigmas, gen=gen)
    assert torch.isfinite(drawn).all() and not np.allclose(drawn.numpy(), out)


@pytest.fixture(scope="module")
def pair(unet_params, vae_params, text_params):
    """maua_tpu's StableDiffusion at the tiny sizes and the port's with the same parameters."""
    kw = dict(sampler="lms", timesteps=5, cfg_scale=5.0, image_size=64)
    jsd = JaxSD(unet_params=unet_params, vae_params=vae_params, text_params=text_params,
                unet_cfg=TINY_UNET, vae_cfg=TINY_VAE, text_cfg=TINY_TEXT, **kw)
    tsd = StableDiffusion(unet_params=bridge.diffusion_params_to_torch(unet_params),
                          vae_params=bridge.diffusion_params_to_torch(vae_params),
                          text_params=bridge.diffusion_params_to_torch(text_params),
                          unet_cfg=port_cfg(TU.UNetConfig, TINY_UNET), vae_cfg=port_cfg(TV.VAEConfig, TINY_VAE),
                          text_cfg=port_cfg(TT.CLIPTextConfig, TINY_TEXT), device="cpu", **kw)
    return jsd, tsd


def _psnr(a, b):
    a, b = np.clip(a, -1, 1), np.clip(b, -1, 1)
    return 10 * math.log10(4.0 / max(float(np.mean((a - b) ** 2)), 1e-20))


def test_stable_forward_matches(pair):
    jsd, tsd = pair
    img = np.zeros((1, 64, 64, 3), np.float32)
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jsd.forward(img, [JaxTextPrompt("a red fox")], 0.0, key=key))
    noise = np.asarray(jax.random.normal(jax.random.split(key)[0], (1, 32, 32, 4)))  # the reference's draw
    out = tsd.forward(img, [TextPrompt("a red fox")], 0.0, noise=noise).numpy()
    assert out.shape == ref.shape == (1, 64, 64, 3)
    print(f"forward: max abs err {np.abs(out - ref).max():.3g}, PSNR {_psnr(out, ref):.1f} dB")
    assert _psnr(out, ref) >= 40.0


def test_image_sample_matches(pair):
    jsd, tsd = pair
    ref = np.asarray(jax_image_sample(text="a lighthouse at dusk", sizes=((64, 64),), diffusion=jsd, verbose=False))
    key = jax.random.split(jax.random.PRNGKey(0))[0]  # the pipeline's key after drawing the init image
    _, sub = jax.random.split(key)
    noise = np.asarray(jax.random.normal(jax.random.split(sub)[0], (1, 32, 32, 4)))
    stages = {}
    out = TI.image_sample(text="a lighthouse at dusk", sizes=((64, 64),), diffusion=tsd, verbose=False, noise=noise,
                          stage_times=stages).numpy()
    assert out.shape == ref.shape == (1, 64, 64, 3)
    print(f"image_sample: max abs err {np.abs(out - ref).max():.3g}, PSNR {_psnr(out, ref):.1f} dB")
    assert _psnr(out, ref) >= 40.0
    assert set(stages) == {"text", "sampling", "decode"}


def test_cfg_scale_and_sampler_are_read_live(pair):
    """maua_tpu's unguided path freezes both at its first jitted call; the port reads them at each call."""
    _, tsd = pair
    noise = np.random.RandomState(9).randn(1, 32, 32, 4).astype(np.float32)
    img = np.zeros((1, 64, 64, 3), np.float32)

    def run():
        return tsd.forward(img, [TextPrompt("a red fox")], 0.0, noise=noise, latent=False).numpy()

    base = run()
    np.testing.assert_array_equal(run(), base)
    tsd.cfg_scale = 1.0
    guided_less = run()
    tsd.cfg_scale = 5.0
    tsd.sampler_name = "euler"
    other_sampler = run()
    tsd.sampler_name = "lms"
    assert np.abs(guided_less - base).max() > 1e-3
    assert np.abs(other_sampler - base).max() > 1e-3


def test_img2img_and_latent_paths(pair):
    _, tsd = pair
    img = np.tanh(np.random.RandomState(10).randn(1, 64, 64, 3)).astype(np.float32)
    out = tsd.forward(img, [TextPrompt("x")], 0.6)
    assert out.shape == (1, 64, 64, 3) and torch.isfinite(out).all()
    lat = tsd.forward(np.zeros((1, 8, 8, 4), np.float32), [], 0.0, latent=True)
    assert lat.shape == (1, 8, 8, 4)
    assert tsd.forward(img, [], 1.0).shape == img.shape  # nothing left to denoise


def test_not_ported_paths_raise(pair):
    """Guidance, the guided / latent processors and GLID3XL build (tests/test_torch_guided_diffusion.py and
    tests/test_torch_glide.py hold them against maua_tpu); GLIDE refuses a guidance scale."""
    _, tsd = pair

    class Grad:
        scale = 1.0

    tiny = dict(unet_cfg=tsd.unet_cfg, vae_cfg=tsd.vae_cfg, text_cfg=tsd.text_cfg, device="cpu")
    assert StableDiffusion(grad_modules=[Grad()], **tiny).grad_modules[0].scale == 1.0
    assert type(TI.get_diffusion_model("glid3xl", timesteps=3, **tiny)).__name__ == "GLID3XL"
    with pytest.raises(ValueError, match="clip_scale"):
        TI.get_diffusion_model("glide", clip_scale=1.0)
    model = TI.get_diffusion_model("stable", color_match_scale=1.0, **tiny)
    assert [type(g).__name__ for g in model.grad_modules] == ["ColorMatchGrads"]


def test_entry_points_need_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        StableDiffusion(unet_cfg=port_cfg(TU.UNetConfig, TINY_UNET), vae_cfg=port_cfg(TV.VAEConfig, TINY_VAE),
                        text_cfg=port_cfg(TT.CLIPTextConfig, TINY_TEXT))


def test_cli_dispatches_to_the_image_sampler(monkeypatch, tmp_path):
    from maua_tpu_torch.__main__ import main

    seen = {}
    monkeypatch.setattr(TI, "main", lambda argv: seen.setdefault("argv", argv))
    main(["diffusion", "image", "--text", "a fox", "--sizes", "64,64", "--device", "cpu"])
    assert seen["argv"] == ["--text", "a fox", "--sizes", "64,64", "--device", "cpu"]
    with pytest.raises(SystemExit):
        main(["diffusion", "video"])


def test_cli_renders_an_image(pair, monkeypatch, tmp_path):
    _, tsd = pair
    seen = {}

    def fake_model(*args, **kwargs):
        seen.update(kwargs)
        return tsd

    monkeypatch.setattr(TI, "get_diffusion_model", fake_model)
    TI.main(["--text", "a fox", "--sizes", "64,64", "--device", "cpu", "--out_dir", str(tmp_path)])
    assert seen["device"] == "cpu" and seen["timesteps"] == 50 and seen["cfg_scale"] == 5.0
    (png,) = tmp_path.glob("a_fox_*.png")
    img = TIO.load_image(png)
    want = TI.image_sample(text="a fox", sizes=((64, 64),), diffusion=tsd, verbose=False).numpy()
    assert img.shape == (1, 64, 64, 3)
    assert np.abs(img - np.clip((want + 1) / 2, 0, 1)).max() <= 1 / 255 + 1e-6


@pytest.mark.parametrize("text", ["a fox", "a fox:0.5", "https://x.org/a.png:2", "w:1:-0.25"])
def test_prompt_parsing_matches(text):
    assert parse_prompt(text) == jax_parse_prompt(text)
    assert TextPrompt(text).text == JaxTextPrompt(text).text and TextPrompt(text).weight == JaxTextPrompt(text).weight


def test_image_prompts_and_io(tmp_path):
    arr = np.random.RandomState(13).rand(1, 16, 24, 3).astype(np.float32)
    prompt = ContentPrompt(img=arr)
    np.testing.assert_allclose(prompt.img, arr * 2 - 1)
    TIO.save_image(torch.from_numpy(arr * 2 - 1), str(tmp_path / "x.png"))
    loaded = ImagePrompt(path=str(tmp_path / "x.png"), size=(16, 24))
    assert np.abs(loaded.img - prompt.img).max() <= 2 / 255 + 1e-6
    from maua_tpu.prompt import ImagePrompt as JaxImagePrompt

    resized = ImagePrompt(img=arr, size=(32, 40)).img
    assert resized.shape == (1, 32, 40, 3)
    assert np.abs(resized - np.asarray(JaxImagePrompt(img=arr, size=(32, 40)).img)).max() <= 1e-5
    with pytest.raises(NotImplementedError):
        ImagePrompt(url="https://x.org/a.png")
