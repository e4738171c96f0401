"""The port's guided and alpha-space diffusion against maua_tpu's, on the CPU:
DDIM, PLMS and q_sample, the secondary model, the whole paths of guided
Stable Diffusion (every grad module on) and the image-conditioned variant,
and the entry points. (GuidedDiffusion, LatentDiffusion and the
latent-diffusion upscaler: tests/test_torch_guided_processors.py.)

The tiny configurations of tests/test_diffusion_pipeline.py (TINY_UNET,
TINY_VAE, TINY_TEXT, TINY_GUIDED) and of tests/test_torch_guidance.py
(the 32^2, patch-8 CLIP vision tower); VGG, LPIPS and the secondary model
at their fixed published widths. Every parameter is a numpy draw in
maua_tpu's pytree, carried over by the bridge; JAX's draws (the starting
noise, DDIM's ancestral noise, cutout sizes and offsets, the image
conditioning's noise image) are handed to the port.

Tolerances, f32: the samplers 1e-5 relative to the largest value on an
analytic eps model; the secondary model 1e-4 of its largest output; each
whole path's image PSNR >= 40 dB against maua_tpu (peak 2, the [-1, 1]
range; the max abs error is printed). A guided path's controls, the port's
image without guidance and without each one grad module, must each fall
below that bar against maua_tpu's guided image (`_apart`), so a port that
lost any of the guidance fails; the scales are chosen so that each module
moves the image well past it (the margins are printed).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu import grad as JG
from maua_tpu.diffusion import samplers as JS
from maua_tpu.diffusion.models import secondary as JSEC
from maua_tpu.diffusion.models import unet as JU
from maua_tpu.diffusion.models import vae as JV
from maua_tpu.diffusion.processors.stable import StableDiffusion as JaxSD
from maua_tpu.perceptors import clip as JCLIP
from maua_tpu.perceptors import vgg as JVGG
from maua_tpu.prompt import ContentPrompt as JContentPrompt
from maua_tpu.prompt import ImagePrompt as JImagePrompt
from maua_tpu.prompt import StylePrompt as JStylePrompt
from maua_tpu.prompt import TextPrompt as JTextPrompt
from maua_tpu.text import clip_text as JT
from maua_tpu_torch import bridge
from maua_tpu_torch import grad as TG
from maua_tpu_torch.diffusion import image as TI
from maua_tpu_torch.diffusion import samplers as TS
from maua_tpu_torch.diffusion.models import secondary as TSEC
from maua_tpu_torch.diffusion.models import unet as TU
from maua_tpu_torch.diffusion.models import vae as TV
from maua_tpu_torch.diffusion.processors.guided import GuidedDiffusion, respaced_timesteps
from maua_tpu_torch.diffusion.processors.latent import LatentDiffusion
from maua_tpu_torch.diffusion.processors.stable import StableDiffusion
from maua_tpu_torch.kernels import attention as TA
from maua_tpu_torch.perceptors import clip as TCLIP
from maua_tpu_torch.perceptors import vgg as TVGG
from maua_tpu_torch.prompt import ContentPrompt, ImagePrompt, StylePrompt, TextPrompt
from maua_tpu_torch.text import clip_text as TT
from test_torch_diffusion import TINY_GUIDED, TINY_TEXT, TINY_UNET, TINY_VAE, _psnr, port_cfg, random_params
from test_torch_guidance import TINY_VISION, clip_grads_draws

# One torch thread a process. Under `-n 6` six test workers share the host's cores and each worker's pool
# defaults to a thread per core, so the pools oversubscribe the cores; every worker imports this module when
# it collects the tests, so the cap holds for all the tests it runs. (Six workers on an 8-core host over the
# six heaviest port test files: 621 s wall uncapped, 205 s capped; this file and
# test_torch_guided_processors.py 1129 s and 290 s of junit time.)
torch.set_num_threads(1)


def _close(got, want, rtol):
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= rtol * np.abs(want).max(), err


def _whole(out, ref, what):
    out, ref = out.numpy(), np.asarray(ref)
    assert out.shape == ref.shape
    print(f"{what}: max abs err {np.abs(out - ref).max():.3g}, PSNR {_psnr(out, ref):.1f} dB")
    assert _psnr(out, ref) >= 40.0
    assert np.abs(ref).max() > 0.05


def _apart(out, ref, what):
    """A control: the port's image with (some of) the guidance left out fails `_whole`'s bar against
    maua_tpu's guided image, so that a port which lost that guidance could not pass."""
    psnr = _psnr(out.numpy(), np.asarray(ref))
    print(f"{what}: PSNR {psnr:.1f} dB against the guided reference")
    assert psnr < 40.0, (what, psnr)


# ------------------------------------------------------------------ samplers
def _eps_models():
    """The same analytic eps model in both frameworks, depending on x and t."""
    target = np.random.RandomState(30).randn(2, 3, 8, 8).astype(np.float32)

    def jax_eps(x, t):
        return jnp.tanh(x - jnp.asarray(target)) * (t.astype(jnp.float32)[:, None, None, None] / 1000 + 0.5)

    def torch_eps(x, t):
        return torch.tanh(x - torch.from_numpy(target)) * (t.float()[:, None, None, None] / 1000 + 0.5)

    return jax_eps, torch_eps


@pytest.mark.parametrize("eta,clip", [(0.0, False), (0.0, True), (0.7, True)])
def test_ddim_matches(eta, clip):
    jax_eps, torch_eps = _eps_models()
    ac = JS.make_ddpm_schedule(1000, schedule="linear")
    steps = respaced_timesteps(1000, "ddim8")[::-1].copy()
    x = np.random.RandomState(31).randn(2, 3, 8, 8).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want_x, want_pred = JS.ddim_sample_loop(jax_eps, jnp.asarray(x), steps, ac, eta=eta, key=key, clip_denoised=clip)
    noises, k = [], key
    for _ in steps:  # the reference's draws, step by step
        k, sub = jax.random.split(k)
        noises.append(np.asarray(jax.random.normal(sub, x.shape)))
    got_x, got_pred = TS.ddim_sample_loop(torch_eps, torch.from_numpy(x), steps, ac, eta=eta, clip_denoised=clip,
                                          noises=noises)
    _close(got_x, want_x, 1e-5)
    _close(got_pred, want_pred, 1e-5)


@pytest.mark.parametrize("clip", [False, True])
def test_plms_and_q_sample_match(clip):
    jax_eps, torch_eps = _eps_models()
    ac = JS.make_ddpm_schedule(1000)
    steps = np.linspace(0, 999, 7).round().astype(int)[::-1].copy()
    x = np.random.RandomState(32).randn(2, 3, 8, 8).astype(np.float32)
    want_x, want_pred = JS.plms_sample_loop(jax_eps, jnp.asarray(x), steps, ac, clip_denoised=clip)
    got_x, got_pred = TS.plms_sample_loop(torch_eps, torch.from_numpy(x), steps, ac, clip_denoised=clip)
    _close(got_x, want_x, 1e-5)
    _close(got_pred, want_pred, 1e-5)
    a = np.array([0.3, 0.9], np.float32)
    n = np.random.RandomState(33).randn(2, 3, 8, 8).astype(np.float32)
    _close(TS.q_sample(torch.from_numpy(x), a, torch.from_numpy(n)), JS.q_sample(jnp.asarray(x), jnp.asarray(a),
                                                                                  jnp.asarray(n)), 1e-6)


def test_respacing_matches():
    from maua_tpu.diffusion.processors.guided import respaced_timesteps as jax_respaced

    for spec in ("ddim25", "ddim7", "25", "100"):
        np.testing.assert_array_equal(respaced_timesteps(1000, spec), jax_respaced(1000, spec))


# ------------------------------------------------------------------ secondary model
@pytest.fixture(scope="module")
def secondary_params():
    return random_params(JSEC.init_params, 34)


def test_secondary_model_matches(secondary_params):
    x = np.random.RandomState(35).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    t = np.array([0.2, 0.85], np.float32)
    want = JSEC.forward(secondary_params, jnp.asarray(x), jnp.asarray(t))
    got = TSEC.forward(bridge.guidance_params_to_torch(secondary_params),
                       torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t))
    for k in ("v", "pred", "eps"):
        _close(got[k].permute(0, 2, 3, 1), want[k], 1e-4)
    sd = {f"{name}.weight": np.random.RandomState(i).randn(co, ci, 3, 3).astype(np.float32) * 0.05
          for i, (name, ci, co) in enumerate(JSEC._conv_names())}
    sd.update({f"{name}.bias": np.full(co, 0.01 * i, np.float32) for i, (name, ci, co) in enumerate(JSEC._conv_names())})
    sd["timestep_embed.weight"] = np.random.RandomState(99).randn(8, 1).astype(np.float32)
    want = jax.tree_util.tree_map(np.asarray, JSEC.params_from_torch(sd))
    got = TSEC.params_from_torch({k: torch.from_numpy(v) for k, v in sd.items()})
    jax.tree_util.tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
                           bridge.guidance_params_to_torch(want), got)


# ------------------------------------------------------------------ whole paths
def make_sd_params():
    return (random_params(lambda k: JU.init_params(k, TINY_UNET), 0), random_params(lambda k: JV.init_params(k, TINY_VAE), 1),
            random_params(lambda k: JT.init_params(k, TINY_TEXT), 2))


def make_clip_params():
    vision = random_params(lambda k: JCLIP.init_vision_params(k, TINY_VISION), 20)
    text = random_params(lambda k: JT.init_params(k, TINY_TEXT), 21)
    proj = np.random.RandomState(22).randn(TINY_TEXT.width, TINY_VISION.embed_dim).astype(np.float32) / 8
    return vision, text, proj


@pytest.fixture(scope="module")
def sd_params():
    return make_sd_params()


@pytest.fixture(scope="module")
def clip_params():
    return make_clip_params()


def clip_perceptors(clip_params):
    vision, text, proj = clip_params
    jp = JCLIP.CLIPPerceptor(vision_params=vision, vision_cfg=TINY_VISION, text_params=text, text_cfg=TINY_TEXT,
                             text_proj=jnp.asarray(proj))
    tp = TCLIP.CLIPPerceptor(vision_params=bridge.guidance_params_to_torch(vision),
                             vision_cfg=port_cfg(TCLIP.CLIPVisionConfig, TINY_VISION),
                             text_params=bridge.diffusion_params_to_torch(text),
                             text_cfg=port_cfg(TT.CLIPTextConfig, TINY_TEXT), text_proj=proj, device="cpu")
    return jp, tp


def _sd_kwargs(sd_params):
    unet, vae, text = sd_params
    jkw = dict(unet_params=unet, vae_params=vae, text_params=text, unet_cfg=TINY_UNET, vae_cfg=TINY_VAE,
               text_cfg=TINY_TEXT)
    tkw = dict(unet_params=bridge.diffusion_params_to_torch(unet), vae_params=bridge.diffusion_params_to_torch(vae),
               text_params=bridge.diffusion_params_to_torch(text), unet_cfg=port_cfg(TU.UNetConfig, TINY_UNET),
               vae_cfg=port_cfg(TV.VAEConfig, TINY_VAE), text_cfg=port_cfg(TT.CLIPTextConfig, TINY_TEXT),
               device="cpu")
    return jkw, tkw


def _prompt_pairs(size, text="a red fox", seed=40):
    rs = np.random.RandomState(seed)
    style, content = rs.rand(1, size, size, 3).astype(np.float32), rs.rand(1, size, size, 3).astype(np.float32)
    return ([JTextPrompt(text), JStylePrompt(img=style), JContentPrompt(img=content)],
            [TextPrompt(text), StylePrompt(img=style), ContentPrompt(img=content)])


def test_guided_stable_diffusion_matches(sd_params, clip_params):
    """Every grad module on (CLIP, LPIPS, VGG style, colour match), 3 LMS steps at 64^2."""
    from test_torch_guidance import _vgg16_state_dict
    from maua_tpu.perceptors import lpips as JLP
    from maua_tpu_torch.perceptors import lpips as TLP

    jkw, tkw = _sd_kwargs(sd_params)
    jclip, tclip = clip_perceptors(clip_params)
    vgg = random_params(lambda k: JVGG.init_params(k, "vgg19"), 23)
    lin_sd = {f"lin{k}.model.1.weight": np.full((1, c, 1, 1), 0.05, np.float32)
              for k, c in enumerate(JLP.STAGE_CHANNELS)}
    vgg16_sd = _vgg16_state_dict(24)
    key, ckey = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
    steps = 3
    jgm = [JG.CLIPGrads(perceptor=jclip, scale=400.0, n_cutouts=4, cutout_key=ckey),
           JG.LPIPSGrads(scale=5000.0, params=JLP.params_from_torch(lin_sd, vgg16_sd)),
           JG.VGGGrads(perceptor=JVGG.VGGPerceptor(params=vgg), scale=200.0), JG.ColorMatchGrads(scale=2000.0)]
    lpips, vggp = TLP.params_from_torch(lin_sd, vgg16_sd), TVGG.VGGPerceptor(
        params=bridge.guidance_params_to_torch(vgg), device="cpu")

    def port_modules():
        return [TG.CLIPGrads(perceptor=tclip, scale=400.0, n_cutouts=4,
                             draws=clip_grads_draws(ckey, steps, 64, 64, 32, 4)),
                TG.LPIPSGrads(scale=5000.0, params=lpips, device="cpu"), TG.VGGGrads(perceptor=vggp, scale=200.0),
                TG.ColorMatchGrads(scale=2000.0)]

    tgm = port_modules()
    kw = dict(sampler="lms", timesteps=steps, cfg_scale=5.0, image_size=64)
    jsd, tsd = JaxSD(grad_modules=jgm, **jkw, **kw), StableDiffusion(grad_modules=tgm, **tkw, **kw)
    jprompts, tprompts = _prompt_pairs(64)
    img = np.zeros((1, 64, 64, 3), np.float32)
    ref = np.asarray(jsd.forward(img, jprompts, 0.0, key=key))
    noise = np.asarray(jax.random.normal(jax.random.split(key)[0], (1, 32, 32, 4)))
    TA.reset_launches()
    out = tsd.forward(img, tprompts, 0.0, noise=noise)
    assert TA.launches == 0 and tgm[0].draws == []
    _whole(out, ref, "guided SD")
    _apart(StableDiffusion(**tkw, **kw).forward(img, tprompts, 0.0, noise=noise), ref, "unguided SD")
    for i, name in enumerate(type(g).__name__ for g in tgm):  # each grad module moves the image past the bar
        less = port_modules()
        del less[i]
        _apart(StableDiffusion(grad_modules=less, **tkw, **kw).forward(img, tprompts, 0.0, noise=noise), ref,
               f"guided SD without {name}")


def test_image_conditioned_stable_diffusion_matches(sd_params, clip_params):
    jkw, tkw = _sd_kwargs(sd_params)
    vision = clip_params[0]
    vis64 = JCLIP.CLIPVisionConfig(**{**vars(TINY_VISION), "embed_dim": 64})
    kw = dict(sampler="euler", timesteps=4, cfg_scale=3.0, image_size=64, image_cond=True)
    jsd = JaxSD(vision_params=vision, vision_cfg=vis64, **jkw, **kw)
    tsd = StableDiffusion(vision_params=bridge.guidance_params_to_torch(vision),
                          vision_cfg=port_cfg(TCLIP.CLIPVisionConfig, vis64), **tkw, **kw)
    tsd.uncond_image = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (1, 32, 32, 3)) * 2.0 - 1.0)
    rs = np.random.RandomState(41)
    prompt = rs.rand(1, 48, 48, 3).astype(np.float32)
    img = rs.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    key = jax.random.PRNGKey(13)
    ref = np.asarray(jsd.forward(img, [JImagePrompt(img=prompt)], 0.3, key=key))
    noise = np.asarray(jax.random.normal(jax.random.split(key)[0], (1, 32, 32, 4)))
    out = tsd.forward(img, [ImagePrompt(img=prompt)], 0.3, noise=noise)
    _whole(out, ref, "image-conditioned SD")
    cond, uncond = tsd.conditioning([ImagePrompt(img=prompt)])
    assert cond.shape == uncond.shape == (1, 1, 64)
    tsd.uncond_image = None  # the port's own fixed draw
    assert tsd.conditioning([ImagePrompt(img=prompt)])[1].shape == (1, 1, 64)
    model = TI.get_diffusion_model("stable", timesteps=3, image="x.png", vision_cfg=tsd.vision_cfg, **tkw)
    assert model.image_cond and not TI.get_diffusion_model("stable", timesteps=3, **tkw).image_cond


# ------------------------------------------------------------------ entry points
def test_get_diffusion_model_builds_the_guidance_and_routes(sd_params):
    _, tkw = _sd_kwargs(sd_params)
    m = TI.get_diffusion_model("stable", timesteps=3, clip_scale=1.0, lpips_scale=2.0, style_scale=3.0,
                               color_match_scale=4.0, **tkw)
    assert [type(g).__name__ for g in m.grad_modules] == ["CLIPGrads", "LPIPSGrads", "VGGGrads", "ColorMatchGrads"]
    assert [g.scale for g in m.grad_modules] == [1.0, 2.0, 3.0, 4.0]
    assert m.grad_modules[3].device == torch.device("cpu")  # its target is built there, in set_targets
    lat = TI.get_diffusion_model("latent", sampler="lms", timesteps=3, **tkw)
    assert isinstance(lat, LatentDiffusion) and lat.sampler == "plms" and lat.grad_modules == []
    with pytest.raises(ValueError, match="clip_scale"):  # latent diffusion takes no scales: none is ignored
        TI.get_diffusion_model("latent", timesteps=3, clip_scale=1.0, **tkw)
    g = TI.get_diffusion_model("guided", sampler="ddim", timesteps=5, guidance_speed="hyper", clip_scale=1.0,
                               unet_cfg=port_cfg(TU.UNetConfig, TINY_GUIDED), device="cpu")
    assert isinstance(g, GuidedDiffusion) and g.conditioning.speed == "hyper" and len(g.timestep_map) == 5
    # GLIDE takes no grad modules: maua_tpu drops a guidance scale silently, the port refuses it
    with pytest.raises(ValueError, match="clip_scale"):
        TI.get_diffusion_model("glide", timesteps=3, clip_scale=1.0, device="cpu")
    g3 = TI.get_diffusion_model("glid3xl", timesteps=3, color_match_scale=4.0, **tkw)
    assert type(g3).__name__ == "GLID3XL" and [(type(g).__name__, g.scale) for g in g3.grad_modules] == \
        [("ColorMatchGrads", 4.0)]


def test_cli_passes_the_guidance_flags(monkeypatch, tmp_path):
    seen = {}

    def fake_model(*args, **kwargs):
        seen.update(kwargs, diffusion=args[0])
        raise SystemExit(0)

    monkeypatch.setattr(TI, "get_diffusion_model", fake_model)
    with pytest.raises(SystemExit):
        TI.main(["--diffusion", "guided", "--clip_scale", "1000", "--lpips_scale", "2", "--style_scale", "3",
                 "--color_match_scale", "500", "--guidance_speed", "hyper", "--device", "cpu",
                 "--out_dir", str(tmp_path)])
    assert seen["diffusion"] == "guided" and seen["guidance_speed"] == "hyper"
    assert (seen["clip_scale"], seen["lpips_scale"], seen["style_scale"], seen["color_match_scale"]) == \
        (1000.0, 2.0, 3.0, 500.0)


@pytest.mark.parametrize("argv", [["--clip_scale", "1000"], ["--diffusion", "guided"], ["--diffusion", "latent"],
                                  ["--image", "p.png"]])
def test_entry_points_need_a_card_unless_told_otherwise(monkeypatch, tmp_path, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TI.main(["--text", "a fox", "--out_dir", str(tmp_path)] + argv)
