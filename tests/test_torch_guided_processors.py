"""The port's guided-diffusion and latent-diffusion processors and the
latent-diffusion upscaler against maua_tpu's, on the CPU (the whole paths
that tests/test_torch_guided_diffusion.py does not hold, in a file of
their own so that the two share the test workers).

GuidedDiffusion with "fast" and "hyper" guidance and DDIM, PLMS and "p"
sampling (TINY_GUIDED, the full-width secondary model, the tiny CLIP);
LatentDiffusion with and without guidance and the upscaler (TINY_UNET,
TINY_VAE, TINY_TEXT). Parameters are numpy draws in maua_tpu's pytree,
carried over by the bridge; JAX's draws (the starting noise, DDIM's
ancestral noise, cutout sizes and offsets) are handed to the port. Each
whole path's image PSNR >= 40 dB against maua_tpu (peak 2, the [-1, 1]
range; the max abs error is printed), and each guided path's controls
(unguided, and without each one grad module) below it (`_apart`).
"""

import jax
import numpy as np
import pytest
import torch

from maua_tpu import grad as JG
from maua_tpu.diffusion.models import secondary as JSEC
from maua_tpu.diffusion.models import unet as JU
from maua_tpu.diffusion.processors.guided import GuidedDiffusion as JaxGuided
from maua_tpu.diffusion.processors.latent import LatentDiffusion as JaxLatent
from maua_tpu.super import image as JSI
from maua_tpu_torch import bridge
from maua_tpu_torch import grad as TG
from maua_tpu_torch.diffusion.models import unet as TU
from maua_tpu_torch.diffusion.processors.guided import GuidedDiffusion
from maua_tpu_torch.diffusion.processors.latent import LatentDiffusion
from maua_tpu_torch.super import image as TSI
from test_torch_diffusion import TINY_GUIDED, port_cfg, random_params
from test_torch_guidance import clip_grads_draws
from test_torch_guided_diffusion import _apart, _prompt_pairs, _sd_kwargs, _whole, clip_perceptors, make_clip_params, \
    make_sd_params


@pytest.fixture(scope="module")
def secondary_params():
    return random_params(JSEC.init_params, 34)


@pytest.fixture(scope="module")
def sd_params():
    return make_sd_params()


@pytest.fixture(scope="module")
def clip_params():
    return make_clip_params()


@pytest.fixture(scope="module")
def guided_unet():
    return random_params(lambda k: JU.init_params(k, TINY_GUIDED), 3)


@pytest.mark.parametrize("speed,sampler", [("fast", "ddim"), ("hyper", "ddim"), ("fast", "plms"), ("fast", "p")])
def test_guided_diffusion_matches(guided_unet, secondary_params, clip_params, speed, sampler):
    jclip, tclip = clip_perceptors(clip_params)
    timesteps = 4
    calls = timesteps + 1 if sampler == "plms" else timesteps  # PLMS's warm-up calls the model once more
    ckey, key = jax.random.PRNGKey(14), jax.random.PRNGKey(15)
    # "hyper" hands the grad modules the noised image's exact x0 (here the input image) plus roundoff
    # magnified by 1/alpha; colour matching's soft histogram has a gradient that jumps at each kernel's
    # centre, so a pixel within that roundoff of a centre takes opposite gradients in the two frameworks
    # (measured 27.7 dB at scale 300, 63 dB at scale 1): "hyper" is held with the smooth TV loss instead
    second = (JG.TVGrads, TG.TVGrads, 50.0) if speed == "hyper" else (JG.ColorMatchGrads, TG.ColorMatchGrads, 500.0)
    jgm = [JG.CLIPGrads(perceptor=jclip, scale=300.0, n_cutouts=4, cutout_key=ckey), second[0](scale=second[2])]

    def port_modules():
        return [TG.CLIPGrads(perceptor=tclip, scale=300.0, n_cutouts=4,
                             draws=clip_grads_draws(ckey, calls, 32, 32, 32, 4)), second[1](scale=second[2])]

    tgm = port_modules()
    kw = dict(sampler=sampler, timesteps=timesteps, speed=speed, image_size=32)
    jgd = JaxGuided(grad_modules=jgm, unet_params=guided_unet, unet_cfg=TINY_GUIDED,
                    secondary_params=secondary_params, **kw)
    tkw = dict(unet_params=bridge.diffusion_params_to_torch(guided_unet), unet_cfg=port_cfg(TU.UNetConfig, TINY_GUIDED),
               secondary_params=bridge.guidance_params_to_torch(secondary_params), device="cpu", **kw)
    tgd = GuidedDiffusion(grad_modules=tgm, **tkw)
    jprompts, tprompts = _prompt_pairs(32)
    img = np.random.RandomState(42).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jgd.forward(img, jprompts, 0.0, key=key))
    k_noise, k_sample = jax.random.split(key)
    noise = np.asarray(jax.random.normal(k_noise, img.shape))
    noises, k = [], k_sample
    for _ in range(len(jgd.timestep_map)):
        k, sub = jax.random.split(k)
        noises.append(np.asarray(jax.random.normal(sub, img.shape)).transpose(0, 3, 1, 2))
    out = tgd.forward(img, tprompts, 0.0, noise=noise, noises=list(noises))
    assert tgm[0].draws == []
    _whole(out, ref, f"guided diffusion {speed} {sampler}")
    # without the guidance, or without either module, the image fails the bar
    _apart(GuidedDiffusion(**tkw).forward(img, tprompts, 0.0, noise=noise, noises=list(noises)), ref,
           f"guided diffusion {speed} {sampler} unguided")
    for i, name in enumerate(type(g).__name__ for g in tgm):
        less = port_modules()
        del less[i]
        _apart(GuidedDiffusion(grad_modules=less, **tkw).forward(img, tprompts, 0.0, noise=noise, noises=list(noises)),
               ref, f"guided diffusion {speed} {sampler} without {name}")
    assert tgd.forward(img, tprompts, 0.5, t_end=0.5).shape == img.shape  # nothing to denoise


@pytest.mark.parametrize("sampler,guided", [("plms", False), ("ddim", True), ("plms", True)])
def test_latent_diffusion_matches(sd_params, sampler, guided):
    jkw, tkw = _sd_kwargs(sd_params)
    kw = dict(sampler=sampler, timesteps=4, cfg_scale=4.0, image_size=64)
    jgm = [JG.ColorMatchGrads(scale=3000.0), JG.TVGrads(scale=200.0)] if guided else []

    def port_modules():
        return [TG.ColorMatchGrads(scale=3000.0), TG.TVGrads(scale=200.0)] if guided else []

    tgm = port_modules()
    jld, tld = JaxLatent(grad_modules=jgm, **jkw, **kw), LatentDiffusion(grad_modules=tgm, **tkw, **kw)
    jprompts, tprompts = _prompt_pairs(64, "a lighthouse")
    img = np.zeros((1, 64, 64, 3), np.float32)
    key = jax.random.PRNGKey(16)
    ref = np.asarray(jld.forward(img, jprompts, 0.0, key=key))
    noise = np.asarray(jax.random.normal(jax.random.split(key)[0], (1, 32, 32, 4)))
    out = tld.forward(img, tprompts, 0.0, noise=noise)
    _whole(out, ref, f"latent diffusion {sampler} guided={guided}")
    if guided:  # without the guidance, or without either module, the image fails the bar
        _apart(LatentDiffusion(**tkw, **kw).forward(img, tprompts, 0.0, noise=noise), ref,
               f"latent diffusion {sampler} unguided")
        for i, name in enumerate(type(g).__name__ for g in tgm):
            less = port_modules()
            del less[i]
            _apart(LatentDiffusion(grad_modules=less, **tkw, **kw).forward(img, tprompts, 0.0, noise=noise), ref,
                   f"latent diffusion {sampler} without {name}")


def test_latent_diffusion_upscaler_matches(sd_params, monkeypatch):
    jkw, tkw = _sd_kwargs(sd_params)
    jax_up = JSI._LDMUpscale.__new__(JSI._LDMUpscale)
    from maua_tpu.ops.image import resample as jax_resample

    jax_up._resample, jax_up.t_start = jax_resample, 0.65
    jax_up.proc = JaxLatent(sampler="ddim", timesteps=6, cfg_scale=1.0, **jkw)
    port_up = TSI._LDMUpscale.__new__(TSI._LDMUpscale)
    port_up.t_start, port_up.proc = 0.65, LatentDiffusion(sampler="ddim", timesteps=6, cfg_scale=1.0, **tkw)
    img = np.random.RandomState(43).rand(1, 16, 16, 3).astype(np.float32)
    ref = np.asarray(jax_up(img))
    noise = np.asarray(jax.random.normal(jax.random.split(jax.random.PRNGKey(0))[0], (1, 32, 32, 4)))
    out = port_up(torch.from_numpy(img), noise=noise)
    _whole(out * 2 - 1, ref * 2 - 1, "latent-diffusion upscaler")
    monkeypatch.setattr(TSI, "_LDMUpscale", lambda **kw: port_up)
    up = TSI.Upscaler("latent-diffusion", device="cpu")
    assert up.scale == 4 and up(img).shape == (1, 64, 64, 3)
