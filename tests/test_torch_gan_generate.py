"""The port's latent sampling (gan/sampling.py), analysis (gan/analysis.py)
and the `gan generate` command (gan/cli.py), against maua_tpu.

A 32^2 StyleGAN2 with narrow channels, random parameters in maua_tpu's
pytree (test_torch_stylegan2.py's helper) brought over by the bridge, f32
on the CPU. Random draws are made by JAX from its keys as maua_tpu makes
them and handed to the port. Tolerances: sampled latents equal (rows of
the same draws), Langevin latents 1e-5, SeFa directions 1e-5 up to the
SVD's sign, blends exact, rendered images within one uint8 level.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from maua_tpu import utility as jax_utility
from maua_tpu.gan import analysis as JA
from maua_tpu.gan import sampling as JS
from maua_tpu.gan import stylegan2 as J
from maua_tpu.gan import wrappers as JW
from maua_tpu_torch import __main__ as cli_main
from maua_tpu_torch import bridge
from maua_tpu_torch.gan import analysis as TA
from maua_tpu_torch.gan import sampling as TS
from maua_tpu_torch.gan import stylegan2 as T
from maua_tpu_torch.gan import wrappers as TW
from test_torch_stylegan2 import random_jax_params

KW = dict(img_resolution=32, channel_base=256, channel_max=32, z_dim=32, w_dim=32, mapping_layers=2, num_fp16_res=0)


@pytest.fixture(scope="module")
def net():
    cfg = J.SG2Config(**KW)
    params = random_jax_params(cfg, 11)
    return cfg, T.SG2Config(**KW), params, bridge.params_to_torch(params)


def test_polarity_sample_with_the_draws_handed_in(net):
    cfg, tcfg, params, tparams = net
    key = jax.random.PRNGKey(3)
    want = np.asarray(JS.polarity_sample(key, 5, params, cfg, n_probe=64, polarity=-0.5))
    kp, ks = jax.random.split(key)
    z = torch.from_numpy(np.array(jax.random.normal(kp, (64, cfg.z_dim))))
    u = torch.from_numpy(np.array(jax.random.uniform(ks, (5,))))
    got = TS.polarity_sample(None, 5, tparams, tcfg, n_probe=64, polarity=-0.5, z=z, u=u).numpy()
    np.testing.assert_array_equal(got, want)
    assert TS.polarity_sample(torch.Generator().manual_seed(0), 5, tparams, tcfg, n_probe=64).shape == (5, 32)


def test_jacnorm_sample_with_the_draws_handed_in(net):
    cfg, tcfg, params, tparams = net
    key = jax.random.PRNGKey(4)
    want = np.asarray(JS.jacnorm_sample(key, 6, params, cfg, percentile=40.0, oversample=3))
    kz, kv = jax.random.split(key)
    z = torch.from_numpy(np.array(jax.random.normal(kz, (18, cfg.z_dim))))
    v = torch.from_numpy(np.array(jax.random.normal(kv, (cfg.z_dim,))))
    got = TS.jacnorm_sample(None, 6, tparams, tcfg, percentile=40.0, oversample=3, z=z, v=v).numpy()
    np.testing.assert_array_equal(got, want)


def test_langevin_sample_with_an_energy_and_the_draws_handed_in():
    a = np.random.RandomState(5).randn(8).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = np.asarray(JS.langevin_sample(key, 3, lambda z: jnp.sum(jnp.sin(z) * a, -1), z_dim=8, n_steps=7,
                                         step_size=0.05, noise_scale=0.2))
    k0, kz = jax.random.split(key)
    z = np.array(jax.random.normal(kz, (3, 8)))
    noise = np.stack([np.array(jax.random.normal(k, (3, 8))) for k in jax.random.split(k0, 7)])
    ta = torch.from_numpy(a)
    got = TS.langevin_sample(None, 3, lambda z: (torch.sin(z) * ta).sum(-1), z_dim=8, n_steps=7, step_size=0.05,
                             noise_scale=0.2, z=torch.from_numpy(z), noise=torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_langevin_energies_wait_for_the_discriminator_and_clip(net):
    """The discriminator's energy needs a generator with its checkpoint (tests/test_torch_gan_discriminator.py
    runs it on one): without a generator both packages raise ValueError. CLIP's runs: energy and its
    gradient against maua_tpu's on the same tiny CLIP (tests/test_torch_guidance.py's), 1e-4 of their
    largest magnitude."""
    from types import SimpleNamespace

    from test_torch_diffusion import TINY_TEXT, random_params
    from test_torch_guidance import TINY_VISION
    from test_torch_guided_diffusion import clip_perceptors
    from maua_tpu.perceptors import clip as JCLIP
    from maua_tpu.text import clip_text as JT

    cfg, tcfg, params, tparams = net
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="generator"):
        TS.sample_latents("langevin", gen, 2, tparams, tcfg)
    with pytest.raises(ValueError, match="generator"):
        JS.sample_latents("langevin", jax.random.PRNGKey(0), 2, params, cfg)
    clip = (random_params(lambda k: JCLIP.init_vision_params(k, TINY_VISION), 20),
            random_params(lambda k: JT.init_params(k, TINY_TEXT), 21),
            np.random.RandomState(22).randn(TINY_TEXT.width, TINY_VISION.embed_dim).astype(np.float32) / 8)
    jclip, tclip = clip_perceptors(clip)
    jenergy = JS.clip_energy(SimpleNamespace(params=params, cfg=cfg), "a red fox", perceptor=jclip)
    tenergy = TS.clip_energy(SimpleNamespace(params=tparams, cfg=tcfg), "a red fox", perceptor=tclip)
    z = np.random.RandomState(9).randn(3, cfg.z_dim).astype(np.float32)
    want, want_grad = (np.asarray(a) for a in jax.value_and_grad(lambda zz: jnp.sum(jenergy(zz)))(jnp.asarray(z)))
    tz = torch.from_numpy(z).requires_grad_(True)
    got = tenergy(tz)
    got.sum().backward()
    assert got.shape == (3,)
    np.testing.assert_allclose(got.sum().item(), want, rtol=1e-4)
    assert np.abs(tz.grad.numpy() - want_grad).max() <= 1e-4 * np.abs(want_grad).max()
    assert TS.sample_latents("random", gen, 4, tparams, tcfg).shape == (4, 32)
    with pytest.raises(ValueError, match="unknown"):
        TS.sample_latents("ddls", gen, 2, tparams, tcfg)


def test_sefa_blend_and_direction(net):
    cfg, tcfg, params, tparams = net
    want_d, want_s = (np.asarray(a) for a in JA.sefa(params, cfg, n_components=4))
    got_d, got_s = (a.numpy() for a in TA.sefa(tparams, tcfg, n_components=4))
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5)
    signs = np.sign(np.sum(got_d * want_d, axis=1, keepdims=True))
    np.testing.assert_allclose(got_d * signs, want_d, atol=1e-5)
    layers = ["b8.conv0", "b16.conv1"]
    np.testing.assert_allclose(TA.sefa(tparams, tcfg, 2, layers)[1].numpy(),
                               np.asarray(JA.sefa(params, cfg, 2, layers)[1]), rtol=1e-5)

    other = random_jax_params(cfg, 12)
    for kw in (dict(), dict(midpoint_resolution=16, blend_width=1.5)):
        want = bridge.params_to_torch(JA.blend_models(params, other, cfg, **kw))
        got = TA.blend_models(tparams, bridge.params_to_torch(other), tcfg, **kw)
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)

    ws = np.random.RandomState(13).randn(2, cfg.num_ws, cfg.w_dim).astype(np.float32)
    np.testing.assert_allclose(TA.apply_direction(torch.from_numpy(ws), torch.from_numpy(want_d[1]), 2.5).numpy(),
                               np.asarray(JA.apply_direction(jnp.asarray(ws), jnp.asarray(want_d[1]), 2.5)))


@pytest.mark.parametrize("grid", [False, True])
def test_generate_images_matches_maua_tpu(net, tmp_path, monkeypatch, grid):
    cfg, tcfg, params, tparams = net
    monkeypatch.setattr(jax_utility, "WORKSPACE", str(tmp_path))  # maua_tpu caches its s2d plans there
    want = JA.generate_images(JW.StyleGAN2(cfg=cfg, params=params), seeds="3-6", truncation=0.7, batch_size=2,
                              out_dir=str(tmp_path / "jax"), grid=grid)
    got = TA.generate_images(TW.StyleGAN2(cfg=tcfg, params=tparams, device="cpu"), seeds="3-6", truncation=0.7,
                             batch_size=2, out_dir=str(tmp_path / "port"), grid=grid)
    assert got.shape == want.shape == (3, 32, 32, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want).max() <= 1
    names = ["grid.png"] if grid else [f"seed_{i:04d}.png" for i in range(3)]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == names
    if not grid:
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port" / names[2])), got[2])


@pytest.mark.parametrize("sampling", ["random", "polarity", "jacnorm"])
def test_gan_generate_command_writes_pngs(tmp_path, sampling):
    """`python -m maua_tpu_torch gan generate` on the CPU, from an ADA .pkl of
    a 32^2 net (loaded in bf16, the command's default dtype)."""
    cfg = T.SG2Config(**{**KW, "num_fp16_res": 4})
    pkl = str(tmp_path / "g.pkl")
    chip_smoke.write_ada_pkl(pkl, chip_smoke.ada_state_dict(T.init_params(cfg, torch.Generator().manual_seed(0))))
    out = tmp_path / sampling
    cli_main.main(["gan", "generate", "--model_file", pkl, "--seeds", "0-3", "--batch_size", "2", "--sampling",
                   sampling, "--out_dir", str(out), "--device", "cpu"])
    files = sorted(os.listdir(out))
    assert files == [f"seed_{i:04d}.png" for i in range(3)]
    imgs = [np.asarray(Image.open(out / f)) for f in files]
    assert all(im.shape == (32, 32, 3) and im.min() < im.max() for im in imgs)
    if sampling != "polarity":  # polarity may draw one probe latent several times
        assert len({im.tobytes() for im in imgs}) == 3
