"""The port's BigGAN and IC-GAN against maua_tpu's, on the CPU.

BigGAN at 32^2 (ch 8, attention at 16^2, classes and instance features)
and 64^2 (ch 4, attention at 32^2, instance features only), every parameter
of maua_tpu's pytree drawn with numpy (positive variances, attention gamma
0.5 so that the attention term shows) and carried over by the bridge; a
synthetic BigGAN-PyTorch state dict (`chip_smoke.biggan_state_dict`) with
and without `sv0` converted by both packages. IC-GAN on a 32^2 StyleGAN2
with c_dim 16 and a 32-px CLIP (test_torch_autoregressive.py's): `generate`
and 3 `icgan_clip` steps on JAX's own draws.

Tolerances, f32: images 1e-4 absolute in [-1, 1] (a dozen f32 conv layers
in another summation order); icgan_clip's latents and images after 3 Adam
steps 1e-4 (Adam normalizes each gradient entry, so the entries' relative
f32 error, 1e-5, moves its steps at lr 0.05 by up to ~1e-5 each).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from maua_tpu.gan import biggan as JB
from maua_tpu.gan import icgan as JI
from maua_tpu.gan import stylegan2 as JS
from maua_tpu_torch import bridge
from maua_tpu_torch.gan import biggan as TB
from maua_tpu_torch.gan import icgan as TI
from maua_tpu_torch.gan import stylegan2 as TS
from test_torch_autoregressive import clip_pair  # noqa: F401
from test_torch_diffusion import port_cfg
from test_torch_stylegan2 import random_jax_params

torch.set_num_threads(1)

CFG32 = JB.BigGANConfig(resolution=32, ch=8, dim_z=32, shared_dim=16, n_classes=5, feature_dim=24, attention_res=16)
CFG64 = JB.BigGANConfig(resolution=64, ch=4, dim_z=40, shared_dim=16, feature_dim=24, attention_res=32)
SG_KW = dict(img_resolution=32, c_dim=16, z_dim=32, w_dim=32, channel_base=256, channel_max=32, mapping_layers=2,
             num_fp16_res=0)


def biggan_params(cfg, seed):
    """maua_tpu's BigGAN pytree filled with numpy draws: weights at 1/sqrt(fan-in), biases, norm scales
    and means near their init, variances in [1, ~1.6], the attention's gamma 0.5."""
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", None)
        a = np.asarray(rs.randn(*leaf.shape), np.float32)
        if name == "w":
            return a / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))
        if name == "var":
            return np.float32(1) + np.abs(a) * np.float32(0.2)
        if name == "gamma":
            return np.float32(0.5)
        if name == "scale":
            return np.float32(1) + a * np.float32(0.1)
        return a * np.float32(0.1)  # biases, means, the class table

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(lambda: JB.init_params(jax.random.PRNGKey(0), cfg)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


@pytest.fixture(scope="module", params=["32", "64"])
def biggan(request):
    cfg = CFG32 if request.param == "32" else CFG64
    params = biggan_params(cfg, 50 + len(request.param))
    return cfg, port_cfg(TB.BigGANConfig, cfg), params, bridge.biggan_params_to_torch(params)


def _inputs(cfg, b=3, seed=51):
    rs = np.random.RandomState(seed)
    z = rs.randn(b, cfg.dim_z).astype(np.float32)
    feats = rs.randn(b, cfg.feature_dim).astype(np.float32)
    labels = rs.randint(0, max(cfg.n_classes, 1), b)
    return z, feats, labels


def test_generator_matches(biggan):
    cfg, tcfg, params, tparams = biggan
    z, feats, labels = _inputs(cfg)
    kw = dict(labels=jnp.asarray(labels)) if cfg.n_classes else {}
    tkw = dict(labels=torch.from_numpy(labels)) if cfg.n_classes else {}
    want = np.asarray(jax.jit(lambda p, z, f: JB.generator(p, z, cfg, features=f, **kw))(params, jnp.asarray(z),
                                                                                      jnp.asarray(feats)))
    got = TB.generator(tparams, torch.from_numpy(z), tcfg, features=torch.from_numpy(feats), **tkw)
    assert got.shape == (3, 3, cfg.resolution, cfg.resolution)
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-4)
    # the attention term is live: without it the image moves
    no_attn = dict(tparams, attention={**tparams["attention"], "gamma": torch.zeros(())})
    assert np.abs(_nhwc(TB.generator(no_attn, torch.from_numpy(z), tcfg, features=torch.from_numpy(feats), **tkw))
                  - want).max() > 1e-3


@pytest.mark.parametrize("sv0", [True, False])
def test_params_from_a_biggan_pytorch_state_dict(biggan, sv0):
    """With sv0 the fold gives back the source weights; without it both packages re-estimate sigma by
    the same five power iterations from u0."""
    cfg, tcfg, params, tparams = biggan
    sd = chip_smoke.biggan_state_dict(tparams, tcfg, sv0=sv0, seed=52)
    jp = JB.params_from_torch({k: v.numpy() for k, v in sd.items()}, cfg)
    tp = TB.params_from_torch(sd, tcfg)
    z, feats, labels = _inputs(cfg, seed=53)
    kw = dict(labels=jnp.asarray(labels)) if cfg.n_classes else {}
    tkw = dict(labels=torch.from_numpy(labels)) if cfg.n_classes else {}
    want = np.asarray(JB.generator(jp, jnp.asarray(z), cfg, features=jnp.asarray(feats), **kw))
    got = TB.generator(tp, torch.from_numpy(z), tcfg, features=torch.from_numpy(feats), **tkw)
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-4)
    src = TB.generator(tparams, torch.from_numpy(z), tcfg, features=torch.from_numpy(feats), **tkw)
    if sv0:
        np.testing.assert_allclose(got.numpy(), src.numpy(), atol=1e-4)
    else:
        assert np.abs(got.numpy() - src.numpy()).max() > 1e-3


def test_load_icgan_biggan_backbone_from_a_file(tmp_path):
    cfg = CFG64
    params = biggan_params(cfg, 54)
    tcfg = port_cfg(TB.BigGANConfig, cfg)
    path = tmp_path / "icgan.pth"
    torch.save({"state_dict": chip_smoke.biggan_state_dict(bridge.biggan_params_to_torch(params), tcfg)}, path)
    jg = JI.load_icgan(str(path), backbone="biggan", biggan_cfg=cfg)
    tg = TI.load_icgan(str(path), backbone="biggan", biggan_cfg=tcfg, device="cpu")
    z, feats, _ = _inputs(cfg, seed=55)
    np.testing.assert_allclose(_nhwc(tg(torch.from_numpy(z), torch.from_numpy(feats))),
                               np.asarray(jg(jnp.asarray(z), jnp.asarray(feats))), atol=1e-4)


def test_load_icgan_takes_a_generator_where_maua_tpu_raises():
    """maua_tpu evaluates `key or PRNGKey(0)`, which raises for a key on the StyleGAN2 backbone; the port
    draws the weights from the generator it is given."""
    with pytest.raises(ValueError, match="truth value"):
        JI.load_icgan(resolution=32, instance_dim=8, key=jax.random.PRNGKey(1))
    a = TI.load_icgan(resolution=32, instance_dim=8, gen=torch.Generator().manual_seed(1))
    b = TI.load_icgan(resolution=32, instance_dim=8, gen=torch.Generator().manual_seed(2))
    d = TI.load_icgan(resolution=32, instance_dim=8, device="cpu")
    assert a.cfg.c_dim == 8 and a.cfg.num_fp16_res == 0
    wa, wb, wd = (g.params["mapping"]["embed"]["w"] for g in (a, b, d))
    assert not torch.equal(wa, wb) and not torch.equal(wa, wd)
    z = torch.randn(2, a.cfg.z_dim, generator=torch.Generator().manual_seed(3))
    assert a(z, torch.randn(2, 8)).shape == (2, 3, 32, 32)
    bg = TI.load_icgan(backbone="biggan", biggan_cfg=port_cfg(TB.BigGANConfig, CFG64), gen=torch.Generator())
    assert bg(torch.randn(1, CFG64.dim_z), torch.randn(1, CFG64.feature_dim)).shape == (1, 3, 64, 64)


@pytest.fixture(scope="module")
def sg():
    cfg = JS.SG2Config(**SG_KW)
    params = random_jax_params(cfg, 56)
    tgen = TS.Generator(TS.SG2Config(**SG_KW), params=bridge.params_to_torch(params))
    return cfg, JS.Generator(cfg, params=params), tgen


def test_instance_features_and_generate_match(sg):
    cfg, jg, tg = sg
    from maua_tpu.gan.metrics import ResNetExtractor as JR
    from maua_tpu_torch.gan.metrics import ResNetExtractor as TR

    jx = JR(width=8, depth=(1, 1), feat_dim=16)
    tx = TR(params=bridge.resnet_extractor_params_to_torch(jx.params))
    imgs = np.tanh(np.random.RandomState(57).randn(2, 32, 32, 3).astype(np.float32))
    want = np.asarray(JI.instance_features(imgs, extractor=jx, dim=16))
    got = TI.instance_features(torch.from_numpy(imgs).permute(0, 3, 1, 2), extractor=tx, dim=16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-6)
    key = jax.random.PRNGKey(58)
    jimgs = np.asarray(JI.generate(jg, jnp.asarray(want), n_per_instance=3, truncation=0.7, key=key))
    z = torch.from_numpy(np.array(jax.random.normal(key, (6, cfg.z_dim))))
    timgs = TI.generate(tg, torch.from_numpy(want), n_per_instance=3, truncation=0.7, z=z)
    np.testing.assert_allclose(_nhwc(timgs), jimgs, atol=1e-4)
    assert TI.generate(tg, torch.from_numpy(want), n_per_instance=1).shape == (2, 3, 32, 32)


def test_icgan_clip_matches(sg, clip_pair):
    """3 Adam steps at lr 0.05 on JAX's draws of z and c, CLIP at 32 px."""
    cfg, jg, tg = sg
    jp, tp = clip_pair
    key = jax.random.PRNGKey(59)
    jimgs, jlat = JI.icgan_clip(jg, "a red fox", perceptor=jp, n_steps=3, batch=2, key=key, verbose=False)
    k1, k2 = jax.random.split(key)
    z = torch.from_numpy(np.array(jax.random.normal(k1, (2, cfg.z_dim))))
    c = torch.from_numpy(np.array(jax.random.normal(k2, (2, cfg.c_dim)) * 0.1))
    timgs, tlat = TI.icgan_clip(tg, "a red fox", perceptor=tp, n_steps=3, batch=2, z=z, c=c, verbose=False)
    for k in ("z", "c"):
        np.testing.assert_allclose(tlat[k].numpy(), np.asarray(jlat[k]), atol=1e-4)
        assert np.abs(tlat[k].numpy() - (z if k == "z" else c).numpy()).max() > 1e-2  # it moved
    np.testing.assert_allclose(_nhwc(timgs), np.asarray(jimgs), atol=1e-4)
