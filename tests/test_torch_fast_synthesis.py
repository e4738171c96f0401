"""The port's space-to-depth synthesis route (gan/fast_synthesis.py) and the
StyleGAN2 facade's dispatch to it, against maua_tpu.

Random parameters in maua_tpu's pytree (the helper of
test_torch_stylegan2.py, nonzero biases and noise strengths), f32 on the
CPU, where the epilogue takes its plain version. Tolerances: plans equal
to 1e-6 (both probe the same numpy ops; the port sums each tap as one
matrix product and probes one input channel at a time); images >= 55 dB
PSNR over the [-1, 1] range against maua_tpu's s2d route and the port's
plain synthesis (maua_tpu's own bar between its exact reformulations),
5e-3 absolute at most.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu import utility as jax_utility
from maua_tpu.gan import fast_synthesis as JF
from maua_tpu.gan import stylegan2 as J
from maua_tpu.gan import wrappers as JW
from maua_tpu_torch import bridge
from maua_tpu_torch.gan import fast_synthesis as TF
from maua_tpu_torch.gan import stylegan2 as T
from maua_tpu_torch.gan import wrappers as TW
from test_torch_stylegan2 import random_jax_params

# tests/test_fast_synthesis.py's configs: every block on s2d grids at 32^2 (64 channels), the top block only at
# 64^2 (128 channels, min_channels 48)
CONFIGS = {"32-all": (dict(img_resolution=32, channel_base=1024, channel_max=64, num_fp16_res=0), 9999),
           "64-top": (dict(img_resolution=64, channel_base=2048, channel_max=128, num_fp16_res=0), 48)}


def psnr(a, b):
    return 10 * np.log10(4.0 / max(float(np.mean((np.asarray(a, np.float64) - b) ** 2)), 1e-20))


def nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


@functools.lru_cache(maxsize=None)
def make_net(name):
    kw, mc = CONFIGS[name]
    cfg, tcfg = J.SG2Config(**kw), T.SG2Config(**kw)
    params = random_jax_params(cfg, 3)
    tparams = bridge.params_to_torch(params)
    ws = np.random.RandomState(4).randn(2, cfg.num_ws, cfg.w_dim).astype(np.float32)
    plan = TF.build_fast_plan(tparams, tcfg, mc)
    return cfg, tcfg, params, tparams, ws, plan


def test_space_to_depth_is_maua_tpus_packing():
    x = np.random.RandomState(0).rand(2, 8, 6, 3).astype(np.float32)  # NHWC
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    s = TF.space_to_depth(xt)
    np.testing.assert_array_equal(nhwc(s), np.asarray(JF.space_to_depth(jnp.asarray(x))))
    np.testing.assert_array_equal(TF.depth_to_space(s).numpy(), xt.numpy())
    assert s[0, (1 * 2 + 0) * 3 + 2, 1, 2] == xt[0, 2, 3, 4]  # phase (p, q) = (1, 0), channel 2, cell (1, 2)


def test_plan_equals_maua_tpus(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_utility, "WORKSPACE", str(tmp_path))  # maua_tpu caches its plans there
    kw = dict(img_resolution=32, channel_base=512, channel_max=32, num_fp16_res=0)
    cfg = J.SG2Config(**kw)
    params = random_jax_params(cfg, 5)
    want = JF.build_fast_plan(params, cfg, min_channels=9999)
    got = TF.build_fast_plan(bridge.params_to_torch(params), T.SG2Config(**kw), min_channels=9999)
    assert set(got["blocks"]) == set(want["blocks"]) == {8, 16, 32}
    for res, entry in want["blocks"].items():
        assert set(got["blocks"][res]) == set(entry)
        for name, k in entry.items():
            np.testing.assert_allclose(got["blocks"][res][name], k, rtol=1e-6, atol=1e-6, err_msg=f"b{res} {name}")
    # the kernel shapes: conv0 (3, 3, ci, 4 co), conv1 (3, 3, 4 co, 4 co) over the res/2 cell grid; b32: 32 -> 16
    assert got["blocks"][32]["k0"].shape == (3, 3, 32, 64) and got["blocks"][32]["k1"].shape == (3, 3, 64, 64)


@pytest.mark.parametrize("name,noise_mode", [("32-all", "const"), ("64-top", "none")])
def test_synthesis_fast_matches_maua_tpu_and_the_plain_route(name, noise_mode):
    cfg, tcfg, params, tparams, ws, plan = make_net(name)
    want = np.asarray(JF.synthesis_fast(params, plan, jnp.asarray(ws), cfg, noise_mode=noise_mode))
    dplan = TF.device_plan(plan, tcfg, "cpu")
    got = nhwc(TF.synthesis_fast(tparams, dplan, torch.from_numpy(ws), tcfg, noise_mode=noise_mode))
    plain = nhwc(T.synthesis(tparams, torch.from_numpy(ws), tcfg, noise_mode=noise_mode))
    assert got.shape == want.shape == (2, cfg.img_resolution, cfg.img_resolution, 3)
    assert psnr(got, want) >= 55 and psnr(got, plain) >= 55
    assert np.abs(got - want).max() < 5e-3 and np.abs(got - plain).max() < 5e-3


def test_synthesis_fast_takes_a_noise_dict():
    kw = CONFIGS["32-all"][0]
    cfg, tcfg = J.SG2Config(**kw), T.SG2Config(**kw)
    params = random_jax_params(cfg, 6)
    tparams = bridge.params_to_torch(params)
    rs = np.random.RandomState(7)
    ws = rs.randn(2, cfg.num_ws, cfg.w_dim).astype(np.float32)
    noises = {f"b{r}.conv{i}": rs.randn(2, r, r).astype(np.float32)
              for r in cfg.block_resolutions for i in ((1,) if r == 4 else (0, 1))}
    plan = TF.build_fast_plan(tparams, tcfg, 9999)
    want = np.asarray(JF.synthesis_fast(params, plan, jnp.asarray(ws), cfg, noise_mode="const",
                                        noises={k: jnp.asarray(v) for k, v in noises.items()}))
    tnoises = {k: torch.from_numpy(v) for k, v in noises.items()}
    dplan = TF.device_plan(plan, tcfg, "cpu")
    got = nhwc(TF.synthesis_fast(tparams, dplan, torch.from_numpy(ws), tcfg, noise_mode="const", noises=tnoises))
    plain = nhwc(T.synthesis(tparams, torch.from_numpy(ws), tcfg, noises=tnoises))
    assert psnr(got, want) >= 55 and psnr(got, plain) >= 55
    assert np.abs(got - want).max() < 5e-3


def test_motion_below_the_bound_matches():
    cfg, tcfg, params, tparams, ws, plan = make_net("64-top")
    assert TF.motion_layer_bound(plan, tcfg) == 8  # only b64 on s2d grids: the default layer 7 is in the head
    t, z, r = np.array([[0.05, -0.02], [0.0, 0.1]], np.float32), np.array([0.9, 1.15], np.float32), \
        np.array([10.0, -4.0], np.float32)
    want = np.asarray(JF.synthesis_fast(params, plan, jnp.asarray(ws), cfg, noise_mode="none", translation=t,
                                        zoom=z, rotation=r, rcfg=JW.RenderConfig()))
    motion = dict(translation=torch.from_numpy(t), zoom=torch.from_numpy(z), rotation=torch.from_numpy(r))
    dplan = TF.device_plan(plan, tcfg, "cpu")
    got = nhwc(TF.synthesis_fast(tparams, dplan, torch.from_numpy(ws), tcfg, noise_mode="none", **motion))
    plain = nhwc(TW.synthesize(tparams, torch.from_numpy(ws), tcfg, noise_mode="none", **motion))
    assert psnr(got, want) >= 55 and psnr(got, plain) >= 55
    assert np.abs(got - plain).max() < 5e-3


def test_the_facade_dispatches_as_maua_tpu_does(monkeypatch):
    """The s2d route for const noise without an output resize and with
    motion in the plain head; the plain route for random noise, a resize
    or motion inside the s2d tail. Images match maua_tpu's facade."""
    kw = CONFIGS["64-top"][0]
    cfg, tcfg = J.SG2Config(**kw), T.SG2Config(**kw)
    params = random_jax_params(cfg, 8)
    tparams = bridge.params_to_torch(params)
    ws = np.random.RandomState(9).randn(2, cfg.num_ws, cfg.w_dim).astype(np.float32)
    calls = []
    fast = TF.synthesis_fast
    monkeypatch.setattr(TF, "synthesis_fast", lambda *a, **k: calls.append(1) or fast(*a, **k))

    model = TW.StyleGAN2(cfg=tcfg, params=tparams, device="cpu")
    img = model.synthesizer(torch.from_numpy(ws))
    assert calls == [1] and set(model._fast_plan["blocks"]) == {64, 32}  # 32 and 64 channels, below 128
    assert TF.motion_layer_bound(model._fast_plan, tcfg) == 6
    jmodel = JW.StyleGAN2(cfg=cfg, params=params)
    jmodel._fast_plan, jmodel._fast_synth = model._fast_plan, jax.jit(
        lambda p, w, noises, nk, t, z, r: JF.synthesis_fast(p, model._fast_plan, w, cfg, noise_mode="const",
                                                            noises=noises, noise_key=nk, rcfg=jmodel.rcfg))
    assert psnr(nhwc(img), np.asarray(jmodel.synthesizer(jnp.asarray(ws)))) >= 55

    model.synthesizer(torch.from_numpy(ws), rotation=torch.tensor([3.0, 4.0]))  # layer 7 >= bound 6: plain
    model.synthesizer(torch.from_numpy(ws), noise_mode="random")
    resized = TW.StyleGAN2(cfg=tcfg, params=tparams, device="cpu", output_size=(48, 40))
    resized.synthesizer(torch.from_numpy(ws))
    assert calls == [1] and resized._fast_plan is None  # a plan is probed only for the s2d route
    model.synthesizer(torch.from_numpy(ws), noises={"b8.conv0": torch.zeros(2, 8, 8)})
    assert calls == [1, 1]


def test_quantized_plans_and_resnet_raise():
    # the int8 plan is ported (tests/test_torch_int8.py holds it against maua_tpu): a quantized plan converts,
    # its int8 kernels as int8 OIHW tensors and its scales as f32; only the resnet architecture still raises
    _, tcfg, _, tparams, ws, plan = make_net("64-top")
    fn, qplan = TF.make_fast_synthesis(tparams, tcfg, min_channels=48, int8=True)
    assert all({"q0", "q1", "s0", "s1", "a0", "a1"} <= set(e) for e in qplan["blocks"].values())
    dplan = TF.device_plan(qplan, tcfg, "cpu")
    for e, q in ((dplan["blocks"][r], qplan["blocks"][r]) for r in qplan["blocks"]):
        assert e["q0"].dtype == e["q1"].dtype == torch.int8 and e["s0"].dtype == e["a1"].dtype == torch.float32
        assert tuple(e["q0"].shape) == tuple(q["q0"].shape[i] for i in (3, 2, 0, 1))  # HWIO -> OIHW
    resnet = dataclasses.replace(tcfg, architecture="resnet")
    with pytest.raises(ValueError, match="resnet"):
        TF.synthesis_fast(tparams, TF.device_plan(plan, resnet, "cpu"), torch.from_numpy(ws), resnet)
    # maua_tpu's facade would take the s2d route and drop the skips: the port's keeps the plain one
    model = TW.StyleGAN2(cfg=resnet, params=T.init_params(resnet, torch.Generator().manual_seed(0)), device="cpu")
    res = tcfg.img_resolution
    assert model._get_fast() is False and model._fast_plan is None
    assert tuple(model.synthesizer(torch.from_numpy(ws)).shape) == (2, 3, res, res)
