"""The port's int8 (W8A8) plans against maua_tpu's, on the CPU: StyleGAN2's
s2d tail (`quantize_plan`, the quantized branch of `synthesis_fast`) and
StyleGAN3's trunk (`quantize_sg3`, `synthesis(int8_plan=)`), with the int8
conv's and the int8-out epilogue's plain versions.

Random parameters in maua_tpu's pytree (the helpers of
test_torch_stylegan2.py and test_torch_stylegan3.py) brought over by the
bridge: StyleGAN2 at 64^2 with the top block on cells (min_channels 48, as
tests/test_fast_synthesis.py builds it), StyleGAN3 at tests/test_stylegan3.py's
config. maua_tpu's results are computed once per module. Noise strengths
are zeroed where a plan is calibrated: the two packages draw the
calibration's random noise from different generators.

Tolerances: the int8 conv's sums equal maua_tpu's int32 exactly, and their
f32 conversion too; the activation quantization is equal code for code. The
int8-out epilogue against `_xla_epilogue(quant_out=True)`: codes within 1, at
most 1e-4 of them differing (a product rounded on the other side of a
half). The plans: amax and scales within 1e-5 relative (the calibration's
f32 sums in other orders), codes within 1, at most 1e-3 of them differing;
recalibration gives the first plan again. Images on maua_tpu's plan carried
across, noise off: >= 50 dB PSNR over the [-1, 1] range against maua_tpu's
int8 image, and maua_tpu's own bars against the f32 synthesis (30 dB
StyleGAN2, 28 dB StyleGAN3).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.gan import fast_synthesis as JF
from maua_tpu.gan import stylegan2 as J2
from maua_tpu.gan import stylegan3 as J3
from maua_tpu.kernels.epilogue import _xla_epilogue
from maua_tpu_torch import bridge
from maua_tpu_torch.gan import fast_synthesis as TF
from maua_tpu_torch.gan import stylegan2 as T2
from maua_tpu_torch.gan import stylegan3 as T3
from maua_tpu_torch.kernels import conv_i8 as CI
from maua_tpu_torch.kernels import epilogue as E
from test_torch_stylegan2 import random_jax_params as sg2_jax_params
from test_torch_stylegan3 import KW as SG3_KW
from test_torch_stylegan3 import random_jax_params as sg3_jax_params

SG2_KW = dict(img_resolution=64, channel_base=2048, channel_max=128, num_fp16_res=0)
QUANT_KEYS = ("q0", "q1", "s0", "s1", "a0", "a1")


def psnr(a, b):
    return 10 * np.log10(4.0 / max(float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)), 1e-20))


def nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


def assert_codes_close(got, want, share: float, what: str):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= share, f"{what}: max {d.max()}, share {(d > 0).mean()}"


@pytest.mark.parametrize("b,h,w,ci,co,k,extreme", [
    (2, 9, 11, 81, 51, 3, False),  # StyleGAN3 T's ragged trunk channels, odd sizes
    (1, 7, 5, 51, 24, 3, False),
    (2, 6, 8, 40, 70, 1, False),  # a 1x1 kernel
    (1, 4, 6, 512, 8, 3, True),  # all +-127 at the widest K: sums past 2^24
    (1, 36, 36, 51, 81, 3, False),  # StyleGAN3 T's L10 channels at its first width (W % 4 == 0, not % 16)
    (1, 12, 20, 323, 203, 3, False),  # its L7 channels, cut in size
])
def test_conv_i8_plain_equals_maua_tpus(b, h, w, ci, co, k, extreme):
    rs = np.random.RandomState(ci + co)
    if extreme:
        x = np.full((b, h, w, ci), 127, np.int8)
        wt = np.where(rs.rand(k, k, ci, co) < 0.5, -127, 127).astype(np.int8)
        wt[..., 0] = 127
    else:
        x = rs.randint(-127, 128, (b, h, w, ci)).astype(np.int8)
        wt = rs.randint(-127, 128, (k, k, ci, co)).astype(np.int8)
    want = JF._conv_i8(jnp.asarray(x), wt)
    xt, wtt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), torch.from_numpy(wt.transpose(3, 2, 0, 1).copy())
    got = CI.conv_i8_int32(xt, wtt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))
    np.testing.assert_array_equal(nhwc(CI.conv_i8(xt, wtt)), np.asarray(want.astype(jnp.float32)))
    if extreme:
        assert int(got.abs().max()) == k * k * ci * 127**2


@pytest.mark.parametrize("co,ci,k,wide,tile", [
    (3, 33, 3, False, 32),  # Co below one n8 tile
    (51, 20, 3, True, 64),
    (81, 51, 3, False, 128),
    (203, 323, 3, False, 256),  # one 256-wide tile pads 203 as much as two of 128
    (323, 64, 3, False, 128),  # three 128-wide tiles pad 323 less than two of 256
    (512, 40, 1, False, 256),
    (256, 128, 3, True, 128),  # 1 x 64 patches (StyleGAN2's b512 cells): 128 channels a block
])
def test_conv_i8_pack_weights_tiles_hold_their_slices(co, ci, k, wide, tile):
    """pack_weights' docstring: tile [n, c, tap, h, j, i] is w[T n + j, 32 c + 16 h + i, tap // k, tap % k] (zero
    past Co and Ci), T = tile_co(Co, wide), and the slice [n, c] is contiguous."""
    assert CI.tile_co(co, wide) == tile
    w = torch.from_numpy(np.random.RandomState(co + ci).randint(-127, 128, (co, ci, k, k)).astype(np.int8))
    wp = CI.pack_weights(w, wide)
    nco, nci = -(-co // tile), -(-ci // 32)
    assert wp.shape == (nco, nci, k * k, 2, tile, 16) and wp.dtype == torch.int8 and wp.is_contiguous()
    n, c, tap, h, j, i = np.meshgrid(*(np.arange(d) for d in wp.shape), indexing="ij")
    o, ic = tile * n + j, 32 * c + 16 * h + i
    inside = (o < co) & (ic < ci)
    want = np.zeros(wp.shape, np.int8)
    want[inside] = w.numpy()[o[inside], ic[inside], tap[inside] // k, tap[inside] % k]
    np.testing.assert_array_equal(wp.numpy(), want)
    stage = k * k * tile * 32  # the bytes of one (output tile, chunk) slice, the kernel's weight stage
    assert wp[nco - 1, nci - 1].numel() == stage and wp.view(-1)[-stage:].equal(wp[nco - 1, nci - 1].reshape(-1))


def test_conv_i8_wide_patches_follow_the_width():
    """1 x 64 patches where W % 64 == 0 or W >= 256: StyleGAN2's cells and StyleGAN3 T's 276 and wider; 8 x 8
    patches at StyleGAN3 T's 36 to 148."""
    assert [CI.wide_patches(w) for w in (256, 512, 64, 276, 532, 1044)] == [True] * 6
    assert [CI.wide_patches(w) for w in (36, 52, 84, 148, 17, 200)] == [False] * 6


def test_quantize_act_equals_maua_tpus():
    rs = np.random.RandomState(0)
    amax = np.float32([127.0, 2.5, 0.3, 40.0, 1e-6])
    x = (rs.randn(2, 6, 7, 5) * amax * 1.3).astype(np.float32)
    x[0, 0, :, 0] = np.arange(7) - 3.5  # ties at a scale of 1: half to even
    for dtype in (np.float32, jnp.bfloat16):
        xj = jnp.asarray(x).astype(dtype)
        want = np.asarray(JF._quantize_act(xj, amax))
        xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32)).transpose(0, 3, 1, 2).copy())
        if dtype is jnp.bfloat16:
            xt = xt.to(torch.bfloat16)
        got = TF._quantize_act(xt, torch.from_numpy(amax))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(nhwc(got), want)
    assert list(want[0, 0, :, 0]) == [-4, -2, -2, 0, 0, 2, 2]


@pytest.mark.parametrize("noise_b,groups,clamp", [(1, 4, 256.0), (2, 4, None), (2, 1, 1.5)])
def test_int8_epilogue_plain_matches_maua_tpus(noise_b, groups, clamp):
    rs = np.random.RandomState(groups + noise_b)
    b, h, w, c = 2, 12, 10, 64
    z = (rs.randn(b, h, w, c) * 40).astype(np.float32)
    post = (rs.rand(b, c) + 0.5).astype(np.float32)
    noise = rs.randn(noise_b, h, w, groups).astype(np.float32)
    bias = (rs.randn(c) * 0.1).astype(np.float32)
    pre = (rs.rand(b, c) * 3).astype(np.float32)
    want = np.asarray(_xla_epilogue(jnp.asarray(z), jnp.asarray(post), jnp.asarray(noise), jnp.asarray(bias), 0.2,
                                    float(np.sqrt(2.0)), clamp, jnp.asarray(pre), quant_out=True))
    assert want.dtype == np.int8
    t = lambda a: torch.from_numpy(a.transpose(0, 3, 1, 2).copy())
    got = E.modconv_epilogue(t(z), torch.from_numpy(post), t(noise), torch.from_numpy(bias), clamp=clamp,
                             pre_next=torch.from_numpy(pre), quant_out=True)
    assert got.dtype == torch.int8
    assert_codes_close(nhwc(got), want, 1e-4, "int8 epilogue")
    assert clamp is not None and clamp < 100 or np.abs(want).max() == 127  # the codes reach the clip


@pytest.fixture(scope="module")
def sg2():
    """maua_tpu's int8 plan of the 64^2 net (the port's float plan, which equals maua_tpu's, quantized by
    maua_tpu's quantize_plan on ws), its int8 image and the f32 image, noise off."""
    cfg, tcfg = J2.SG2Config(**SG2_KW), T2.SG2Config(**SG2_KW)
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.float32(0) if path[-1].key == "noise_strength" else leaf, sg2_jax_params(cfg, 3))
    tparams = bridge.params_to_torch(params)
    ws = np.random.RandomState(4).randn(4, cfg.num_ws, cfg.w_dim).astype(np.float32)
    plan = TF.build_fast_plan(tparams, tcfg, 48)
    jplan = JF.quantize_plan(params, copy.deepcopy(plan), cfg, ws=jnp.asarray(ws))
    jout = np.asarray(JF.synthesis_fast(params, jplan, jnp.asarray(ws), cfg, noise_mode="none"))
    return tcfg, tparams, ws, plan, jplan, jout


def test_quantize_plan_matches_maua_tpus(sg2):
    tcfg, tparams, ws, plan, jplan, _ = sg2
    tplan = TF.quantize_plan(tparams, copy.deepcopy(plan), tcfg, ws=torch.from_numpy(ws))
    assert set(tplan["blocks"]) == set(jplan["blocks"]) == {64}
    for res, want in jplan["blocks"].items():
        got = tplan["blocks"][res]
        for k in ("a0", "a1", "s0", "s1"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0, err_msg=f"b{res} {k}")
        for k in ("q0", "q1"):
            assert got[k].dtype == np.int8 and got[k].shape == want[k].shape
            assert_codes_close(got[k], want[k], 1e-3, f"b{res} {k}")
    first = copy.deepcopy(tplan)
    again = TF.quantize_plan(tparams, tplan, tcfg, ws=torch.from_numpy(ws))  # strips the quant keys first
    for res, e in first["blocks"].items():
        for k in QUANT_KEYS:
            np.testing.assert_array_equal(again["blocks"][res][k], e[k], err_msg=f"recalibrated b{res} {k}")


def test_synthesis_fast_on_maua_tpus_int8_plan(sg2):
    tcfg, tparams, ws, _, jplan, jout = sg2
    with torch.no_grad():
        got = nhwc(TF.synthesis_fast(tparams, TF.device_plan(jplan, tcfg, "cpu"), torch.from_numpy(ws), tcfg,
                                     noise_mode="none"))
        f32 = nhwc(T2.synthesis(tparams, torch.from_numpy(ws), tcfg, noise_mode="none"))
    assert got.shape == jout.shape == (4, 64, 64, 3)
    assert psnr(got, jout) >= 50 and psnr(got, f32) >= 30


def test_make_fast_synthesis_int8_runs_on_the_cpu(sg2):
    tcfg, tparams, ws, *_ = sg2
    fn, plan = TF.make_fast_synthesis(tparams, tcfg, min_channels=48, int8=True)
    assert all(set(QUANT_KEYS) <= set(e) for e in plan["blocks"].values())
    with torch.no_grad():
        img = fn(torch.from_numpy(ws[:2]), noise_mode="none")
    assert img.shape == (2, 3, 64, 64) and bool(torch.isfinite(img).all())


def test_quantize_plan_conditional_default_calibration():
    """ws=None on a conditional net draws one-hot labels beside the latents (the port's torch.Generator)."""
    cfg = T2.SG2Config(img_resolution=32, channel_base=1024, channel_max=64, num_fp16_res=0, c_dim=5, z_dim=32,
                       w_dim=32)
    params = T2.init_params(cfg, torch.Generator().manual_seed(2))
    plan = TF.quantize_plan(params, TF.build_fast_plan(params, cfg, min_channels=9999), cfg, batch=2)
    assert set(plan["blocks"]) == {8, 16, 32}
    assert all(set(QUANT_KEYS) <= set(e) for e in plan["blocks"].values())


@pytest.fixture(scope="module")
def sg3():
    """maua_tpu's int8 plan of the 64^2 StyleGAN3 calibrated on ws, its int8 image and the f32 image."""
    cfg, tcfg = J3.SG3Config(**SG3_KW), T3.SG3Config(**SG3_KW)
    params = sg3_jax_params(cfg, 1)
    ws = np.asarray(J3.mapping(params, jnp.asarray(np.random.RandomState(7).randn(2, 32).astype(np.float32)), cfg))
    jplan = J3.quantize_sg3(params, cfg, ws=jnp.asarray(ws))
    jout = np.asarray(J3.synthesis(params, jnp.asarray(ws), cfg, int8_plan=jplan))
    return tcfg, bridge.params_to_torch(params), ws, jplan, jout


def test_quantize_sg3_matches_maua_tpus(sg3):
    tcfg, tparams, ws, jplan, _ = sg3
    tplan = T3.quantize_sg3(tparams, tcfg, ws=torch.from_numpy(ws))
    assert set(tplan) == set(jplan) == {f"L{i}" for i in range(tcfg.num_layers - 1)}
    for name, want in jplan.items():
        got = tplan[name]
        for k in ("a", "s"):
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5, atol=0, err_msg=f"{name} {k}")
        assert got["q"].dtype == torch.int8
        assert_codes_close(got["q"].permute(2, 3, 1, 0).numpy(), want["q"], 1e-3, f"{name} q")


def test_sg3_synthesis_on_maua_tpus_int8_plan(sg3):
    tcfg, tparams, ws, jplan, jout = sg3
    with torch.no_grad():
        got = nhwc(T3.synthesis(tparams, torch.from_numpy(ws), tcfg, int8_plan=jplan))  # numpy, HWIO: carried
        f32 = nhwc(T3.synthesis(tparams, torch.from_numpy(ws), tcfg))
    assert got.shape == jout.shape == (2, 64, 64, 3)
    assert psnr(got, jout) >= 50 and psnr(got, f32) >= 28
