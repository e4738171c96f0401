"""The port's super-resolution models and Upscaler (maua_tpu_torch/super)
against maua_tpu's, on the CPU in f32.

Small configurations: RRDBNet with 2 blocks, nf 16, gc 8; SRVGG nf 16 with
4 convs; SwinIR embed 12, depths (2, 2), window 4; UpConv7 at its fixed
widths on 10^2 inputs; CARN with mid 16. Every parameter of maua_tpu's
pytree is drawn with numpy from a seed (biases and norms included) and
carried over by `bridge.super_params_to_torch`; inputs are numpy draws.

Tolerances, f32: model forwards and the Upscaler 1e-4 absolute (outputs
of magnitude ~1; the convolutions and matmuls sum in other orders); the
grouped dense block against the concat form 1e-5 (the same products,
regrouped); converters exact; the pixel shuffle and nearest upsampling
exact.
"""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from maua_tpu.ops import image as JImg
from maua_tpu.super import image as JI
from maua_tpu.super.models import rrdbnet as JR
from maua_tpu.super.models import swinir as JS
from maua_tpu.super.models import waifu as JW
from maua_tpu_torch import bridge, oom
from maua_tpu_torch.ops import image as TImg
from maua_tpu_torch.super import image as TI
from maua_tpu_torch.super.models import rrdbnet as TR
from maua_tpu_torch.super.models import swinir as TS
from maua_tpu_torch.super.models import waifu as TW

TOL = 1e-4
TINY_RRDB = dict(num_feat=16, num_block=2, num_grow_ch=8)
TINY_SRVGG = dict(num_feat=16, num_conv=4)
TINY_SWIN = dict(embed_dim=12, depths=(2, 2), num_heads=(2, 3), window_size=4, num_feat=8)
TINY_CARN = dict(mid=16)


def random_params(init, seed):
    """maua_tpu's pytree shapes filled with numpy draws: weights at
    1/sqrt(fan-in), biases and norm affines near their init."""
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: init(jax.random.PRNGKey(0)))

    def fill(path, leaf):
        names = [getattr(k, "key", None) for k in path]
        name = [n for n in names if n is not None][-1]
        a = rs.randn(*leaf.shape).astype(np.float32)
        if name == "w":
            fan_in = leaf.shape[0] if len(leaf.shape) == 2 else int(np.prod(leaf.shape[:3]))
            return a / np.float32(math.sqrt(fan_in))
        if name == "g":
            return np.float32(1) + a * np.float32(0.1)
        if name == "prelu":
            return np.float32(0.25) + a * np.float32(0.1)
        if name == "rpb":
            return a * np.float32(0.5)
        return a * np.float32(0.1)  # biases

    return jax.tree_util.tree_map_with_path(fill, shapes)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def trees_equal(got, want):
    """Exact equality of two of the port's trees (dicts, lists, tensors); the number of tensors."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        return sum(trees_equal(got[k], want[k]) for k in want)
    if isinstance(want, list):
        assert len(got) == len(want)
        return sum(trees_equal(g, w) for g, w in zip(got, want))
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    return 1


# ------------------------------------------------------------ forwards
@pytest.fixture(scope="module")
def rrdb():
    cfg = JR.RRDBConfig(**TINY_RRDB)
    return cfg, TR.RRDBConfig(**TINY_RRDB), random_params(lambda k: JR.init_params(k, cfg), 0)


def test_rrdb_forward_matches(rrdb):
    jcfg, tcfg, params = rrdb
    img = np.random.RandomState(1).rand(2, 12, 10, 3).astype(np.float32)
    ref = np.asarray(JR.forward(params, img, jcfg))
    out = nhwc(TR.forward(TR.prepare(bridge.super_params_to_torch(params), tcfg), nchw(img), tcfg))
    assert out.shape == ref.shape == (2, 48, 40, 3)
    assert np.abs(out - ref).max() <= TOL


def test_grouped_dense_block_equals_concat(rrdb):
    _, tcfg, params = rrdb
    blk = TR.prepare(bridge.super_params_to_torch(params), tcfg)["body"][0]["rdb2"]
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 16, 9, 11).astype(np.float32))
    torch.testing.assert_close(TR._rdb(blk, x), TR._rdb_concat(blk, x), rtol=1e-5, atol=1e-5)
    ref = JR._rdb_concat(params["body"][0]["rdb2"], jnp.asarray(nhwc(x)))
    assert np.abs(nhwc(TR._rdb_concat(blk, x)) - np.asarray(ref)).max() <= 1e-5


def test_srvgg_forward_matches():
    jcfg = JR.SRVGGConfig(**TINY_SRVGG)
    params = random_params(lambda k: JR.init_srvgg_params(k, jcfg), 4)
    img = np.random.RandomState(5).rand(2, 9, 7, 3).astype(np.float32)
    ref = np.asarray(JR.srvgg_forward(params, img, jcfg))
    out = nhwc(TR.srvgg_forward(bridge.super_params_to_torch(params), nchw(img), TR.SRVGGConfig(**TINY_SRVGG)))
    assert out.shape == ref.shape == (2, 36, 28, 3)
    assert np.abs(out - ref).max() <= TOL


@pytest.mark.parametrize("r", [2, 4])
def test_pixel_shuffle_and_nearest_up_match_jax(r):
    """maua_tpu's NHWC depth-to-space reshape order is F.pixel_shuffle's, and
    jax.image.resize "nearest" by an integer factor is F.interpolate's nearest."""
    x = np.random.RandomState(r).randn(2, 5, 6, 3 * r * r).astype(np.float32)
    b, h, w, _ = x.shape
    ref = x.reshape(b, h, w, 3, r, r).transpose(0, 1, 4, 2, 5, 3).reshape(b, h * r, w * r, 3)
    np.testing.assert_array_equal(nhwc(F.pixel_shuffle(nchw(x), r)), ref)
    up = np.asarray(jax.image.resize(jnp.asarray(x), (b, h * r, w * r, x.shape[-1]), "nearest"))
    np.testing.assert_array_equal(nhwc(F.interpolate(nchw(x), scale_factor=r, mode="nearest")), up)


@pytest.mark.parametrize("resi", ["1conv", "3conv"])
def test_swinir_forward_matches(resi):
    jcfg = JS.SwinIRConfig(**TINY_SWIN, resi_connection=resi)
    params = random_params(lambda k: JS.init_params(k, jcfg), 6)
    img = np.random.RandomState(7).rand(2, 8, 12, 3).astype(np.float32)
    ref = np.asarray(JS.forward(params, img, jcfg))
    out = nhwc(TS.forward(bridge.super_params_to_torch(params), nchw(img),
                          TS.SwinIRConfig(**TINY_SWIN, resi_connection=resi)))
    assert out.shape == ref.shape == (2, 32, 48, 3)
    assert np.abs(out - ref).max() <= TOL


def test_swinir_tables_match():
    for ws, shift, (h, w) in ((4, 2, (8, 12)), (8, 4, (16, 8)), (8, 4, (8, 8))):
        np.testing.assert_array_equal(TS._rel_pos_index(ws), JS._rel_pos_index(ws))
        np.testing.assert_array_equal(TS._shift_mask(h, w, ws, shift), JS._shift_mask(h, w, ws, shift))


def test_upconv7_forward_matches():
    params = random_params(JW.init_upconv7_params, 8)
    img = np.random.RandomState(9).rand(1, 10, 7, 3).astype(np.float32)
    ref = np.asarray(JW.upconv7_forward(params, img))
    out = nhwc(TW.upconv7_forward(bridge.super_params_to_torch(params), nchw(img)))
    assert out.shape == ref.shape == (1, 20, 14, 3)
    assert np.abs(out - ref).max() <= TOL


def test_carn_forward_matches():
    jcfg = JW.CARNConfig(**TINY_CARN)
    params = random_params(lambda k: JW.init_carn_params(k, jcfg), 10)
    img = np.random.RandomState(11).rand(2, 9, 10, 3).astype(np.float32)
    ref = np.asarray(JW.carn_forward(params, img, jcfg))
    out = nhwc(TW.carn_forward(bridge.super_params_to_torch(params), nchw(img), TW.CARNConfig(**TINY_CARN)))
    assert out.shape == ref.shape == (2, 18, 20, 3)
    assert np.abs(out - ref).max() <= TOL


# ---------------------------------------------------------- converters
def _port_random(kind, cfg, seed):
    return TI._INIT_FNS[kind](torch.Generator().manual_seed(seed), cfg)


def _jax_converted(tree):
    return bridge.super_params_to_torch(jax.tree_util.tree_map(np.asarray, tree))


def test_rrdb_and_srvgg_converters_match():
    """chip_smoke's state-dict writers, read back by both packages' converters:
    the port's tree exactly, and maua_tpu's tree bridged to the same."""
    cfg, scfg = TR.RRDBConfig(**TINY_RRDB), TR.SRVGGConfig(**TINY_SRVGG)
    src = _port_random("rrdb", cfg, 0)
    sd = chip_smoke.rrdb_state_dict(src)
    assert trees_equal(TR.params_from_torch(sd, cfg), src) == 2 + 2 * 3 * 5 * 2 + 5 * 2
    jax_tree = JR.params_from_torch({k: v.numpy() for k, v in sd.items()}, JR.RRDBConfig(**TINY_RRDB))
    trees_equal(_jax_converted(jax_tree), src)

    src = _port_random("srvgg", scfg, 1)
    sd = chip_smoke.srvgg_state_dict(src)
    trees_equal(TR.srvgg_params_from_torch(sd, scfg), src)
    jax_tree = JR.srvgg_params_from_torch({k: v.numpy() for k, v in sd.items()}, JR.SRVGGConfig(**TINY_SRVGG))
    trees_equal(_jax_converted(jax_tree), src)


@pytest.mark.parametrize("resi", ["1conv", "3conv"])
def test_swinir_converter_matches(resi):
    cfg = TS.SwinIRConfig(**TINY_SWIN, resi_connection=resi)
    src = _port_random("swinir", cfg, 2)
    sd = chip_smoke.swinir_state_dict(src, cfg)
    trees_equal(TS.params_from_torch(sd, cfg), src)
    jcfg = JS.SwinIRConfig(**TINY_SWIN, resi_connection=resi)
    trees_equal(_jax_converted(JS.params_from_torch({k: v.numpy() for k, v in sd.items()}, jcfg)), src)


def test_upconv7_converters_match(tmp_path):
    """The waifu2x JSON and the torch-port state dict: the transposed conv's
    (in, out, kh, kw) weight is taken as it is, unflipped, and maua_tpu's
    (kh, kw, in, out) bridges back to it."""
    import json

    src = _port_random("upconv7", None, 3)
    path = tmp_path / "noise0_scale2.0x_model.json"
    path.write_text(json.dumps(chip_smoke.upconv7_json(src)))
    trees_equal(TW.upconv7_params_from_json(str(path)), src)
    trees_equal(_jax_converted(JW.upconv7_params_from_json(str(path))), src)
    sd = {}
    for i in range(6):
        chip_smoke._put_conv(sd, f"model.{2 * i}", src[f"conv{i}"])
    chip_smoke._put_conv(sd, "model.12", src["deconv"])
    trees_equal(TW.upconv7_params_from_torch(sd), src)
    trees_equal(_jax_converted(JW.upconv7_params_from_torch({k: v.numpy() for k, v in sd.items()})), src)


def test_registry_names_equal_jax():
    assert TI.MODEL_NAMES == JI.MODEL_NAMES
    assert TI._CHECKPOINT_FILES == JI._CHECKPOINT_FILES
    for name in TI.MODEL_NAMES:
        (tkind, tcfg), (jkind, jcfg) = TI.MODEL_REGISTRY[name], JI.MODEL_REGISTRY[name]
        assert tkind == jkind
        if jcfg is not None:
            assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg), name


# ------------------------------------------------------------- Upscaler
@pytest.fixture
def tiny_registry(monkeypatch, rrdb):
    jcfg, tcfg, _ = rrdb
    swin = dict(TINY_SWIN, resi_connection="1conv")
    monkeypatch.setitem(JI.MODEL_REGISTRY, "tiny", ("rrdb", jcfg))
    monkeypatch.setitem(TI.MODEL_REGISTRY, "tiny", ("rrdb", tcfg))
    monkeypatch.setitem(JI.MODEL_REGISTRY, "tiny-swin", ("swinir", JS.SwinIRConfig(**swin)))
    monkeypatch.setitem(TI.MODEL_REGISTRY, "tiny-swin", ("swinir", TS.SwinIRConfig(**swin)))


def _pair(monkeypatch, name, params):
    """maua_tpu's Upscaler and the port's with the same parameters (maua_tpu's
    handed them in place of its random init, which is slow op by op)."""
    monkeypatch.setitem(JI._INIT_FNS, JI.MODEL_REGISTRY[name][0], lambda key, cfg: params)
    return JI.Upscaler(name), TI.Upscaler(name, device="cpu", params=bridge.super_params_to_torch(params))


@pytest.mark.parametrize("tile", [0, 8])
def test_upscaler_matches_jax(tiny_registry, rrdb, tile, monkeypatch):
    jup, tup = _pair(monkeypatch, "tiny", rrdb[2])
    jup.tile = tup.tile = tile
    img = np.random.RandomState(12).rand(1, 12, 12, 3).astype(np.float32)
    ref = np.asarray(jup(img))
    out = tup(img)
    assert out.shape == ref.shape == (1, 48, 48, 3) and out.dtype == torch.float32
    assert np.abs(out.numpy() - ref).max() <= TOL
    assert float(out.min()) >= 0 and float(out.max()) <= 1


@pytest.mark.parametrize("size", [(11, 13), (8, 7)])
def test_upscaler_pads_swinir_to_its_window(tiny_registry, size, monkeypatch):
    params = random_params(lambda k: JS.init_params(k, JI.MODEL_REGISTRY["tiny-swin"][1]), 13)
    jup, tup = _pair(monkeypatch, "tiny-swin", params)
    img = np.random.RandomState(14).rand(1, *size, 3).astype(np.float32)
    ref = np.asarray(jup(img))
    out = tup(torch.from_numpy(img)).numpy()
    assert out.shape == ref.shape == (1, 4 * size[0], 4 * size[1], 3)
    assert np.abs(out - ref).max() <= TOL



def test_upscaler_tiles_land_at_their_destitch_offsets(tiny_registry, rrdb, monkeypatch):
    """Tiled, a model that commutes with cropping (nearest x4) gives the whole
    image's result: each upscaled tile goes back at its destitch offset times
    the scale. maua_tpu recomputes the grid at the upscaled size, which puts
    tiles a pixel off here (ROADMAP C8), so JAX is not compared."""
    tup = TI.Upscaler("tiny", device="cpu", params=bridge.super_params_to_torch(rrdb[2]), tile=8)
    monkeypatch.setattr(tup, "_run", lambda x: x.repeat_interleave(4, 1).repeat_interleave(4, 2))
    img = torch.from_numpy(np.random.RandomState(16).rand(1, 21, 21, 3).astype(np.float32))
    ys = TImg._tile_grid(21, 21, 8, 1)[0]  # [0, 6, 13]: maua_tpu's grid at 84^2 is [0, 26, 52], not [0, 24, 52]
    assert len(ys) == 3 and list(JImg._tile_grid(84, 84, 32, 1)[0]) != list(4 * ys)
    torch.testing.assert_close(tup(img), img.repeat_interleave(4, 1).repeat_interleave(4, 2), rtol=0, atol=1e-6)

def test_is_oom_error_recognises_only_running_out_of_memory():
    assert oom.is_oom_error(torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"))
    assert oom.is_oom_error(RuntimeError("CUDA out of memory. Tried to allocate 20.00 MiB"))
    assert oom.is_oom_error(MemoryError())
    for msg in ("CUDNN_STATUS_INTERNAL_ERROR", "RESOURCE_EXHAUSTED", "CUDA error: an illegal memory access",
                "out of memory"):
        assert not oom.is_oom_error(RuntimeError(msg)), msg
    with pytest.raises(ValueError):
        oom.run_with_oom_fallback([("a", lambda: (_ for _ in ()).throw(ValueError("no")))])


def test_upscaler_oom_ladder(tiny_registry, rrdb, monkeypatch, capsys):
    """Out of memory, the Upscaler takes smaller tiles, and last a lanczos
    upscale without the model; a different error is raised at once."""
    tup = TI.Upscaler("tiny", device="cpu", params=bridge.super_params_to_torch(rrdb[2]))
    img = torch.from_numpy(np.random.RandomState(15).rand(1, 256, 256, 3).astype(np.float32))
    real_run = tup._run
    calls = []

    def failing(n, error=torch.cuda.OutOfMemoryError):
        def run(x):
            calls.append(tuple(x.shape))
            if len(calls) <= n:
                raise error("CUDA out of memory. Tried to allocate 1.00 GiB")
            return real_run(x)

        return run

    monkeypatch.setattr(tup, "_run", failing(2))
    tup(img)
    # the whole image, then tiles of 128 (9 of them), then of 64
    assert calls[0] == (1, 256, 256, 3) and calls[1] == (9, 128, 128, 3) and calls[2][1:3] == (64, 64)
    assert capsys.readouterr().out.count("device OOM") == 2

    calls.clear()
    monkeypatch.setattr(tup, "_run", failing(10))
    out = tup(img)
    assert len(calls) == 3  # full, 128, 64: then the lanczos rung
    torch.testing.assert_close(out, torch.clamp(TImg.resample(img, (1024, 1024)), 0, 1), rtol=0, atol=0)

    monkeypatch.setattr(tup, "_run", lambda x: (_ for _ in ()).throw(RuntimeError("CUDNN_STATUS_BAD_PARAM")))
    with pytest.raises(RuntimeError, match="CUDNN"):
        tup(img)


def test_not_ported_entries_raise():
    with pytest.raises(NotImplementedError, match="diffusion/processors/latent.py"):
        TI.Upscaler("latent-diffusion", device="cpu")
    with pytest.raises(NotImplementedError, match="parallel"):
        TI.upscale_bulk_sharded([np.zeros((1, 8, 8, 3), np.float32)])
    with pytest.raises(ValueError):
        TI.Upscaler("no-such-model", device="cpu")


def test_upscaler_needs_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TI.Upscaler("CARN")


def test_checkpoint_cascade(tiny_registry, monkeypatch, tmp_path, capsys):
    """A basicsr .pth in MODELZOO (params_ema container) loads exactly; an
    unreadable one prints a warning and the model runs its random weights."""
    from maua_tpu_torch import utility

    cfg = TI.MODEL_REGISTRY["tiny"][1]
    src = _port_random("rrdb", cfg, 5)
    monkeypatch.setattr(utility, "MODELZOO", str(tmp_path))
    monkeypatch.setitem(TI._CHECKPOINT_FILES, "tiny", "tiny.pth")
    torch.save({"params_ema": chip_smoke.rrdb_state_dict(src)}, tmp_path / "tiny.pth")
    trees_equal(TI.Upscaler("tiny", device="cpu").params, src)
    (tmp_path / "tiny.pth").write_bytes(b"not a checkpoint")
    up = TI.Upscaler("tiny", device="cpu", seed=3)
    assert "checkpoint load failed" in capsys.readouterr().out
    trees_equal(up.params, _port_random("rrdb", cfg, 3))


def test_upscale_entry_points(tiny_registry, tmp_path, monkeypatch):
    from PIL import Image

    from maua_tpu_torch.__main__ import main

    rs = np.random.RandomState(16)
    path = str(tmp_path / "in.png")
    Image.fromarray((rs.rand(10, 12, 3) * 255).astype(np.uint8)).save(path)
    up = TI.Upscaler("tiny", device="cpu")
    (a,) = list(TI.upscale([path], model=up))
    b = TI.upscale_image(path, model=up)
    assert a.shape == (1, 40, 48, 3)
    np.testing.assert_array_equal(a, b.numpy())
    main(["super", "image", path, "--model_name", "CARN", "--out_dir", str(tmp_path / "out"), "--device", "cpu",
          "--postdownsample", "2"])
    assert Image.open(tmp_path / "out" / "in_CARN.png").size == (12, 10)
    results = TI.compare(path, model_names=["tiny", "CARN"], out_dir=str(tmp_path / "cmp"), device="cpu")
    assert sorted(os.listdir(tmp_path / "cmp")) == ["CARN.png", "tiny.png"]
    assert results["CARN"].shape == (1, 20, 24, 3)
