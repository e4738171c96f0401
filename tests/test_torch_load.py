"""The port's checkpoint loader (maua_tpu_torch/gan/load.py) against maua_tpu's.

Each check loads one synthetic checkpoint file, written in the real
on-disk format from seeded random parameters (no checkpoint is
downloaded), with both packages, and compares the parameter trees
through `bridge.params_to_torch` exactly: both read the same float32
values and only rename, squeeze and transpose them, and StyleGAN3's
input mixing weight is divided by sqrt(channels) with the same numpy
arithmetic. Frames rendered from a loaded file by both facades, in f32
on the CPU with explicit latents and noise, agree to roundoff: PSNR
>= 55 dB on the [-1, 1] images (the JAX package's bar between exact
reformulations) and at most one level on the uint8 frames.
"""

import dataclasses
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.gan import load as JL
from maua_tpu.gan import stylegan2 as J2
from maua_tpu.gan import stylegan3 as J3
from maua_tpu.gan import wrappers as JW
from maua_tpu_torch import bridge
from maua_tpu_torch.gan import load as TL
from maua_tpu_torch.gan import stylegan3 as T3
from maua_tpu_torch.gan import wrappers as TW
from test_nvidia_pkl import _ada_state_dict, _fake_nvidia_modules, _module_tree, _write_ada_pkl

SG2_CFG = J2.SG2Config(img_resolution=32, channel_base=1024, channel_max=64, num_fp16_res=0)
SG3_KW = dict(z_dim=32, w_dim=32, img_resolution=32, channel_base=1024, channel_max=64, num_layers=6,
              mapping_layers=2, margin_size=4)


def assert_same_tree(port, jax_params):
    """The port's tree equals maua_tpu's brought over by the bridge, leaf for leaf, exactly."""
    ref = bridge.params_to_torch(jax.device_get(jax_params))

    def walk(a, b, path):
        assert type(a) is type(b), path
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}[{i}]")
        else:
            assert a.dtype == torch.float32 and a.device.type == "cpu", path
            assert torch.equal(a, b), path

    walk(port, ref, "params")


def assert_same_config(port_cfg, jax_cfg):
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)


def psnr(a, b, peak=2.0):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return 10 * np.log10(peak**2 / max(mse, 1e-30))


# ------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def ada_pkl(tmp_path_factory):
    _, sd = _ada_state_dict(SG2_CFG, seed=2)
    path = str(tmp_path_factory.mktemp("ada") / "network-snapshot-000000.pkl")
    _write_ada_pkl(path, sd)
    return path, sd


def rosinality_state_dict(seed=0):
    """A rosinality StyleGAN2 generator state dict at 16^2 (blocks 4, 8, 16),
    64 channels, as tests/test_sg2_parity.py builds one."""
    rs = np.random.RandomState(seed)

    def rnd(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32))

    sd = {
        "input.input": rnd(1, 64, 4, 4),
        "conv1.conv.weight": rnd(1, 64, 64, 3, 3),
        "conv1.activate.bias": rnd(64),
        "conv1.conv.modulation.weight": rnd(64, 512),
        "conv1.conv.modulation.bias": rnd(64),
        "conv1.noise.weight": rnd(1),
        "to_rgb1.conv.weight": rnd(1, 3, 64, 1, 1),
        "to_rgb1.bias": rnd(1, 3, 1, 1),
        "to_rgb1.conv.modulation.weight": rnd(64, 512),
        "to_rgb1.conv.modulation.bias": rnd(64),
        "noises.noise_0": rnd(1, 1, 4, 4),
    }
    for i in range(1, 9):
        sd[f"style.{i}.weight"] = rnd(512, 512)
        sd[f"style.{i}.bias"] = rnd(512)
    n = 0
    for r in (8, 16):
        for _ in (0, 1):
            sd[f"convs.{n}.conv.weight"] = rnd(1, 64, 64, 3, 3)
            sd[f"convs.{n}.activate.bias"] = rnd(64)
            sd[f"convs.{n}.conv.modulation.weight"] = rnd(64, 512)
            sd[f"convs.{n}.conv.modulation.bias"] = rnd(64)
            sd[f"convs.{n}.noise.weight"] = rnd(1)
            sd[f"noises.noise_{n + 1}"] = rnd(1, 1, r, r)
            n += 1
    for m in range(2):
        sd[f"to_rgbs.{m}.conv.weight"] = rnd(1, 3, 64, 1, 1)
        sd[f"to_rgbs.{m}.bias"] = rnd(1, 3, 1, 1)
        sd[f"to_rgbs.{m}.conv.modulation.weight"] = rnd(64, 512)
        sd[f"to_rgbs.{m}.conv.modulation.bias"] = rnd(64)
    return sd, rnd(512)


def sg3_state_dict(cfg, seed):
    """An NVIDIA-named StyleGAN3 state dict from maua_tpu's init, as
    tests/test_stylegan3.py's round trip builds it (the input mixing weight
    stored raw, as NVIDIA stores it)."""
    src = J3.init_params(jax.random.PRNGKey(seed), cfg)
    _, _, _, _, sizes, channels = cfg.layer_plan()

    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    sd = {}
    for i in range(cfg.mapping_layers):
        sd[f"mapping.fc{i}.weight"] = t(np.asarray(src["mapping"][f"fc{i}"]["w"]).T)
        sd[f"mapping.fc{i}.bias"] = t(src["mapping"][f"fc{i}"]["b"])
    sd["mapping.w_avg"] = t(np.random.RandomState(seed).randn(cfg.w_dim) * 0.1)
    sd["synthesis.input.freqs"] = t(src["input"]["freqs"])
    sd["synthesis.input.phases"] = t(src["input"]["phases"])
    sd["synthesis.input.affine.weight"] = t(np.asarray(src["input"]["affine"]["w"]).T)
    sd["synthesis.input.affine.bias"] = t(src["input"]["affine"]["b"])
    w = np.asarray(src["input"]["weight"])
    sd["synthesis.input.weight"] = t(w[0, 0].T * np.sqrt(w.shape[-2]))
    sd["synthesis.input.transform"] = t(np.eye(3))
    for i, layer in enumerate(src["layers"]):
        name = f"synthesis.L{i}_{int(sizes[i + 1])}_{int(channels[i + 1])}"
        sd[f"{name}.weight"] = t(np.transpose(np.asarray(layer["weight"]), (3, 2, 0, 1)))
        sd[f"{name}.bias"] = t(np.random.RandomState(seed + i).randn(*layer["bias"].shape) * 0.1)
        sd[f"{name}.affine.weight"] = t(np.asarray(layer["affine"]["w"]).T)
        sd[f"{name}.affine.bias"] = t(layer["affine"]["b"])
        sd[f"{name}.magnitude_ema"] = t(np.float32(0.5 + 0.1 * i))
    return sd


@pytest.fixture(scope="module")
def sg3_pt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sg3") / "sg3.pt")
    torch.save(sg3_state_dict(J3.SG3Config(**SG3_KW), seed=5), path)
    return path


# ------------------------------------------------------------------ SG2
def test_ada_pkl_loads_as_maua_tpu_loads_it(ada_pkl):
    path, _ = ada_pkl
    assert "torch_utils" not in sys.modules and "dnnlib" not in sys.modules  # the reader must stub them
    params, cfg = TL.load_network(path)
    jparams, jcfg = JL.load_network(path)
    assert isinstance(cfg, TW.SG2Config)
    assert_same_config(cfg, jcfg)
    assert_same_tree(params, jparams)
    _, bf16 = TL.load_network(path, dtype="bfloat16")
    assert bf16.dtype == "bfloat16"


def test_nvidia_pkl_raw_walk_extracts_every_tensor(ada_pkl):
    path, sd = ada_pkl
    raw = TL._load_nvidia_pickle(path)
    assert set(raw) == set(sd)
    for k in sd:
        assert torch.equal(raw[k], torch.from_numpy(np.array(sd[k], np.float32))), k


def test_tf_style_pickle_does_not_crash(tmp_path):
    """An original TF StyleGAN2 pickle holds a dnnlib.tflib.Network whose
    state is a `variables` list: the stubs take it without raising."""
    mods = _fake_nvidia_modules()
    tflib = types.ModuleType("dnnlib.tflib")

    class Network:
        pass

    Network.__module__ = "dnnlib.tflib"
    Network.__qualname__ = "Network"
    tflib.Network = Network
    sys.modules.update(mods)
    sys.modules["dnnlib.tflib"] = tflib
    try:
        net = Network()
        net.__dict__.update({"name": "G_ema", "static_kwargs": {}, "variables": [("w", np.zeros(3))]})
        path = str(tmp_path / "tf.pkl")
        with open(path, "wb") as f:
            pickle.dump({"G_ema": net}, f, protocol=4)
    finally:
        for name in list(mods) + ["dnnlib.tflib"]:
            sys.modules.pop(name, None)
    assert isinstance(TL._load_nvidia_pickle(path), dict)


def _containers():
    """(id, object to torch.save): the .pt layouts load_torch_file takes."""
    _, sd = _ada_state_dict(SG2_CFG, seed=4)
    tensors = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}
    inference = {}
    for k, v in tensors.items():  # the ModuleList naming of inference nets: fcs.{i}, bs.{log2(res) - 2}
        k = k.replace("mapping.fc", "mapping.fcs.")
        for res in SG2_CFG.block_resolutions:
            k = k.replace(f"synthesis.b{res}.", f"synthesis.bs.{int(np.log2(res)) - 2}.")
        inference[k] = v
    ros, latent_avg = rosinality_state_dict()
    return {
        "rosinality-g_ema-latent_avg": {"g_ema": ros, "latent_avg": latent_avg},
        "ada-G_ema-module": {"G_ema": _module_tree(sd), "D": None},
        "ada-bare-state-dict": tensors,
        "ada-state_dict-key": {"state_dict": tensors},
        "inference-modulelist": inference,
    }


@pytest.mark.parametrize("kind", list(_containers()))
def test_pt_containers_load_as_maua_tpu_loads_them(tmp_path, kind):
    path = str(tmp_path / f"{kind}.pt")
    torch.save(_containers()[kind], path)
    params, cfg = TL.load_network(path)
    jparams, jcfg = JL.load_network(path)
    assert_same_config(cfg, jcfg)
    assert_same_tree(params, jparams)
    if kind.startswith("rosinality"):
        assert TL.is_rosinality(TL.load_torch_file(path)) and cfg.img_resolution == 16 and cfg.mapping_layers == 8
        np.testing.assert_array_equal(params["mapping"]["w_avg"].numpy(), _containers()[kind]["latent_avg"].numpy())


def test_sg2_facade_renders_a_loaded_pkl_like_maua_tpu(ada_pkl):
    """StyleGAN2(model_file=...) in both packages, f32 on the CPU, with
    explicit latents and per-frame noise: images and rendered frames."""
    path, _ = ada_pkl
    port = TW.StyleGAN2(model_file=path, dtype="float32", device="cpu")
    ref = JW.StyleGAN2(model_file=path, dtype="float32")
    assert port.params["synthesis"]["b32"]["conv1"]["weight"].device.type == "cpu"
    rs = np.random.RandomState(7)
    z = rs.randn(3, 512).astype(np.float32)
    ws = np.asarray(ref.mapper(z))
    np.testing.assert_allclose(port.mapper(torch.from_numpy(z)).numpy(), ws, rtol=1e-5, atol=1e-5)
    noise = {f"b{r}.conv{i}": rs.randn(3, r, r).astype(np.float32) for r in (8, 16, 32) for i in (0, 1)}
    img = port.synthesizer(torch.from_numpy(ws), noises={k: torch.from_numpy(v) for k, v in noise.items()})
    jimg = np.asarray(ref.synthesizer(jnp.asarray(ws), noises={k: jnp.asarray(v) for k, v in noise.items()}))
    assert psnr(img.permute(0, 2, 3, 1).numpy(), jimg) >= 55.0
    frames = np.stack(list(port.render(torch.from_numpy(ws), batch_size=2)))
    jframes = np.stack(list(ref.render(jnp.asarray(ws), batch_size=2)))
    assert frames.shape == jframes.shape == (3, 32, 32, 3)
    assert np.abs(frames.astype(int) - jframes.astype(int)).max() <= 1


# ------------------------------------------------------------------ SG3
def test_sg3_state_dict_loads_as_maua_tpu_loads_it(sg3_pt):
    sd = TL.load_torch_file(sg3_pt)
    assert TL.is_stylegan3(sd) and JL.is_stylegan3(sd)
    assert_same_config(TL.infer_sg3_config(sd), JL.infer_sg3_config(sd))
    assert_same_config(TL.infer_sg3_config(sd, "bfloat16"), JL.infer_sg3_config(sd, "bfloat16"))
    params, cfg = TL.load_network(sg3_pt)
    jparams, jcfg = JL.load_network(sg3_pt)
    assert isinstance(cfg, T3.SG3Config)
    assert_same_config(cfg, jcfg)
    assert_same_tree(params, jparams)
    # the raw (co, ci) mixing weight becomes OIHW with 1/sqrt(ci) baked in
    raw = sd["synthesis.input.weight"]
    np.testing.assert_allclose(params["input"]["weight"][:, :, 0, 0].numpy(), raw / np.sqrt(raw.shape[1]),
                               rtol=1e-7)


def test_sg3_facade_renders_a_loaded_file_like_maua_tpu(sg3_pt):
    port = T3.StyleGAN3(model_file=sg3_pt, device="cpu")
    ref = J3.StyleGAN3(model_file=sg3_pt)
    assert port.cfg.img_resolution == 32 and port.cfg.dtype == "float32"
    z = np.random.RandomState(8).randn(3, 32).astype(np.float32)
    ws = np.asarray(ref.mapper(z))
    np.testing.assert_allclose(port.mapper(torch.from_numpy(z)).numpy(), ws, rtol=0, atol=1e-5)
    img = port.synthesizer(torch.from_numpy(ws), translation=(0.1, -0.05), rotation=12.0)
    jimg = np.asarray(ref.synthesizer(jnp.asarray(ws), translation=(0.1, -0.05), rotation=12.0))
    assert psnr(img.permute(0, 2, 3, 1).numpy(), jimg) >= 55.0
    ro = np.array([0.0, 15.0, -30.0], np.float32)
    frames = np.stack(list(port.render(torch.from_numpy(ws), rotation=torch.from_numpy(ro), batch_size=2)))
    jframes = np.stack(list(ref.render(jnp.asarray(ws), rotation=ro, batch_size=2)))
    assert frames.shape == jframes.shape == (3, 32, 32, 3)
    assert np.abs(frames.astype(int) - jframes.astype(int)).max() <= 1


def test_sg3_facade_refuses_a_stylegan2_file(ada_pkl):
    with pytest.raises(ValueError, match="alias-free"):
        T3.StyleGAN3(model_file=ada_pkl[0], device="cpu")


def test_chip_smoke_writes_what_the_loaders_read(tmp_path):
    """chip_smoke.py's checkpoint writers (the full-width files of its
    gan_load phase) at 32^2: an ADA .pkl and a rosinality .pt of a
    StyleGAN2 and an NVIDIA-named StyleGAN3 .pt load back as their source
    in the port, exactly, and as the same trees in maua_tpu."""
    import chip_smoke

    from maua_tpu_torch.gan import stylegan2 as T2

    cfg = T2.SG2Config(img_resolution=32, channel_base=1024, channel_max=64, dtype="bfloat16")
    sg2 = T2.init_params(cfg, torch.Generator().manual_seed(0))
    cfg3 = T3.SG3Config(**SG3_KW)
    sg3, sg3_sd = chip_smoke.sg3_source_params(cfg3, device="cpu")
    paths = {k: str(tmp_path / k) for k in ("ada.pkl", "rosinality.pt", "sg3.pt")}
    chip_smoke.write_ada_pkl(paths["ada.pkl"], chip_smoke.ada_state_dict(sg2))
    assert "torch_utils" not in sys.modules
    torch.save({"g_ema": chip_smoke.rosinality_state_dict(sg2, cfg), "latent_avg": sg2["mapping"]["w_avg"]},
               paths["rosinality.pt"])
    torch.save(sg3_sd, paths["sg3.pt"])
    for name, src, want_cfg in (("ada.pkl", sg2, cfg), ("rosinality.pt", sg2, cfg), ("sg3.pt", sg3, cfg3)):
        params, got_cfg = TL.load_network(paths[name], dtype=want_cfg.dtype)
        assert got_cfg == want_cfg, name
        assert chip_smoke.assert_trees_equal(params, src, name) > 40
        assert_same_tree(params, JL.load_network(paths[name])[0])
