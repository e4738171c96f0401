"""The port's StyleGAN3 generator and facade against maua_tpu's.

The 64^2 config of tests/test_stylegan3.py, random parameters in the JAX
package's pytree (every leaf drawn with numpy, the input affine and the
magnitude EMAs included, so every term is exercised) brought over by the
bridge. Everything is f32 on the CPU, where the filtered nonlinearity
takes its plain version and JAX its XLA chain. Tolerance: 1e-5 absolute
on activations and images of magnitude ~1 (f32 summation order; measured
~1e-6 here); rendered uint8 frames may differ by one level where a value
sits on a rounding edge.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.gan import stylegan3 as J
from maua_tpu_torch import bridge
from maua_tpu_torch.gan import stylegan3 as T

KW = dict(z_dim=32, w_dim=32, img_resolution=64, channel_base=1024, channel_max=64, num_layers=6,
          mapping_layers=2, margin_size=4)


def random_jax_params(cfg, seed):
    """Random SG3 parameters in maua_tpu's pytree: the shapes of
    `init_params` (traced abstractly, nothing drawn by JAX) filled from
    numpy."""
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: J.init_params(jax.random.PRNGKey(0), cfg))

    def fill(path, leaf):
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        name = keys[-1]
        if name == "magnitude_ema":
            return np.float32(rs.uniform(0.5, 1.5))
        if name == "transform":
            return np.eye(3, dtype=np.float32)
        if name == "phases":
            return (rs.rand(*leaf.shape) - 0.5).astype(np.float32)
        a = rs.randn(*leaf.shape).astype(np.float32)
        if keys[:2] == ["input", "affine"]:
            # near NVIDIA's init (zero weight, bias (1, 0, 0, 0)): a small rotation and
            # translation per sample; large ones make the Fourier phases, and so the
            # f32 roundoff of sin(), grow with them
            return a * np.float32(0.05) + (np.float32([1, 0, 0, 0]) if name == "b" else np.float32(0))
        if name in ("b", "bias", "w_avg"):
            return a * np.float32(0.1) + np.float32(keys[-2] == "affine")
        if keys[0] == "mapping" and name == "w":
            return a / np.float32(0.01)
        if keys[0] == "input" and name == "weight":
            return a / np.float32(np.sqrt(leaf.shape[-1]))
        return a

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def net():
    cfg = J.SG3Config(**KW)
    params = random_jax_params(cfg, 1)
    z = np.random.RandomState(0).randn(3, 32).astype(np.float32)
    ws = np.array(J.mapping(params, jnp.asarray(z), cfg))
    return cfg, T.SG3Config(**KW), params, bridge.params_to_torch(params), z, ws


def nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("kw", [KW, {}], ids=["64px", "default-1024px"])
def test_layer_plan_matches_jax(kw):
    for a, b in zip(T.SG3Config(**kw).layer_plan(), J.SG3Config(**kw).layer_plan()):
        np.testing.assert_array_equal(a, b)
    assert T.SG3Config(**kw).num_ws == J.SG3Config(**kw).num_ws


def test_resample_plan_matches_jax_filters():
    """The per-layer up/down factors and kaiser filters, as JAX's synthesis derives them."""
    cfg = J.SG3Config()
    cutoffs, _, srates, half_widths, sizes, _ = cfg.layer_plan()
    plan = T.resample_plan(T.SG3Config())
    assert len(plan) == cfg.num_layers - 1 == 13
    assert [p[0] for p in plan] == [2, 4, 2, 4, 4, 2, 4, 2, 4, 4, 2, 2, 2] and {p[1] for p in plan} == {2}
    for i, (up, down, up_f, down_f, out_size) in enumerate(plan):
        tmp = max(srates[i], srates[i + 1]) * 2
        np.testing.assert_array_equal(up_f, J._lowpass(cfg.filter_size * up, cutoffs[i], half_widths[i], tmp))
        np.testing.assert_array_equal(down_f, J._lowpass(cfg.filter_size * down, cutoffs[i + 1],
                                                         half_widths[i + 1], tmp))
        assert out_size == sizes[i + 1]


def test_bridge_round_trips_the_sg3_pytree(net):
    _, _, params, tparams, _, _ = net
    assert isinstance(tparams["layers"], list) and len(tparams["layers"]) == KW["num_layers"]
    assert tuple(tparams["input"]["weight"].shape) == (params["input"]["weight"].shape[-1],) * 2 + (1, 1)
    ci, co = params["layers"][2]["weight"].shape[2:]
    assert tuple(tparams["layers"][2]["weight"].shape) == (co, ci, 3, 3)
    assert tuple(tparams["layers"][-1]["weight"].shape) == (3, params["layers"][-1]["weight"].shape[2], 1, 1)
    assert tuple(tparams["mapping"]["fc0"]["w"].shape) == (KW["w_dim"], KW["z_dim"])
    np.testing.assert_array_equal(tparams["input"]["freqs"].numpy(), params["input"]["freqs"])
    back = bridge.params_to_jax(tparams)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_back = dict((jax.tree_util.keystr(k), v) for k, v in jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(flat_back)
    for k, v in flat:
        np.testing.assert_array_equal(np.asarray(v), flat_back[jax.tree_util.keystr(k)])


def test_mapping_matches_jax(net):
    cfg, tcfg, params, tparams, z, ws = net
    np.testing.assert_allclose(T.mapping(tparams, torch.from_numpy(z), tcfg).numpy(), ws, rtol=0, atol=1e-5)
    ref = np.asarray(J.mapping(params, jnp.asarray(z), cfg, 0.5))
    np.testing.assert_allclose(T.mapping(tparams, torch.from_numpy(z), tcfg, 0.5).numpy(), ref, rtol=0, atol=1e-5)


def _transforms():
    per_sample = np.stack([np.array(J.make_transform_mat((0.1 * i, -0.05), 20.0 * i)) for i in range(3)])
    return {"none": None, "shared": np.array(J.make_transform_mat((0.25, 0.1), 30.0)), "per-sample": per_sample}


@pytest.mark.parametrize("kind", ["none", "shared", "per-sample"])
def test_synthesis_input_matches_jax(net, kind):
    cfg, tcfg, params, tparams, _, ws = net
    _, _, srates, _, sizes, _ = cfg.layer_plan()
    m = _transforms()[kind]
    ref = np.asarray(J.synthesis_input(params, jnp.asarray(ws[:, 0]), cfg, int(sizes[0]), float(srates[0]),
                                       None if m is None else jnp.asarray(m)))
    out = T.synthesis_input(tparams, torch.from_numpy(ws[:, 0]), tcfg, int(sizes[0]), float(srates[0]),
                            None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(nhwc(out), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["none", "shared", "per-sample"])
def test_synthesis_matches_jax(net, kind):
    cfg, tcfg, params, tparams, _, ws = net
    m = _transforms()[kind]
    ref = np.asarray(J.synthesis(params, jnp.asarray(ws), cfg, None if m is None else jnp.asarray(m)))
    out = T.synthesis(tparams, torch.from_numpy(ws), tcfg, None if m is None else torch.from_numpy(m))
    assert out.dtype == torch.float32 and tuple(out.shape) == (3, 3, 64, 64)
    np.testing.assert_allclose(nhwc(out), ref, rtol=0, atol=1e-5)


def test_make_transform_mat_matches_jax():
    for t, a in [((0.0, 0.0), 0.0), ((0.25, -0.1), 37.0), ((1.5, 2.0), -90.0)]:
        np.testing.assert_array_equal(T.make_transform_mat(t, a).numpy(), np.asarray(J.make_transform_mat(t, a)))


def test_bf16_trunk_stays_within_the_parity_bar(net):
    """The bf16 trunk (the card's configuration) against JAX's f32 net:
    frame PSNR >= 40 dB on the [-1, 1] range."""
    cfg, tcfg, params, tparams, _, ws = net
    ref = np.asarray(J.synthesis(params, jnp.asarray(ws), cfg))
    out = nhwc(T.synthesis(tparams, torch.from_numpy(ws), dataclasses.replace(tcfg, dtype="bfloat16")))
    mse = float(np.mean((np.clip(out, -1, 1) - np.clip(ref, -1, 1)) ** 2))
    assert 10 * np.log10(4.0 / max(mse, 1e-20)) >= 40.0


def test_facade_render_matches_jax(net):
    """Per-frame translation and rotation through both facades' render:
    4 frames in batches of 3 (the port pads the tail batch; JAX does not)."""
    cfg, tcfg, params, tparams, _, ws = net
    lat = np.concatenate([ws, ws[:1]])
    tr = np.array([[0.0, 0.0], [0.1, 0.0], [0.0, -0.2], [0.3, 0.1]], np.float32)
    ro = np.array([0.0, 15.0, -30.0, 90.0], np.float32)
    jax_frames = np.stack(list(J.StyleGAN3(cfg, params=params).render(jnp.asarray(lat), tr, ro, batch_size=2)))
    model = T.StyleGAN3(cfg=tcfg, params=tparams, device="cpu")
    frames = np.stack(list(model.render(torch.from_numpy(lat), torch.from_numpy(tr), torch.from_numpy(ro),
                                        batch_size=3, noises=None, zoom=None)))
    assert frames.shape == jax_frames.shape == (4, 64, 64, 3) and frames.dtype == np.uint8
    diff = np.abs(frames.astype(int) - jax_frames.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    assert not np.array_equal(frames[0], frames[-1])


def test_facade_mapper_and_call(net):
    cfg, tcfg, params, tparams, z, ws = net
    model = T.StyleGAN3(cfg=tcfg, params=tparams, device="cpu")
    np.testing.assert_allclose(model.mapper(latent_z=torch.from_numpy(z)).numpy(), ws, rtol=0, atol=1e-5)
    ref = np.asarray(J.StyleGAN3(cfg, params=params)(z[:1], translation=(0.25, 0.0), rotation=10.0))
    np.testing.assert_allclose(nhwc(model(torch.from_numpy(z[:1]), translation=(0.25, 0.0), rotation=10.0)), ref,
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(model.get_z_latents("1-3").numpy(), J.StyleGAN3(cfg, params=params)
                                  .get_z_latents("1-3"))


def test_facade_render_halves_the_batch_on_oom(net, monkeypatch, capsys):
    _, tcfg, _, tparams, _, ws = net
    model = T.StyleGAN3(cfg=tcfg, params=tparams, device="cpu")
    real, sizes = T.synthesis, []

    def flaky(params, latents, cfg, transform=None):
        sizes.append(latents.shape[0])
        if latents.shape[0] > 2:
            raise torch.OutOfMemoryError("out of memory")
        return real(params, latents, cfg, transform)

    monkeypatch.setattr(T, "synthesis", flaky)
    frames = list(model.render(torch.from_numpy(ws), batch_size=4))
    assert len(frames) == 3 and sizes == [4, 2, 2]
    assert "batch_size=2" in capsys.readouterr().out


def test_facade_raises_on_what_is_not_ported(net):
    _, tcfg, _, tparams, _, _ = net
    with pytest.raises(FileNotFoundError):  # checkpoints load now (tests/test_torch_load.py): a missing one raises
        T.StyleGAN3(model_file="net.pkl", device="cpu")
    # output resizing is ported now (its parity test: tests/test_torch_av_extras.py): frames come at the size
    model = T.StyleGAN3(cfg=tcfg, params=tparams, output_size=(32, 24), device="cpu")
    ws = model.mapper(model.get_z_latents("0"))
    assert [f.shape for f in model.render(ws)] == [(24, 32, 3)]
    T.StyleGAN3(cfg=tcfg, params=tparams, output_size=(64, 64), device="cpu")


def test_random_init_renders_on_the_cpu():
    model = T.StyleGAN3(cfg=T.SG3Config(**KW), device="cpu", seed=3)
    assert isinstance(model.params["layers"], list)
    img = model(model.get_z_latents("0-2"))
    assert tuple(img.shape) == (2, 3, 64, 64) and torch.isfinite(img).all() and img.std() > 0
