"""The port's StyleGAN2 generator, wrappers and warps against maua_tpu.

A 64^2 net with narrow channels, random parameters in the JAX package's
pytree brought over by the bridge, explicit noise maps. Everything is f32 on the CPU, where the
synthesis layers take the epilogue's plain version. Tolerances: 1e-4
absolute on images of magnitude ~20 (f32 conv summation order), 1e-5 on
the warps and noise maps, 5e-5 on the bicubic resize (its weights are
built in numpy here and by XLA there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.gan import stylegan2 as J
from maua_tpu.gan import wrappers as JW
from maua_tpu.ops import warp as JWarp
from maua_tpu_torch import bridge
from maua_tpu_torch.gan import stylegan2 as T
from maua_tpu_torch.gan import wrappers as TW
from maua_tpu_torch.ops import warp as TWarp

KW = dict(img_resolution=64, channel_base=256, channel_max=32, z_dim=32, w_dim=32, mapping_layers=2)


def random_jax_params(cfg, seed):
    """Random SG2 parameters in maua_tpu's pytree: the shapes of
    `init_params` (traced abstractly, nothing compiled or drawn by JAX)
    filled from numpy, with nonzero biases, w_avg and noise strengths so
    that every term of a layer is exercised."""
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: J.init_params(jax.random.PRNGKey(0), cfg))

    def fill(path, leaf):
        keys = [p.key for p in path]
        if keys[-1] == "noise_strength":
            return np.float32(rs.uniform(0.5, 1.5))
        a = rs.randn(*leaf.shape).astype(np.float32)
        if keys[-1] in ("b", "bias", "w_avg"):
            return a * np.float32(0.1) + np.float32(keys[-2] == "affine")
        if keys[0] == "mapping" and keys[-1] == "w":
            return a / np.float32(cfg.mapping_lr_multiplier)
        return a

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def net():
    cfg = J.SG2Config(**KW)
    params = random_jax_params(cfg, 1)
    z = np.random.RandomState(0).randn(3, 32).astype(np.float32)
    ws = np.array(J.mapping(params, jnp.asarray(z), cfg))
    return cfg, T.SG2Config(**KW), params, bridge.params_to_torch(params), z, ws


def nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


def test_bridge_round_trip(net):
    _, _, params, tparams, _, _ = net
    back = bridge.params_to_jax(tparams)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_back = dict((jax.tree_util.keystr(k), v) for k, v in jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(flat_back)
    for k, v in flat:
        np.testing.assert_array_equal(np.asarray(v), flat_back[jax.tree_util.keystr(k)])


def test_bridge_layouts(net):
    cfg, _, params, tparams, _, _ = net
    b8 = tparams["synthesis"]["b8"]
    assert tuple(b8["conv0"]["weight"].shape) == (cfg.channels(8), cfg.channels(4), 3, 3)
    assert tuple(b8["torgb"]["weight"].shape) == (3, cfg.channels(8), 1, 1)
    assert tuple(tparams["synthesis"]["b4"]["const"].shape) == (cfg.channels(4), 4, 4)
    assert tuple(tparams["mapping"]["fc0"]["w"].shape) == (cfg.w_dim, cfg.z_dim)
    np.testing.assert_array_equal(b8["conv0"]["noise_const"].numpy(), params["synthesis"]["b8"]["conv0"]["noise_const"])


def test_torch_init_params_matches_jax_tree(net):
    cfg, tcfg, _, _, _, _ = net
    mine = bridge.params_to_jax(T.init_params(tcfg, torch.Generator().manual_seed(0)))
    shapes = jax.eval_shape(lambda: J.init_params(jax.random.PRNGKey(0), cfg))
    assert jax.tree_util.tree_map(np.shape, mine) == jax.tree_util.tree_map(lambda s: s.shape, shapes)


def test_mapping(net):
    cfg, tcfg, params, tparams, z, ws = net
    out = T.mapping(tparams, torch.from_numpy(z), tcfg, truncation_psi=0.7, truncation_cutoff=4)
    ref = np.asarray(J.mapping(params, jnp.asarray(z), cfg, truncation_psi=0.7, truncation_cutoff=4))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("explicit_noise", [False, True])
def test_synthesis(net, explicit_noise):
    cfg, tcfg, params, tparams, _, ws = net
    noises = None
    if explicit_noise:
        rs = np.random.RandomState(3)
        noises = {f"b{r}.conv{i}": rs.randn(3, r, r).astype(np.float32) for r in (8, 16) for i in (0, 1)}
    ref = np.asarray(J.synthesis(params, jnp.asarray(ws), cfg, noises=noises))
    out = T.synthesis(tparams, torch.from_numpy(ws), tcfg,
                      noises=None if noises is None else {k: torch.from_numpy(v) for k, v in noises.items()})
    assert out.shape == (3, 3, 64, 64)
    np.testing.assert_allclose(nhwc(out), ref, rtol=0, atol=1e-4)


def test_synthesis_noise_none_and_resnet():
    kw = dict(KW, architecture="resnet", img_resolution=32)
    cfg = J.SG2Config(**kw)
    params = random_jax_params(cfg, 2)
    ws = np.random.RandomState(1).randn(2, cfg.num_ws, 32).astype(np.float32)
    ref = np.asarray(J.synthesis(params, jnp.asarray(ws), cfg, noise_mode="none"))
    out = T.synthesis(bridge.params_to_torch(params), torch.from_numpy(ws), T.SG2Config(**kw), noise_mode="none")
    np.testing.assert_allclose(nhwc(out), ref, rtol=0, atol=1e-4)


def test_synthesize_with_motion_and_noise_pyramid(net):
    cfg, tcfg, params, tparams, _, ws = net
    rs = np.random.RandomState(4)
    tr = rs.randn(3, 2).astype(np.float32) * 0.1
    zoom = 1 - 0.3 * rs.rand(3).astype(np.float32)
    rot = rs.randn(3).astype(np.float32) * 5
    noise = rs.randn(3, 64, 64, 1).astype(np.float32)
    nj = JW.make_noise_pyramid(cfg, jnp.asarray(noise))
    nt = TW.make_noise_pyramid(tcfg, torch.from_numpy(np.ascontiguousarray(noise.transpose(0, 3, 1, 2))))
    assert list(nj) == list(nt)
    for k in nj:
        np.testing.assert_allclose(nhwc(nt[k]), np.asarray(nj[k]), rtol=0, atol=1e-5)
    ref = np.asarray(JW.synthesize(params, jnp.asarray(ws), cfg, translation=jnp.asarray(tr),
                                   zoom=jnp.asarray(zoom), rotation=jnp.asarray(rot), noises=nj))
    out = TW.synthesize(tparams, torch.from_numpy(ws), tcfg, translation=torch.from_numpy(tr),
                        zoom=torch.from_numpy(zoom), rotation=torch.from_numpy(rot), noises=nt)
    np.testing.assert_allclose(nhwc(out), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("size", [(4, 4), (8, 16), (32, 32), (100, 37), (128, 128)])
def test_resize_bicubic(size):
    x = np.random.RandomState(5).randn(2, 64, 48, 3).astype(np.float32)
    ref = np.asarray(JWarp.resize_bicubic(jnp.asarray(x), size))
    out = TWarp.resize_bicubic(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))), size)
    np.testing.assert_allclose(nhwc(out), ref, rtol=0, atol=5e-5)


@pytest.mark.parametrize("padding_mode", ["reflection", "border", "zeros"])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample(padding_mode, mode):
    rs = np.random.RandomState(6)
    x = rs.randn(2, 9, 7, 3).astype(np.float32)
    grid = (rs.rand(2, 5, 6, 2).astype(np.float32) * 3 - 1.5)
    ref = np.asarray(JWarp.grid_sample(jnp.asarray(x), jnp.asarray(grid), mode=mode, padding_mode=padding_mode))
    out = TWarp.grid_sample(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))), torch.from_numpy(grid),
                            mode=mode, padding_mode=padding_mode)
    np.testing.assert_allclose(nhwc(out), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("center", [None, (3.0, 5.0)])
def test_warps(center):
    rs = np.random.RandomState(7)
    x = rs.randn(2, 12, 10, 3).astype(np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    angle = np.array([10.0, -25.0], np.float32)
    factor = np.array([1.3, 0.8], np.float32)
    shift = np.array([[1.5, -2.0], [0.25, 3.0]], np.float32)
    pairs = [
        (JWarp.rotate(jnp.asarray(x), jnp.asarray(angle), center), TWarp.rotate(xt, torch.from_numpy(angle), center)),
        (JWarp.zoom(jnp.asarray(x), jnp.asarray(factor), center), TWarp.zoom(xt, torch.from_numpy(factor), center)),
        (JWarp.translate(jnp.asarray(x), jnp.asarray(shift)), TWarp.translate(xt, torch.from_numpy(shift))),
    ]
    for ref, out in pairs:
        np.testing.assert_allclose(nhwc(out), np.asarray(ref), rtol=0, atol=1e-5)


def test_stylegan2_render_yields_uint8_frames(net):
    _, tcfg, _, tparams, _, ws = net
    model = TW.StyleGAN2(cfg=tcfg, params=tparams, device="cpu")
    latents = torch.from_numpy(np.repeat(ws, 3, axis=0))  # 9 frames, batches of 4 with a padded tail
    frames = list(model.render(latents, batch_size=4))
    assert len(frames) == 9 and frames[0].shape == (64, 64, 3) and frames[0].dtype == np.uint8
    img = model.synthesizer(torch.from_numpy(ws))
    want = ((img + 1) * 127.5).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(frames[0], want[0])
    np.testing.assert_array_equal(frames[8], want[2])


def test_get_z_latents_matches_jax():
    np.testing.assert_array_equal(TW.get_z_latents("1-3,7", 16), JW.get_z_latents("1-3,7", 16))
    assert TW.layer_names(T.SG2Config(**KW)) == JW.layer_names(J.SG2Config(**KW))


def test_entry_points_need_a_card_unless_told_otherwise(net, monkeypatch):
    _, tcfg, _, tparams, _, _ = net
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TW.StyleGAN2(cfg=tcfg, params=tparams)
    assert TW.StyleGAN2(cfg=tcfg, params=tparams, device="cpu").device.type == "cpu"
