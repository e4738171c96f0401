"""The port's StyleGAN2 output resize, and the layout of a patch's
`process_outputs`, against maua_tpu.

A 64^2 net with narrow channels and random parameters in the JAX
package's pytree, as in tests/test_torch_stylegan2.py, f32 on the CPU.
`synthesize` runs with `RenderConfig(output_size, strategy, layer,
resize_noise=False)` (the channel-statistics refill draws random numbers
that differ between the packages) and explicit noise maps from
`make_noise_pyramid` under the same plan, against
`maua_tpu.gan.wrappers.synthesize`: `stretch` and every
`pad-<how>-<where>`, at layer 0 (the 4x4 const, with pads as large as
the map and larger) and at layer 4 (b16.conv0, pads smaller than the
map). Tolerances: 1e-5 of the image's peak magnitude (~40 here; measured
5e-6 of it), since the final bicubic resize to the output size builds its
weights in numpy here and in XLA there (5e-5 on unit inputs, as in
tests/test_torch_stylegan2.py), behind f32 convs in another summation
order; 1e-5 absolute on the noise maps; rendered uint8 frames may differ
by one level on a rounding edge.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.gan import stylegan2 as J
from maua_tpu.gan import wrappers as JW
from maua_tpu_torch import bridge
from maua_tpu_torch.gan import stylegan2 as T
from maua_tpu_torch.gan import stylegan3 as T3
from maua_tpu_torch.gan import wrappers as TW

from test_torch_stylegan2 import KW, nhwc, random_jax_params

HOWS = ("reflect", "replicate", "circular", "0")
WHERES = ("out", "left", "right", "top", "bottom")
STRATEGIES = ["stretch"] + [f"pad-{how}-{where}" for how in HOWS for where in WHERES]
# (label, layer, output size (W, H)): at layer 0 the 4x4 const becomes 8x12, so the
# pads are 4 (as large as the map) and 8 (larger); at layer 4 the 16x16 map becomes 18x20
GEOMETRIES = [("layer0-large-pads", 0, (200, 120)), ("layer4-small-pads", 4, (80, 72))]


@pytest.fixture(scope="module")
def net():
    cfg = J.SG2Config(**KW)
    params = random_jax_params(cfg, 1)
    z = np.random.RandomState(0).randn(2, 32).astype(np.float32)
    ws = np.array(J.mapping(params, jnp.asarray(z), cfg))
    return cfg, T.SG2Config(**KW), params, bridge.params_to_torch(params), ws


def _noise_video(seed=5):
    return np.random.RandomState(seed).randn(2, 64, 64, 1).astype(np.float32)


def _pyramids(cfg, tcfg, jr, tr):
    noise = _noise_video()
    nj = JW.make_noise_pyramid(cfg, jnp.asarray(noise), rcfg=jr)
    nt = TW.make_noise_pyramid(tcfg, torch.from_numpy(np.ascontiguousarray(noise.transpose(0, 3, 1, 2))), rcfg=tr)
    return nj, nt


def _configs(output_size, strategy, layer):
    kw = dict(output_size=output_size, strategy=strategy, layer=layer, resize_noise=False)
    return JW.RenderConfig(**kw), TW.RenderConfig(**kw)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=[g[0] for g in GEOMETRIES])
def test_synthesize_resized_matches(net, strategy, geometry):
    cfg, tcfg, params, tparams, ws = net
    _, layer, output_size = geometry
    jr, tr = _configs(output_size, strategy, layer)
    nj, nt = _pyramids(cfg, tcfg, jr, tr)
    ref = np.asarray(JW.synthesize(params, jnp.asarray(ws), cfg, jr, noises=nj))
    out = TW.synthesize(tparams, torch.from_numpy(ws), tcfg, tr, noises=nt)
    assert ref.shape == (2, output_size[1], output_size[0], 3)
    assert tuple(out.shape) == (2, 3, output_size[1], output_size[0])
    np.testing.assert_allclose(nhwc(out), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("how", ["reflect", "circular"])
def test_pad_wider_than_the_const(net, how):
    """pad-<how>-left at layer 0 with output (120, 64): the const grows from 4 to 8
    columns, a left pad of 4, which is the map's whole width."""
    cfg, tcfg, params, tparams, ws = net
    jr, tr = _configs((120, 64), f"pad-{how}-left", 0)
    nj, nt = _pyramids(cfg, tcfg, jr, tr)
    ref = np.asarray(JW.synthesize(params, jnp.asarray(ws[:1]), cfg, jr, noises={k: v[:1] for k, v in nj.items()}))
    out = TW.synthesize(tparams, torch.from_numpy(ws[:1]), tcfg, tr, noises={k: v[:1] for k, v in nt.items()})
    assert tuple(out.shape) == (1, 3, 64, 120) and ref.shape == (1, 64, 120, 3)
    np.testing.assert_allclose(nhwc(out), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("how", ["reflect", "replicate", "circular"])
@pytest.mark.parametrize("size,before,after", [(4, 4, 0), (4, 9, 3), (1, 2, 2), (5, 0, 13)])
def test_pad_index_follows_numpy(how, size, before, after):
    x = np.arange(size, dtype=np.float32)
    mode = {"reflect": "reflect", "replicate": "edge", "circular": "wrap"}[how]
    want = np.pad(x, (before, after), mode=mode)
    got = torch.from_numpy(x)[TW._pad_index(size, before, after, how, "cpu")].numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("geometry", GEOMETRIES + [("layer0-below-a-pixel", 0, (8, 8))],
                         ids=[g[0] for g in GEOMETRIES] + ["layer0-below-a-pixel"])
def test_noise_pyramid_under_a_resize_plan(net, geometry):
    cfg, tcfg, _, _, _ = net
    _, layer, output_size = geometry
    jr, tr = _configs(output_size, "stretch", layer)
    assert TW._resize_plan(tcfg, tr) == JW._resize_plan(cfg, jr)
    nj, nt = _pyramids(cfg, tcfg, jr, tr)
    assert list(nj) == list(nt)
    for k in nj:
        np.testing.assert_allclose(nhwc(nt[k]), np.asarray(nj[k]), rtol=0, atol=1e-5)


def test_process_outputs_gets_nhwc_like_maua_tpu(net):
    """A patch written against maua_tpu flips the last axis (RGB -> BGR) of each batch."""
    cfg, tcfg, params, tparams, ws = net
    latents = np.repeat(ws, 3, axis=0)  # 6 frames in batches of 4, the tail padded
    jmodel = JW.StyleGAN2(cfg=cfg, params=params)
    ref = np.stack(list(jmodel.render(jnp.asarray(latents), batch_size=4, postprocess=lambda v: v[..., ::-1])))
    tmodel = TW.StyleGAN2(cfg=tcfg, params=tparams, device="cpu")
    seen = []

    def flip(video):
        seen.append(tuple(video.shape))
        return video.flip(-1)

    out = np.stack(list(tmodel.render(torch.from_numpy(latents), batch_size=4, postprocess=flip)))
    assert seen == [(4, 64, 64, 3), (4, 64, 64, 3)]
    assert out.shape == ref.shape == (6, 64, 64, 3)
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
    plain = np.stack(list(tmodel.render(torch.from_numpy(latents), batch_size=4)))
    np.testing.assert_array_equal(out, plain[..., ::-1])


def test_stylegan3_process_outputs_gets_nhwc():
    cfg = T3.SG3Config(z_dim=32, w_dim=32, img_resolution=64, channel_base=1024, channel_max=64, num_layers=6,
                       mapping_layers=2, margin_size=4)
    model = T3.StyleGAN3(cfg=cfg, device="cpu", seed=0)
    ws = model.mapper(model.get_z_latents("0-3"))
    seen = []

    def flip(video):
        seen.append(tuple(video.shape))
        return video.flip(-1)

    out = np.stack(list(model.render(ws, batch_size=2, postprocess=flip)))
    plain = np.stack(list(model.render(ws, batch_size=2)))
    assert seen == [(2, 64, 64, 3)] * 2
    np.testing.assert_array_equal(out, plain[..., ::-1])
