"""The gradient through the port's epilogue (`kernels/epilogue.ModconvEpilogue`)
against maua_tpu's, which differentiates its XLA chain (`_xla_epilogue`).

On the CPU the Function's forward is the plain version under no_grad and
its backward the same code that runs on the card. Inputs come from seeded
numpy draws. Tolerances: 1e-5 of each gradient's largest magnitude unit by
unit (f32, the same sums in other orders); the StyleGAN2 synthesis
gradient with respect to ws 1e-4 relative at 64^2 (maua_tpu demodulates
the weights before the conv, the port scales the conv's output: the same
function up to rounding); CLIP-guided Langevin over 3 steps with JAX's
draws handed in, 1e-4.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.gan import sampling as JS
from maua_tpu.gan import stylegan2 as J
from maua_tpu.kernels.epilogue import _xla_epilogue
from maua_tpu_torch import bridge
from maua_tpu_torch.gan import sampling as TS
from maua_tpu_torch.gan import stylegan2 as T
from maua_tpu_torch.kernels import epilogue as E
from test_torch_stylegan2 import random_jax_params

torch.set_num_threads(1)

CASES = [  # (noise: None | "sample" | "shared", groups, pre_next, clamp)
    (None, 1, False, 256.0),
    ("sample", 1, False, 256.0),
    ("shared", 1, False, 0.5),
    ("sample", 4, True, 0.5),
    ("shared", 4, True, None),
    ("sample", 1, True, 1.0),
]


def _draws(seed, noise, groups, pre, b=2, c=8, h=5, w=6, grid=False):
    rs = np.random.RandomState(seed)

    def draw(*shape):
        a = rs.randn(*shape).astype(np.float32)
        return np.round(a * 4) / 4 if grid else a  # on a grid of 1/4, sums and products land on the clamp

    z = draw(b, c, h, w) * 2
    post = np.abs(draw(b, c)) + 0.5 if not grid else np.ones((b, c), np.float32)
    nz = None if noise is None else draw(1 if noise == "shared" else b, groups, h, w)
    bias = draw(c)
    pre_next = np.abs(draw(b, c)) + 0.5 if pre else None
    g = draw(b, c, h, w)
    return z, post, nz, bias, pre_next, g


def _jax_vjp(z, post, nz, bias, pre_next, g, alpha, gain, clamp):
    """jax.vjp of _xla_epilogue in NHWC, the cotangents back in the port's layouts."""
    prim = [jnp.asarray(z.transpose(0, 2, 3, 1)), jnp.asarray(post), jnp.asarray(bias)]
    if nz is not None:
        prim.append(jnp.asarray(nz.transpose(0, 2, 3, 1)))
    if pre_next is not None:
        prim.append(jnp.asarray(pre_next))

    def f(zz, pp, bb, *rest):
        rest = list(rest)
        n = rest.pop(0) if nz is not None else None
        pn = rest.pop(0) if pre_next is not None else None
        return _xla_epilogue(zz, pp, n, bb, alpha, gain, clamp, pn)

    y, vjp = jax.vjp(f, *prim)
    grads = [np.asarray(a) for a in vjp(jnp.asarray(g.transpose(0, 2, 3, 1)))]
    out = {"y": np.asarray(y).transpose(0, 3, 1, 2), "z": grads[0].transpose(0, 3, 1, 2), "post": grads[1],
           "bias": grads[2]}
    i = 3
    if nz is not None:
        out["noise"] = grads[i].transpose(0, 3, 1, 2)
        i += 1
    if pre_next is not None:
        out["pre_next"] = grads[i]
    return out


def _port_grads(z, post, nz, bias, pre_next, g, alpha, gain, clamp, fn=E.modconv_epilogue):
    ts = {k: None if a is None else torch.from_numpy(a).requires_grad_(True)
          for k, a in (("z", z), ("post", post), ("noise", nz), ("bias", bias), ("pre_next", pre_next))}
    y = fn(ts["z"], ts["post"], ts["noise"], ts["bias"], alpha, gain, clamp, ts["pre_next"])
    y.backward(torch.from_numpy(g))
    return y, {"y": y.detach().numpy(), **{k: t.grad.numpy() for k, t in ts.items() if t is not None}}


def _assert_close(got, want, rtol):
    for k, w in want.items():
        err = np.abs(got[k] - w).max()
        assert err <= rtol * max(np.abs(w).max(), 1e-30), (k, err, np.abs(w).max())


@pytest.mark.parametrize("noise,groups,pre,clamp", CASES)
def test_modconv_epilogue_backward_matches_jax_vjp(noise, groups, pre, clamp):
    args = _draws(0, noise, groups, pre)
    alpha, gain = 0.2, float(np.sqrt(2.0))
    y, got = _port_grads(*args, alpha, gain, clamp)
    assert type(y.grad_fn).__name__ == "ModconvEpilogueBackward"
    _assert_close(got, _jax_vjp(*args, alpha, gain, clamp), 1e-5)
    # the plain version's own autograd (its clip halves a tie as jnp.clip does) agrees too
    _, plain = _port_grads(*args, alpha, gain, clamp, fn=E.modconv_epilogue_plain)
    _assert_close(got, plain, 1e-5)


def test_modconv_epilogue_backward_at_the_clamp_takes_jnp_clip_rule():
    """Seeded draws on a grid of 1/4, gain 1 and clamp 1: many outputs land exactly on +-1, where
    jnp.clip's min / max pass half the gradient; the Function's mask does the same."""
    args = _draws(1, "sample", 2, True, c=8, h=8, w=8, grid=True)
    z, post, nz, bias = args[:4]
    u = z + nz.repeat(4, axis=1) + bias[None, :, None, None]
    v = np.where(u >= 0, u, u * 0.5)
    assert (np.abs(v) == 1.0).sum() >= 10  # ties exist in these draws
    _, got = _port_grads(*args, 0.5, 1.0, 1.0)
    want = _jax_vjp(*args, 0.5, 1.0, 1.0)
    _assert_close(got, want, 1e-5)
    at_bound = np.abs(v) == 1.0
    slope = np.where(u >= 0, 1.0, 0.5)
    np.testing.assert_allclose(got["z"][at_bound], (0.5 * slope * args[5] * args[4][:, :, None, None])[at_bound],
                               rtol=1e-6)


def test_modconv_epilogue_without_autograd_stays_the_bare_call():
    args = [torch.from_numpy(a) for a in _draws(2, "sample", 1, False)[:4]]
    y = E.modconv_epilogue(*args)
    assert y.grad_fn is None and not y.requires_grad
    with torch.no_grad():
        assert E.modconv_epilogue(args[0].requires_grad_(True), *args[1:]).grad_fn is None


KW = dict(img_resolution=64, channel_base=256, channel_max=32, z_dim=32, w_dim=32, mapping_layers=2,
          num_fp16_res=0)


@pytest.fixture(scope="module")
def net():
    cfg = J.SG2Config(**KW)
    params = random_jax_params(cfg, 3)
    return cfg, T.SG2Config(**KW), params, bridge.params_to_torch(params)


def test_synthesis_gradient_wrt_ws_matches_jax_grad(net):
    cfg, tcfg, params, tparams = net
    rs = np.random.RandomState(4)
    ws = (rs.randn(2, cfg.num_ws, cfg.w_dim) * 0.7).astype(np.float32)
    r = rs.randn(2, 64, 64, 3).astype(np.float32)

    def loss(w):
        return jnp.sum(J.synthesis(params, w, cfg, noise_mode="const") * r)

    want_v, want = (np.asarray(a) for a in jax.jit(jax.value_and_grad(loss))(jnp.asarray(ws)))
    tws = torch.from_numpy(ws).requires_grad_(True)
    got_v = (T.synthesis(tparams, tws, tcfg, noise_mode="const").permute(0, 2, 3, 1) * torch.from_numpy(r)).sum()
    got_v.backward()
    np.testing.assert_allclose(got_v.item(), want_v, rtol=1e-4)
    assert np.abs(tws.grad.numpy() - want).max() <= 1e-4 * np.abs(want).max()


def test_clip_langevin_trajectory_matches_maua_tpu():
    """CLIP's energy through a 32^2 net (the tests' tiny CLIP), three Langevin steps from JAX's
    start and noise: the trajectory differentiates every synthesis layer's epilogue."""
    from test_torch_diffusion import TINY_TEXT, random_params
    from test_torch_guidance import TINY_VISION
    from test_torch_guided_diffusion import clip_perceptors
    from maua_tpu.perceptors import clip as JCLIP
    from maua_tpu.text import clip_text as JT

    kw = dict(KW, img_resolution=32)
    cfg, tcfg = J.SG2Config(**kw), T.SG2Config(**kw)
    params = random_jax_params(cfg, 11)
    clip = (random_params(lambda k: JCLIP.init_vision_params(k, TINY_VISION), 20),
            random_params(lambda k: JT.init_params(k, TINY_TEXT), 21),
            np.random.RandomState(22).randn(TINY_TEXT.width, TINY_VISION.embed_dim).astype(np.float32) / 8)
    jclip, tclip = clip_perceptors(clip)
    jenergy = JS.clip_energy(SimpleNamespace(params=params, cfg=cfg), "a red fox", perceptor=jclip)
    tenergy = TS.clip_energy(SimpleNamespace(params=bridge.params_to_torch(params), cfg=tcfg), "a red fox",
                             perceptor=tclip)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax.jit(lambda k: JS.langevin_sample(k, 2, jenergy, z_dim=cfg.z_dim, n_steps=3,
                                                           step_size=0.05))(key))
    k0, kz = jax.random.split(key)
    z = np.array(jax.random.normal(kz, (2, cfg.z_dim)))
    noise = np.stack([np.array(jax.random.normal(k, (2, cfg.z_dim))) for k in jax.random.split(k0, 3)])
    got = TS.langevin_sample(None, 2, tenergy, z_dim=cfg.z_dim, n_steps=3, step_size=0.05,
                             z=torch.from_numpy(z), noise=torch.from_numpy(noise)).numpy()
    assert np.abs(got - z).max() > 1e-2  # the trajectory moved
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
