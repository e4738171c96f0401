"""The port's StyleGAN2 `Generator` facade and the StyleGAN w+ parameterization
(`parameterizations/stylegan.StyleGANLatent`) against maua_tpu's.

A narrow 32^2 net (random parameters in maua_tpu's pytree, brought over by
the bridge), f32 on the CPU; w+ from the same z. The parameterization
decodes through synthesis without noise, then a bilinear resize that
antialiases when it shrinks (as jax.image.resize). Tolerances: images and
w within 1e-5 of their largest magnitude, the gradient of a random linear
loss through decode within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.gan import stylegan2 as J
from maua_tpu.parameterizations.stylegan import StyleGANLatent as JLatent
from maua_tpu_torch import bridge
from maua_tpu_torch.gan import stylegan2 as T
from maua_tpu_torch.parameterizations import load_parameterization
from maua_tpu_torch.parameterizations.stylegan import StyleGANLatent
from test_torch_stylegan2 import random_jax_params

torch.set_num_threads(1)

KW = dict(img_resolution=32, channel_base=256, channel_max=32, z_dim=32, w_dim=32, mapping_layers=2,
          num_fp16_res=0)


def _close(got, want, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (what, err, np.abs(want).max())


@pytest.fixture(scope="module")
def gens():
    cfg = J.SG2Config(**KW)
    params = random_jax_params(cfg, 5)
    return J.Generator(cfg, params=params), T.Generator(T.SG2Config(**KW), params=bridge.params_to_torch(params))


def test_generator_facade_matches(gens):
    jg, tg = gens
    z = np.random.RandomState(1).randn(2, 32).astype(np.float32)
    assert tg.num_ws == jg.num_ws == 8
    ws = tg.mapping(torch.from_numpy(z), truncation_psi=0.7)
    _close(ws, jax.jit(lambda v: jg.mapping(v, truncation_psi=0.7))(jnp.asarray(z)), 1e-5, "mapping")
    img = tg.synthesis(ws, noise_mode="none").permute(0, 2, 3, 1)
    _close(img, jax.jit(lambda v: jg.synthesis(v, noise_mode="none"))(jnp.asarray(ws.numpy())), 1e-5, "synthesis")
    _close(tg(torch.from_numpy(z)).permute(0, 2, 3, 1), jax.jit(jg)(jnp.asarray(z)), 1e-5, "generator")
    drawn = T.Generator(T.SG2Config(**KW), gen=torch.Generator().manual_seed(0))
    assert drawn.synthesis(drawn.mapping(torch.zeros(1, 32))).shape == (1, 3, 32, 32)


@pytest.mark.parametrize("h,w", [(32, 32), (24, 20)])
def test_stylegan_latent_decode_and_gradient(gens, h, w):
    jg, tg = gens
    z = np.random.RandomState(2).randn(1, 32).astype(np.float32)
    j = JLatent(h, w, tensor=jg.mapping(jnp.asarray(z)), generator=jg)
    t = load_parameterization("stylegan")(h, w, generator=tg, z=torch.from_numpy(z), device="cpu")
    _close(t.tensor.detach(), j.tensor, 1e-5, "w+")
    _close(t.decode().detach(), jax.jit(j.decode)(j.tensor), 1e-5, "decode")
    r = np.random.RandomState(3).randn(1, h, w, 3).astype(np.float32)
    want = np.asarray(jax.jit(jax.grad(lambda ws: jnp.sum(j.decode(ws) * r)))(j.tensor))
    (t.decode() * torch.from_numpy(r)).sum().backward()
    _close(t.tensor.grad, want, 1e-4, "gradient through decode")
    with pytest.raises(NotImplementedError, match="projection"):
        t.encode(None)


def test_stylegan_latent_draws_its_own_generator():
    t = StyleGANLatent(16, 16, gen=torch.Generator().manual_seed(0), ema=True)
    assert t.generator.cfg.img_resolution == 16 and t.generator.cfg.num_fp16_res == 0
    assert tuple(t.tensor.shape) == (1, t.generator.num_ws, 512)
    assert t.decode().shape == (1, 16, 16, 3) and t.decode_average().shape == (1, 16, 16, 3)
