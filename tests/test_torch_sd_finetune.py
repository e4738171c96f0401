"""The port's Stable Diffusion finetuning against maua_tpu's, on the CPU.

The tiny SD of test_torch_diffusion.py (UNet 32 channels, VAE 16, CLIP text
64 wide) at 32^2 images (16^2 latents), its parameters carried over by the
bridge. maua_tpu's timesteps, noise and batch indices are rebuilt from its
keys and handed to the port. On the CPU the UNet's attention takes the
flash kernel's plain version under autograd; JAX differentiates its XLA
attention, which computes the same function.

Tolerances, f32: the loss 1e-5 relative; AdamW's first moment (the step's
gradient times 0.1) 1e-4 of each leaf's largest magnitude or 1e-7 of the
largest of all, whichever is larger (the gradient of a dozen f32 layers in
another summation order; the floor for the leaves described below). Parameters and EMA: 1e-5 of
each leaf's largest magnitude, plus Adam's own sensitivity to that gradient
error: a step is lr * m / (sqrt(v) + 1e-8), so a gradient error d moves it
by up to lr * 4 d / (sqrt(v) + 1e-8) (capped at 2 lr), summed over the steps,
with d = 1e-4 of the leaf's largest gradient or 1e-7 of the largest of all
(at this width every group of the group norms holds one channel, so the
biases of the convs before them have a gradient of exactly 0 that both
packages compute as f32 noise, 1e-9 where other leaves reach 1e-1). Where
the gradient entries are large the bar is the first term alone. The
resumed run equals the uninterrupted one exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maua_tpu.diffusion import finetune as JF
from maua_tpu.diffusion.processors.stable import StableDiffusion as JaxSD
from maua_tpu.text import clip_text as JT
from maua_tpu_torch import bridge
from maua_tpu_torch import transforms as T
from maua_tpu_torch.diffusion import finetune as TF
from maua_tpu_torch.diffusion.models import unet as TU
from maua_tpu_torch.diffusion.models import vae as TV
from maua_tpu_torch.diffusion.processors.stable import StableDiffusion
from maua_tpu_torch.gan.training import tree_leaves
from maua_tpu_torch.text import clip_text as TT
from test_torch_diffusion import TINY_TEXT, TINY_UNET, TINY_VAE, port_cfg, random_params

torch.set_num_threads(1)

KW = dict(sampler="lms", timesteps=3, cfg_scale=3.0, image_size=32)
CAPTIONS = ["a red fox", "a blue bird", "a green field"]


@pytest.fixture(scope="module")
def pair():
    unet = random_params(lambda k: JF.unet_mod.init_params(k, TINY_UNET), 60)
    vae = random_params(lambda k: JF.vae_mod.init_params(k, TINY_VAE), 61)
    text = random_params(lambda k: JT.init_params(k, TINY_TEXT), 62)
    jsd = JaxSD(unet_params=unet, vae_params=vae, text_params=text, unet_cfg=TINY_UNET, vae_cfg=TINY_VAE,
                text_cfg=TINY_TEXT, **KW)

    def port():
        return StableDiffusion(unet_params=bridge.diffusion_params_to_torch(unet),
                               vae_params=bridge.diffusion_params_to_torch(vae),
                               text_params=bridge.diffusion_params_to_torch(text),
                               unet_cfg=port_cfg(TU.UNetConfig, TINY_UNET), vae_cfg=port_cfg(TV.VAEConfig, TINY_VAE),
                               text_cfg=port_cfg(TT.CLIPTextConfig, TINY_TEXT), device="cpu", **KW)

    return jsd, port


def images(n=3, seed=63):
    return np.tanh(np.random.RandomState(seed).randn(n, 32, 32, 3).astype(np.float32))


def jax_step_draws(key, b, latent_shape, n):
    """maua_tpu's (batch indices, timesteps, NCHW noise) for one step of `finetune` from its loop key."""
    key, k_b, k_s = jax.random.split(key, 3)
    idx = np.asarray(jax.random.randint(k_b, (b,), 0, n))
    k_t, k_n = jax.random.split(k_s)
    t = np.asarray(jax.random.randint(k_t, (b,), 0, 1000))
    noise = np.array(jax.random.normal(k_n, (b,) + latent_shape)).transpose(0, 3, 1, 2)
    return key, (idx, t, noise)


def adam_slack(mu, nus, lr):
    """Per leaf, Adam's sensitivity to the stated gradient error, summed over the steps whose second
    moments `nus` (bias-uncorrected, after steps 1, 2, ...) are given; mu is the first step's."""
    grads = [m / 0.1 for m in mu]
    top = max(float(g.abs().max()) for g in grads)
    out = []
    for i, g in enumerate(grads):
        d = max(1e-4 * float(g.abs().max()), 1e-7 * top)
        out.append(sum(lr * torch.clamp(4 * d / (torch.sqrt(nu[i] / (1 - 0.999 ** (s + 1))) + 1e-8), max=2.0)
                       for s, nu in enumerate(nus)).numpy())
    return out


def leaves_close(got, want, tol, slack=None):
    """Each leaf within tol of its largest magnitude, plus the elementwise `slack`."""
    for i, (g, w) in enumerate(zip(tree_leaves(got), jax.tree_util.tree_leaves(want))):
        g, w = g.detach().numpy(), np.asarray(w)
        assert np.all(np.abs(g - w) <= tol * max(np.abs(w).max(), 1e-30) + (0 if slack is None else slack[i]))


def test_train_step_matches(pair):
    jsd, port = pair
    tsd = port()
    imgs = images(2)
    lat = jsd.encode(jnp.asarray(imgs))
    ctx = jnp.concatenate([JF.encode_text(jsd.text_params, jnp.asarray(JF.tokenize(c, 16)), TINY_TEXT)
                           for c in CAPTIONS[:2]])
    ac = jnp.asarray(jsd.alphas_cumprod, jnp.float32)
    opt = optax.adamw(1e-3)
    key = jax.random.PRNGKey(64)
    jp, jstate, jloss = JF._train_step(jsd.unet_params, opt.init(jsd.unet_params), lat, ctx, key, ac, TINY_UNET,
                                       opt.update)
    k_t, k_n = jax.random.split(key)
    t = torch.from_numpy(np.asarray(jax.random.randint(k_t, (2,), 0, 1000))).long()
    noise = torch.from_numpy(np.array(jax.random.normal(k_n, lat.shape)).transpose(0, 3, 1, 2).copy())
    tx = T.adamw(1e-3)
    tlat = torch.from_numpy(np.array(lat).transpose(0, 3, 1, 2).copy())
    tp, tstate, tloss = TF.train_step(tsd.unet_params, tx.init(tree_leaves(tsd.unet_params)), tx, tlat,
                                      torch.from_numpy(np.array(ctx)), t, noise, tsd.alphas_cumprod, tsd.unet_cfg)
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * float(jloss)
    mu = tree_leaves(bridge.diffusion_params_to_torch(jax.tree_util.tree_map(np.asarray, jstate[0].mu)))
    top = max(float(w.abs().max()) for w in mu)
    for g, w in zip(tstate[0]["mu"], mu):
        assert np.abs(g.numpy() - w.numpy()).max() <= max(1e-4 * float(w.abs().max()), 1e-7 * top)
    slack = adam_slack(tstate[0]["mu"], [tstate[0]["nu"]], 1e-3)
    leaves_close(tp, bridge.diffusion_params_to_torch(jax.tree_util.tree_map(np.asarray, jp)), 1e-5, slack)


def test_finetune_with_ema_matches(pair, tmp_path):
    """Two steps of `finetune` (batch 2 of 3 images), EMA decay 0.9: params and EMA against maua_tpu's; the
    processor is left holding the EMA weights and reads them live when it samples."""
    jsd, port = pair
    tsd = port()
    imgs = images()
    key = jax.random.PRNGKey(65)
    jparams, jema = JF.finetune(jsd, imgs, CAPTIONS, n_steps=2, batch_size=2, lr=1e-3, ema_decay=0.9, key=key,
                                verbose=False)
    draws, k = [], key
    for _ in range(2):
        k, d = jax_step_draws(k, 2, (16, 16, 4), 3)
        draws.append(d)
    start = tsd.unet_params
    with torch.no_grad():
        lat = tsd.encode(torch.from_numpy(imgs[draws[0][0]]).permute(0, 3, 1, 2))
    ctx = torch.cat([TF.encode_text(tsd.text_params, TF.tokenize(CAPTIONS[i], 16), tsd.text_cfg) for i in draws[0][0]])
    tx = T.adamw(1e-3)
    _, st, _ = TF.train_step(start, tx.init(tree_leaves(start)), tx, lat, ctx, torch.from_numpy(draws[0][1]).long(),
                             torch.from_numpy(draws[0][2]), tsd.alphas_cumprod, tsd.unet_cfg)
    tparams, tema = TF.finetune(tsd, imgs, CAPTIONS, n_steps=2, batch_size=2, lr=1e-3, ema_decay=0.9,
                                draws=iter(draws), checkpoint_dir=str(tmp_path), verbose=False)
    nu2 = TF.load_checkpoint(str(tmp_path / "finetune_last.pt"))["opt"][0]["nu"]
    slack = adam_slack(st[0]["mu"], [st[0]["nu"], nu2], 1e-3)
    conv = bridge.diffusion_params_to_torch
    leaves_close(tparams, conv(jax.tree_util.tree_map(np.asarray, jparams)), 1e-5, slack)
    leaves_close(tema, conv(jax.tree_util.tree_map(np.asarray, jema)), 1e-5, slack)
    assert tsd.unet_params is tema
    noise = np.random.RandomState(66).randn(1, 16, 16, 4).astype(np.float32)
    from maua_tpu_torch.prompt import TextPrompt

    def sample(proc):
        return proc.forward(np.zeros((1, 32, 32, 3), np.float32), [TextPrompt("a fox")], 0.0, noise=noise).numpy()

    fresh = port()
    before = sample(fresh)
    fresh.unet_params = tema
    np.testing.assert_array_equal(sample(fresh), sample(tsd))
    assert np.abs(sample(tsd) - before).max() > 1e-4


def test_resume_equals_the_uninterrupted_run(pair, tmp_path):
    """Three steps in one run against two, a saved state, and the third after resuming from it; the sample
    hook sees the EMA weights every 2 steps."""
    _, port = pair
    imgs = images()
    hook = []
    full_sd = port()
    full = TF.finetune(full_sd, imgs, CAPTIONS, n_steps=3, batch_size=2, lr=1e-3, ema_decay=0.9,
                       gen=torch.Generator().manual_seed(7), verbose=False, sample_every=2,
                       sample_hook=lambda step, im: hook.append((step, im.shape)))
    assert hook == [(2, (1, 32, 32, 3))]
    a = port()
    TF.finetune(a, imgs, CAPTIONS, n_steps=2, batch_size=2, lr=1e-3, ema_decay=0.9,
                gen=torch.Generator().manual_seed(7), checkpoint_dir=str(tmp_path), verbose=False)
    gen = torch.Generator().manual_seed(7)
    for _ in range(2):  # the draws the first two steps took
        torch.randint(0, 3, (2,), generator=gen), torch.randint(0, 1000, (2,), generator=gen)
        torch.randn((2, 4, 16, 16), generator=gen)
    resumed = TF.finetune(port(), imgs, CAPTIONS, n_steps=3, batch_size=2, lr=1e-3, ema_decay=0.9, gen=gen,
                          checkpoint_dir=str(tmp_path), resume=True, verbose=False)
    for x, y in zip(tree_leaves(full[0]) + tree_leaves(full[1]), tree_leaves(resumed[0]) + tree_leaves(resumed[1])):
        assert torch.equal(x, y)
    state = TF.load_checkpoint(str(tmp_path / "finetune_last.pt"))
    assert state["step"] == 3 and state["opt"][0]["count"] == 3
