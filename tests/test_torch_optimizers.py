"""The port's optimizers against maua_tpu's (optax 0.2.6), on the CPU.

`lbfgs` and `lbfgs-20` (optax.lbfgs: the L-BFGS direction, -lr, the zoom
linesearch) run side by side with optax's, as maua_tpu's style transfer
steps them (`optax.value_and_grad_from_state`, a jitted update), on the
8-D Rosenbrock function from a seeded start and on a 32^2 style loss (a
seed-0 VGG19's grams of an RGB pastiche against a style image's, with its
total variation). Per iteration the port's value, accepted stepsize,
linesearch steps and memory index are held against optax's state; then
the parameters. `adam` (optax's update order) against
optax.adam over 10 steps.

Tolerances, f32: each iteration's value and stepsize within 1e-5
relative, the parameters within 1e-5 of their largest magnitude; the
linesearch steps and memory index equal; adam's parameters within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maua_tpu import loss as JL
from maua_tpu.optimizers import load_optimizer as jax_load_optimizer
from maua_tpu.perceptors import vgg as JVGG
from maua_tpu_torch import loss as TL
from maua_tpu_torch.bridge import guidance_params_to_torch
from maua_tpu_torch.optimizers import LBFGS, Adam, load_optimizer
from maua_tpu_torch.perceptors import vgg as TVGG

REL = 1e-5


def _rosenbrock_jax(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def _rosenbrock_torch(x):
    return (100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2).sum()


def _optax_trajectory(opt, fn, x0, iters):
    """maua_tpu's L-BFGS loop (maua_tpu/style/image.py): per iteration the value at the start, the
    linesearch's stepsize and steps, and the parameters after."""
    vg = optax.value_and_grad_from_state(fn)

    @jax.jit
    def step(params, state):
        value, grad = vg(params, state=state)
        updates, state = opt.update(grad, state, params, value=value, grad=grad, value_fn=fn)
        return optax.apply_updates(params, updates), state, value

    params, state, out = x0, opt.init(x0), []
    for _ in range(iters):
        params, state, value = step(params, state)
        ls = state[2]
        out.append({"value": float(value), "stepsize": float(ls.learning_rate),
                    "linesearch_steps": int(ls.info.num_linesearch_steps), "memory_idx": int(state[0].count - 1) % (
                        state[0].weights_memory.shape[0]), "params": np.asarray(params)})
    return out


def _port_trajectory(opt, closure, x, iters):
    out = []
    for _ in range(iters):
        value = opt.step(closure)
        out.append({"value": float(value), "stepsize": opt.info["stepsize"],
                    "linesearch_steps": opt.info["linesearch_steps"], "memory_idx": opt.info["memory_idx"],
                    "params": x.detach().numpy().copy()})
    return out


def _assert_trajectories_match(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        print(i, {k: v for k, v in w.items() if k != "params"}, "err", float(np.abs(g["params"] - w["params"]).max()))
        assert g["linesearch_steps"] == w["linesearch_steps"] and g["memory_idx"] == w["memory_idx"], (i, g, w)
        for k in ("value", "stepsize"):
            assert abs(g[k] - w[k]) <= REL * abs(w[k]), (i, k, g[k], w[k])
        assert np.abs(g["params"] - w["params"]).max() <= REL * np.abs(w["params"]).max(), i
    assert len(got) == len(want)


# lr 0.5 (the style CLI's) takes every first guess; lr 8 zooms in most steps; lr 0.02 grows the step
@pytest.mark.parametrize("name,memory,lr", [("lbfgs", 10, 0.5), ("LBFGS-n", 20, 8.0), ("lbfgs", 10, 0.02)])
def test_lbfgs_follows_optax_on_rosenbrock(name, memory, lr):
    x0 = np.random.RandomState(3).uniform(-1.5, 1.5, 8).astype(np.float32)
    jopt, n = jax_load_optimizer(name, lr, None, 8)
    want = _optax_trajectory(jopt, _rosenbrock_jax, jnp.asarray(x0), n)
    factory, n_port = load_optimizer(name, lr, None, 8)
    x = torch.tensor(x0, requires_grad=True)
    opt = factory([x])
    assert isinstance(opt, LBFGS) and opt.memory_size == memory and n_port == n

    def closure():
        opt.zero_grad()
        loss = _rosenbrock_torch(x)
        loss.backward()
        return loss

    got = _port_trajectory(opt, closure, x, n)
    _assert_trajectories_match(got, want)
    if lr == 8.0:
        assert sum(w["stepsize"] < 1 for w in want) > 4  # the zoom ran
    if lr == 0.02:
        assert max(w["stepsize"] for w in want) > 2  # the interval search doubled the step
    assert want[-1]["value"] < 0.5 * want[0]["value"]


def test_lbfgs_follows_optax_on_a_style_loss():
    rs = np.random.RandomState(4)
    vgg = JVGG.init_params(jax.random.PRNGKey(0), "vgg19")
    vgg = jax.tree_util.tree_map(np.asarray, vgg)
    tvgg = guidance_params_to_torch(vgg)
    style = (rs.rand(1, 32, 32, 3) * 2 - 1).astype(np.float32)
    init = rs.rand(1, 32, 32, 3).astype(np.float32)
    layers = (1, 3, 6, 10, 14)

    jtargets = [JL.gram_matrix(f) for i, f in enumerate(JVGG.features(vgg, jnp.asarray(style))) if i in layers]

    def jloss(p):
        img = JL.clamp_with_grad(p, 0.0, 1.0) * 2.0 - 1.0
        feats = JVGG.features(vgg, img)
        out = sum(50.0 * JL.scaled_mse_loss(JL.gram_matrix(feats[i]), t) for i, t in zip(layers, jtargets))
        return out + 10.0 * JL.tv_loss(img)

    ttargets = [TL.gram_matrix(f) for i, f in enumerate(TVGG.features(tvgg, torch.from_numpy(style))) if i in layers]

    def tloss(p):
        img = TL.clamp_with_grad(p, 0.0, 1.0) * 2.0 - 1.0
        feats = TVGG.features(tvgg, img)
        out = sum(50.0 * TL.scaled_mse_loss(TL.gram_matrix(feats[i]), t) for i, t in zip(layers, ttargets))
        return out + 10.0 * TL.tv_loss(img)

    want = _optax_trajectory(optax.lbfgs(0.5), jloss, jnp.asarray(init), 6)
    x = torch.tensor(init, requires_grad=True)
    opt = LBFGS([x], 0.5)

    def closure():
        opt.zero_grad()
        loss = tloss(x)
        loss.backward()
        return loss

    got = _port_trajectory(opt, closure, x, 6)
    _assert_trajectories_match(got, want)
    assert opt.evaluations == 1 + sum(w["linesearch_steps"] for w in want)


def test_adam_follows_optax():
    x0 = np.random.RandomState(5).uniform(-1.5, 1.5, 8).astype(np.float32)
    jopt, _ = jax_load_optimizer("adam", 0.05, {"b1": 0.8}, 10)
    params, state = jnp.asarray(x0), jopt.init(jnp.asarray(x0))
    for _ in range(10):
        updates, state = jopt.update(jax.grad(_rosenbrock_jax)(params), state, params)
        params = optax.apply_updates(params, updates)
    factory, _ = load_optimizer("adam", 0.05, {"b1": 0.8}, 10)
    x = torch.tensor(x0, requires_grad=True)
    opt = factory([x])
    for _ in range(10):
        opt.zero_grad()
        _rosenbrock_torch(x).backward()
        opt.step()
    assert np.abs(x.detach().numpy() - np.asarray(params)).max() <= 1e-6


def test_load_optimizer_names():
    """The whole registry is ported (tests/test_torch_optimizer_registry.py holds each name); AdaHessian
    is not a registry name in maua_tpu either (it needs the loss: `adahessian_optimizer`)."""
    for name in ("lookahead-adam", "sgd", "adamw", "shampoo", "ranger"):
        factory, _ = load_optimizer(name)
        factory([torch.zeros(2, requires_grad=True)]).step()
    for name in ("bogus", "adahessian"):
        with pytest.raises(ValueError, match="unknown optimizer"):
            load_optimizer(name)
    factory, n = load_optimizer("Adam", 0.1, None, 7)
    assert n == 7 and isinstance(factory([torch.zeros(2, requires_grad=True)]), Adam)
