"""Every name of the port's optimizer registry against maua_tpu's (optax
0.2.6 and maua_tpu's own transforms), on the CPU.

Each runs 8 steps (a lookahead sync at the sixth) on a dict of a (6, 5)
and a (7,) f32 parameter, the gradient g = R_t + p / 2 with R_t drawn
from a seed each step; adafactor also on a (128, 130) matrix, which it
factors. maua_tpu is driven eagerly, each step's update applied with
optax.apply_updates. Its lookahead and ranger names raise on plain
parameters (optax.lookahead reads `params.fast`): they are held against
optax.lookahead driven through `optax.LookaheadParams.init_synced`, nested
for lookahead-ranger*. noisysgd gets optax's normals (optax's key 0 split
as add_noise splits it), AdaHessian maua_tpu's Rademacher draws. The
L-BFGS names (held against optax in test_torch_optimizers.py) check their
memory; their lookahead forms against L-BFGS with the lookahead step done
by hand. Tolerance: 1e-5 of each parameter's largest magnitude.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maua_tpu import optimizers as J
from maua_tpu_torch import optimizers as O
from maua_tpu_torch import transforms as T

torch.set_num_threads(1)

STEPS, LR = 8, 0.01
SHAPES = {"b": (7,), "w": (6, 5)}


def _draws(shapes, seed=0):
    rs = np.random.RandomState(seed)
    p0 = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    rs_g = [{k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()} for _ in range(STEPS)]
    return p0, rs_g


def _lookahead_depth(name):
    return name.count("lookahead-") + int(name.split("-")[-1].startswith("ranger"))


def _synced(params, depth):
    for _ in range(depth):
        params = optax.LookaheadParams.init_synced(params) if not isinstance(params, optax.LookaheadParams) \
            else optax.LookaheadParams(fast=params, slow=params)
    return params


def _fast(params):
    while isinstance(params, optax.LookaheadParams):
        params = params.fast
    return params


def _noise_draws(shapes):
    """optax.noisy_sgd's normals (key 0, split each step as add_noise does), in the port's order."""
    key = jax.random.key(0)
    out = []
    for _ in range(STEPS):
        key, sample = jax.random.split(key)
        tree = optax.tree.random_like(sample, {k: jnp.zeros(s) for k, s in shapes.items()}, jax.random.normal)
        out.append([np.array(tree[k]) for k in sorted(shapes, reverse=True)])
    return out


def run_maua_tpu(name, shapes):
    p0, rs_g = _draws(shapes)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tx, _ = J.load_optimizer(name, LR)
        params = _synced({k: jnp.asarray(v) for k, v in p0.items()}, _lookahead_depth(name))
        state = tx.init(params)
    for r in rs_g:
        g = {k: jnp.asarray(r[k]) + 0.5 * _fast(params)[k] for k in shapes}
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
    return {k: np.asarray(v) for k, v in _fast(params).items()}


def run_port(name, shapes, kwargs=None):
    p0, rs_g = _draws(shapes)
    order = sorted(shapes, reverse=True)  # w, b: the port's parameters are a list
    ps = [torch.tensor(p0[k], requires_grad=True) for k in order]
    factory, _ = O.load_optimizer(name, LR, kwargs)
    opt = factory(ps)
    for r in rs_g:
        for k, p in zip(order, ps):
            p.grad = torch.from_numpy(r[k]) + 0.5 * p.detach()
        opt.step()
    return {k: p.detach().numpy() for k, p in zip(order, ps)}, opt


NAMES = [n for n in J.optimizer_choices if "lbfgs" not in n]
CASES = [(n, SHAPES) for n in NAMES] + [("adafactor", {"b": (7,), "w": (128, 130)})]


@pytest.mark.parametrize("name,shapes", CASES, ids=[n for n in NAMES] + ["adafactor-128x130"])
def test_registry_name_matches_maua_tpu(name, shapes):
    kwargs = {"draws": iter(_noise_draws(shapes))} if name.endswith("noisysgd") else None
    got, opt = run_port(name, shapes, kwargs)
    want = run_maua_tpu(name, shapes)
    p0, _ = _draws(shapes)
    for k in shapes:
        err = np.abs(got[k] - want[k]).max()
        assert err <= 1e-5 * np.abs(want[k]).max(), (k, err, np.abs(want[k]).max())
        assert np.abs(want[k] - p0[k]).max() > 1e-4  # the parameters moved
    if _lookahead_depth(name):
        assert isinstance(opt, O.Lookahead)


def test_maua_tpus_lookahead_route_raises_on_plain_parameters():
    """maua_tpu's style paths hand plain arrays to optax.lookahead, which reads `.fast` (ROADMAP C8)."""
    names = [n for n in J.optimizer_choices if _lookahead_depth(n)]
    assert len(names) == 56
    p = {"b": jnp.zeros(3)}
    for name in names:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tx, _ = J.load_optimizer(name, LR)
            state = tx.init(p)
        with pytest.raises(AttributeError, match="fast"):
            tx.update(p, state, p)


def test_lbfgs_names_and_their_lookahead():
    """lookahead-lbfgs: the port's L-BFGS on a quadratic with the lookahead step done by hand at
    the sixth step, against the registry's Lookahead over it."""
    rs = np.random.RandomState(3)
    a, c, x0 = (rs.rand(9) + 0.5).astype(np.float32), rs.randn(9).astype(np.float32), rs.randn(9).astype(np.float32)
    loss = lambda x: (torch.from_numpy(a) * (x - torch.from_numpy(c)) ** 2).sum() + (x**4).sum() * 0.01  # noqa: E731

    def closure_for(x, opt):
        def closure():
            opt.zero_grad()
            v = loss(x)
            v.backward()
            return v
        return closure

    for name, memory in (("lbfgs", 10), ("LBFGS-n", 20), ("lbfgs-20", 20)):
        factory, _ = O.load_optimizer(name, 0.5)
        assert factory([torch.zeros(2, requires_grad=True)]).memory_size == memory
    for name in ("lookahead-lbfgs", "lookahead-lbfgs-20"):
        x = torch.tensor(x0, requires_grad=True)
        opt = O.load_optimizer(name, 0.5)[0]([x])
        assert opt.closure_step
        y = torch.tensor(x0, requires_grad=True)
        ref = O.LBFGS([y], 0.5, memory_size=opt.inner.memory_size)
        slow = y.detach().clone()
        for step in range(1, STEPS + 1):
            opt.step(closure_for(x, opt))
            ref.step(closure_for(y, ref))
            if step % 6 == 0:
                with torch.no_grad():
                    slow = slow + 0.5 * (y - slow)
                    y.copy_(slow)
                ref.value = None
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(), rtol=1e-6, atol=1e-7)
        assert np.abs(x.detach().numpy() - x0).max() > 1e-2


def test_adahessian_matches_maua_tpu_with_its_draws():
    rs = np.random.RandomState(4)
    p0 = {"b": rs.randn(7).astype(np.float32), "w": rs.randn(6, 5).astype(np.float32)}
    xin = rs.randn(5, 4).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jnp.tanh(p["w"] @ x) ** 2) + jnp.sum(p["b"] ** 4) * 0.1

    def tloss(p, x):
        return (torch.tanh(p["w"] @ x) ** 2).sum() + (p["b"] ** 4).sum() * 0.1

    init, step = J.adahessian_optimizer(jloss, lr=0.05)
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    state = init(params)
    draws = []
    for _ in range(5):
        _, sub = jax.random.split(state["key"])
        flat, treedef = jax.tree_util.tree_flatten(params)
        draws.append(treedef.unflatten([np.asarray(jax.random.rademacher(jax.random.fold_in(sub, i), f.shape,
                                                                         dtype=jnp.float32))
                                        for i, f in enumerate(flat)]))
        params, state = step(params, state, jnp.asarray(xin))
    tinit, tstep = O.adahessian_optimizer(tloss, lr=0.05, draws=draws)
    tparams = {k: torch.from_numpy(v) for k, v in p0.items()}
    tstate = tinit(tparams)
    for _ in range(5):
        tparams, tstate = tstep(tparams, tstate, torch.from_numpy(xin))
    for k in p0:
        want = np.asarray(params[k])
        assert np.abs(tparams[k].numpy() - want).max() <= 1e-5 * np.abs(want).max(), k
    # its own draws, from a generator
    tinit, tstep = O.adahessian_optimizer(tloss, lr=0.05, gen=torch.Generator().manual_seed(1))
    out, _ = tstep({k: torch.from_numpy(v) for k, v in p0.items()}, tinit(tparams), torch.from_numpy(xin))
    assert all(torch.isfinite(v).all() for v in out.values())


def test_load_optimizer_name_rules_match_maua_tpu():
    assert O.optimizer_choices == J.optimizer_choices and len(O.optimizer_choices) == 104
    for name in ("AdamW", "Sign_SGD", "lookahead-nadam", "LookAhead-NovoGrad", "RMSPropTF", "lbfgs-n", "Ranger21"):
        jkey = J.load_optimizer(name, 0.1)[0]  # maua_tpu resolves it
        factory, n = O.load_optimizer(name, 0.1, None, 9)
        assert n == 9 and jkey is not None
        factory([torch.zeros(3, requires_grad=True)])
    for name in ("bogus", "lookahead-bogus", "adahessian", "lookahead_adam"):
        with pytest.raises(ValueError, match="unknown optimizer"):
            J.load_optimizer(name)
        with pytest.raises(ValueError, match="unknown optimizer"):
            O.load_optimizer(name)


def test_noisy_sgd_draws_from_a_generator_without_draws():
    x = torch.zeros(4, requires_grad=True)
    opt = T.TransformOptimizer([x], T.noisy_sgd(0.1, gen=torch.Generator().manual_seed(0)))
    x.grad = torch.zeros(4)
    opt.step()
    assert 0 < x.detach().abs().max() < 1.0


# ------------------------------------------------ the finetuning transforms (optax's formulas)
def _optax_steps(tx, ttx, shapes=SHAPES, labels=None):
    """STEPS steps of an optax transformation and the port's on the same draws (the gradient
    g = R_t + p / 2, updates applied), compared after each within 1e-5 of each leaf's largest magnitude."""
    p0, rs_g = _draws(shapes)
    names = sorted(shapes)
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    tparams = [torch.from_numpy(p0[k].copy()) for k in names]
    state, tstate = tx.init(params), ttx.init(tparams)
    for r in rs_g:
        g = {k: jnp.asarray(r[k]) + 0.5 * params[k] for k in names}
        u, state = tx.update(g, state, params)
        params = optax.apply_updates(params, u)
        tu, tstate = ttx.update([torch.from_numpy(r[k]) + 0.5 * p for k, p in zip(names, tparams)], tstate, tparams)
        tparams = [p + x for p, x in zip(tparams, tu)]
        for k, p in zip(names, tparams):
            want = np.asarray(params[k])
            assert np.abs(p.numpy() - want).max() <= 1e-5 * np.abs(want).max(), k


@pytest.mark.parametrize("steps,pct,final", [(10, 0.3, 500.0), (20, 0.3, 1e4), (100, 0.25, 500.0), (7, 0.3, 500.0)])
def test_cosine_onecycle_schedule_matches_optax(steps, pct, final):
    """Every count from 0 past the end, within 1e-5 relative (near the end cos + 1 approaches 0, where one
    f32 ulp of XLA's cos against numpy's reads ~3e-6); 7 steps puts the ramp's boundary at 2 (maua_tpu floors
    its finetuning horizon at 10 because shorter ones leave an empty interval: at 3 steps optax's rate is
    NaN)."""
    want = optax.cosine_onecycle_schedule(steps, 0.01, pct_start=pct, final_div_factor=final)
    got = T.cosine_onecycle_schedule(steps, 0.01, pct_start=pct, final_div_factor=final)
    for count in range(steps + 3):
        w = float(want(count))
        assert abs(float(got(count)) - w) <= 1e-5 * abs(w), count


@pytest.mark.parametrize("max_norm", [0.24, 100.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    """0.24 clips every step (the gradients' global norm is ~3), 100 none."""
    _optax_steps(optax.chain(optax.clip_by_global_norm(max_norm), optax.sgd(LR)),
                 T.chain(T.clip_by_global_norm(max_norm), T.sgd(LR)))


def test_set_to_zero_matches_optax():
    _optax_steps(optax.chain(optax.sgd(LR), optax.set_to_zero()), T.chain(T.sgd(LR), T.set_to_zero()))


def test_multi_transform_matches_optax():
    """Adam with a schedule on "b", frozen (set_to_zero) "w", as the finetuning chain labels its leaves."""
    sched, tsched = optax.cosine_onecycle_schedule(10, 0.05), T.cosine_onecycle_schedule(10, 0.05)
    labels = {"b": "train", "w": "freeze"}
    _optax_steps(optax.chain(optax.clip_by_global_norm(0.24),
                             optax.multi_transform({"train": optax.adamw(sched), "freeze": optax.set_to_zero()},
                                                   labels)),
                 T.chain(T.clip_by_global_norm(0.24),
                         T.multi_transform({"train": T.adamw(tsched), "freeze": T.set_to_zero()},
                                           [labels[k] for k in sorted(SHAPES)])))
