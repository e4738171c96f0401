"""Gradient transformations in PyTorch, with optax's formulas.

The registry of `optimizers.py` builds its first-order optimizers from
these: each is a `GradientTransformation` (init(params) -> state,
update(updates, state, params) -> (updates, state)) over a list of
tensors, as optax's are over a pytree, and `TransformOptimizer` applies
one to a list of parameters (p += u, as `optax.apply_updates`).

- optax 0.2.6's families, each its own formula and order of operations
  (`optax/_src/{alias,transform,factorized}.py`, `optax/transforms`), not
  `torch.optim`'s: rmsprop scales by rsqrt(nu + eps); adagrad's
  accumulator starts at 0.1 with where(t > 0, rsqrt(t + eps), 0); adamw
  decays by 1e-4; adafactor factors only dimensions >= 128; bias
  corrections count from 1, their powers in f32. `noisy_sgd` draws its
  noise from a torch.Generator or takes the draws.
- maua_tpu's own transforms (`maua_tpu/optimizers.py`): accsgd, adabound,
  adamod, adamp, sgdp, aggmo, diffgrad, pid, qhadam, qhm, swats, shampoo,
  in maua_tpu's order of operations.

Counts live on the host; the scalars of a step (bias corrections,
schedules) are numpy float32, as optax computes them in f32 on the device.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Iterator, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

f32 = np.float32
Tensors = List[torch.Tensor]


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def _zeros(params: Tensors) -> Tensors:
    return [torch.zeros_like(p) for p in params]


def _bc(moment: Tensors, decay: float, count: int) -> Tensors:
    """optax.tree.bias_correction: t / (1 - decay^count), the power in f32."""
    c = float(f32(1) - f32(decay) ** f32(count))
    return [t / c for t in moment]


def _moment(g: Tensors, t: Tensors, decay: float, order: int) -> Tensors:
    """optax.tree.update_moment: (1 - decay) g^order + decay t."""
    return [(1 - decay) * (x if order == 1 else x * x) + decay * y for x, y in zip(g, t)]


def stateless(fn: Callable) -> GradientTransformation:
    """A transformation without state: fn(updates, params) -> updates."""
    return GradientTransformation(lambda params: (), lambda u, s, p=None: (fn(u, p), s))


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return [t.init(params) for t in txs]

    def update(updates, state, params=None):
        new = []
        for t, s in zip(txs, state):
            updates, s = t.update(updates, s, params)
            new.append(s)
        return updates, new

    return GradientTransformation(init, update)


def scale(step_size) -> GradientTransformation:
    return stateless(lambda u, p: [step_size * x for x in u])


def scale_by_schedule(step_size_fn: Callable) -> GradientTransformation:
    """optax.scale_by_schedule: updates times step_size_fn(count), count from 0 before the step."""

    def update(u, s, p=None):
        step = float(step_size_fn(s["count"]))
        return [step * x for x in u], {"count": s["count"] + 1}

    return GradientTransformation(lambda p: {"count": 0}, update)


def scale_by_learning_rate(lr, flip_sign: bool = True) -> GradientTransformation:
    """optax.scale_by_learning_rate: a constant, or a schedule (a callable of the step count)."""
    if callable(lr):
        return scale_by_schedule(lambda count: f32(-1 if flip_sign else 1) * f32(lr(count)))
    return scale(-lr if flip_sign else lr)


def cosine_onecycle_schedule(transition_steps: int, peak_value: float, pct_start: float = 0.3,
                             div_factor: float = 25.0, final_div_factor: float = 1e4) -> Callable:
    """optax.cosine_onecycle_schedule: optax's piecewise cosine interpolation between the accumulated
    values at the boundaries {pct_start * steps: div_factor, steps: 1 / (div_factor * final_div_factor)},
    evaluated in f32 as optax evaluates it on the device. A count is a host int."""
    if transition_steps <= 0:
        raise ValueError("A linear onecycle schedule was set with a non-positive `transition_steps`")
    boundaries = (int(pct_start * transition_steps), int(transition_steps))
    scales = (div_factor, 1.0 / (div_factor * final_div_factor))
    bounds = np.array((0,) + boundaries, np.int32)
    values = np.cumprod(np.array((peak_value / div_factor,) + scales))  # f64, cast to f32 where used
    sizes = bounds[1:] - bounds[:-1]
    end = values[1:].astype(f32)
    half = ((values[:-1] - values[1:]) / 2.0).astype(f32)

    def schedule(count):
        count = np.int32(count)
        indicator = ((bounds[:-1] <= count) & (count < bounds[1:])).astype(f32)
        with np.errstate(divide="ignore", invalid="ignore"):
            pct = ((count - bounds[:-1]) / sizes).astype(f32)
        interp = end + half * (np.cos(f32(np.pi) * pct) + f32(1))
        return f32(indicator.dot(interp) + f32(bounds[-1] <= count) * f32(values[-1]))

    return schedule


def _global_norm(updates: Tensors) -> torch.Tensor:
    """optax.tree.norm: the square root of the sum of every leaf's squares."""
    return torch.sqrt(sum(torch.sum(x * x) for x in updates))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """optax.clip_by_global_norm: where the global norm is at least max_norm, (t / norm) * max_norm."""

    def fn(u, p):
        g_norm = _global_norm(u)
        return [torch.where(g_norm < max_norm, x, (x / g_norm.to(x.dtype)) * max_norm) for x in u]

    return stateless(fn)


def set_to_zero() -> GradientTransformation:
    """optax.set_to_zero: zero updates, no state."""
    return stateless(lambda u, p: [torch.zeros_like(x) for x in u])


def multi_transform(transforms: dict, labels: Sequence) -> GradientTransformation:
    """optax.multi_transform over a list: `labels` names each leaf's transformation, and each
    transformation sees only its own leaves (in order), as optax masks the others out."""
    groups = {name: [i for i, lab in enumerate(labels) if lab == name] for name in transforms}

    def pick(xs, idx):
        return None if xs is None else [xs[i] for i in idx]

    def init(params):
        return {name: tx.init(pick(params, groups[name])) for name, tx in transforms.items()}

    def update(updates, state, params=None):
        out, new = list(updates), {}
        for name, tx in transforms.items():
            idx = groups[name]
            part, new[name] = tx.update(pick(updates, idx), state[name], pick(params, idx))
            for i, x in zip(idx, part):
                out[i] = x
        return out, new

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay) -> GradientTransformation:
    return stateless(lambda u, p: [x + weight_decay * y for x, y in zip(u, p)])


def trace(decay: float, nesterov: bool = False) -> GradientTransformation:
    def update(u, s, p=None):
        t = [g + decay * x for g, x in zip(u, s["trace"])]
        out = [g + decay * x for g, x in zip(u, t)] if nesterov else t
        return out, {"trace": t}

    return GradientTransformation(lambda p: {"trace": _zeros(p)}, update)


def centralize() -> GradientTransformation:
    return stateless(lambda u, p: [g - g.mean(tuple(range(1, g.dim())), keepdim=True) if g.dim() > 1 else g
                                   for g in u])


def _safe_norm(x: torch.Tensor, min_norm: float) -> torch.Tensor:
    n = torch.linalg.vector_norm(x)
    return torch.where(n <= min_norm, torch.as_tensor(min_norm, dtype=n.dtype, device=n.device), n)


def scale_by_trust_ratio(min_norm: float = 0.0, trust_coefficient: float = 1.0, eps: float = 0.0):
    def one(u, p):
        pn, un = _safe_norm(p, min_norm), _safe_norm(u, min_norm)
        ratio = trust_coefficient * pn / (un + eps)
        return u * torch.where((pn == 0.0) | (un == 0.0), torch.ones_like(ratio), ratio)

    return stateless(lambda u, p: [one(x, y) for x, y in zip(u, p)])


def _adam_like(b1, b2, eps, eps_root, nesterov, count, mu, nu, g):
    """mu_hat / (sqrt(nu_hat + eps_root) + eps) of scale_by_adam (and its nesterov form)."""
    if nesterov:
        mu_hat = [b1 * m + (1 - b1) * x for m, x in zip(_bc(mu, b1, count + 1), _bc(g, b1, count))]
    else:
        mu_hat = _bc(mu, b1, count)
    return [m / (torch.sqrt(v + eps_root) + eps) for m, v in zip(mu_hat, _bc(nu, b2, count))]


def scale_by_adam(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, nesterov=False) -> GradientTransformation:
    def update(g, s, p=None):
        mu, nu, count = _moment(g, s["mu"], b1, 1), _moment(g, s["nu"], b2, 2), s["count"] + 1
        return _adam_like(b1, b2, eps, eps_root, nesterov, count, mu, nu, g), {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(lambda p: {"count": 0, "mu": _zeros(p), "nu": _zeros(p)}, update)


def scale_by_amsgrad(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0) -> GradientTransformation:
    def update(g, s, p=None):
        mu, nu, count = _moment(g, s["mu"], b1, 1), _moment(g, s["nu"], b2, 2), s["count"] + 1
        nu_max = [torch.maximum(a, b) for a, b in zip(s["nu_max"], _bc(nu, b2, count))]
        out = [m / (torch.sqrt(v + eps_root) + eps) for m, v in zip(_bc(mu, b1, count), nu_max)]
        return out, {"count": count, "mu": mu, "nu": nu, "nu_max": nu_max}

    return GradientTransformation(lambda p: {"count": 0, "mu": _zeros(p), "nu": _zeros(p), "nu_max": _zeros(p)},
                                  update)


def scale_by_adamax(b1=0.9, b2=0.999, eps=1e-8) -> GradientTransformation:
    def update(g, s, p=None):
        count = s["count"] + 1
        mu = _moment(g, s["mu"], b1, 1)
        nu = [torch.maximum(x.abs() + eps, b2 * t) for x, t in zip(g, s["nu"])]
        return [m / v for m, v in zip(_bc(mu, b1, count), nu)], {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(lambda p: {"count": 0, "mu": _zeros(p), "nu": _zeros(p)}, update)


def scale_by_rss(initial_accumulator_value=0.1, eps=1e-7) -> GradientTransformation:
    def update(g, s, p=None):
        ss = [x * x + t for x, t in zip(g, s["sum_of_squares"])]
        inv = [torch.where(t > 0, torch.rsqrt(t + eps), 0.0) for t in ss]
        return [a * x for a, x in zip(inv, g)], {"sum_of_squares": ss}

    return GradientTransformation(
        lambda p: {"sum_of_squares": [torch.full_like(x, initial_accumulator_value) for x in p]}, update)


def scale_by_rms(decay=0.9, eps=1e-8, initial_scale=0.0) -> GradientTransformation:
    def update(g, s, p=None):
        nu = _moment(g, s["nu"], decay, 2)
        return [torch.rsqrt(n + eps) * x for n, x in zip(nu, g)], {"nu": nu}

    return GradientTransformation(lambda p: {"nu": [torch.full_like(x, initial_scale) for x in p]}, update)


def scale_by_adadelta(rho=0.9, eps=1e-6) -> GradientTransformation:
    def update(g, s, p=None):
        e_g = _moment(g, s["e_g"], rho, 2)
        out = [(torch.sqrt(ex + eps) / torch.sqrt(eg + eps)) * x for x, eg, ex in zip(g, e_g, s["e_x"])]
        return out, {"e_g": e_g, "e_x": _moment(out, s["e_x"], rho, 2)}

    return GradientTransformation(lambda p: {"e_g": _zeros(p), "e_x": _zeros(p)}, update)


def scale_by_belief(b1=0.9, b2=0.999, eps=1e-16, eps_root=1e-16) -> GradientTransformation:
    def update(g, s, p=None):
        mu = _moment(g, s["mu"], b1, 1)
        nu = [v + eps_root for v in _moment([x - m for x, m in zip(g, mu)], s["nu"], b2, 2)]
        count = s["count"] + 1
        out = [m / (torch.sqrt(v) + eps) for m, v in zip(_bc(mu, b1, count), _bc(nu, b2, count))]
        return out, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(lambda p: {"count": 0, "mu": _zeros(p), "nu": _zeros(p)}, update)


def _decay_rate_pow(i: int, exponent: float = 0.8) -> np.float32:
    return f32(1.0) - f32(i + 1) ** f32(-exponent)


def _factored_dims(shape, factored: bool, min_dim_size_to_factor: int):
    if not factored or len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


def scale_by_factored_rms(factored=True, decay_rate=0.8, step_offset=0, min_dim_size_to_factor=128, epsilon=1e-30):
    """Adafactor's factored second moment: row and column means of g^2 + eps for a parameter whose
    second-largest dimension is >= min_dim_size_to_factor, the full moment otherwise."""

    def init(params):
        out = []
        for p in params:
            dims = _factored_dims(tuple(p.shape), factored, min_dim_size_to_factor)
            if dims is None:
                out.append({"v": torch.zeros_like(p)})
            else:
                d1, d0 = dims
                out.append({"v_row": p.new_zeros(np.delete(p.shape, d0).tolist()),
                            "v_col": p.new_zeros(np.delete(p.shape, d1).tolist())})
        return {"count": 0, "leaves": out}

    def update(g, s, params=None):
        d = float(_decay_rate_pow(s["count"] - step_offset, decay_rate))
        out, leaves = [], []
        for x, st in zip(g, s["leaves"]):
            dims = _factored_dims(tuple(x.shape), factored, min_dim_size_to_factor)
            sq = x * x + epsilon
            if dims is None:
                v = d * st["v"] + (1.0 - d) * sq
                out.append(x * v ** -0.5)
                leaves.append({"v": v})
                continue
            d1, d0 = dims
            v_row = d * st["v_row"] + (1.0 - d) * sq.mean(d0)
            v_col = d * st["v_col"] + (1.0 - d) * sq.mean(d1)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (v_row / v_row.mean(reduced_d1, keepdim=True)) ** -0.5
            out.append(x * row_factor.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1))
            leaves.append({"v_row": v_row, "v_col": v_col})
        return out, {"count": s["count"] + 1, "leaves": leaves}

    return GradientTransformation(init, update)


def ema(decay: float) -> GradientTransformation:
    """optax.ema(decay, debias=False): the exponential moving average of the updates."""

    def update(u, s, p=None):
        e = _moment(u, s["ema"], decay, 1)
        return e, {"ema": e}

    return GradientTransformation(lambda p: {"ema": _zeros(p)}, update)


def clip_by_block_rms(threshold: float) -> GradientTransformation:
    return stateless(lambda u, p: [x / torch.clamp_min(torch.sqrt((x * x).mean()) / threshold, 1.0) for x in u])


def scale_by_param_block_rms(min_scale: float = 1e-3) -> GradientTransformation:
    def rms(p):
        r = torch.sqrt((p * p).mean())
        return torch.where(r <= min_scale, torch.as_tensor(min_scale, dtype=r.dtype, device=r.device), r)

    return stateless(lambda u, p: [x * rms(y) for x, y in zip(u, p)])


def scale_by_adan(b1=0.98, b2=0.92, b3=0.99, eps=1e-8, eps_root=1e-8) -> GradientTransformation:
    def update(g, s, p=None):
        diff = [torch.zeros_like(x) for x in g] if s["t"] == 0 else [x - y for x, y in zip(g, s["g"])]
        m = _moment(g, s["m"], b1, 1)
        v = _moment(diff, s["v"], b2, 1)
        n = _moment([x + (1 - b2) * y for x, y in zip(g, diff)], s["n"], b3, 2)
        t = s["t"] + 1
        u = [a + (1 - b2) * b for a, b in zip(_bc(m, b1, t), _bc(v, b2, t))]
        out = [a / (torch.sqrt(c + eps_root) + eps) for a, c in zip(u, _bc(n, b3, t))]
        return out, {"m": m, "v": v, "n": n, "g": list(g), "t": t}

    return GradientTransformation(lambda p: {"m": _zeros(p), "v": _zeros(p), "n": _zeros(p), "g": _zeros(p), "t": 0},
                                  update)


def scale_by_lion(b1=0.9, b2=0.99) -> GradientTransformation:
    def update(g, s, p=None):
        out = [torch.sign((1.0 - b1) * x + b1 * m) for x, m in zip(g, s["mu"])]
        return out, {"count": s["count"] + 1, "mu": _moment(g, s["mu"], b2, 1)}

    return GradientTransformation(lambda p: {"count": 0, "mu": _zeros(p)}, update)


def scale_by_radam(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, threshold=5.0) -> GradientTransformation:
    ro_inf = 2.0 / (1.0 - b2) - 1.0

    def update(g, s, p=None):
        mu, nu, count = _moment(g, s["mu"], b1, 1), _moment(g, s["nu"], b2, 2), s["count"] + 1
        b2t = f32(b2) ** f32(count)
        ro = f32(ro_inf) - f32(2 * count) * b2t / (f32(1) - b2t)
        mu_hat, nu_hat = _bc(mu, b1, count), _bc(nu, b2, count)
        if ro >= threshold:
            # optax's operands: the f32 ro against ro_inf's Python-float products
            r = float(np.sqrt((ro - f32(4.0)) * (ro - f32(2.0)) * f32(ro_inf)
                              / (f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro)))
            out = [r * m / (torch.sqrt(v + eps_root) + eps) for m, v in zip(mu_hat, nu_hat)]
        else:
            out = mu_hat
        return out, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(lambda p: {"count": 0, "mu": _zeros(p), "nu": _zeros(p)}, update)


def scale_by_novograd(b1=0.9, b2=0.25, eps=1e-6, eps_root=0.0, weight_decay=0.0) -> GradientTransformation:
    def update(g, s, params):
        count = s["count"] + 1
        sq = [torch.linalg.vector_norm(x) ** 2 for x in g]
        nu = sq if count == 1 else _moment(sq, s["nu"], b2, 1)
        add = [x / (torch.sqrt(n + eps_root) + eps) + weight_decay * p for x, n, p in zip(g, nu, params)]
        mu = add if count == 1 else [b1 * m + a for m, a in zip(s["mu"], add)]
        return mu, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(lambda p: {"count": 0, "mu": _zeros(p), "nu": [x.new_zeros(()) for x in p]},
                                  update)


def scale_by_yogi(b1=0.9, b2=0.999, eps=1e-3, eps_root=0.0, initial_accumulator_value=1e-6):
    def update(g, s, p=None):
        mu = _moment(g, s["mu"], b1, 1)
        nu = [v - (1 - b2) * torch.sign(v - x * x) * (x * x) for x, v in zip(g, s["nu"])]
        count = s["count"] + 1
        out = [m / (torch.sqrt(v + eps_root) + eps) for m, v in zip(_bc(mu, b1, count), _bc(nu, b2, count))]
        return out, {"count": count, "mu": mu, "nu": nu}

    full = lambda p: [torch.full_like(x, initial_accumulator_value) for x in p]  # noqa: E731
    return GradientTransformation(lambda p: {"count": 0, "mu": full(p), "nu": full(p)}, update)


def scale_by_sm3(b1=0.9, b2=1.0, eps=1e-8) -> GradientTransformation:
    coeffs = ((1.0 - b2) if b2 != 1.0 else 1.0, b2)

    def expanded(v, i, ndim):
        shape = [1] * ndim
        shape[i] = -1
        return v.reshape(shape)

    def update(g, s, p=None):
        nu, mu = [], []
        for x, vs, n in zip(g, s["mu"], s["nu"]):
            v = [expanded(vs[i], i, x.dim()) for i in range(x.dim())]
            if x.dim() < 2:
                acc = coeffs[0] * x**2 + coeffs[1] * v[0]
            else:
                acc = coeffs[0] * x**2 + coeffs[1] * functools.reduce(torch.minimum, v)
            up = x * torch.where(acc > 0, torch.rsqrt(acc + eps), 0.0)
            nu.append((1 - b1) * up + b1 * n)
            mu.append([acc if x.dim() < 2 else acc.amax([j for j in range(x.dim()) if j != i])
                       for i in range(x.dim())])
        return nu, {"mu": mu, "nu": nu}

    return GradientTransformation(lambda p: {"mu": [[x.new_zeros(d) for d in x.shape] for x in p], "nu": _zeros(p)},
                                  update)


def add_noise(eta: float, gamma: float, gen: Optional[torch.Generator] = None,
              draws: Optional[Iterator[Sequence[torch.Tensor]]] = None) -> GradientTransformation:
    """g + sqrt(eta / t^gamma) N(0, 1): the normals from `draws` (one list per step) where given,
    else from `gen` (seed 0 on the updates' device)."""

    def update(g, s, p=None):
        count = s["count"] + 1
        std = float(np.sqrt(f32(eta) / f32(count) ** f32(gamma)))
        gen_ = s["gen"]
        if draws is not None:
            noise = [torch.as_tensor(n, dtype=x.dtype, device=x.device) for n, x in zip(next(draws), g)]
        else:
            if gen_ is None:
                gen_ = torch.Generator(device=g[0].device).manual_seed(0)
            noise = [torch.randn(x.shape, generator=gen_, device=x.device, dtype=x.dtype) for x in g]
        return [x + std * n for x, n in zip(g, noise)], {"count": count, "gen": gen_}

    return GradientTransformation(lambda p: {"count": 0, "gen": gen}, update)


def scale_by_optimistic_gradient(alpha=1.0, beta=1.0) -> GradientTransformation:
    def update(g, s, p=None):
        prev = list(g) if s["initial"] else s["prev"]
        return [(alpha + beta) * x - beta * y for x, y in zip(g, prev)], {"initial": False, "prev": list(g)}

    return GradientTransformation(lambda p: {"initial": True, "prev": _zeros(p)}, update)


def scale_by_rprop(learning_rate, eta_minus=0.5, eta_plus=1.2, min_step_size=1e-6, max_step_size=50.0):
    def update(g, s, p=None):
        sign = [x * y for x, y in zip(g, s["prev"])]
        steps = [torch.where(sg == 0, st, (st * torch.where(sg > 0, eta_plus, eta_minus))
                             .clamp(min_step_size, max_step_size)) for sg, st in zip(sign, s["steps"])]
        prev = [torch.where(sg < 0, torch.zeros_like(x), st * torch.sign(x)) for sg, x, st in zip(sign, g, steps)]
        # optax applies the previous step's signed steps (its lambda's third operand is the old state)
        out = [torch.where(sg < 0, torch.zeros_like(pp), pp) for sg, pp in zip(sign, s["prev"])]
        return out, {"steps": steps, "prev": prev}

    return GradientTransformation(lambda p: {"steps": [torch.full_like(x, learning_rate) for x in p],
                                             "prev": _zeros(p)}, update)


# ---------------------------------------------------------------- optax's aliases
def adam(lr, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, *, nesterov=False):
    return chain(scale_by_adam(b1, b2, eps, eps_root, nesterov), scale_by_learning_rate(lr))


def adamw(lr, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, weight_decay=1e-4, *, nesterov=False):
    return chain(scale_by_adam(b1, b2, eps, eps_root, nesterov), add_decayed_weights(weight_decay),
                 scale_by_learning_rate(lr))


nadam = functools.partial(adam, nesterov=True)
nadamw = functools.partial(adamw, nesterov=True)


def adamax(lr, b1=0.9, b2=0.999, eps=1e-8):
    return chain(scale_by_adamax(b1, b2, eps), scale_by_learning_rate(lr))


def adamaxw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4):
    return chain(scale_by_adamax(b1, b2, eps), add_decayed_weights(weight_decay), scale_by_learning_rate(lr))


def amsgrad(lr, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0):
    return chain(scale_by_amsgrad(b1, b2, eps, eps_root), scale_by_learning_rate(lr))


def adagrad(lr, initial_accumulator_value=0.1, eps=1e-7):
    return chain(scale_by_rss(initial_accumulator_value, eps), scale_by_learning_rate(lr))


def adadelta(lr=None, rho=0.9, eps=1e-6, weight_decay=0.0):
    txs = [add_decayed_weights(weight_decay), scale_by_adadelta(rho, eps)]
    return chain(*txs, *([] if lr is None else [scale_by_learning_rate(lr)]))


def adabelief(lr, b1=0.9, b2=0.999, eps=1e-16, eps_root=1e-16):
    return chain(scale_by_belief(b1, b2, eps, eps_root), scale_by_learning_rate(lr))


def adafactor(lr=None, min_dim_size_to_factor=128, decay_rate=0.8, decay_offset=0, multiply_by_parameter_scale=True,
              clipping_threshold=1.0, momentum=None, weight_decay_rate=None, eps=1e-30, factored=True):
    tx = [scale_by_factored_rms(factored, decay_rate, decay_offset, min_dim_size_to_factor, eps)]
    if clipping_threshold is not None:
        tx.append(clip_by_block_rms(clipping_threshold))
    if lr is not None:
        tx.append(scale_by_learning_rate(lr, flip_sign=False))
    if multiply_by_parameter_scale:
        tx.append(scale_by_param_block_rms())
    if momentum is not None:
        tx.append(ema(momentum))
    if weight_decay_rate is not None:
        tx.append(add_decayed_weights(weight_decay_rate))
    tx.append(scale(-1))
    return chain(*tx)


def adan(lr, b1=0.98, b2=0.92, b3=0.99, eps=1e-8, eps_root=1e-8, weight_decay=0.0):
    return chain(scale_by_adan(b1, b2, b3, eps, eps_root), add_decayed_weights(weight_decay),
                 scale_by_learning_rate(lr))


def sgd(lr, momentum=None, nesterov=False):
    return chain(*([] if momentum is None else [trace(momentum, nesterov)]), scale_by_learning_rate(lr))


def rmsprop(lr, decay=0.9, eps=1e-8, initial_scale=0.0, momentum=None, nesterov=False):
    return chain(scale_by_rms(decay, eps, initial_scale), scale_by_learning_rate(lr),
                 *([] if momentum is None else [trace(momentum, nesterov)]))


def lamb(lr, b1=0.9, b2=0.999, eps=1e-6, eps_root=0.0, weight_decay=0.0):
    return chain(scale_by_adam(b1, b2, eps, eps_root), add_decayed_weights(weight_decay), scale_by_trust_ratio(),
                 scale_by_learning_rate(lr))


def lars(lr, weight_decay=0.0, trust_coefficient=0.001, eps=0.0, momentum=0.9, nesterov=False):
    return chain(add_decayed_weights(weight_decay), scale_by_trust_ratio(trust_coefficient=trust_coefficient, eps=eps),
                 scale_by_learning_rate(lr), trace(momentum, nesterov))


def lion(lr, b1=0.9, b2=0.99, weight_decay=1e-3):
    return chain(scale_by_lion(b1, b2), add_decayed_weights(weight_decay), scale_by_learning_rate(lr))


def radam(lr, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, threshold=5.0):
    return chain(scale_by_radam(b1, b2, eps, eps_root, threshold), scale_by_learning_rate(lr))


def novograd(lr, b1=0.9, b2=0.25, eps=1e-6, eps_root=0.0, weight_decay=0.0):
    return chain(scale_by_novograd(b1, b2, eps, eps_root, weight_decay), scale_by_learning_rate(lr))


def yogi(lr, b1=0.9, b2=0.999, eps=1e-3):
    return chain(scale_by_yogi(b1, b2, eps), scale_by_learning_rate(lr))


def fromage(lr, min_norm=1e-6):
    mult = f32(1) / np.sqrt(f32(1) + f32(lr) ** 2)  # optax: 1 / jnp.sqrt(1 + lr**2), in f32
    return chain(scale_by_trust_ratio(min_norm), scale_by_learning_rate(float(f32(lr) * mult)),
                 add_decayed_weights(float(mult - f32(1))))


def sm3(lr, momentum=0.9):
    return chain(scale_by_sm3(momentum), scale(-lr))


def noisy_sgd(lr, eta=0.01, gamma=0.55, gen=None, draws=None):
    return chain(add_noise(eta, gamma, gen, draws), scale_by_learning_rate(lr))


def optimistic_gradient_descent(lr, alpha=1.0, beta=1.0):
    return chain(scale_by_optimistic_gradient(alpha, beta), scale_by_learning_rate(lr))


def rprop(lr, eta_minus=0.5, eta_plus=1.2, min_step_size=1e-6, max_step_size=50.0):
    return chain(scale_by_rprop(lr, eta_minus, eta_plus, min_step_size, max_step_size), scale(-1.0))


# ---------------------------------------------------------------- maua_tpu's own transforms
def _adam_moments(b1, b2):
    """maua_tpu's Adam moments: m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, corrected by
    1 - b^count in f32."""

    def init(params):
        return {"m": _zeros(params), "v": _zeros(params), "count": 0}

    def moments(g, s):
        count = s["count"] + 1
        m = [b1 * a + (1 - b1) * x for a, x in zip(s["m"], g)]
        v = [b2 * a + (1 - b2) * x * x for a, x in zip(s["v"], g)]
        return m, v, _bc(m, b1, count), _bc(v, b2, count), count

    return init, moments


def adabound(lr=1e-3, final_lr=0.1, b1=0.9, b2=0.999, gamma=1e-3, eps=1e-8):
    """AdaBound: Adam with the per-element step size clipped into a band converging to final_lr."""
    init, moments = _adam_moments(b1, b2)

    def update(g, s, p=None):
        m, v, mhat, vhat, count = moments(g, s)
        t = f32(count)
        lower = float(f32(final_lr) * (f32(1) - f32(1) / (f32(gamma) * t + f32(1))))
        upper = float(f32(final_lr) * (f32(1) + f32(1) / (f32(gamma) * t)))
        out = [-(lr / (torch.sqrt(vh) + eps)).clamp(lower, upper) * mh for mh, vh in zip(mhat, vhat)]
        return out, {"m": m, "v": v, "count": count}

    return GradientTransformation(init, update)


def adamod(lr=1e-3, b1=0.9, b2=0.999, b3=0.999, eps=1e-8):
    """AdaMod: Adam with an exponential long-term memory bound on the adaptive learning rate."""
    init_m, moments = _adam_moments(b1, b2)

    def update(g, s, p=None):
        m, v, mhat, vhat, count = moments(g, s)
        out, ss = [], []
        for mh, vh, s_ in zip(mhat, vhat, s["s"]):
            eta = lr / (torch.sqrt(vh) + eps)
            s_new = b3 * s_ + (1 - b3) * eta
            out.append(-torch.minimum(eta, s_new) * mh)
            ss.append(s_new)
        return out, {"m": m, "v": v, "count": count, "s": ss}

    return GradientTransformation(lambda p: {**init_m(p), "s": _zeros(p)}, update)


def diffgrad(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8):
    """diffGrad: the Adam step scaled by sigmoid(|g_prev - g|)."""
    init_m, moments = _adam_moments(b1, b2)

    def update(g, s, p=None):
        m, v, mhat, vhat, count = moments(g, s)
        out = [-lr * torch.sigmoid((pg - x).abs()) * mh / (torch.sqrt(vh) + eps)
               for mh, vh, x, pg in zip(mhat, vhat, g, s["prev_g"])]
        return out, {"m": m, "v": v, "count": count, "prev_g": list(g)}

    return GradientTransformation(lambda p: {**init_m(p), "prev_g": _zeros(p)}, update)


def qhm(lr=1e-3, b=0.999, nu=0.7):
    """Quasi-hyperbolic momentum."""

    def update(g, s, p=None):
        m = [b * a + (1 - b) * x for a, x in zip(s["m"], g)]
        return [-lr * (nu * a + (1 - nu) * x) for a, x in zip(m, g)], {"m": m}

    return GradientTransformation(lambda p: {"m": _zeros(p)}, update)


def qhadam(lr=1e-3, b1=0.995, b2=0.999, nu1=0.7, nu2=1.0, eps=1e-8):
    """QHAdam."""
    init_m, moments = _adam_moments(b1, b2)

    def update(g, s, p=None):
        m, v, mhat, vhat, count = moments(g, s)
        out = [-lr * (nu1 * mh + (1 - nu1) * x) / (torch.sqrt(nu2 * vh + (1 - nu2) * x * x) + eps)
               for mh, vh, x in zip(mhat, vhat, g)]
        return out, {"m": m, "v": v, "count": count}

    return GradientTransformation(init_m, update)


def pid(lr=1e-3, momentum=0.9, integral=5.0, derivative=10.0):
    """PID: P = grad, I = a momentum buffer, D = the gradient's difference (0 at the first step)."""

    def update(g, s, p=None):
        i_buf = [momentum * a + x for a, x in zip(s["i"], g)]
        first = 1.0 if s["count"] == 0 else 0.0
        d_buf = [(1 - first) * (x - pg) for x, pg in zip(g, s["prev_g"])]
        out = [-lr * (x + integral * i + derivative * d) for x, i, d in zip(g, i_buf, d_buf)]
        return out, {"i": i_buf, "prev_g": list(g), "count": s["count"] + 1}

    return GradientTransformation(lambda p: {"i": _zeros(p), "prev_g": _zeros(p), "count": 0}, update)


def aggmo(lr=1e-3, betas=(0.0, 0.9, 0.99)):
    """Aggregated momentum: the mean of momentum buffers with different betas."""

    def update(g, s, p=None):
        ms = [[b * a + x for a, x in zip(mb, g)] for b, mb in zip(betas, s["m"])]
        k = float(len(betas))
        return [-lr / k * sum(bufs) for bufs in zip(*ms)], {"m": ms}

    return GradientTransformation(lambda p: {"m": [_zeros(p) for _ in betas]}, update)


def _project_radial(step, param, grad, eps=1e-8, delta=0.1):
    """AdamP / SGDP: drop the radial part of the step where cos(g, p) is small (scale invariance)."""
    if param.dim() == 0:
        return step
    p_flat, g_flat, s_flat = param.reshape(-1), grad.reshape(-1), step.reshape(-1)
    p_n = p_flat / (torch.linalg.vector_norm(p_flat) + eps)
    cos = torch.dot(p_n, g_flat).abs() / (torch.linalg.vector_norm(g_flat) + eps)
    projected = s_flat - torch.dot(s_flat, p_n) * p_n
    use_proj = cos < delta / math.sqrt(float(p_flat.shape[0]))
    return torch.where(use_proj, projected, s_flat).reshape(step.shape)


def adamp(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8):
    """AdamP."""
    init_m, moments = _adam_moments(b1, b2)

    def update(g, s, params=None):
        m, v, mhat, vhat, count = moments(g, s)
        out = [-lr * mh / (torch.sqrt(vh) + eps) for mh, vh in zip(mhat, vhat)]
        if params is not None:
            out = [_project_radial(a, p, x) for a, p, x in zip(out, params, g)]
        return out, {"m": m, "v": v, "count": count}

    return GradientTransformation(init_m, update)


def sgdp(lr=1e-3, momentum=0.9):
    """SGDP."""

    def update(g, s, params=None):
        m = [momentum * a + x for a, x in zip(s["m"], g)]
        out = [-lr * a for a in m]
        if params is not None:
            out = [_project_radial(a, p, x) for a, p, x in zip(out, params, g)]
        return out, {"m": m}

    return GradientTransformation(lambda p: {"m": _zeros(p)}, update)


def accsgd(lr=1e-3, kappa=1000.0, xi=10.0, small_const=0.7):
    """AccSGD (the step as p_new - p, the momentum starting at the parameters)."""
    large = xi * small_const * small_const
    alpha = 1.0 - large * large * small_const / kappa
    beta = 1.0 - alpha
    zeta = small_const / (small_const + beta)

    def update(g, s, params):
        out, mom = [], []
        for x, mo, p in zip(g, s["momentum"], params):
            mom_new = alpha * mo + (1.0 - alpha) * (p - (kappa / large) * lr * x)
            p_new = zeta * (p - lr * x) + (1.0 - zeta) * mom_new
            out.append(p_new - p)
            mom.append(mom_new)
        return out, {"momentum": mom}

    return GradientTransformation(lambda p: {"momentum": [x.detach().clone() for x in p]}, update)


def swats(lr=1e-3, switch_step=100, b1=0.9, b2=0.999, eps=1e-8):
    """SWATS, simplified as in maua_tpu: Adam for switch_step steps, momentum SGD after."""
    init_m, moments = _adam_moments(b1, b2)

    def update(g, s, p=None):
        m, v, mhat, vhat, count = moments(g, s)
        use_adam = 1.0 if count <= switch_step else 0.0
        out = [-lr * (use_adam * mh / (torch.sqrt(vh) + eps) + (1 - use_adam) * a) for mh, vh, a in zip(mhat, vhat, m)]
        return out, {"m": m, "v": v, "count": count}

    return GradientTransformation(init_m, update)


def shampoo(lr=1e-3, update_preconditioner_every=1, eps=1e-6, momentum=0.9):
    """Basic Shampoo: L^-1/4 G R^-1/4 for matrices (L, R the running sums of G G^T and G^T G),
    adagrad for other shapes, then momentum."""

    def inv_quarter(M):
        w, U = torch.linalg.eigh(M)
        return (U * torch.clamp_min(w, eps).pow(-0.25)[None]) @ U.T

    def init(params):
        return [{"l": p.new_zeros(p.shape[0], p.shape[0]), "r": p.new_zeros(p.shape[1], p.shape[1]),
                 "m": torch.zeros_like(p)} if p.dim() == 2 else {"acc": torch.zeros_like(p), "m": torch.zeros_like(p)}
                for p in params]

    def update(g, state, p=None):
        out, new = [], []
        for x, s in zip(g, state):
            if x.dim() == 2:
                l, r = s["l"] + x @ x.T, s["r"] + x.T @ x
                eye_l = torch.eye(l.shape[0], dtype=l.dtype, device=l.device)
                eye_r = torch.eye(r.shape[0], dtype=r.dtype, device=r.device)
                pre = inv_quarter(l + eps * eye_l) @ x @ inv_quarter(r + eps * eye_r)
                m = momentum * s["m"] + pre
                out.append(-lr * m)
                new.append({"l": l, "r": r, "m": m})
            else:
                acc = s["acc"] + x * x
                m = momentum * s["m"] + x / (torch.sqrt(acc) + eps)
                out.append(-lr * m)
                new.append({"acc": acc, "m": m})
        return out, new

    return GradientTransformation(init, update)


# ---------------------------------------------------------------- applying a transformation
class TransformOptimizer(torch.optim.Optimizer):
    """A `GradientTransformation` over `params` (tensors that require grad): step() reads their
    gradients (zeros where there is none), updates the transformation's state and adds the
    updates to the parameters, as `optax.apply_updates` does."""

    def __init__(self, params, tx: GradientTransformation):
        super().__init__(params, {})
        self.params: Tensors = [p for g in self.param_groups for p in g["params"]]
        self.tx = tx
        self.tx_state = tx.init([p.detach() for p in self.params])

    @torch.no_grad()
    def step(self, closure: Optional[Callable] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        updates, self.tx_state = self.tx.update(grads, self.tx_state, [p.detach() for p in self.params])
        for p, u in zip(self.params, updates):
            p.add_(u)
        return loss
