"""The optimizer registry: L-BFGS with a zoom linesearch, Adam, optax's
other families, maua_tpu's own transforms and Lookahead.

Port of `maua_tpu/optimizers.py`: every name of its registry (104 with the
"lookahead-" prefix), `optimizer_choices`, `load_optimizer`'s name rules
and `adahessian_optimizer`. `load_optimizer` returns (factory, n_iters),
where factory(params) builds the optimizer over a list of tensors: "adam"
is `Adam` (optax's update order), "lbfgs" and "lbfgs-20" `LBFGS`, the
other families `transforms.TransformOptimizer` over optax's formula or
maua_tpu's (`transforms.py`), and the lookahead and ranger names a
`Lookahead` over one of those. maua_tpu wraps them in optax.lookahead,
which needs `optax.LookaheadParams` its style paths do not pass, so they
raise there; the port keeps the slow weights in the optimizer.

`LBFGS` is optax 0.2.6's `lbfgs(learning_rate)`, not `torch.optim.LBFGS`
(the two take different steps): the two-loop L-BFGS direction P g
(`scale_by_lbfgs`: a ring buffer of `memory_size` parameter and gradient
differences starting from zeros, the identity scaled by min(1, 1/|g|) at
the first step and by <dw, du> / <du, du> after), scaled by -lr, then
optax's zoom linesearch along it (`scale_by_zoom_linesearch` with
max_linesearch_steps 20 and a first guess of 1: Nocedal and Wright's
interval search and zoom, Armijo or Hager-Zhang approximate decrease,
curvature 0.9, cubic, quadratic or bisection trial points, a safeguarded
step when it fails). `step(closure)` reuses the value and gradient of the
linesearch's accepted point, as `optax.value_and_grad_from_state` does.
The linesearch's scalar algebra runs in numpy float32, as optax's does in
f32; the directions' dot products and updates run on the parameters'
device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import transforms as T

f32 = np.float32
# optax.lbfgs's default linesearch: scale_by_zoom_linesearch(max_linesearch_steps=20, initial_guess_strategy="one")
# at its defaults (tol 0, increase factor 2, slope_rtol 1e-4, curv_rtol 0.9, approx_dec_rtol 1e-6,
# stepsize_precision 1e-5)
MAX_LINESEARCH_STEPS = 20
TOL, INCREASE, SLOPE_RTOL, CURV_RTOL = f32(0.0), f32(2.0), f32(1e-4), f32(0.9)
APPROX_DEC_RTOL, INTERVAL_THRESHOLD = f32(1e-6), f32(1e-5)


def _dot(a: torch.Tensor, b: torch.Tensor) -> np.float32:
    return f32(torch.dot(a, b).item())


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The critical point of the cubic through (a, fa), (b, fb), (c, fc) with slope fpa at a (nan if none)."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    d1 = np.array([[dc**2, -(db**2)], [-(dc**3), db**3]], np.float32)
    A, B = (d1 @ np.array([fb - fa - C * db, fc - fa - C * dc], np.float32)) / denom
    radical = B * B - f32(3.0) * A * C
    return f32(a + (-B + np.sqrt(radical)) / (f32(3.0) * A))


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through (a, fa), (b, fb) with slope fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db**2)
    return f32(a - fpa / (f32(2.0) * B))


class LBFGS(torch.optim.Optimizer):
    """optax.lbfgs(lr, memory_size, scale_init_precond) with its default zoom linesearch, over
    `params` (tensors that require grad). `step(closure)`: closure() zeroes the gradients,
    evaluates the loss, calls backward and returns the loss. Returns the loss at the
    parameters the step started from. After each step `info` holds the step's accepted
    stepsize, its linesearch steps, whether the interval was found, whether the linesearch
    failed, the memory index used and the value at the new parameters."""

    def __init__(self, params, lr: Optional[float] = None, memory_size: int = 10, scale_init_precond: bool = True):
        if memory_size < 1:
            raise ValueError("memory_size must be >= 1")
        super().__init__(params, {"lr": lr})
        self.params: List[torch.Tensor] = [p for g in self.param_groups for p in g["params"]]
        self.memory_size = memory_size
        self.scale_init_precond = scale_init_precond
        n = sum(p.numel() for p in self.params)
        dev = self.params[0].device
        self.count = 0
        self.prev_params = torch.zeros(n, device=dev)
        self.prev_grad = torch.zeros(n, device=dev)
        self.dw = torch.zeros(memory_size, n, device=dev)
        self.du = torch.zeros(memory_size, n, device=dev)
        self.rho = np.zeros(memory_size, np.float32)
        self.value: Optional[np.float32] = None  # the linesearch's last value and gradient
        self.grad: Optional[torch.Tensor] = None
        self.evaluations = 0
        self.info: Dict[str, Any] = {}

    closure_step = True  # step(closure) evaluates the loss itself

    # ---------------------------------------------------------------- flat views
    def _flat(self) -> torch.Tensor:
        return torch.cat([p.detach().reshape(-1) for p in self.params]).float()

    def _set(self, flat: torch.Tensor) -> None:
        with torch.no_grad():
            i = 0
            for p in self.params:
                p.copy_(flat[i:i + p.numel()].view_as(p))
                i += p.numel()

    def _evaluate(self, closure: Callable, flat: torch.Tensor) -> Tuple[np.float32, torch.Tensor]:
        self._set(flat)
        with torch.enable_grad():
            loss = closure()
        self.evaluations += 1
        grad = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1) for p in self.params])
        return f32(float(loss)), grad.detach().float().clone()

    # ---------------------------------------------------------------- L-BFGS direction
    def _direction(self, params: torch.Tensor, grad: torch.Tensor) -> Tuple[torch.Tensor, int]:
        """scale_by_lbfgs: update the memory with this step's differences, then P g."""
        m = self.memory_size
        memory_idx, prev_idx = self.count % m, (self.count - 1) % m
        if self.count > 0:
            dw, du = params - self.prev_params, grad - self.prev_grad
            vdot = _dot(du, dw)
            weight = f32(0.0) if vdot == 0.0 else f32(f32(1.0) / vdot)
        else:
            dw, du, vdot, weight = torch.zeros_like(params), torch.zeros_like(grad), f32(0.0), f32(0.0)
        self.dw[prev_idx], self.du[prev_idx], self.rho[prev_idx] = dw, du, weight
        if self.scale_init_precond:
            if self.count > 0:
                denom = _dot(du, du)
                scale = f32(vdot / denom) if denom > 0.0 else f32(1.0)
            else:
                scale = np.minimum(f32(1.0), f32(1.0) / f32(torch.linalg.vector_norm(grad).item()))
        else:
            scale = f32(1.0)
        order = [(memory_idx + i) % m for i in range(m)]
        vec, alphas = grad.clone(), {}
        for i in reversed(order):  # newest to oldest
            alphas[i] = f32(self.rho[i] * _dot(self.dw[i], vec))
            vec = vec - float(alphas[i]) * self.du[i]
        vec = vec * float(scale)
        for i in order:  # oldest to newest
            beta = f32(self.rho[i] * _dot(self.du[i], vec))
            vec = vec + float(f32(alphas[i] - beta)) * self.dw[i]
        self.count += 1
        self.prev_params, self.prev_grad = params, grad
        return vec, memory_idx

    # ---------------------------------------------------------------- zoom linesearch
    @staticmethod
    def _errors(stepsize, value, slope, value_init, slope_init):
        """The sufficient-decrease error (Armijo, or Hager-Zhang's approximate decrease near a minimum)
        and the curvature error, each 0 when met and inf for nan."""
        dec = value - value_init - SLOPE_RTOL * stepsize * slope_init
        approx = slope - (f32(2.0) * SLOPE_RTOL - f32(1.0)) * slope_init
        delta = value - value_init - APPROX_DEC_RTOL * np.abs(value_init)
        dec = np.maximum(np.minimum(np.maximum(approx, delta), dec), f32(0.0))
        dec = f32(np.inf) if np.isnan(dec) else f32(dec)
        curv = np.maximum(np.abs(slope) - CURV_RTOL * np.abs(slope_init), f32(0.0))
        curv = f32(np.inf) if np.isnan(curv) else f32(curv)
        return dec, curv

    def _linesearch(self, closure, params, updates, value_init, grad_init):
        """scale_by_zoom_linesearch with initial_guess_strategy "one": -> (stepsize, value, grad, info)."""
        tol = TOL
        slope_init = _dot(updates, grad_init)
        s = dict(stepsize=f32(0.0), value=value_init, grad=grad_init, slope=slope_init, dec=f32(np.inf),
                 curv=f32(np.inf), interval_found=False, done=False, failed=False,
                 low=f32(0.0), value_low=value_init, slope_low=slope_init,
                 high=f32(0.0), value_high=value_init, slope_high=slope_init,
                 cubic_ref=f32(0.0), value_cubic_ref=value_init,
                 safe_stepsize=f32(0.0), safe_value=value_init, safe_grad=grad_init)
        count = 0

        def on_line(stepsize):
            v, g = self._evaluate(closure, params + float(stepsize) * updates)
            return v, g, _dot(g, updates)

        while not (s["done"] or s["failed"]):
            if not s["interval_found"]:  # Algorithm 3.5 of Nocedal and Wright
                trial = new = f32(1.0) if count == 0 else f32(INCREASE * s["stepsize"])
                v, g, slope = on_line(new)
                dec, curv = self._errors(new, v, slope, value_init, slope_init)
                err = max(dec, curv)
                if dec <= tol:
                    s["safe_stepsize"], s["safe_value"], s["safe_grad"] = new, v, g
                set_high = bool(dec > 0.0) or (bool(v >= s["value"]) and count > 0)
                set_low = bool(slope >= 0.0) and not set_high
                prev = (s["stepsize"], s["value"], s["slope"])
                if set_low:
                    (s["low"], s["value_low"], s["slope_low"]), (s["high"], s["value_high"], s["slope_high"]) = \
                        (new, v, slope), prev
                else:
                    (s["low"], s["value_low"], s["slope_low"]), (s["high"], s["value_high"], s["slope_high"]) = \
                        prev, (new, v, slope)
                s["cubic_ref"], s["value_cubic_ref"] = s["low"], s["value_low"]
                s["interval_found"] = set_high or set_low or bool(err <= tol)
                s["done"] = bool(err <= tol)
                s["failed"] = (count + 1 >= MAX_LINESEARCH_STEPS) and not s["done"]
            else:  # Algorithm 3.6: zoom
                low, high = s["low"], s["high"]
                delta = f32(np.abs(high - low))
                left, right = min(high, low), max(high, low)
                with np.errstate(all="ignore"):
                    cubic = _cubicmin(low, s["value_low"], s["slope_low"], high, s["value_high"], s["cubic_ref"],
                                      s["value_cubic_ref"])
                    quad = _quadmin(low, s["value_low"], s["slope_low"], high, s["value_high"])
                if bool(cubic > left + f32(0.2) * delta) and bool(cubic < right - f32(0.2) * delta):
                    middle = cubic
                elif bool(quad > left + f32(0.1) * delta) and bool(quad < right - f32(0.1) * delta):
                    middle = quad
                else:
                    middle = f32((low + high) / f32(2.0))
                trial = middle
                v, g, slope = on_line(middle)
                dec, curv = self._errors(middle, v, slope, value_init, slope_init)
                err = max(dec, curv)
                if dec <= tol and bool(v < s["safe_value"]):
                    s["safe_stepsize"], s["safe_value"], s["safe_grad"] = middle, v, g
                done = bool(err <= tol)
                set_high_to_middle = bool(dec > 0.0) or bool(v >= s["value_low"])
                set_high_to_low = bool(slope * (high - low) >= 0.0) and not set_high_to_middle
                mid = (middle, v, slope)
                lo = (low, s["value_low"], s["slope_low"])
                hi = (high, s["value_high"], s["slope_high"])
                new_hi = lo if set_high_to_low else (mid if set_high_to_middle else hi)
                new_lo = lo if set_high_to_middle else mid
                if set_high_to_middle or set_high_to_low:
                    s["cubic_ref"], s["value_cubic_ref"] = high, s["value_high"]
                else:
                    s["cubic_ref"], s["value_cubic_ref"] = low, s["value_low"]
                (s["low"], s["value_low"], s["slope_low"]), (s["high"], s["value_high"], s["slope_high"]) = new_lo, new_hi
                presumably_failed = (count + 1 >= MAX_LINESEARCH_STEPS) or (bool(delta <= INTERVAL_THRESHOLD)
                                                                             and bool(s["safe_stepsize"] > 0.0))
                s["done"], s["failed"] = done, presumably_failed and not done
            s["stepsize"], s["value"], s["grad"], s["slope"], s["dec"], s["curv"] = trial, v, g, slope, dec, curv
            count += 1
            if s["failed"] and (bool(s["safe_stepsize"] > 0.0) or np.isinf(s["dec"])):  # the safeguarded step
                s["stepsize"], s["value"], s["grad"] = s["safe_stepsize"], s["safe_value"], s["safe_grad"]
        return s["stepsize"], s["value"], s["grad"], {"linesearch_steps": count, "interval_found": s["interval_found"],
                                                       "failed": s["failed"], "decrease_error": float(s["dec"]),
                                                       "curvature_error": float(s["curv"])}

    @torch.no_grad()
    def step(self, closure: Callable) -> torch.Tensor:
        params = self._flat()
        if self.value is None or not np.isfinite(self.value):
            self.value, self.grad = self._evaluate(closure, params)
        value, grad = self.value, self.grad
        direction, memory_idx = self._direction(params, grad)
        lr = self.param_groups[0]["lr"]
        updates = direction * -float(lr) if lr is not None else -direction
        stepsize, self.value, self.grad, info = self._linesearch(closure, params, updates, value, grad)
        self._set(params + float(stepsize) * updates)
        self.info = {"stepsize": float(stepsize), "memory_idx": memory_idx, "value": float(self.value), **info}
        return torch.tensor(float(value))


class Adam(T.TransformOptimizer):
    """optax.adam(lr, b1, b2, eps, eps_root) in optax's order of operations: mu = (1 - b1) g + b1 mu,
    nu = (1 - b2) g^2 + b2 nu, p += -lr (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t) + eps_root) + eps).
    (torch.optim.Adam computes the same update in another order, which drifts a few f32 ulps a step.)"""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 eps_root: float = 0.0):
        super().__init__(params, T.adam(lr, b1, b2, eps, eps_root))


class Lookahead:
    """Lookahead over an inner optimizer (optax.lookahead(sync_period, slow_step_size) on plain
    parameters): the fast weights are the parameters the loss sees, the slow weights live here.
    Every `sync_period` inner steps, slow += slow_step_size (fast - slow) and fast = slow. Nested
    (lookahead-ranger), the outer sync also sets the inner slow weights, as optax's nested
    LookaheadParams move together. An inner L-BFGS re-evaluates after a sync, where the
    parameters jumped. `step(closure)` takes a closure when the inner optimizer does."""

    def __init__(self, inner, sync_period: int = 6, slow_step_size: float = 0.5):
        if sync_period < 1:
            raise ValueError("Synchronization period must be >= 1.")
        self.inner = inner
        self.sync_period, self.slow_step_size = sync_period, slow_step_size
        self.params: List[torch.Tensor] = [p for g in inner.param_groups for p in g["params"]]
        self.slow = [p.detach().clone() for p in self.params]
        self.steps_since_sync = 0

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def closure_step(self) -> bool:
        return getattr(self.inner, "closure_step", False)

    @property
    def evaluations(self) -> int:
        return getattr(self.inner, "evaluations", 0)

    def zero_grad(self, set_to_none: bool = True):
        self.inner.zero_grad(set_to_none)

    @torch.no_grad()
    def step(self, closure: Optional[Callable] = None):
        loss = self.inner.step(closure) if (closure is not None or self.closure_step) else self.inner.step()
        self.steps_since_sync = (self.steps_since_sync + 1) % self.sync_period
        if self.steps_since_sync == 0:
            for p, s in zip(self.params, self.slow):
                s.add_(self.slow_step_size * (p - s))
                p.copy_(s)
            if isinstance(self.inner, Lookahead):
                self.inner.slow = [s.clone() for s in self.slow]
            if isinstance(self.inner, LBFGS):
                self.inner.value = None
        return loss


def adahessian_optimizer(loss_fn: Callable, lr: float = 0.1, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-4,
                         gen: Optional[torch.Generator] = None, draws=None):
    """AdaHessian (maua_tpu's `adahessian_optimizer`): (init(params), step(params, state, *args) ->
    (params, state)) over a dict (or list) of tensors, the Hutchinson diagonal |z * (H z)| from a
    jvp of the gradient (`torch.func`), z Rademacher from `draws` (one tree per step) where given,
    else from `gen` (seed 0 on the parameters' device)."""
    draws = iter(draws) if draws is not None else None

    def _map(fn, *trees):
        if isinstance(trees[0], dict):
            return {k: fn(*(t[k] for t in trees)) for k in trees[0]}
        return [fn(*xs) for xs in zip(*trees)]

    def init(params):
        zeros = _map(torch.zeros_like, params)
        return {"m": zeros, "v": _map(torch.zeros_like, params), "count": 0, "gen": gen}

    def step(params, state, *args):
        grad_fn = torch.func.grad(lambda p: loss_fn(p, *args))
        grads = grad_fn(params)
        g_ = state["gen"]
        if draws is not None:
            z = _map(lambda p, d: torch.as_tensor(d, dtype=p.dtype, device=p.device), params, next(draws))
        else:
            if g_ is None:
                leaf = next(iter(params.values())) if isinstance(params, dict) else params[0]
                g_ = torch.Generator(device=leaf.device).manual_seed(0)
            z = _map(lambda p: torch.randint(0, 2, p.shape, generator=g_, device=p.device).to(p.dtype) * 2 - 1,
                     params)
        _, hz = torch.func.jvp(grad_fn, (params,), (z,))
        hdiag = _map(lambda a, b: (a * b).abs(), z, hz)
        count = state["count"] + 1
        c1, c2 = float(f32(1) - f32(b1) ** f32(count)), float(f32(1) - f32(b2) ** f32(count))
        m = _map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        v = _map(lambda v_, h: b2 * v_ + (1 - b2) * h * h, state["v"], hdiag)
        new = _map(lambda p, m_, v_: p - lr * (m_ / c1) / (torch.sqrt(v_ / c2) + eps), params, m, v)
        return new, {"m": m, "v": v, "count": count, "gen": g_}

    return init, step


def _tx(build):
    """A registry factory over a gradient transformation: (lr, **kw) -> params -> optimizer."""
    return lambda lr, **kw: lambda params: T.TransformOptimizer(params, build(lr, **kw))


def _lookahead(inner):
    return lambda lr, **kw: lambda params: Lookahead(inner(lr, **kw)(params), sync_period=6, slow_step_size=0.5)


_REGISTRY: Dict[str, Callable] = {
    "adam": lambda lr, **kw: lambda params: Adam(params, lr, **kw),
    "adamw": _tx(T.adamw),
    "adamax": _tx(T.adamax),
    "adamaxw": _tx(T.adamaxw),
    "amsgrad": _tx(T.amsgrad),
    "adagrad": _tx(T.adagrad),
    "adadelta": _tx(T.adadelta),
    "adabelief": _tx(T.adabelief),
    "adafactor": _tx(T.adafactor),
    "adan": _tx(T.adan),
    "sgd": _tx(T.sgd),
    "sgdw": _tx(lambda lr, **kw: T.sgd(lr, momentum=0.9, nesterov=True, **kw)),
    "rmsprop": _tx(T.rmsprop),
    "rmsproptf": _tx(lambda lr, **kw: T.rmsprop(lr, decay=0.9, eps=1e-3, **kw)),
    "lamb": _tx(T.lamb),
    "lars": _tx(T.lars),
    "lion": _tx(T.lion),
    "radam": _tx(T.radam),
    "nadam": _tx(T.nadam),
    "nadamw": _tx(T.nadamw),
    "novograd": _tx(T.novograd),
    "yogi": _tx(T.yogi),
    "fromage": _tx(T.fromage),
    "sm3": _tx(T.sm3),
    "noisysgd": _tx(T.noisy_sgd),
    "optimisticgd": _tx(T.optimistic_gradient_descent),
    "polyaksgd": _tx(T.sgd),
    "rprop": _tx(T.rprop),
    "sign_sgd": _tx(T.sgd),
    "lbfgs": lambda lr, **kw: lambda params: LBFGS(params, lr, **kw),
    "lbfgs-20": lambda lr, **kw: lambda params: LBFGS(params, lr, memory_size=20, **kw),
    # maua_tpu's own transforms
    "accsgd": _tx(T.accsgd),
    "adabound": _tx(T.adabound),
    "adamod": _tx(T.adamod),
    "adamp": _tx(T.adamp),
    "sgdp": _tx(T.sgdp),
    "aggmo": _tx(T.aggmo),
    "diffgrad": _tx(T.diffgrad),
    "pid": _tx(T.pid),
    "qhadam": _tx(T.qhadam),
    "qhm": _tx(T.qhm),
    "swats": _tx(T.swats),
    "shampoo": _tx(T.shampoo),
    # the ranger family: lookahead composites
    "ranger": _lookahead(_tx(T.radam)),
    "rangerqh": _lookahead(_tx(T.qhadam)),
    "rangerva": _lookahead(_tx(T.radam)),
    "ranger21": _lookahead(_tx(lambda lr, **kw: T.chain(T.centralize(), T.adamw(lr, **kw)))),
    # torch's "Fused*" variants are speed clones of the base rule
    "fusedsgd": _tx(lambda lr, **kw: T.sgd(lr, momentum=0.9, **kw)),
    "fusedadam": _tx(T.adam),
    "fusedlamb": _tx(T.lamb),
    "fusednovograd": _tx(T.novograd),
    "nvnovograd": _tx(T.novograd),
}
for _name in list(_REGISTRY):
    _REGISTRY[f"lookahead-{_name}"] = _lookahead(_REGISTRY[_name])

optimizer_choices = sorted(_REGISTRY)


def load_optimizer(name: str, lr: float = 0.1, optimizer_kwargs: Optional[Dict[str, Any]] = None,
                   n_iters: int = 512) -> Tuple[Callable[[List[torch.Tensor]], Any], int]:
    """(factory, n_iters) for a registry name, as maua_tpu resolves it (case folded, "_" dropped and
    "-n" read as "-20", else the case-folded name as given): factory(params) builds the optimizer.
    L-BFGS (and a Lookahead over it) steps with a closure (`closure_step`)."""
    key = name.lower().replace("_", "").replace("-n", "-20")
    if key not in _REGISTRY:
        key2 = name.lower()
        if key2 not in _REGISTRY:
            raise ValueError(f"unknown optimizer {name}; options: {optimizer_choices}")
        key = key2
    return _REGISTRY[key](lr, **(optimizer_kwargs or {})), n_iters
