"""Optimizers for the style paths: L-BFGS with a zoom linesearch and Adam.

Port of `maua_tpu/optimizers.py` for the names the style paths use:
"lbfgs", "lbfgs-20" and "adam" (optax's update order, `Adam`). `load_optimizer` returns (factory,
n_iters), where factory(params) builds a `torch.optim.Optimizer` over a
list of tensors; every other name of maua_tpu's registry raises
NotImplementedError.

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


class Adam(torch.optim.Optimizer):
    """optax.adam(lr, b1, b2, eps, eps_root) in optax's order of operations: mu = (1 - b1) g + b1 mu,
    nu = (1 - b2) g^2 + b2 nu, p += -lr (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t) + eps_root) + eps).
    (torch.optim.Adam computes the same update in another order, which drifts a few f32 ulps a step.)"""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 eps_root: float = 0.0):
        super().__init__(params, {"lr": lr, "b1": b1, "b2": b2, "eps": eps, "eps_root": eps_root})

    @torch.no_grad()
    def step(self, closure: Optional[Callable] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["count"], st["mu"], st["nu"] = 0, torch.zeros_like(p), torch.zeros_like(p)
                g = p.grad
                st["count"] += 1
                st["mu"] = (1 - b1) * g + b1 * st["mu"]
                st["nu"] = (1 - b2) * g.square() + b2 * st["nu"]
                mu_hat = st["mu"] / float(1 - f32(b1) ** st["count"])
                nu_hat = st["nu"] / float(1 - f32(b2) ** st["count"])
                p.add_(-group["lr"] * (mu_hat / ((nu_hat + group["eps_root"]).sqrt() + group["eps"])))
        return loss


_REGISTRY: Dict[str, Callable] = {
    "adam": lambda lr, **kw: lambda params: Adam(params, lr, **kw),
    "lbfgs": lambda lr, **kw: lambda params: LBFGS(params, lr, **kw),
    "lbfgs-20": lambda lr, **kw: lambda params: LBFGS(params, lr, memory_size=20, **kw),
}

# maua_tpu's other registry names (maua_tpu/optimizers.py): not ported yet
_NOT_PORTED = (
    "accsgd", "adabelief", "adabound", "adadelta", "adafactor", "adagrad", "adamax", "adamaxw", "adamod", "adamp",
    "adamw", "adan", "aggmo", "amsgrad", "diffgrad", "fromage", "fusedadam", "fusedlamb", "fusednovograd", "fusedsgd",
    "lamb", "lars", "lion", "nadam", "nadamw", "noisysgd", "novograd", "nvnovograd", "optimisticgd", "pid",
    "polyaksgd", "qhadam", "qhm", "radam", "ranger", "ranger21", "rangerqh", "rangerva", "rmsprop", "rmsproptf",
    "rprop", "sgd", "sgdp", "sgdw", "shampoo", "sign_sgd", "sm3", "swats", "yogi",
)
optimizer_choices = sorted(_REGISTRY)


def load_optimizer(name: str, lr: float = 0.1, optimizer_kwargs: Optional[Dict[str, Any]] = None,
                   n_iters: int = 512) -> Tuple[Callable[[List[torch.Tensor]], torch.optim.Optimizer], int]:
    """(factory, n_iters) for a registry name, as maua_tpu resolves it (case folded, "_" dropped,
    "-n" read as "-20"): factory(params) builds the optimizer. The names maua_tpu has and the
    port does not yet (the lookahead-* prefix, the custom transforms, shampoo, adahessian, optax's
    other families) raise NotImplementedError."""
    key = name.lower().replace("_", "").replace("-n", "-20")
    if key not in _REGISTRY and name.lower() in _REGISTRY:
        key = name.lower()
    if key in _REGISTRY:
        return _REGISTRY[key](lr, **(optimizer_kwargs or {})), n_iters
    if key.startswith("lookahead-") or key in _NOT_PORTED or name.lower() in _NOT_PORTED or key == "adahessian":
        raise NotImplementedError(f"optimizer {name!r} is not ported yet (maua_tpu/optimizers.py); "
                                  f"ported: {optimizer_choices}")
    raise ValueError(f"unknown optimizer {name}; options: {optimizer_choices}")
