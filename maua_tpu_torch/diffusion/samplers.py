"""Diffusion samplers in sigma space (the k-diffusion family), as Python loops.

Port of `maua_tpu/diffusion/samplers.py` (euler, euler_ancestral, heun,
dpm_2, dpm_2_ancestral, lms, dpmpp_2m, dpm_fast, dpm_adaptive, and the
DDPM schedule). Each `lax.scan` of the reference is a loop over the
steps here. `sigmas` is a host numpy array; per-step constants (the LMS
quadrature coefficients, ancestral step sizes) are computed on the host
in f64 and applied as f32, as in the reference, so the loop launches
device work only and never waits for the device.

Interface: `denoiser(x, sigma_batch) -> denoised x0`; samplers integrate
from sigmas[0] to sigmas[-1]. The ancestral samplers draw their noise
from `gen`, a torch.Generator on x's device, or take it from `noises`
(one standard-normal tensor per step) so that a test can feed the
reference's draws.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch


def append_dims(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.reshape(tuple(x.shape) + (1,) * (n - x.dim()))


def to_d(x: torch.Tensor, sigma: torch.Tensor, denoised: torch.Tensor) -> torch.Tensor:
    return (x - denoised) / append_dims(sigma, x.dim())


def _f32(values) -> list:
    """Host constants as the f32 values the reference's device arrays hold."""
    return [float(v) for v in np.asarray(values, np.float32)]


def _batch(x: torch.Tensor, value) -> torch.Tensor:
    return torch.full((x.shape[0],), float(value), dtype=torch.float32, device=x.device)


def _ancestral_steps(sigma: np.ndarray, sigma_next: np.ndarray, eta: float = 1.0):
    sigma_up = np.minimum(
        sigma_next, eta * np.sqrt(np.maximum(sigma_next**2 * (sigma**2 - sigma_next**2) / np.maximum(sigma**2, 1e-20), 0))
    )
    sigma_down = np.sqrt(np.maximum(sigma_next**2 - sigma_up**2, 0.0))
    return sigma_down, sigma_up


def _noise(x, i, gen, noises):
    if noises is not None:
        n = noises[i] if isinstance(noises[i], torch.Tensor) else torch.from_numpy(np.array(noises[i], np.float32))
        return n.to(dtype=x.dtype, device=x.device)
    return torch.randn(x.shape, generator=gen, device=x.device, dtype=x.dtype)


def sample_euler(denoiser: Callable, x: torch.Tensor, sigmas: np.ndarray) -> torch.Tensor:
    """Karras et al. 2022, Algorithm 1 without churn."""
    sig = _f32(sigmas)
    for i in range(len(sig) - 1):
        sigma = _batch(x, sig[i])
        d = to_d(x, sigma, denoiser(x, sigma))
        x = x + d * (sig[i + 1] - sig[i])
    return x


def sample_euler_ancestral(denoiser: Callable, x: torch.Tensor, sigmas: np.ndarray,
                           gen: Optional[torch.Generator] = None, eta: float = 1.0,
                           noises: Optional[Sequence] = None) -> torch.Tensor:
    down, up = _ancestral_steps(np.asarray(sigmas)[:-1], np.asarray(sigmas)[1:], eta)
    down, up, sig = _f32(down), _f32(up), _f32(sigmas)
    for i in range(len(sig) - 1):
        sigma = _batch(x, sig[i])
        d = to_d(x, sigma, denoiser(x, sigma))
        x = x + d * (down[i] - sig[i])
        x = x + _noise(x, i, gen, noises) * up[i]
    return x


def sample_heun(denoiser: Callable, x: torch.Tensor, sigmas: np.ndarray) -> torch.Tensor:
    """Karras et al. 2022, Algorithm 1, second order."""
    sig = _f32(sigmas)
    for i in range(len(sig) - 1):
        sigma = _batch(x, sig[i])
        d = to_d(x, sigma, denoiser(x, sigma))
        dt = sig[i + 1] - sig[i]
        if sig[i + 1] == 0:
            x = x + d * dt
        else:
            x_2 = x + d * dt
            sigma_2 = _batch(x, sig[i + 1])
            d_2 = to_d(x_2, sigma_2, denoiser(x_2, sigma_2))
            x = x + (d + d_2) / 2 * dt
    return x


def _log_midpoint(a: float, b: float) -> float:
    """exp((log a + log max(b, 1e-10)) / 2) in f32, as the reference computes it on the device."""
    la, lb = np.log(np.float32(a)), np.log(np.maximum(np.float32(b), np.float32(1e-10)))
    return float(np.exp(np.float32(0.5) * (la + lb)))


def sample_dpm_2(denoiser: Callable, x: torch.Tensor, sigmas: np.ndarray) -> torch.Tensor:
    """DPM-Solver-2: the midpoint in log sigma."""
    sig = _f32(sigmas)
    for i in range(len(sig) - 1):
        sigma = _batch(x, sig[i])
        d = to_d(x, sigma, denoiser(x, sigma))
        if sig[i + 1] == 0:
            x = x + d * (sig[i + 1] - sig[i])
        else:
            sigma_mid = _log_midpoint(sig[i], sig[i + 1])
            x_2 = x + d * (sigma_mid - sig[i])
            s_mid = _batch(x, sigma_mid)
            d_2 = to_d(x_2, s_mid, denoiser(x_2, s_mid))
            x = x + d_2 * (sig[i + 1] - sig[i])
    return x


def sample_dpm_2_ancestral(denoiser: Callable, x: torch.Tensor, sigmas: np.ndarray,
                           gen: Optional[torch.Generator] = None, eta: float = 1.0,
                           noises: Optional[Sequence] = None) -> torch.Tensor:
    down, up = _ancestral_steps(np.asarray(sigmas)[:-1], np.asarray(sigmas)[1:], eta)
    down, up, sig = _f32(down), _f32(up), _f32(sigmas)
    for i in range(len(sig) - 1):
        sigma = _batch(x, sig[i])
        d = to_d(x, sigma, denoiser(x, sigma))
        if down[i] == 0:
            x = x + d * (down[i] - sig[i])
        else:
            sigma_mid = _log_midpoint(sig[i], down[i])
            x_2 = x + d * (sigma_mid - sig[i])
            s_mid = _batch(x, sigma_mid)
            d_2 = to_d(x_2, s_mid, denoiser(x_2, s_mid))
            x = x + d_2 * (down[i] - sig[i])
        x = x + _noise(x, i, gen, noises) * up[i]
    return x


def _lms_coefficients(sigmas: np.ndarray, order: int = 4) -> np.ndarray:
    """Integrated Lagrange-polynomial coefficients of LMS, by quadrature on the host."""
    from scipy import integrate

    n = len(sigmas) - 1
    coeffs = np.zeros((n, order), np.float64)
    for i in range(n):
        cur_order = min(i + 1, order)
        for j in range(cur_order):
            def fn(tau, j=j, i=i, cur_order=cur_order):
                prod = 1.0
                for k in range(cur_order):
                    if k == j:
                        continue
                    prod *= (tau - sigmas[i - k]) / (sigmas[i - j] - sigmas[i - k])
                return prod

            coeffs[i, j] = integrate.quad(fn, sigmas[i], sigmas[i + 1], epsrel=1e-4)[0]
    return coeffs


def sample_lms(denoiser: Callable, x: torch.Tensor, sigmas: np.ndarray, order: int = 4) -> torch.Tensor:
    """Linear multistep over the last `order` derivatives."""
    coeffs = np.asarray(_lms_coefficients(np.asarray(sigmas, np.float64), order), np.float32)
    sig = _f32(sigmas)
    hist = []  # newest first
    for i in range(len(sig) - 1):
        sigma = _batch(x, sig[i])
        hist = [to_d(x, sigma, denoiser(x, sigma))] + hist[: order - 1]
        delta = hist[0] * float(coeffs[i, 0])
        for j in range(1, len(hist)):
            delta = delta + hist[j] * float(coeffs[i, j])
        x = x + delta
    return x


def sample_dpmpp_2m(denoiser: Callable, x: torch.Tensor, sigmas: np.ndarray) -> torch.Tensor:
    """DPM-Solver++(2M)."""
    sig64 = np.asarray(sigmas, np.float64)
    t = -np.log(np.maximum(sig64, 1e-20))
    hs = np.asarray(t[1:] - t[:-1], np.float32)
    sig = np.asarray(sigmas, np.float32)
    old_denoised = None
    for i in range(len(sig) - 1):
        denoised = denoiser(x, _batch(x, sig[i]))
        h = hs[i]
        ratio = float(sig[i + 1] / sig[i])
        em1 = float(np.expm1(-h))
        if i > 0 and sig[i + 1] != 0:
            r = hs[i - 1] / h
            denoised_d = denoised * float(1 + 1 / (2 * r)) - old_denoised * float(1 / (2 * r))
        else:
            denoised_d = denoised
        x = x * ratio - denoised_d * em1
        old_denoised = denoised
    return x


# ------------------------------------------------ DPM-Solver fast / adaptive
# Exponential-integrator steps of Lu et al. 2022 in the sigma
# parameterisation: t = -ln(sigma), eps(x, t) = (x - denoised) / sigma.
# t, h and the step sizes are f32 scalars, as on the reference's device.


def _dpm_eps(denoiser, x, t):
    sigma = torch.exp(-t)
    denoised = denoiser(x, sigma * torch.ones(x.shape[0], device=x.device))
    return (x - denoised) / sigma


def _dpm_1_step(denoiser, x, t, t_next, eps):
    h = t_next - t
    return x - torch.exp(-t_next) * torch.expm1(h) * eps


def _dpm_2_step(denoiser, x, t, t_next, eps, r1=0.5):
    h = t_next - t
    s1 = t + r1 * h
    u1 = x - torch.exp(-s1) * torch.expm1(r1 * h) * eps
    eps1 = _dpm_eps(denoiser, u1, s1)
    return x - torch.exp(-t_next) * (torch.expm1(h) * eps + torch.expm1(h) / (2 * r1) * (eps1 - eps))


def _dpm_3_step(denoiser, x, t, t_next, eps, r1=1.0 / 3, r2=2.0 / 3):
    h = t_next - t
    s1, s2 = t + r1 * h, t + r2 * h
    u1 = x - torch.exp(-s1) * torch.expm1(r1 * h) * eps
    eps1 = _dpm_eps(denoiser, u1, s1)
    u2 = x - torch.exp(-s2) * (
        torch.expm1(r2 * h) * eps + (r2 / r1) * (torch.expm1(r2 * h) / (r2 * h) - 1) * (eps1 - eps)
    )
    eps2 = _dpm_eps(denoiser, u2, s2)
    return x - torch.exp(-t_next) * (torch.expm1(h) * eps + (torch.expm1(h) / h - 1) / r2 * (eps2 - eps))


def sample_dpm_fast(denoiser: Callable, x: torch.Tensor, sigmas: np.ndarray) -> torch.Tensor:
    """DPM-Solver fast: len(sigmas) - 1 model calls spent on third-order
    steps over uniform t segments, with a second/first-order tail."""
    sig = np.asarray(sigmas, np.float64)
    nz = sig[sig > 0]
    n = max(len(sig) - 1, 1)
    t_start, t_end = -np.log(nz[0]), -np.log(nz[-1])
    m = n // 3 + 1
    orders = [3] * (m - 2) + [2, 1] if n % 3 == 0 else [3] * (m - 1) + [n % 3]
    ts = np.linspace(t_start, t_end, len(orders) + 1)
    for i, order in enumerate(orders):
        t = torch.tensor(ts[i], dtype=torch.float32, device=x.device)
        t_next = torch.tensor(ts[i + 1], dtype=torch.float32, device=x.device)
        eps = _dpm_eps(denoiser, x, t)
        x = {1: _dpm_1_step, 2: _dpm_2_step, 3: _dpm_3_step}[order](denoiser, x, t, t_next, eps)
    return x


def sample_dpm_adaptive(denoiser: Callable, x: torch.Tensor, sigmas: np.ndarray, order: int = 3,
                        rtol: float = 0.05, atol: float = 0.0078, h_init: float = 0.05,
                        accept_safety: float = 0.81, max_steps: int = 200) -> torch.Tensor:
    """DPM-Solver-23 with an adaptive step size (embedded lower-order error
    estimate, integral control with a soft arctan limiter). The number of
    model calls depends on the data: each step reads its acceptance back
    from the device."""
    sig = np.asarray(sigmas, np.float64)
    nz = sig[sig > 0]
    t_end = float(-np.log(nz[-1]))
    n_el = float(x.numel())

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=x.device)

    s, h = f32(float(-np.log(nz[0]))), f32(h_init)
    for _ in range(max_steps):
        if not bool(s < t_end - 1e-5):
            break
        t_next = torch.minimum(f32(t_end), s + h)
        eps = _dpm_eps(denoiser, x, s)
        if order == 2:
            x_low = _dpm_1_step(denoiser, x, s, t_next, eps)
            x_high = _dpm_2_step(denoiser, x, s, t_next, eps)
        else:
            x_low = _dpm_2_step(denoiser, x, s, t_next, eps, r1=1.0 / 3)
            x_high = _dpm_3_step(denoiser, x, s, t_next, eps)
        delta = torch.maximum(f32(atol), rtol * torch.maximum(x_low.abs(), x_high.abs()))
        err = torch.sqrt(torch.sum(((x_low - x_high) / delta) ** 2) / n_el)
        factor = 1.0 + torch.atan((1.0 / (err + 1e-8)) ** (1.0 / order) - 1.0)
        accept = factor >= accept_safety
        x = torch.where(accept, x_high, x)
        s = torch.where(accept, t_next, s)
        h = h * factor
    return x


SAMPLERS = {
    "euler": sample_euler,
    "euler_ancestral": sample_euler_ancestral,
    "heun": sample_heun,
    "dpm_2": sample_dpm_2,
    "dpm_2_ancestral": sample_dpm_2_ancestral,
    "lms": sample_lms,
    "dpmpp_2m": sample_dpmpp_2m,
    "dpm_fast": sample_dpm_fast,
    "dpm_adaptive": sample_dpm_adaptive,
}
ANCESTRAL = ("euler_ancestral", "dpm_2_ancestral")


def get_sampler(name: str) -> Callable:
    if name not in SAMPLERS:
        raise ValueError(f"unknown sampler {name}; options: {sorted(SAMPLERS)}")
    return SAMPLERS[name]


def make_ddpm_schedule(n_timesteps: int = 1000, beta_start: float = 0.00085 ** 0.5, beta_end: float = 0.012 ** 0.5,
                       schedule: str = "scaled_linear") -> np.ndarray:
    """alphas_cumprod of the base discrete schedule (CompVis scaled linear by
    default; 'linear' is guided-diffusion's)."""
    if schedule == "scaled_linear":
        betas = np.linspace(beta_start, beta_end, n_timesteps, dtype=np.float64) ** 2
    elif schedule == "linear":
        scale = 1000 / n_timesteps
        betas = np.linspace(scale * 0.0001, scale * 0.02, n_timesteps, dtype=np.float64)
    elif schedule == "cosine":
        t = np.arange(n_timesteps + 1) / n_timesteps
        f = np.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
        betas = np.clip(1 - f[1:] / f[:-1], 0, 0.999)
    else:
        raise ValueError(schedule)
    return np.cumprod(1.0 - betas)
