"""Diffusion samplers in sigma space (the k-diffusion family), as Python loops.

Port of `maua_tpu/diffusion/samplers.py` (euler, euler_ancestral, heun,
dpm_2, dpm_2_ancestral, lms, dpmpp_2m, dpm_fast, dpm_adaptive, the DDPM
schedule, and the alpha-space ddim_sample_loop, plms_sample_loop and
q_sample). Each `lax.scan` of the reference is a loop over the
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


# ---------------------------------------------------- alpha-space samplers
# DDIM and PLMS step over discrete timesteps of an eps-prediction model,
# eps_model(x, t) with t a (B,) int64 tensor of original timesteps. The
# schedule's scalars are computed on the host in f32, as the reference's
# device arrays hold them.

def _alphas(alphas_cumprod: np.ndarray, timesteps: np.ndarray):
    ac = np.asarray(alphas_cumprod, np.float32)
    ts = np.asarray(timesteps, np.int64)
    return ac[ts], np.append(ac[ts[1:]], np.float32(1.0)).astype(np.float32)


def _pred_x0(x, eps, a_t, clip_denoised: bool):
    one = np.float32(1.0)
    pred_x0 = (x - float(np.sqrt(one - a_t)) * eps) / float(np.sqrt(a_t))
    if clip_denoised:
        pred_x0 = pred_x0.clamp(-1.0, 1.0)
        eps = (x - float(np.sqrt(a_t)) * pred_x0) / float(np.sqrt(one - a_t))
    return pred_x0, eps


def _timestep(x: torch.Tensor, t) -> torch.Tensor:
    return torch.full((x.shape[0],), int(t), dtype=torch.int64, device=x.device)


def ddim_sample_loop(eps_model: Callable, x: torch.Tensor, timesteps: np.ndarray, alphas_cumprod: np.ndarray,
                     eta: float = 0.0, gen: Optional[torch.Generator] = None, clip_denoised: bool = False,
                     noises: Optional[Sequence] = None):
    """DDIM (Song et al. 2020) over descending `timesteps`: returns (x, the last step's pred_x0).
    clip_denoised clamps pred_x0 to [-1, 1] at each step and derives eps anew from it. With eta > 0
    each step adds noise from `gen` or `noises` (one standard normal tensor per step)."""
    a_ts, a_nexts = _alphas(alphas_cumprod, timesteps)
    one, eta32 = np.float32(1.0), np.float32(eta)
    pred_x0 = torch.zeros_like(x)
    for i, t in enumerate(np.asarray(timesteps)):
        a_t, a_next = a_ts[i], a_nexts[i]
        pred_x0, eps = _pred_x0(x, eps_model(x, _timestep(x, t)), a_t, clip_denoised)
        sigma = eta32 * np.sqrt((one - a_next) / (one - a_t)) * np.sqrt(one - a_t / max(a_next, np.float32(1e-10)))
        x = float(np.sqrt(a_next)) * pred_x0 + float(np.sqrt(max(one - a_next - sigma**2, np.float32(0)))) * eps
        if sigma != 0:
            x = x + float(sigma) * _noise(x, i, gen, noises)
    return x, pred_x0


def plms_sample_loop(eps_model: Callable, x: torch.Tensor, timesteps: np.ndarray, alphas_cumprod: np.ndarray,
                     clip_denoised: bool = False):
    """PLMS / PNDM (Liu et al. 2022): a 4th-order linear multistep on eps, warmed up by a pseudo improved
    Euler step (one extra model call at the next timestep) and orders 2 and 3. Returns (x, the last
    step's pred_x0)."""
    a_ts, a_nexts = _alphas(alphas_cumprod, timesteps)
    ts = np.asarray(timesteps)
    one = np.float32(1.0)

    def transfer(x, eps, a_t, a_next):
        pred_x0, eps = _pred_x0(x, eps, a_t, clip_denoised)
        return float(np.sqrt(a_next)) * pred_x0 + float(np.sqrt(one - a_next)) * eps, pred_x0

    hist = []  # the latest eps first
    pred_x0 = torch.zeros_like(x)
    for i, t in enumerate(ts):
        a_t, a_next = a_ts[i], a_nexts[i]
        eps = eps_model(x, _timestep(x, t))
        if not hist:
            x_mid, _ = transfer(x, eps, a_t, a_next)
            eps_prime = (eps + eps_model(x_mid, _timestep(x, ts[min(i + 1, len(ts) - 1)]))) / 2
        elif len(hist) == 1:
            eps_prime = (3 * eps - hist[0]) / 2
        elif len(hist) == 2:
            eps_prime = (23 * eps - 16 * hist[0] + 5 * hist[1]) / 12
        else:
            eps_prime = (55 * eps - 59 * hist[0] + 37 * hist[1] - 9 * hist[2]) / 24
        x, pred_x0 = transfer(x, eps_prime, a_t, a_next)
        hist = [eps] + hist[:2]
    return x, pred_x0


def q_sample(x0: torch.Tensor, alphas_cumprod_t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Forward diffusion q(x_t | x_0) = sqrt(a) x0 + sqrt(1 - a) noise, a per batch element."""
    a = torch.as_tensor(alphas_cumprod_t, dtype=torch.float32, device=x0.device)
    return append_dims(torch.sqrt(a), x0.dim()) * x0 + append_dims(torch.sqrt(1 - a), x0.dim()) * noise
