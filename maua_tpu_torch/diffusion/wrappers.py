"""Denoiser wrappers: discrete eps- and v-models exposed in Karras sigma space.

Port of `maua_tpu/diffusion/wrappers.py` (DiscreteSchedule, EpsDenoiser,
VDenoiser, cfg_denoiser, guided_denoiser). The sigma table and the schedule are numpy on
the host; `sigma_to_t` interpolates in log sigma in f32 on the device.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from .samplers import append_dims


class DiscreteSchedule:
    """sigma <-> timestep maps over a discrete alphas_cumprod table."""

    def __init__(self, alphas_cumprod: np.ndarray):
        self.alphas_cumprod = np.asarray(alphas_cumprod, np.float64)
        self.sigmas_table = np.sqrt((1 - self.alphas_cumprod) / self.alphas_cumprod)
        self.log_sigmas = np.log(self.sigmas_table)
        self._log_sigmas_on: Dict[torch.device, torch.Tensor] = {}

    def get_sigmas(self, n: int) -> np.ndarray:
        """n + 1 descending sigmas ending in 0, f32."""
        t_max = len(self.sigmas_table) - 1
        t = np.linspace(t_max, 0, n)
        low = np.floor(t).astype(int)
        high = np.ceil(t).astype(int)
        w = t - low
        log_s = (1 - w) * self.log_sigmas[low] + w * self.log_sigmas[high]
        return np.append(np.exp(log_s), 0.0).astype(np.float32)

    def sigma_to_t(self, sigma: torch.Tensor) -> torch.Tensor:
        """Fractional timestep of each sigma (interpolation in log sigma)."""
        ls = self._log_sigmas_on.get(sigma.device)
        if ls is None:
            ls = torch.tensor(self.log_sigmas, dtype=torch.float32, device=sigma.device)
            if not torch.compiler.is_compiling():  # a traced tensor (torch.export) is the trace's, not a cache's
                self._log_sigmas_on[sigma.device] = ls
        log_sigma = torch.log(sigma.float().clamp_min(1e-10))
        dists = log_sigma[..., None] - ls
        low_idx = ((dists >= 0).sum(dim=-1) - 1).clamp(0, len(self.log_sigmas) - 2)
        high_idx = low_idx + 1
        low, high = ls[low_idx], ls[high_idx]
        w = ((low - log_sigma) / (low - high)).clamp(0, 1)
        return (1 - w) * low_idx + w * high_idx


class EpsDenoiser(DiscreteSchedule):
    """eps-prediction model -> denoised x0 (CompVisDenoiser semantics):
    denoised = x - eps(x * c_in, t) * sigma, c_in = 1 / sqrt(sigma^2 + 1)."""

    def __init__(self, eps_model: Callable, alphas_cumprod: np.ndarray):
        super().__init__(alphas_cumprod)
        self.eps_model = eps_model

    def __call__(self, x: torch.Tensor, sigma: torch.Tensor, **kwargs) -> torch.Tensor:
        c_in = append_dims(1.0 / torch.sqrt(sigma**2 + 1.0), x.dim())
        eps = self.eps_model(x * c_in, self.sigma_to_t(sigma), **kwargs)
        return x - eps * append_dims(sigma, x.dim())


class VDenoiser(DiscreteSchedule):
    """v-prediction model -> denoised x0."""

    def __init__(self, v_model: Callable, alphas_cumprod: np.ndarray):
        super().__init__(alphas_cumprod)
        self.v_model = v_model

    def __call__(self, x: torch.Tensor, sigma: torch.Tensor, **kwargs) -> torch.Tensor:
        c_in = append_dims(1.0 / torch.sqrt(sigma**2 + 1.0), x.dim())
        c_out = append_dims(sigma / torch.sqrt(sigma**2 + 1.0), x.dim())
        c_skip = append_dims(1.0 / (sigma**2 + 1.0), x.dim())
        v = self.v_model(x * c_in, self.sigma_to_t(sigma), **kwargs)
        return x * c_skip - v * c_out


def cfg_denoiser(denoiser: Callable, cond: torch.Tensor, uncond: torch.Tensor, cond_scale: float) -> Callable:
    """Classifier-free guidance as one 2x-batched evaluation."""

    def model_fn(x, sigma):
        b = x.shape[0]
        ctx = torch.cat([uncond.expand(b, *uncond.shape[1:]), cond.expand(b, *cond.shape[1:])])
        out = denoiser(torch.cat([x, x]), torch.cat([sigma, sigma]), context=ctx)
        un, co = out[:b], out[b:]
        return un + (co - un) * cond_scale

    return model_fn


def guided_denoiser(model_fn: Callable, cond_fn: Callable) -> Callable:
    """Score guidance: denoised + grad * sigma^2, with grad = cond_fn(x, sigma,
    denoised, vjp), where vjp(ct) = (ct^T d(denoised)/dx,) pulls a cotangent back
    through model_fn by `torch.autograd.grad` (the reference's `jax.vjp`). The
    model runs under `torch.enable_grad()` whatever the caller's mode; the
    result carries no graph."""

    def guided(x, sigma):
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            denoised = model_fn(xx, sigma)

            def vjp(ct):
                return torch.autograd.grad(denoised, xx, ct)

            grad = cond_fn(xx, sigma, denoised, vjp)
        return denoised.detach() + grad.detach() * append_dims(sigma**2, x.dim())

    return guided
