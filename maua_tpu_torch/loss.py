"""Style and guidance losses, and the gradient-surgery functions.

Port of `maua_tpu/loss.py` (scaled_mse_loss, feature_loss, gram_matrix,
spherical_dist_loss, tv_loss, range_loss; normalize_gradients,
replace_grad and clamp_with_grad, whose `jax.custom_vjp`s become
`torch.autograd.Function`s). Images and feature maps are NHWC, as in
maua_tpu.
"""

from __future__ import annotations

import torch


def scaled_mse_loss(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """MSE scaled inversely with the target's magnitude."""
    return (x - y).square().mean() / torch.sqrt(y.square().mean() + eps)


def feature_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return scaled_mse_loss(x, y)


def gram_matrix(x: torch.Tensor, shift_x: int = 0, shift_y: int = 0, shift_t: int = 0, flip_h: bool = False,
                flip_v: bool = False, use_covariance: bool = False) -> torch.Tensor:
    """Gram (or covariance) matrix (B, C, C) of NHWC features, with optional transport shifts and flips."""
    b, h, w, c = x.shape
    y = x
    if shift_x or shift_y:
        y = torch.roll(torch.roll(y, shift_x, dims=2), shift_y, dims=1)
        x = x[:, abs(shift_y):, abs(shift_x):, :]
        y = y[:, abs(shift_y):, abs(shift_x):, :]
    if flip_h:
        y = y.flip(2)
    if flip_v:
        y = y.flip(1)
    xf = x.reshape(b, -1, c)
    yf = y.reshape(b, -1, c)
    if use_covariance:
        xf = xf - xf.mean(dim=1, keepdim=True)
        yf = yf - yf.mean(dim=1, keepdim=True)
    return torch.einsum("bnc,bnd->bcd", xf, yf) / xf.shape[1]


def spherical_dist_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    xn = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    yn = y / torch.linalg.vector_norm(y, dim=-1, keepdim=True)
    return torch.arcsin((torch.linalg.vector_norm(xn - yn, dim=-1) / 2).clamp(-1, 1)).square() * 2


def tv_loss(x: torch.Tensor) -> torch.Tensor:
    """Isotropic total variation of NHWC images."""
    x_diff = x[:, :-1, 1:, :] - x[:, :-1, :-1, :]
    y_diff = x[:, 1:, :-1, :] - x[:, :-1, :-1, :]
    return (x_diff.square() + y_diff.square()).mean()


def range_loss(x: torch.Tensor) -> torch.Tensor:
    return (x.abs() - x.clamp(-1, 1)).square().mean()


# ------------------------------------------------ gradient surgery ops
class _NormalizeGradients(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, strength):
        ctx.strength = abs(float(strength))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # the incoming gradient at unit norm, scaled by |strength|
        norm = g.square().sum().sqrt()
        return g / norm.clamp_min(1e-12) * ctx.strength, None


def normalize_gradients(x: torch.Tensor, strength: float = 1.0) -> torch.Tensor:
    """Identity forward; backward passes the gradient at unit norm times |strength|."""
    return _NormalizeGradients.apply(x, strength)


class _ReplaceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_forward, x_backward):
        return x_forward.view_as(x_forward)

    @staticmethod
    def backward(ctx, g):
        return None, g


def replace_grad(x_forward: torch.Tensor, x_backward: torch.Tensor) -> torch.Tensor:
    """x_forward forward; the gradient goes to x_backward."""
    return _ReplaceGrad.apply(x_forward, x_backward)


class _ClampWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.lo, ctx.hi = lo, hi
        return x.clamp(lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.lo, ctx.hi
        inside = (x >= lo) & (x <= hi)
        pushing_in = ((x < lo) & (g < 0)) | ((x > hi) & (g > 0))
        return torch.where(inside | pushing_in, g, torch.zeros_like(g)), None, None


def clamp_with_grad(x: torch.Tensor, lo: float = -1.0, hi: float = 1.0) -> torch.Tensor:
    """Clamp forward; backward zeroes the gradients that would push a clamped value further out."""
    return _ClampWithGrad.apply(x, lo, hi)
