"""GAN training: losses, regularizers and the alternating train step.

Port of `maua_tpu/gan/training.py`. The step is eager PyTorch over a
state dict (both networks, the generator's EMA, both Adam states, the
path-length mean, the step count):

- n_d_steps discriminator updates, the fakes generated under no_grad;
- a generator update with lazy R1 (on the D side) and path-length
  regularization, each when the host-side step count hits its interval
  (a Python `if` where maua_tpu traces `lax.cond`);
- the EMA of the generator.

R1 and path length differentiate a gradient (create_graph), so the G
update reaches the epilogue kernel's double backward
(`kernels/epilogue.ModconvEpilogue`). Adam is optax's (the transformation
that `optimizers.Adam` applies, `transforms.adam`), its state a list over
the parameters in JAX's leaf order (dict keys sorted), so a state carried
over from maua_tpu (`bridge.train_state_to_torch`) lines up. Random draws
come from a torch.Generator, or are handed in explicitly (`draws`), so
that both packages can be fed the same numbers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import transforms as T
from ..utility import StageClock
from . import stylegan2 as sg2
from .discriminator import D2Config, discriminator, init_params as init_d_params


# ------------------------------------------------- model family seam
@dataclasses.dataclass(frozen=True)
class GenericModel:
    """Config of a non-StyleGAN family of the registry: one hashable config
    names the family, and the step and fit functions dispatch on it."""

    family: str  # 'dcgan' | 'hypermixer' | 'involution' | 'steerable'
    resolution: int = 64
    z_dim: int = 100
    base: int = 64  # generator width (`--ngf`)
    d_base: int = 0  # discriminator width (`--ndf`); 0 = same as base
    dim: int = 0  # hypermixer token width (`--w_dim`); 0 = family default


def _generic_init(gen: torch.Generator, m: GenericModel):
    from . import models_experimental as me

    depth = max((m.resolution // 4).bit_length() - 1, 1) if m.family == "steerable" else None
    d_base = m.d_base or m.base
    if m.family == "dcgan":
        return me.init_dcgan_g(gen, m.z_dim, m.base, m.resolution), me.init_dcgan_d(gen, d_base, m.resolution)
    if m.family == "hypermixer":
        g_kw = {"dim": m.dim} if m.dim else {}
        return (me.init_hypermixer_g(gen, z_dim=m.z_dim, resolution=m.resolution, **g_kw),
                me.init_dcgan_d(gen, d_base, m.resolution))
    if m.family == "involution":
        return me.init_involution_g(gen, m.z_dim, m.base, m.resolution), me.init_involution_d(gen, d_base, m.resolution)
    if m.family == "steerable":
        return (me.init_steerable_g(gen, m.z_dim, m.base, m.resolution, depth=depth),
                me.init_steerable_d(gen, d_base, m.resolution, depth=depth))
    raise ValueError(f"unknown model family {m.family!r}")


def generate(g_params, z: torch.Tensor, g_cfg, gen: Optional[torch.Generator] = None,
             noises: Optional[Dict] = None) -> torch.Tensor:
    """Model-agnostic z -> image (B, C, H, W), used by the train step and eval. A
    StyleGAN2 draws per-layer noise from `gen` (or takes `noises` by layer name),
    and uses its constant noise when given neither."""
    if isinstance(g_cfg, sg2.SG2Config):
        mode = "random" if gen is not None or noises is not None else "const"
        return sg2.generator(g_params, z, g_cfg, noise_mode=mode, noises=noises, gen=gen)
    from . import models_experimental as me

    return {"dcgan": me.dcgan_g, "hypermixer": me.hypermixer_g,
            "involution": me.involution_g, "steerable": me.steerable_g}[g_cfg.family](g_params, z)


def disc_forward(d_params, img: torch.Tensor, d_cfg) -> torch.Tensor:
    if isinstance(d_cfg, D2Config):
        return discriminator(d_params, img, d_cfg)
    from . import models_experimental as me

    d_fn = me.involution_d if d_cfg.family == "involution" else (
        me.steerable_d if d_cfg.family == "steerable" else me.dcgan_d)
    return d_fn(d_params, img)


# ------------------------------------------------------------- losses
def _sigmoid_bce(logits: torch.Tensor, labels: float) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy against a constant label."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def g_logistic_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    """Non-saturating softplus G loss."""
    return F.softplus(-fake_logits).mean()


def d_logistic_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    return F.softplus(fake_logits).mean() + F.softplus(-real_logits).mean()


def g_bce_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    return _sigmoid_bce(fake_logits, 1.0).mean()


def d_bce_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    return _sigmoid_bce(real_logits, 1.0).mean() + _sigmoid_bce(fake_logits, 0.0).mean()


def r1_penalty(d_params, real: torch.Tensor, d_cfg) -> torch.Tensor:
    """R1 gradient penalty E[|grad_x D(x)|^2], differentiable in d_params (a double backward through D)."""
    x = real.detach().requires_grad_(True)
    with torch.enable_grad():
        (grads,) = torch.autograd.grad(disc_forward(d_params, x, d_cfg).sum(), x, create_graph=True)
    return grads.float().square().sum(dim=(1, 2, 3)).mean()


def path_length_penalty(g_params, ws: torch.Tensor, g_cfg: sg2.SG2Config, pl_mean: torch.Tensor,
                        decay: float = 0.01, batch_shrink: int = 1, noise: Optional[torch.Tensor] = None,
                        gen: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Path-length regularization: penalize the deviation of |J_w^T y| from its running mean,
    on batch // batch_shrink samples. `noise` (B', C, H, W) is y before its 1/sqrt(H W) scale,
    drawn from `gen` unless given. The penalty and the new mean are differentiable in g_params
    (a double backward through the synthesis) and through ws back to the mapping."""
    if batch_shrink > 1:
        ws = ws[: max(ws.shape[0] // batch_shrink, 1)]
    with torch.enable_grad():
        if not ws.requires_grad:
            ws = ws.detach().requires_grad_(True)
        img = sg2.synthesis(g_params, ws, g_cfg, noise_mode="none")
        if noise is None:
            noise = torch.randn(img.shape, generator=gen, device=img.device)
        noise = noise.to(img.device) / math.sqrt(img.shape[2] * img.shape[3])
        (grads,) = torch.autograd.grad((img * noise).sum(), ws, create_graph=True)
    lengths = torch.sqrt(grads.square().sum(dim=2).mean(dim=1) + 1e-8)
    new_pl_mean = pl_mean + decay * (lengths.mean() - pl_mean)
    return (lengths - new_pl_mean).square().mean(), new_pl_mean


# ------------------------------------------------------ initial blur
def initial_blur(img: torch.Tensor, step: int, batch_size: int, init_sigma: float, fade_kimg: float) -> torch.Tensor:
    """Fade-out Gaussian blur of D's inputs early in training: sigma ramps linearly from init_sigma to 0
    over fade_kimg * batch / 32 thousand images. The kernel size is fixed (3 * init_sigma, odd); at
    sigma 0 the kernel is a delta. Sigma and the taps are computed in f32, as maua_tpu does on the device."""
    size = int(3 * init_sigma)
    size = size + 1 - size % 2
    fade = fade_kimg * batch_size / 32.0
    f32 = lambda v: torch.full((), v, dtype=torch.float32, device=img.device)  # noqa: E731  (no host copy)
    sigma = torch.clamp(f32(1.0) - f32(step) * batch_size / f32(fade * 1e3), min=0.0) * init_sigma
    x = torch.arange(size, dtype=torch.float32, device=img.device) - size // 2
    k1d = torch.exp(-0.5 * x.square() / (sigma.square() + 1e-8))
    k1d = (k1d / k1d.sum()).to(img.dtype)
    c, pad = img.shape[1], size // 2
    img = F.conv2d(img, k1d.view(1, 1, size, 1).repeat(c, 1, 1, 1), padding=(pad, 0), groups=c)
    return F.conv2d(img, k1d.view(1, 1, 1, size).repeat(c, 1, 1, 1), padding=(0, pad), groups=c)


# -------------------------------------------------------------- state
@dataclasses.dataclass(frozen=True)
class TrainConfig:
    g_lr: float = 2.5e-3
    d_lr: float = 2.5e-3
    beta1: float = 0.0
    beta2: float = 0.99
    r1_gamma: float = 10.0
    r1_interval: int = 16
    pl_weight: float = 2.0
    pl_interval: int = 4
    pl_decay: float = 0.01  # running-mean EMA of the path lengths
    pl_batch_shrink: int = 2  # path length on batch // shrink samples
    n_d_steps: int = 1  # D updates per G update
    ema_beta: float = 0.999
    loss: str = "logistic"  # 'logistic' | 'bce'
    latent: str = "normal"  # latent distribution
    blur_init_sigma: float = 0.0  # 0 disables the initial blur
    blur_fade_kimg: float = 200.0


def _latent_sampler(kind: str) -> Callable:
    """(gen, shape) -> latents: standard normal, or uniform on [-sqrt 3, sqrt 3] (unit variance)."""
    if kind == "uniform":
        return lambda gen, shape: (torch.rand(shape, generator=gen, device=gen.device) * 2.0 - 1.0) * math.sqrt(3.0)
    return lambda gen, shape: torch.randn(shape, generator=gen, device=gen.device)


def make_optimizers(cfg: TrainConfig) -> Tuple[T.GradientTransformation, T.GradientTransformation]:
    """(G's, D's) Adam, optax.adam(lr, b1, b2, eps=1e-8)'s formulas (`optimizers.Adam`'s transformation)."""
    return (T.adam(cfg.g_lr, b1=cfg.beta1, b2=cfg.beta2, eps=1e-8),
            T.adam(cfg.d_lr, b1=cfg.beta1, b2=cfg.beta2, eps=1e-8))


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of nested dicts and lists in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves: List[torch.Tensor]):
    """`like`'s structure holding `leaves` (in tree_leaves' order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}  # the original key order
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    return build(like)


def tree_map(fn, *trees):
    return tree_unflatten(trees[0], [fn(*xs) for xs in zip(*(tree_leaves(t) for t in trees))])


def init_train_state(g_cfg, d_cfg, t_cfg: TrainConfig, gen: torch.Generator) -> Dict:
    """Both networks drawn from `gen` (independently, so that families can mix), the EMA a copy of G,
    both Adam states, pl_mean 0 and step 0."""
    g_params = (sg2.init_params(g_cfg, gen) if isinstance(g_cfg, sg2.SG2Config) else _generic_init(gen, g_cfg)[0])
    d_params = (init_d_params(d_cfg, gen) if isinstance(d_cfg, D2Config) else _generic_init(gen, d_cfg)[1])
    g_opt, d_opt = make_optimizers(t_cfg)
    return {
        "g_params": g_params,
        "d_params": d_params,
        "g_ema": tree_map(torch.clone, g_params),
        "g_opt": g_opt.init(tree_leaves(g_params)),
        "d_opt": d_opt.init(tree_leaves(d_params)),
        "pl_mean": torch.zeros((), device=gen.device),
        "step": 0,
    }


def _with_grad(tree):
    """Detached copies of the tree's tensors that require grad: (the tree, its leaves)."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tree)]
    return tree_unflatten(tree, leaves), leaves


def _adam_step(tx, opt_state, leaves, loss):
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    params = [p.detach() for p in leaves]
    updates, opt_state = tx.update(grads, opt_state, params)
    return [p + u for p, u in zip(params, updates)], opt_state


# ---------------------------------------------------------- train step
def train_step(state: Dict, real: torch.Tensor, g_cfg, d_cfg, t_cfg: TrainConfig,
               gen: Optional[torch.Generator] = None, draws: Optional[Dict] = None,
               times: Optional[Dict[str, float]] = None):
    """One alternating D + G update with lazy R1 / path length and the EMA; returns (new state, metrics).
    With beta1 = 0 the new Adam first moments (state["g_opt"][0]["mu"], state["d_opt"][0]["mu"]) are the
    G step's and the last D step's gradients.

    real: (B, C, H, W) in [-1, 1]. `draws` may hold any of: "z_d" (n_d_steps latents (B, z_dim)),
    "noise_d" (n_d_steps dicts of per-layer noise maps by layer name), "z_g", "noise_g", "pl_noise"
    ((B // pl_batch_shrink, C, H, W)); what it lacks is drawn from `gen`, which is then required. Path
    length applies to the StyleGAN2 family only (it needs the mapping / synthesis split). With `times`,
    the seconds of the D steps, the G step and the EMA (each ended by a device synchronization) are
    written into it."""
    draws = draws or {}
    device = real.device
    is_sg2 = isinstance(g_cfg, sg2.SG2Config)
    g_tx, d_tx = make_optimizers(t_cfg)
    batch, step = real.shape[0], int(state["step"])
    if gen is None:
        need = {"z_d", "z_g"} | ({"noise_d", "noise_g"} if is_sg2 else set())
        need |= {"pl_noise"} if is_sg2 and step % t_cfg.pl_interval == 0 else set()
        missing = sorted(k for k in need if draws.get(k) is None)
        if missing:
            raise ValueError(f"train_step draws {missing} from gen: pass gen or draws with them")
    g_loss_fn = g_logistic_loss if t_cfg.loss == "logistic" else g_bce_loss
    d_loss_fn = d_logistic_loss if t_cfg.loss == "logistic" else d_bce_loss
    sample_z = _latent_sampler(t_cfg.latent)
    clock = StageClock(device, times)

    def maybe_blur(img):
        if t_cfg.blur_init_sigma > 0:
            return initial_blur(img, step, batch, t_cfg.blur_init_sigma, t_cfg.blur_fade_kimg)
        return img

    def draw(name, i=None, shape=None):
        v = draws.get(name)
        if v is not None:
            return v if i is None else v[i]
        return None if shape is None else sample_z(gen, shape)

    def timed(name, fn):
        return fn() if times is None else clock.stage(name, fn)

    real = maybe_blur(real)
    z_dim = g_cfg.z_dim

    def d_steps():
        d_params, d_opt = state["d_params"], state["d_opt"]
        for i in range(max(t_cfg.n_d_steps, 1)):
            z, noises = draw("z_d", i, (batch, z_dim)), draw("noise_d", i)
            with torch.no_grad():
                fake = maybe_blur(generate(state["g_params"], z, g_cfg, gen=None if noises is not None else gen,
                                           noises=noises))
            d_tree, d_leaves = _with_grad(d_params)
            with torch.enable_grad():
                fake_logits = disc_forward(d_tree, fake, d_cfg)
                real_logits = disc_forward(d_tree, real, d_cfg)
                d_l = d_loss_fn(real_logits, fake_logits)
                if step % t_cfg.r1_interval == 0:
                    r1 = r1_penalty(d_tree, real, d_cfg)
                else:
                    r1 = torch.zeros((), device=device)
                d_total = d_l + (t_cfg.r1_gamma / 2) * r1 * t_cfg.r1_interval
            new_leaves, d_opt = _adam_step(d_tx, d_opt, d_leaves, d_total)
            d_params = tree_unflatten(d_params, new_leaves)
        metrics = {"d_loss": d_total.detach(), "real_logits": real_logits.detach().mean(),
                   "fake_logits": fake_logits.detach().mean(), "r1": r1.detach()}
        return d_params, d_opt, metrics

    def g_step():
        d_fixed = tree_map(torch.Tensor.detach, d_params)
        g_tree, g_leaves = _with_grad(state["g_params"])
        pl_mean = state["pl_mean"]
        with torch.enable_grad():
            z = draw("z_g", None, (batch, z_dim))
            if is_sg2:
                ws = sg2.mapping(g_tree, z, g_cfg)
                noises = draw("noise_g")
                fake = sg2.synthesis(g_tree, ws, g_cfg, noise_mode="random", noises=noises,
                                     gen=None if noises is not None else gen)
            else:
                fake = generate(g_tree, z, g_cfg)
            g_total = g_loss_fn(disc_forward(d_fixed, maybe_blur(fake), d_cfg))
            if is_sg2 and step % t_cfg.pl_interval == 0:
                pl, pl_mean = path_length_penalty(g_tree, ws, g_cfg, pl_mean, decay=t_cfg.pl_decay,
                                                  batch_shrink=t_cfg.pl_batch_shrink,
                                                  noise=draws.get("pl_noise"), gen=gen)
                g_total = g_total + t_cfg.pl_weight * pl * t_cfg.pl_interval
        new_leaves, g_opt = _adam_step(g_tx, state["g_opt"], g_leaves, g_total)
        return tree_unflatten(state["g_params"], new_leaves), g_opt, g_total.detach(), pl_mean.detach()

    d_params, d_opt, metrics = timed("d_steps", d_steps)
    g_params, g_opt, metrics["g_loss"], pl_mean = timed("g_step", g_step)
    beta = t_cfg.ema_beta
    g_ema = timed("ema", lambda: tree_map(lambda e, p: e * beta + p * (1.0 - beta), state["g_ema"], g_params))

    new_state = {"g_params": g_params, "d_params": d_params, "g_ema": g_ema, "g_opt": g_opt, "d_opt": d_opt,
                 "pl_mean": pl_mean, "step": step + 1}
    metrics = {k: metrics[k] for k in ("d_loss", "g_loss", "real_logits", "fake_logits", "r1")}
    return new_state, metrics
