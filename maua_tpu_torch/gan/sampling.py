"""Latent sampling strategies: random, Langevin, polarity and
Jacobian-norm rejection.

Port of `maua_tpu/gan/sampling.py`. A torch.Generator takes the place of
the JAX key; each function also takes its random draws as arguments (z,
the uniform draws of a choice, a tangent, the Langevin noise) so that
both packages can be fed the same numbers. Langevin sampling runs with
an energy function or with CLIP's (`clip_energy`); the energy from a
checkpoint's discriminator waits for `gan/discriminator.py`.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from . import stylegan2 as sg2


def _normal(gen: Optional[torch.Generator], shape, device=None) -> torch.Tensor:
    device = gen.device if gen is not None else device
    return torch.randn(shape, generator=gen, device=device)


def random_latents(gen: Optional[torch.Generator], n: int, z_dim: int = 512) -> torch.Tensor:
    return _normal(gen, (n, z_dim))


def langevin_sample(gen: Optional[torch.Generator], n: int, energy_fn: Callable, z_dim: int = 512,
                    n_steps: int = 50, step_size: float = 0.01, noise_scale: float = 0.1,
                    z: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Langevin dynamics on E(z) + |z|^2 / 2: z <- z - e/2 dE/dz + s sqrt(e)
    N. energy_fn maps z (n, z_dim) to per-sample energies; z (the start)
    and noise (n_steps, n, z_dim) are drawn from gen unless given."""
    z = _normal(gen, (n, z_dim)) if z is None else torch.as_tensor(z).float()
    for step in range(n_steps):
        with torch.enable_grad():
            zz = z.detach().requires_grad_(True)
            (g,) = torch.autograd.grad((energy_fn(zz) + 0.5 * zz.square().sum(-1)).sum(), zz)
        eps = _normal(gen, z.shape, z.device) if noise is None else torch.as_tensor(noise[step], device=z.device)
        z = z - 0.5 * step_size * g + noise_scale * step_size**0.5 * eps
    return z.detach()


def polarity_sample(gen: Optional[torch.Generator], n: int, params, cfg: sg2.SG2Config, n_probe: int = 256,
                    polarity: float = 1.0, z: Optional[torch.Tensor] = None,
                    u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Polarity sampling: draw n of n_probe latents with weights
    softmax(polarity * log-volume), the log-volume being the summed log
    |projection| of each mapped w on the top 8 singular directions of the
    centred batch (negative polarity favours modes). z (n_probe, z_dim) and
    the choice's uniform draws u (n,) come from gen unless given."""
    device = params["mapping"]["w_avg"].device
    z = _normal(gen, (n_probe, cfg.z_dim), device) if z is None else torch.as_tensor(z, device=device).float()
    ws = sg2.mapping(params, z, cfg)[:, 0]
    centered = ws - ws.mean(0)
    _, _, vt = torch.linalg.svd(centered, full_matrices=False)
    proj = centered @ vt.T
    logvol = torch.log(proj[:, :8].abs() + 1e-6).sum(1)
    weights = torch.softmax(polarity * logvol, dim=0)
    if u is None:
        u = torch.rand(n, generator=gen, device=device)
    # jax.random.choice with p: the inverse of the cumulative weights at 1 - u
    p_cuml = torch.cumsum(weights, 0)
    idx = torch.searchsorted(p_cuml, p_cuml[-1] * (1 - torch.as_tensor(u, device=device).float()))
    return z[idx.clamp_max(n_probe - 1)]


def jacnorm_sample(gen: Optional[torch.Generator], n: int, params, cfg: sg2.SG2Config, percentile: float = 50.0,
                   oversample: int = 4, z: Optional[torch.Tensor] = None,
                   v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Jacobian-norm rejection: of n * oversample latents, keep n whose
    mapping Jacobian-vector norm (one shared tangent v) is at or below the
    percentile, smallest first. z and v (z_dim,) come from gen unless given."""
    device = params["mapping"]["w_avg"].device
    z = _normal(gen, (n * oversample, cfg.z_dim), device) if z is None else torch.as_tensor(z, device=device).float()
    v = _normal(gen, (cfg.z_dim,), device) if v is None else torch.as_tensor(v, device=device).float()
    # each mapped row depends on its own z row only, so one JVP of the batch with v on every row gives
    # every sample's Jacobian-vector product
    _, jvp = torch.func.jvp(lambda zz: sg2.mapping(params, zz, cfg)[:, 0, :], (z,), (v.expand_as(z),))
    norms = jvp.norm(dim=1)
    cutoff = torch.quantile(norms, percentile / 100.0)
    order = torch.argsort((norms > cutoff).float() + norms * 1e-6, stable=True)
    return z[order[:n]]


def discriminator_energy(generator, d_params, d_cfg) -> Callable:
    """E(z) = -D(G(z)) from a checkpoint's discriminator: not ported."""
    raise NotImplementedError("discriminator-driven Langevin sampling waits for gan/discriminator.py "
                              "(the discriminator and its loaders)")


def clip_energy(generator, text: str, perceptor=None) -> Callable:
    """E(z) = -10 sim(CLIP(G(z)), CLIP(text)) for a generator with `params` and
    `cfg`; the CLIP perceptor is drawn from seed 0 on the generator's device
    unless given. As in maua_tpu, the image is mapped to [0, 1] before the
    image tower, which maps its input from [-1, 1] once more."""
    if perceptor is None:
        from ..perceptors.clip import CLIPPerceptor

        perceptor = CLIPPerceptor(device=generator.params["mapping"]["w_avg"].device)
    with torch.no_grad():
        temb = perceptor.encode_text([text])
    g_params, g_cfg = generator.params, generator.cfg

    def energy(z):
        img = sg2.synthesis(g_params, sg2.mapping(g_params, z, g_cfg), g_cfg)
        emb = perceptor.encode_image((img.float().permute(0, 2, 3, 1) + 1.0) / 2.0)
        return -10.0 * (emb * temb).sum(-1)

    return energy


def make_langevin_energy(generator, critic: str = "discriminator") -> Callable:
    """maua_tpu's `--langevin_critic`: "discriminator" for the checkpoint's D
    (not ported yet), any other string a CLIP text prompt."""
    if critic == "discriminator":
        return discriminator_energy(generator, None, None)
    return clip_energy(generator, critic)


def sample_latents(strategy: str, gen: Optional[torch.Generator], n: int, params=None,
                   cfg: Optional[sg2.SG2Config] = None, generator=None, critic: str = "discriminator",
                   **kwargs) -> torch.Tensor:
    """z latents (n, z_dim) by strategy: random, langevin (with an
    `energy_fn`, else the critic's energy), polarity or jacnorm."""
    if strategy == "random":
        return random_latents(gen, n, kwargs.get("z_dim", cfg.z_dim if cfg else 512))
    if strategy == "langevin":
        if "energy_fn" not in kwargs:
            kwargs["energy_fn"] = make_langevin_energy(generator, critic)
        kwargs.setdefault("z_dim", cfg.z_dim if cfg else 512)
        return langevin_sample(gen, n, **kwargs)
    if strategy == "polarity":
        return polarity_sample(gen, n, params, cfg, **kwargs)
    if strategy == "jacnorm":
        return jacnorm_sample(gen, n, params, cfg, **kwargs)
    raise ValueError(f"unknown sampling strategy {strategy}")
