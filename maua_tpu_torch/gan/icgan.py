"""Instance-conditioned GAN generation and CLIP-guided latent search.

Port of `maua_tpu/gan/icgan.py`: generation conditioned on instance
features (unit-normalized feature-extractor embeddings of conditioning
images) and CLIP-guided optimization of (z, instance feature) toward a text
prompt. Two backbones: BigGAN with hierarchical z and ccbn conditioned on
embedded SwAV features (`gan/biggan.py`, IC-GAN's own), and the port's
StyleGAN2 with c_dim > 0, whose mapping embeds the instance feature. On a
card the StyleGAN2 synthesis runs the epilogue kernel, under autograd
through `ModconvEpilogue` in `icgan_clip`.

A generator given to `load_icgan` draws the random weights. (maua_tpu's
`load_icgan` evaluates `key or PRNGKey(0)`, which raises for any key given
to the StyleGAN2 backbone.)
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..utility import resolve_device
from . import stylegan2 as sg2


def load_icgan(model_file: Optional[str] = None, instance_dim: int = 256, resolution: int = 128,
               cfg: Optional[sg2.SG2Config] = None, backbone: str = "stylegan2", biggan_cfg=None,
               gen: Optional[torch.Generator] = None, device=None):
    """An instance-conditioned generator on `device` (cuda unless told otherwise). backbone="biggan"
    builds IC-GAN's BigGAN (a BigGAN-PyTorch / ic_gan state dict with spectral norm folded, or random
    weights); "stylegan2" the StyleGAN2 c_dim variant (a checkpoint through `gan/load.load_network`, or
    random weights at `resolution` with c_dim `instance_dim`, f32). Random weights come from `gen`
    (seed 0 on `device` unless given)."""
    device = resolve_device(device) if gen is None else gen.device
    if model_file is None and gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    if backbone == "biggan":
        from . import biggan

        bcfg = biggan_cfg or biggan.BigGANConfig(resolution=resolution)
        if model_file:
            sd = torch.load(model_file, map_location="cpu", weights_only=False)
            sd = sd.get("state_dict", sd) if isinstance(sd, dict) else sd
            params = biggan.params_from_torch(sd, bcfg, device=device)
        else:
            params = biggan.init_params(bcfg, gen)
        return BigGANWrapper(params, bcfg)
    if model_file:
        from ..utility import to_device
        from .load import load_network

        params, cfg = load_network(model_file)
        return sg2.Generator(cfg, params=to_device(params, device))
    if cfg is None:
        cfg = sg2.SG2Config(img_resolution=resolution, c_dim=instance_dim, num_fp16_res=0)
    return sg2.Generator(cfg, gen=gen)


class BigGANWrapper:
    """Minimal generator facade for the BigGAN backbone: (z, features) -> (B, 3, R, R)."""

    def __init__(self, params, cfg):
        self.params, self.cfg = params, cfg

    def __call__(self, z, features=None):
        from . import biggan

        return biggan.generator(self.params, z, self.cfg, features=features)


def instance_features(images: torch.Tensor, extractor: Optional[Callable] = None, dim: int = 256,
                      device=None) -> torch.Tensor:
    """Unit-normalized embeddings of conditioning images (B, 3, H, W) in [-1, 1]. Without an extractor:
    the SwAV ResNet-50 (`gan/extractors.load_swav`, IC-GAN's instance tower) at dim 2048, else the
    small ResNet stand-in of `gan/metrics`."""
    if extractor is None:
        if dim == 2048:
            from .extractors import load_swav

            extractor = load_swav(device=device or images.device)
        else:
            from .metrics import ResNetExtractor

            extractor = ResNetExtractor(feat_dim=dim, device=device or images.device)
    feats = extractor(images)
    return feats / torch.clamp_min(torch.linalg.vector_norm(feats, dim=-1, keepdim=True), 1e-8)


def generate(gen: sg2.Generator, instance_feats: torch.Tensor, n_per_instance: int = 4, truncation: float = 1.0,
             z: Optional[torch.Tensor] = None, rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """Images (K * n_per_instance, 3, R, R) conditioned on each of K instance features; z is given or
    drawn from `rng` (seed 0 on the features' device)."""
    k = instance_feats.shape[0]
    if z is None:
        rng = rng if rng is not None else torch.Generator(device=instance_feats.device).manual_seed(0)
        z = torch.randn(k * n_per_instance, gen.cfg.z_dim, generator=rng, device=instance_feats.device)
    c = torch.repeat_interleave(instance_feats, n_per_instance, dim=0)
    return sg2.generator(gen.params, z, gen.cfg, c=c, truncation_psi=truncation)


def icgan_clip(gen: sg2.Generator, text: str, perceptor=None, n_steps: int = 100, lr: float = 0.05,
               batch: int = 4, z: Optional[torch.Tensor] = None, c: Optional[torch.Tensor] = None,
               rng: Optional[torch.Generator] = None, verbose: bool = True) -> Tuple[torch.Tensor, dict]:
    """CLIP-guided optimization of (z, instance feature) with Adam (optax's formulas): minimize the
    spherical distance between the images' CLIP embeddings (resized bilinearly with antialias, as
    jax.image.resize) and the prompt's, plus 1e-3 mean(z^2). z (batch, z_dim) and c (batch, c_dim)
    start from the given draws, else N(0, 1) and 0.1 N(0, 1) draws from `rng`. Returns (images,
    {"z", "c"})."""
    from ..loss import spherical_dist_loss
    from ..optimizers import Adam
    from ..ops.warp import resize

    device = gen.params["mapping"]["w_avg"].device
    if perceptor is None:
        from ..perceptors.clip import CLIPPerceptor

        perceptor = CLIPPerceptor(device=device)
    rng = rng if rng is not None else torch.Generator(device=device).manual_seed(0)
    if z is None:
        z = torch.randn(batch, gen.cfg.z_dim, generator=rng, device=device)
    if c is None and gen.cfg.c_dim > 0:
        c = torch.randn(batch, gen.cfg.c_dim, generator=rng, device=device) * 0.1
    with torch.no_grad():
        txt_emb = perceptor.encode_text([text])
    params = {"z": z.clone().requires_grad_(True)}
    if c is not None:
        params["c"] = c.clone().requires_grad_(True)
    opt = Adam(list(params.values()), lr=lr)
    size = perceptor.image_size

    for i in range(n_steps):
        opt.zero_grad()
        img = sg2.generator(gen.params, params["z"], gen.cfg, c=params.get("c"))
        img = resize(img, (size, size), "bilinear").permute(0, 2, 3, 1)
        emb = perceptor.encode_image(img)
        loss = spherical_dist_loss(emb, txt_emb).mean() + 1e-3 * params["z"].square().mean()
        loss.backward()
        opt.step()
        if verbose and i % max(n_steps // 5, 1) == 0:
            print(f"icgan_clip step {i}/{n_steps} loss {float(loss):.4f}")

    params = {k: v.detach() for k, v in params.items()}
    with torch.no_grad():
        imgs = sg2.generator(gen.params, params["z"], gen.cfg, c=params.get("c"))
    return imgs, params
