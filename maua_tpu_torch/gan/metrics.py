"""GAN evaluation metrics: FID, KID and PRDC over pluggable feature extractors.

Port of `maua_tpu/gan/metrics.py`: the Newton-Schulz square root, the
Frechet distance through the PSD eigh form, the unbiased polynomial
kernel distance, precision / recall / density / coverage, the
anti-aliased clean resize (jax.image.resize's Keys cubic, a = -0.5, with
antialias: `ops/warp.resize`, not F.interpolate's a = -0.75), a tiny
random ResNet stand-in extractor, the suite over image batches and the
folder-vs-generator run with its real-feature cache. Images are NCHW;
the extractors are those of `gan/extractors.py`.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.warp import resize
from ..utility import resolve_device


# ------------------------------------------------------------ distances
def sqrtm_newton_schulz(A: torch.Tensor, num_iters: int = 50) -> torch.Tensor:
    """Matrix square root by the Newton-Schulz iteration."""
    dim = A.shape[0]
    norm = torch.linalg.norm(A)
    Y = A / norm
    eye = torch.eye(dim, dtype=A.dtype, device=A.device)
    Z = eye.clone()
    for _ in range(num_iters):
        T = 0.5 * (3.0 * eye - Z @ Y)
        Y, Z = Y @ T, T @ Z
    return Y * torch.sqrt(norm)


def _sqrtm_psd(A: torch.Tensor) -> torch.Tensor:
    eva, eve = torch.linalg.eigh(A)
    return (eve * torch.sqrt(eva.clamp(min=0.0))[None, :]) @ eve.T


def frechet_distance(mu_x, sigma_x, mu_y, sigma_y) -> torch.Tensor:
    """The Frechet distance of two Gaussians, tr(sqrtm(Sx Sy)) through the PSD form
    tr(sqrt(sqrt(Sx) Sy sqrt(Sx))) (eigh): Newton-Schulz diverges on the near-singular
    covariances of small sample sets."""
    sx_half = _sqrtm_psd(sigma_x)
    tr_covmean = torch.sqrt(torch.linalg.eigvalsh(sx_half @ sigma_y @ sx_half).clamp(min=0.0)).sum()
    diff = mu_x - mu_y
    return (diff * diff).sum() + torch.trace(sigma_x) + torch.trace(sigma_y) - 2.0 * tr_covmean


def feature_stats(feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    mu = feats.mean(dim=0)
    c = feats - mu
    return mu, c.T @ c / (feats.shape[0] - 1)


def fid(feats_real: torch.Tensor, feats_fake: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """FID of two feature sets, each covariance regularized by eps I."""
    mu_r, sig_r = feature_stats(feats_real)
    mu_f, sig_f = feature_stats(feats_fake)
    eye = torch.eye(sig_r.shape[0], dtype=sig_r.dtype, device=sig_r.device)
    return frechet_distance(mu_r, sig_r + eps * eye, mu_f, sig_f + eps * eye)


def kernel_distance(feats_x: torch.Tensor, feats_y: torch.Tensor, degree: int = 3, gamma: Optional[float] = None,
                    coef0: float = 1.0) -> torch.Tensor:
    """Unbiased polynomial-kernel MMD^2 (KID)."""
    gamma = 1.0 / feats_x.shape[1] if gamma is None else gamma
    k_xx = (gamma * feats_x @ feats_x.T + coef0) ** degree
    k_yy = (gamma * feats_y @ feats_y.T + coef0) ** degree
    k_xy = (gamma * feats_x @ feats_y.T + coef0) ** degree
    m, n = feats_x.shape[0], feats_y.shape[0]
    sum_xx = (k_xx.sum() - torch.trace(k_xx)) / (m * (m - 1))
    sum_yy = (k_yy.sum() - torch.trace(k_yy)) / (n * (n - 1))
    return sum_xx + sum_yy - 2 * k_xy.mean()


def prdc(feats_real: torch.Tensor, feats_fake: torch.Tensor, nearest_k: int = 5) -> Dict[str, torch.Tensor]:
    """Precision, recall, density and coverage with k-th nearest neighbour radii."""

    def pairwise(a, b):
        a2, b2 = (a * a).sum(1), (b * b).sum(1)
        return torch.sqrt(torch.clamp(a2[:, None] + b2[None] - 2 * a @ b.T, min=0.0))

    d_rr, d_ff, d_rf = pairwise(feats_real, feats_real), pairwise(feats_fake, feats_fake), pairwise(feats_real,
                                                                                                    feats_fake)
    r_real = torch.sort(d_rr, dim=1).values[:, nearest_k]  # the k-th neighbour, self at index 0
    r_fake = torch.sort(d_ff, dim=1).values[:, nearest_k]
    inside_real = d_rf < r_real[:, None]
    return {"precision": inside_real.any(dim=0).float().mean(),
            "recall": (d_rf < r_fake[None, :]).any(dim=1).float().mean(),
            "density": inside_real.float().sum(dim=0).mean() / nearest_k,
            "coverage": (d_rf.min(dim=1).values < r_real).float().mean()}


# ------------------------------------------------------------ extractor
def clean_resize(img: torch.Tensor, size: int = 299) -> torch.Tensor:
    """Anti-aliased bicubic resize of (B, C, H, W) to size x size, as jax.image.resize does."""
    return resize(img, (size, size), "bicubic")


class ResNetExtractor:
    """A tiny random ResNet trunk: a fast stand-in for tests of the metric math and for the fit loop's
    evaluation; real FID / KID runs take extractor="swav" or "inception". Parameters are drawn from
    `gen` (seed 0 on `device` unless given) with maua_tpu's distributions, or taken as given in the
    port's layout (`bridge.resnet_extractor_params_to_torch`)."""

    def __init__(self, width: int = 32, depth: Tuple[int, ...] = (2, 2, 2, 2), feat_dim: int = 512,
                 gen: Optional[torch.Generator] = None, params: Optional[Dict] = None, device=None):
        if params is None:
            gen = gen if gen is not None else torch.Generator(device=resolve_device(device)).manual_seed(0)
            params = {"stem": self._conv_init(gen, 7, 3, width)}
            blocks, ch = [], width
            for stage, n in enumerate(depth):
                out_ch = width * 2**stage
                for i in range(n):
                    blocks.append({
                        "conv1": self._conv_init(gen, 3, ch, out_ch),
                        "conv2": self._conv_init(gen, 3, out_ch, out_ch),
                        "skip": None if ch == out_ch else self._conv_init(gen, 1, ch, out_ch),
                        "stride": 2 if (i == 0 and stage > 0) else 1,
                    })
                    ch = out_ch
            params["blocks"] = blocks
            params["head"] = {"w": torch.randn(feat_dim, ch, generator=gen, device=gen.device) / math.sqrt(ch)}
        self.params = params
        self.feat_dim = params["head"]["w"].shape[0]

    @staticmethod
    def _conv_init(gen, k, ci, co):
        w = torch.randn(co, ci, k, k, generator=gen, device=gen.device) * math.sqrt(2.0 / (ci * k * k))
        return {"w": w, "b": torch.zeros(co, device=gen.device)}

    def _forward(self, img: torch.Tensor) -> torch.Tensor:
        def conv(p, x, stride=1):
            return F.conv2d(x, p["w"], p["b"], stride=stride, padding=p["w"].shape[-1] // 2)

        x = F.relu(conv(self.params["stem"], img, stride=2))
        for blk in self.params["blocks"]:
            y = conv(blk["conv2"], F.relu(conv(blk["conv1"], x, stride=blk["stride"])))
            skip = x if blk["skip"] is None else conv(blk["skip"], x)
            if blk["stride"] > 1:
                skip = skip[:, :, :: blk["stride"], :: blk["stride"]]
            x = F.relu(y + skip)
        return x.mean(dim=(2, 3)) @ self.params["head"]["w"].t()

    @torch.no_grad()
    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        """img (B, 3, H, W) in [-1, 1] -> (B, feat_dim)."""
        return self._forward(clean_resize(img.float(), 64))


def _as_images(images, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(images) if not isinstance(images, torch.Tensor) else images,
                           dtype=torch.float32, device=device)


def compute_metrics(real_images, fake_images, extractor: Optional[Callable] = None, batch: int = 32,
                    nearest_k: int = 5, device=None) -> Dict[str, float]:
    """FID, KID and PRDC of two image sets (B, 3, H, W) in [-1, 1] (tensors or arrays). `extractor` is a
    callable or a name, "swav" or "inception" (`gan/extractors.py`); the default is ResNetExtractor."""
    device = resolve_device(device)
    if isinstance(extractor, str):
        from .extractors import get_extractor

        extractor = get_extractor(extractor, device=device)
    extractor = extractor or ResNetExtractor(device=device)

    def extract(images):
        return torch.cat([extractor(_as_images(images[i : i + batch], device)) for i in range(0, len(images), batch)])

    fr, ff = extract(real_images), extract(fake_images)
    out = {"fid": float(fid(fr, ff)), "kid": float(kernel_distance(fr, ff))}
    out.update({k: float(v) for k, v in prdc(fr, ff, nearest_k).items()})
    return out


def compute(real_samples, fake_samples: Callable, n_samples: int = 10_000, extractor="swav", batch_size: int = 32,
            nearest_k: int = 5, ignore_cache: bool = False, size: int = 256, device=None) -> Dict[str, float]:
    """An image folder (or an NCHW array in [0, 1]) against a generator: `fake_samples()` returns a batch
    (B, 3, H, W) in [0, 1]. Batches off `size` are resized to it (lanczos3, clipped to [0, 1]). The
    folder's features are cached under WORKSPACE/cache by folder, extractor and n_samples."""
    import os

    from .. import utility
    from ..ops.image import resample
    from ..ops.io import load_image

    device = resolve_device(device)
    if isinstance(extractor, str):
        from .extractors import get_extractor

        name, extract_fn = extractor, get_extractor(extractor, device=device)
    else:
        name, extract_fn = getattr(extractor, "__name__", "custom"), extractor

    def features(batches):
        outs = []
        for b in batches:
            b = _as_images(b, device)
            if b.shape[2] != size or b.shape[3] != size:
                b = resize(b, (size, size), "lanczos3").clamp(0, 1)
            outs.append(extract_fn(b * 2 - 1).float().cpu().numpy())
        return np.concatenate(outs)

    if isinstance(real_samples, (str, os.PathLike)):
        cache_dir = os.path.join(utility.WORKSPACE, "cache")
        stem = os.path.basename(os.path.normpath(str(real_samples)))
        cache_file = os.path.join(cache_dir, f"{stem}_real_{name}_{n_samples}_features.npz")
        if os.path.exists(cache_file) and not ignore_cache:
            fr = np.load(cache_file)["features"]
        else:
            exts = (".png", ".jpg", ".jpeg", ".webp", ".bmp")
            paths = sorted(os.path.join(str(real_samples), f) for f in os.listdir(str(real_samples))
                           if f.lower().endswith(exts))[:n_samples]
            if not paths:
                raise ValueError(f"no images found in {real_samples}")

            def load(p):  # (1, 3, H, W): short side at `size`, as ops.image.resample scales it
                return resample(torch.from_numpy(load_image(p)).to(device), size).permute(0, 3, 1, 2)

            batches = (torch.cat([load(p) for p in paths[i : i + batch_size]])
                       for i in range(0, len(paths), batch_size))
            fr = features(batches)
            os.makedirs(cache_dir, exist_ok=True)
            np.savez(cache_file, features=fr)
    else:
        arr = real_samples[:n_samples]
        fr = features(arr[i : i + batch_size] for i in range(0, len(arr), batch_size))

    n_fake = min(n_samples, len(fr))
    ff = []
    while sum(len(f) for f in ff) < n_fake:
        ff.append(features([fake_samples()]))
    ff = np.concatenate(ff)[:n_fake]
    fr_t, ff_t = torch.from_numpy(fr[: len(ff)]).to(device), torch.from_numpy(ff).to(device)
    out = {"fid": float(fid(fr_t, ff_t)), "kid": float(kernel_distance(fr_t, ff_t))}
    out.update({k: float(v) for k, v in prdc(fr_t, ff_t, nearest_k).items()})
    return out
