"""CLIP and aesthetic image ranking.

Port of `maua_tpu/dataset/ranker.py`: `ImageRanker` scores images by their
CLIP similarity to a prompt plus a weighted aesthetic score
(`perceptors.clip.AestheticPerceptor`), and `laion_clip_retrieval` queries
the LAION service and downloads its candidates
(`laion_clip_retrieval.retrieve` / `download`, with injectable transports).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class ImageRanker:
    """Rank images by CLIP-prompt similarity plus aesthetic score."""

    def __init__(self, perceptor=None, aesthetic_weight: float = 0.5, device=None):
        if perceptor is None:
            from ..perceptors.clip import AestheticPerceptor

            perceptor = AestheticPerceptor(device=device)
        self.perceptor = perceptor
        self.aesthetic_weight = aesthetic_weight

    @torch.no_grad()
    def score(self, images, prompt: Optional[str] = None) -> np.ndarray:
        """images (B, H, W, 3) in [-1, 1] (the perceptor's input) -> (B,) scores."""
        imgs = torch.as_tensor(np.asarray(images) if not isinstance(images, torch.Tensor) else images,
                               dtype=torch.float32, device=self.perceptor.device)
        emb = self.perceptor.encode_image(imgs)
        total = torch.zeros(imgs.shape[0], device=emb.device)
        if prompt is not None:
            txt = self.perceptor.encode_text([prompt])
            total = total + (emb @ txt.T)[:, 0]
        if hasattr(self.perceptor, "score") and self.aesthetic_weight > 0:
            total = total + self.aesthetic_weight * self.perceptor.score(imgs)
        return total.cpu().numpy()

    def rank(self, images, prompt: Optional[str] = None) -> np.ndarray:
        """Indices of the images, best first."""
        return np.argsort(-self.score(images, prompt))


def laion_clip_retrieval(texts=(), images=(), urls=(), out_dir="output/", min_size=None, http_post=None,
                         http_get=None, **query_kwargs):
    """Retrieve LAION candidates for the prompts and download them into `out_dir`; the number written."""
    from .laion_clip_retrieval import download, retrieve

    candidates = retrieve(texts=texts, images=images, urls=urls, http_post=http_post, **query_kwargs)
    return download(candidates, out_dir, min_size=min_size, http_get=http_get)
