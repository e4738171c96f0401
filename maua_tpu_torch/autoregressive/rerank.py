"""CLIP reranking of autoregressive sample candidates.

Port of `maua_tpu/autoregressive/rerank.py`: sample candidates (in chunks
of a fixed size, the last padded and its extras dropped), decode them,
score each against the prompt with the port's CLIP (`perceptors/clip.py`)
and keep the best.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def clip_rerank(images: torch.Tensor, text: str, top_n: int = 4, perceptor=None) -> np.ndarray:
    """Indices of the top_n candidates (B, 3, H, W) in [-1, 1] by CLIP similarity to the prompt."""
    if perceptor is None:
        from ..perceptors.clip import CLIPPerceptor

        perceptor = CLIPPerceptor(device=images.device)
    with torch.no_grad():
        img_emb = perceptor.encode_image(images.permute(0, 2, 3, 1))
        txt_emb = perceptor.encode_text([text])
    sims = (img_emb @ txt_emb.T)[:, 0].cpu().numpy()
    return np.argsort(-sims)[:top_n]


def generate_and_rerank(params, cfg, text_tokens, text: str, decode_fn: Callable, n_candidates: int = 8,
                        top_n: int = 2, gen: Optional[torch.Generator] = None, perceptor=None, batch_size: int = 0,
                        draw: Optional[Callable] = None, **sample_kwargs) -> torch.Tensor:
    """Sample n_candidates token grids, decode them, CLIP-rerank, return the best top_n images. With
    0 < batch_size < n_candidates the candidates are sampled in chunks of batch_size, the last padded
    to the same shape and its extras dropped. Draws as in `generate_tokens`."""
    from .transformer import generate_tokens, resolve_draw

    draw = resolve_draw(params, gen, draw)
    text_tokens = torch.as_tensor(text_tokens, device=params["tok_emb"].device)
    if batch_size and batch_size < n_candidates:
        imgs, done = [], 0
        while done < n_candidates:
            toks = generate_tokens(params, text_tokens.repeat(batch_size, 1), cfg, draw=draw, **sample_kwargs)
            take = min(batch_size, n_candidates - done)
            imgs.append(decode_fn(toks)[:take])
            done += take
        imgs = torch.cat(imgs)
    else:
        imgs = decode_fn(generate_tokens(params, text_tokens.repeat(n_candidates, 1), cfg, draw=draw,
                                         **sample_kwargs))
    best = clip_rerank(imgs, text, top_n=top_n, perceptor=perceptor)
    return imgs[torch.as_tensor(best, device=imgs.device)]
