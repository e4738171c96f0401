"""CogVideo-style autoregressive text-to-video: the sequence-filling sampler,
the two-stage (keyframes, then dyadic interpolation) pipeline, the rolling
token window and the VQ decode to frames.

Port of `maua_tpu/autoregressive/video.py`:
- `filling_sequence` fills a sequence's -1 holes left to right; given
  positions (text, conditioning frames) are teacher-forced, holes sampled
  with a per-position top-k (the first frame's may differ). An optional
  guider sequence (a generic text) runs beside it and token-level CFG mixes
  `guider + (logits - guider) * alpha`. The input at each frame's first
  position is <start_of_image>, while the output token is kept.
- stage 1 `generate_video_tokens`: text -> sequential frames, sliding a
  window of real frame token grids once it is full.
- stage 2 `interpolate_frames`: keyframe triples at temporal slots 0, 2, 4
  (sequence slots [0, 2, 4, 1, 3]); the model fills slots 1 and 3, merged in
  temporal order: K frames -> 2K - 1.
- `generate_video`: both stages and the VQ decode to uint8 frames
  (F, B, H, W, 3), rounded half to even as `jnp.round`.

The KV-cached fill (`cached=True`, the default) prefills the given context
once and pays one cached step per token; `cached=False` recomputes the
prefix for every token. Both take one draw a step (see `transformer.py`) and
sample the same tokens for the same draws. `sharded_generate*` place the
parameters for a mesh (`transformer.tp_shardings`' rule, on the mesh's one
device) and sample the same tokens as the unsharded functions.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from .transformer import ARConfig, categorical, forward, kv_prefill, kv_step, position_table, resolve_draw


def boi_token(cfg: ARConfig) -> int:
    """The reserved <start_of_image> id: the last text-vocabulary slot."""
    return cfg.text_vocab_size - 1


def _sample_dynamic_k(logits: torch.Tensor, temperature: float, k: int, draw: Callable) -> torch.Tensor:
    """Top-k sample (every logit equal to the k-th largest kept) at a per-position k."""
    logits = logits / max(temperature, 1e-6)
    v = logits.shape[-1]
    kth = torch.sort(logits, dim=-1).values[..., min(max(v - k, 0), v - 1)][..., None]
    return categorical(logits.masked_fill(logits < kth, -float("inf")), draw)


def build_video_sequence(cfg: ARConfig, text_tokens: np.ndarray, n_frames: int,
                         given_frames: Optional[np.ndarray] = None, frame_order: Optional[np.ndarray] = None):
    """(seq, frame_ids, boi_mask): seq (B, T) full-vocabulary ids with -1 holes to fill, frame_ids each
    position's temporal frame (-1 = text), boi_mask the frame-start positions whose input embedding is
    <start_of_image>. given_frames (B, n_given, L) image-vocabulary ids fill the first slots."""
    text_tokens = np.asarray(text_tokens)
    b, L = text_tokens.shape[0], cfg.image_length
    t = cfg.text_length + n_frames * L
    seq = np.full((b, t), -1, np.int64)
    seq[:, : cfg.text_length] = text_tokens
    if given_frames is not None:
        given_frames = np.asarray(given_frames)
        for f in range(given_frames.shape[1]):
            s = cfg.text_length + f * L
            seq[:, s: s + L] = given_frames[:, f] + cfg.text_vocab_size
    order = np.arange(n_frames) if frame_order is None else np.asarray(frame_order)
    frame_ids = np.concatenate([np.full(cfg.text_length, -1), np.repeat(order, L)])
    boi_mask = np.zeros(t, bool)
    boi_mask[cfg.text_length + np.arange(n_frames) * L] = True
    return seq, frame_ids, boi_mask


@torch.no_grad()
def filling_sequence(params: Dict, seq, frame_ids, boi_mask, cfg: ARConfig, gen: Optional[torch.Generator] = None,
                     guider_seq=None, guidance_alpha: float = 1.0, temperature: float = 1.0, top_k: int = 64,
                     top_k_first_frame: Optional[int] = None, cached: bool = True,
                     draw: Optional[Callable] = None) -> torch.Tensor:
    """Fill every -1 hole of seq (B, T) left to right; returns (B, T) full-vocabulary tokens. The first
    frame samples with top_k_first_frame (default top_k). One draw a step from `draw`, else Gumbel noise
    from `gen` (seed 0 on the parameters' device)."""
    device = params["tok_emb"].device
    draw = resolve_draw(params, gen, draw)
    seq_np = np.asarray(seq)
    context_length = int(np.min(np.argmax(np.concatenate([seq_np < 0, np.ones((seq_np.shape[0], 1), bool)], 1), 1)))
    if context_length == 0:
        raise ValueError("sequence needs at least one given token")
    b, t = seq_np.shape
    tk1 = top_k if top_k_first_frame is None else top_k_first_frame
    top_ks = np.full(t, top_k, np.int64)
    top_ks[: cfg.text_length + cfg.image_length] = tk1

    seq = torch.as_tensor(seq_np, device=device).long()
    boi = torch.as_tensor(np.asarray(boi_mask), device=device)
    boi_id = boi_token(cfg)
    streams = [torch.clamp_min(seq, 0)]  # the main tokens, then the guider's
    if guider_seq is not None:
        streams.append(torch.clamp_min(torch.as_tensor(np.asarray(guider_seq), device=device).long(), 0))

    def inputs(tokens, n):
        return torch.where(boi[None, :n], boi_id, tokens[:, :n])

    if cached:
        pos_tab = position_table(params, cfg, t, frame_ids)
        n = context_length - 1
        caches = [kv_prefill(params, cfg, params["tok_emb"][inputs(s, n)] + pos_tab[None, :n], t) for s in streams]

    for p in range(context_length, t):
        lgs = []
        for si, tokens in enumerate(streams):
            if cached:
                prev = torch.where(boi[p - 1], boi_id, tokens[:, p - 1])
                lg, caches[si] = kv_step(params, cfg, params["tok_emb"][prev] + pos_tab[p - 1], p - 1, caches[si])
            else:
                lg = forward(params, inputs(tokens, p), cfg, frame_ids=frame_ids)[:, p - 1]
            lgs.append(lg)
        lg = lgs[0] if len(lgs) == 1 else lgs[1] + (lgs[0] - lgs[1]) * guidance_alpha
        sampled = _sample_dynamic_k(lg[:, cfg.text_vocab_size:], temperature, int(top_ks[p]), draw)
        nxt = torch.where(seq[:, p] >= 0, seq[:, p], sampled + cfg.text_vocab_size)
        for tokens in streams:
            tokens[:, p] = nxt
    return streams[0]


def _image_tokens(cfg: ARConfig, filled: torch.Tensor, n_frames: int) -> torch.Tensor:
    """(B, T) full-vocabulary -> (n_frames, B, L) image-vocabulary ids."""
    img = torch.clamp(filled[:, cfg.text_length:] - cfg.text_vocab_size, 0, cfg.vocab_size - 1)
    return img.reshape(filled.shape[0], n_frames, cfg.image_length).transpose(0, 1)


def generate_video_tokens(params: Dict, text_tokens, cfg: ARConfig, n_frames: int,
                          gen: Optional[torch.Generator] = None, window: Optional[int] = None,
                          guider_text_tokens=None, guidance_alpha: float = 1.0, temperature: float = 1.0,
                          top_k: int = 64, top_k_first_frame: Optional[int] = None, cached: bool = True,
                          draw: Optional[Callable] = None) -> torch.Tensor:
    """Stage 1: fill up to `window` frames in one sequence, then slide, each new frame sampled with the
    previous window - 1 frames teacher-forced. Returns (n_frames, B, L) image-vocabulary ids."""
    draw = resolve_draw(params, gen, draw)
    text_tokens = np.asarray(text_tokens)
    window = min(n_frames, cfg.max_frames) if window is None else min(window, cfg.max_frames)

    def fill(given, n_in_seq):
        seq, fids, boi = build_video_sequence(cfg, text_tokens, n_in_seq, given_frames=given)
        gseq = None
        if guider_text_tokens is not None:
            gseq = seq.copy()
            gseq[:, : cfg.text_length] = np.asarray(guider_text_tokens)
        filled = filling_sequence(params, seq, fids, boi, cfg, guider_seq=gseq, guidance_alpha=guidance_alpha,
                                  temperature=temperature, top_k=top_k, top_k_first_frame=top_k_first_frame,
                                  cached=cached, draw=draw)
        return _image_tokens(cfg, filled, n_in_seq)

    frames = list(fill(None, window))
    while len(frames) < n_frames:
        ctx = torch.stack(frames[-(window - 1):], dim=1).cpu().numpy()  # (B, window - 1, L)
        frames.append(fill(ctx, window)[-1])
    return torch.stack(frames[:n_frames])


def interpolate_frames(params: Dict, keyframes, text_tokens, cfg: ARConfig, gen: Optional[torch.Generator] = None,
                       temperature: float = 1.0, top_k: int = 64, cached: bool = True,
                       draw: Optional[Callable] = None) -> torch.Tensor:
    """Stage 2: each keyframe triple at temporal slots 0, 2, 4 of a 5-frame window; the model fills
    slots 1 and 3; windows merge in temporal order. keyframes (K, B, L), K odd >= 3 -> (2K - 1, B, L)."""
    draw = resolve_draw(params, gen, draw)
    keyframes = torch.as_tensor(keyframes)
    k_frames = keyframes.shape[0]
    if k_frames < 3 or k_frames % 2 == 0:
        raise ValueError("need an odd number (>=3) of keyframes")
    if cfg.max_frames < 5:
        raise ValueError("stage 2 needs cfg.max_frames >= 5")
    order = np.array([0, 2, 4, 1, 3])  # sequence slot -> temporal id
    out = []
    for i in range((k_frames - 1) // 2):
        given = keyframes[2 * i: 2 * i + 3].transpose(0, 1).cpu().numpy()  # (B, 3, L)
        seq, fids, boi = build_video_sequence(cfg, text_tokens, 5, given_frames=given, frame_order=order)
        slots = _image_tokens(cfg, filling_sequence(params, seq, fids, boi, cfg, temperature=temperature,
                                                    top_k=top_k, cached=cached, draw=draw), 5)
        # temporal order: slot 0 (t0), slot 3 (t1), slot 1 (t2), slot 4 (t3); slot 2 (t4) opens the next window
        out.extend([slots[0], slots[3], slots[1], slots[4]])
    out.append(keyframes[-1].to(out[-1].device))
    return torch.stack(out)


def generate_video(params: Dict, text_tokens, cfg: ARConfig, vq_params: Dict, vq_cfg, n_keyframes: int = 3,
                   interpolation_rounds: int = 1, gen: Optional[torch.Generator] = None, guider_text_tokens=None,
                   guidance_alpha: float = 1.0, temperature: float = 1.0, top_k: int = 64, cached: bool = True,
                   draw: Optional[Callable] = None) -> np.ndarray:
    """Keyframes, interpolation rounds (each doubles the frame rate), then the VQ decode: uint8 frames
    (F, B, H, W, 3)."""
    from .vq import decode_video_tokens

    if interpolation_rounds > 0 and (n_keyframes < 3 or n_keyframes % 2 == 0):
        raise ValueError("stage-2 interpolation needs an odd number (>=3) of keyframes")
    draw = resolve_draw(params, gen, draw)
    tokens = generate_video_tokens(params, text_tokens, cfg, n_keyframes, guider_text_tokens=guider_text_tokens,
                                   guidance_alpha=guidance_alpha, temperature=temperature, top_k=top_k,
                                   cached=cached, draw=draw)
    for _ in range(interpolation_rounds):
        tokens = interpolate_frames(params, tokens, text_tokens, cfg, temperature=temperature, top_k=top_k,
                                    cached=cached, draw=draw)
    imgs = decode_video_tokens(vq_params, tokens, vq_cfg, cfg.image_rows, cfg.image_cols)
    return torch.round((imgs + 1.0) * 127.5).to(torch.uint8).permute(0, 1, 3, 4, 2).cpu().numpy()


def _shard_params(params, mesh):
    from ..parallel.mesh import shard_params
    from .transformer import tp_shardings

    tp_shardings(params, mesh)  # maua_tpu's rule; over the mesh's one device every shard is the whole leaf
    return shard_params(mesh, params)


def sharded_generate(params, text_tokens, cfg: ARConfig, mesh, **kwargs):
    """`transformer.generate_tokens` with the parameters placed for `mesh`: the same tokens for the same
    draws."""
    from .transformer import generate_tokens

    with mesh:
        return generate_tokens(_shard_params(params, mesh), text_tokens, cfg, **kwargs)


def sharded_generate_video(params, text_tokens, cfg: ARConfig, mesh, n_frames: int = 2, **kwargs):
    """`generate_video_tokens` with the parameters placed for `mesh`: the same tokens for the same draws."""
    with mesh:
        return generate_video_tokens(_shard_params(params, mesh), text_tokens, cfg, n_frames, **kwargs)
