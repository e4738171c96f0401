"""Autoregressive token transformer for text-to-image and text-to-video.

Port of `maua_tpu/autoregressive/transformer.py`: a GPT-style decoder over
text tokens followed by VQ image tokens, with absolute text positions and
row / column (and, for video, frame) embeddings of image positions; a
KV-cached sampler and a recompute sampler with temperature, top-k and
top-p; teacher-forced positions for the oversampled decode.

Parameters are a dict of tensors in maua_tpu's layout (linear weights
(in, out), applied as `x @ w`), so `bridge.ar_params_to_torch` and the
finetune `.npz` checkpoints carry them over unchanged. The attention is
plain: maua_tpu computes it with einsum and softmax, outside any Pallas
kernel. Logits are f32, masked positions get -1e9, and the MLP's GELU is
the tanh approximation (`jax.nn.gelu`'s default).

Sampling is an eager loop over steps. Each step's draw is Gumbel noise of
the sampled logits' shape, added before the argmax (Gumbel-max, as
`jax.random.categorical` samples): `draw(shape)` gives it, by default
`gumbel_draws(gen)`; tests hand in JAX's own draws. The cache holds
(B, H, total, hd) keys and values; a step attends to the positions filled so
far (maua_tpu masks the rest of the padded row to -1e9, whose softmax
weight is exactly 0).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..utility import StageClock

NEG = -1e9


@dataclasses.dataclass(frozen=True)
class ARConfig:
    vocab_size: int = 8192  # image token codebook
    text_vocab_size: int = 16384
    text_length: int = 64
    image_rows: int = 16
    image_cols: int = 16
    width: int = 256
    layers: int = 4
    heads: int = 8
    dtype: str = "float32"
    max_frames: int = 8  # temporal positions for video token grids

    @property
    def image_length(self) -> int:
        return self.image_rows * self.image_cols

    @property
    def total_length(self) -> int:
        return self.text_length + self.image_length

    @property
    def total_vocab(self) -> int:
        return self.text_vocab_size + self.vocab_size


def init_params(cfg: ARConfig, gen: torch.Generator) -> Dict:
    """Random parameters with maua_tpu's init distributions, drawn from `gen` on its device."""
    dev, w = gen.device, cfg.width

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * std

    def ln():
        return {"scale": torch.ones(w, device=dev), "bias": torch.zeros(w, device=dev)}

    p = {
        "tok_emb": randn(cfg.total_vocab, w, std=0.02),
        "pos_emb": randn(cfg.total_length, w, std=0.01),
        "row_emb": randn(cfg.image_rows, w, std=0.01),
        "col_emb": randn(cfg.image_cols, w, std=0.01),
        "frame_emb": randn(cfg.max_frames, w, std=0.01),
        "ln_f": ln(),
        "head": {"w": randn(w, cfg.total_vocab, std=0.02)},
        "blocks": [],
    }
    for _ in range(cfg.layers):
        p["blocks"].append({
            "ln1": ln(),
            "qkv": {"w": randn(w, 3 * w, std=1 / math.sqrt(w)), "b": torch.zeros(3 * w, device=dev)},
            "proj": {"w": randn(w, w, std=1 / math.sqrt(w)), "b": torch.zeros(w, device=dev)},
            "ln2": ln(),
            "fc1": {"w": randn(w, 4 * w, std=1 / math.sqrt(w)), "b": torch.zeros(4 * w, device=dev)},
            "fc2": {"w": randn(4 * w, w, std=1 / math.sqrt(4 * w)), "b": torch.zeros(w, device=dev)},
        })
    return p


def _ln(p, x):
    return F.layer_norm(x.float(), (x.shape[-1],), p["scale"], p["bias"], 1e-5).to(x.dtype)


def _dense(p, x):
    return torch.addmm(p["b"], x.reshape(-1, x.shape[-1]), p["w"]).reshape(*x.shape[:-1], p["w"].shape[1])


def _mlp(blk, x):
    return _dense(blk["fc2"], F.gelu(_dense(blk["fc1"], _ln(blk["ln2"], x)), approximate="tanh"))


def _softmax_attend(q, k, v, mask, dtype):
    """q (B, H, Tq, hd), k and v (B, H, Tk, hd): f32 logits, masked entries -1e9, probabilities in dtype."""
    logits = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG)
    return torch.softmax(logits, -1).to(dtype) @ v


def position_table(params: Dict, cfg: ARConfig, t: int, frame_ids=None) -> torch.Tensor:
    """(T, width) position embedding of each global position: text positions absolute, image positions
    (frame_emb +) row / column embeddings of the position within its frame's grid (`frame_ids` gives each
    position's temporal frame, -1 for text)."""
    dev = params["pos_emb"].device
    if frame_ids is None:
        pos = params["pos_emb"][:t]
        img_idx = torch.arange(t, device=dev) - cfg.text_length
        in_img = img_idx >= 0
        rows = torch.clamp(torch.div(img_idx, cfg.image_cols, rounding_mode="floor"), 0, cfg.image_rows - 1)
        cols = torch.clamp(torch.remainder(img_idx, cfg.image_cols), 0, cfg.image_cols - 1)
        grid = params["row_emb"][rows] + params["col_emb"][cols]
        return pos + torch.where(in_img[:, None], grid, torch.zeros_like(grid))
    frame_ids = torch.as_tensor(frame_ids, device=dev).long()[:t]
    in_img = frame_ids >= 0
    img_pos = torch.cumsum(in_img.long(), 0) - 1
    off = torch.where(in_img, torch.remainder(img_pos, cfg.image_length), torch.zeros_like(img_pos))
    rows = torch.clamp(torch.div(off, cfg.image_cols, rounding_mode="floor"), 0, cfg.image_rows - 1)
    cols = torch.clamp(torch.remainder(off, cfg.image_cols), 0, cfg.image_cols - 1)
    fe = params["frame_emb"][torch.clamp(frame_ids, 0, cfg.max_frames - 1)]
    text_pos = torch.clamp(torch.arange(t, device=dev), 0, cfg.text_length - 1)
    return torch.where(in_img[:, None], fe + params["row_emb"][rows] + params["col_emb"][cols],
                       params["pos_emb"][text_pos])


def _heads(x, cfg):
    b, t = x.shape[:2]
    return x.reshape(b, t, cfg.heads, cfg.width // cfg.heads).transpose(1, 2)


def transformer_block(blk: Dict, x: torch.Tensor, cfg: ARConfig, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """One pre-LN causal block (attention + MLP) on x (B, T, width); mask (T, T) bool, True = attend."""
    b, t = x.shape[:2]
    q, k, v = _dense(blk["qkv"], _ln(blk["ln1"], x)).chunk(3, dim=-1)
    att = _softmax_attend(_heads(q, cfg), _heads(k, cfg), _heads(v, cfg), mask, x.dtype)
    x = x + _dense(blk["proj"], att.transpose(1, 2).reshape(b, t, cfg.width))
    return x + _mlp(blk, x)


def forward(params: Dict, tokens: torch.Tensor, cfg: ARConfig, mask: Optional[torch.Tensor] = None,
            frame_ids=None, remat: bool = False) -> torch.Tensor:
    """Full-sequence logits (B, T, total_vocab) of tokens (B, T). `mask` overrides the causal mask;
    `frame_ids` (T,) embeds image positions by frame (video); `remat` recomputes each block's
    activations in the backward pass (torch.utils.checkpoint)."""
    t = tokens.shape[1]
    x = params["tok_emb"][tokens.long()] + position_table(params, cfg, t, frame_ids)[None]
    if mask is None:
        mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    for blk in params["blocks"]:
        if remat:
            from torch.utils.checkpoint import checkpoint

            x = checkpoint(transformer_block, blk, x, cfg, mask, use_reentrant=False)
        else:
            x = transformer_block(blk, x, cfg, mask)
    return _ln(params["ln_f"], x) @ params["head"]["w"]


Caches = List[Tuple[torch.Tensor, torch.Tensor]]


def kv_prefill(params: Dict, cfg: ARConfig, x: torch.Tensor, total: int) -> Caches:
    """Run the causal blocks over an embedded prefix x (B, n, width) in one pass; returns each block's
    key and value caches (B, H, total, hd), filled at [0, n)."""
    b, n = x.shape[:2]
    hd = cfg.width // cfg.heads
    mask = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
    caches = []
    for blk in params["blocks"]:
        q, k, v = _dense(blk["qkv"], _ln(blk["ln1"], x)).chunk(3, dim=-1)
        kh, vh = _heads(k, cfg), _heads(v, cfg)
        ck = x.new_zeros(b, cfg.heads, total, hd)
        cv = x.new_zeros(b, cfg.heads, total, hd)
        ck[:, :, :n] = kh
        cv[:, :, :n] = vh
        caches.append((ck, cv))
        att = _softmax_attend(_heads(q, cfg), kh, vh, mask, x.dtype)
        x = x + _dense(blk["proj"], att.transpose(1, 2).reshape(b, n, cfg.width))
        x = x + _mlp(blk, x)
    return caches


def kv_step(params: Dict, cfg: ARConfig, x: torch.Tensor, p: int, caches: Caches):
    """One cached decode step: x (B, width) is the embedded input at position p; each cache gains
    position p (in place) and the query attends to positions [0, p]. Returns (logits (B, total_vocab),
    caches)."""
    b = x.shape[0]
    hd = cfg.width // cfg.heads
    for blk, (ck, cv) in zip(params["blocks"], caches):
        q, k, v = _dense(blk["qkv"], _ln(blk["ln1"], x)).chunk(3, dim=-1)
        ck[:, :, p] = k.reshape(b, cfg.heads, hd)
        cv[:, :, p] = v.reshape(b, cfg.heads, hd)
        att = _softmax_attend(q.reshape(b, cfg.heads, 1, hd), ck[:, :, : p + 1], cv[:, :, : p + 1], None, x.dtype)
        x = x + _dense(blk["proj"], att.reshape(b, cfg.width))
        x = x + _mlp(blk, x)
    return _ln(params["ln_f"], x) @ params["head"]["w"], caches


def gumbel_draws(gen: torch.Generator) -> Callable:
    """draw(shape) -> standard Gumbel noise -log(-log(U)) from `gen`, U in [tiny, 1)."""

    def draw(shape):
        u = torch.rand(shape, generator=gen, device=gen.device).clamp_min_(torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))

    return draw


def resolve_draw(params: Dict, gen: Optional[torch.Generator], draw: Optional[Callable]) -> Callable:
    """`draw` where given, else Gumbel draws from `gen`, else from a generator seeded 0 on the parameters'
    device."""
    if draw is not None:
        return draw
    return gumbel_draws(gen if gen is not None else torch.Generator(device=params["tok_emb"].device).manual_seed(0))


def filter_logits(logits: torch.Tensor, temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0):
    """Temperature, then top-k (every logit equal to the k-th largest kept), then top-p by the sorted
    cumulative probability (maua_tpu's `_sample_logits` before its draw); removed entries are -inf."""
    logits = logits / max(temperature, 1e-6)
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -math.inf)
    if top_p > 0.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, -1), -1)
        cutoff_idx = torch.clamp((cum < top_p).sum(-1, keepdim=True), max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, -math.inf)
    return logits


def categorical(logits: torch.Tensor, draw: Callable) -> torch.Tensor:
    """Gumbel-max sample over the last axis (jax.random.categorical's method); the draw may come from
    another device's generator."""
    return torch.argmax(logits + draw(tuple(logits.shape)).to(logits.device, logits.dtype), dim=-1)


def sample_logits(logits, draw: Callable, temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0):
    return categorical(filter_logits(logits, temperature, top_k, top_p), draw)


@torch.no_grad()
def generate_tokens(params: Dict, text_tokens: torch.Tensor, cfg: ARConfig, gen: Optional[torch.Generator] = None,
                    temperature: float = 1.0, top_k: int = 64, top_p: float = 0.0,
                    n_image_tokens: Optional[int] = None, forced_tokens: Optional[torch.Tensor] = None,
                    forced_mask=None, cached: bool = True, draw: Optional[Callable] = None,
                    stage_times: Optional[Dict[str, float]] = None) -> torch.Tensor:
    """Sample (B, n_image_tokens) image-vocab ids after text_tokens (B, text_length). Forced positions
    (`forced_mask` (n_img,) bool) keep `forced_tokens` (B, n_img) but still condition every later sample.
    The KV-cached path prefills the text once and pays one cached step per token; cached=False
    recomputes the prefix for each token (the same tokens for the same draws). One draw a step, from
    `draw` where given, else Gumbel noise from `gen` (seed 0 on the parameters' device). `stage_times`
    collects the seconds of the prefill and of the sampling loop, each ended by a device synchronization."""
    device = params["tok_emb"].device
    draw = resolve_draw(params, gen, draw)
    n_img = n_image_tokens or cfg.image_length
    text_tokens = torch.as_tensor(text_tokens, device=device).long()
    b = text_tokens.shape[0]
    total = cfg.text_length + n_img
    tokens = torch.cat([text_tokens, text_tokens.new_zeros(b, n_img)], dim=1)
    forced = None
    if forced_tokens is not None and forced_mask is not None:
        forced = (torch.as_tensor(forced_tokens, device=device).long() + cfg.text_vocab_size,
                  [bool(m) for m in torch.as_tensor(forced_mask).tolist()])
    clock = StageClock(device, stage_times)
    caches = None
    if cached:
        pos_tab = position_table(params, cfg, total)
        n = cfg.text_length - 1
        caches = clock.stage("prefill", lambda: kv_prefill(params, cfg, params["tok_emb"][tokens[:, :n]]
                                                           + pos_tab[None, :n], total))

    def sample():
        for i in range(n_img):
            p = cfg.text_length + i  # the position being sampled
            if cached:
                logits, _ = kv_step(params, cfg, params["tok_emb"][tokens[:, p - 1]] + pos_tab[p - 1], p - 1, caches)
            else:
                logits = forward(params, tokens[:, :p], cfg)[:, p - 1]
            nxt = sample_logits(logits[:, cfg.text_vocab_size:], draw, temperature, top_k, top_p) \
                + cfg.text_vocab_size
            tokens[:, p] = forced[0][:, i] if forced is not None and forced[1][i] else nxt

    clock.stage("sampling", sample)
    return tokens[:, cfg.text_length:] - cfg.text_vocab_size


def tp_shardings(params: Dict, mesh):
    """maua_tpu's tensor-parallel rule, leaf by leaf: a matrix under `qkv`, `fc1` or `head` splits its
    output features on the mesh's `tensor` axis, (None, "tensor"); under `proj` or `fc2` its input
    features, ("tensor", None); every other leaf is replicated, (). A tree of these specs in the shape
    of `params` (`parallel.mesh.shard_params` places the leaves; on one device each shard is the leaf)."""
    if "tensor" not in mesh.shape:
        raise ValueError(f"the mesh has no 'tensor' axis: {mesh.axis_names}")

    def spec(names, leaf):
        if leaf.ndim != 2:
            return ()
        if {"qkv", "fc1", "head"} & set(names):
            return (None, "tensor")
        if {"proj", "fc2"} & set(names):
            return ("tensor", None)
        return ()

    def walk(tree, names):
        if isinstance(tree, dict):
            return {k: walk(v, names + [k]) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, names + [i]) for i, v in enumerate(tree)]
        return spec(names, tree)

    return walk(params, [])
