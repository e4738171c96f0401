"""RuDALL-E-style autoregressive finetuning.

Port of `maua_tpu/autoregressive/finetune.py`:
- selective freeze: attention and MLP weights frozen, embeddings, layer
  norms and the head trainable;
- AdamW, or `quantized_adam`: Adam with int8 blockwise moments (m as linear
  codes with a per-block absmax scale, the second moment stored as sqrt(v),
  the denominator floored by half a code step of sqrt(v)), rounding half to
  even as `jnp.round`;
- optax's cosine one-cycle schedule (its horizon floored at 10 steps),
  global-norm clipping at 0.24 and a multi-transform that zeroes the frozen
  leaves' updates, each with optax's formulas (`transforms.py`);
- cross-entropy split into text and image segments;
- gradient checkpointing through `transformer.forward(remat=True)`;
- checkpoints as a flat `.npz` keyed by `jax.tree_util.keystr` paths, so a
  file maua_tpu wrote restores here; an interrupt saves a partial one.

The parameter tree is maua_tpu's (see `transformer.py`); gradients and
updates run over its leaves in JAX's order (dict keys sorted).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import transforms as T
from ..gan.training import tree_leaves, tree_unflatten
from .transformer import ARConfig, forward

f32 = np.float32


# ------------------------------------------------ int8 blockwise Adam
def _quantize_block(x: torch.Tensor, block: int):
    flat = x.reshape(-1)
    flat = F.pad(flat, (0, (-flat.shape[0]) % block))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dequantize_block(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    n = int(np.prod(shape))
    return (q.float() * scale).reshape(-1)[:n].reshape(shape)


def quantized_adam(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                   block: int = 256) -> T.GradientTransformation:
    """Adam with int8 blockwise-quantized moments (the 8-bit Adam role); `learning_rate` is a constant
    or a schedule of the step count (counted from 1, as maua_tpu reads it)."""

    def init(params):
        def q(p):
            mq, ms = _quantize_block(torch.zeros_like(p), block)
            return {"mq": mq, "ms": ms, "uq": mq.clone(), "us": ms.clone()}

        return {"count": 0, "state": [q(p) for p in params]}

    def update(grads, opt_state, params=None):
        count = opt_state["count"] + 1
        lr = f32(learning_rate(count)) if callable(learning_rate) else learning_rate
        bc1 = float(f32(1) - f32(b1) ** f32(count))
        bc2 = float(f32(1) - f32(b2) ** f32(count))
        steps, state = [], []
        for g, s in zip(grads, opt_state["state"]):
            m = _dequantize_block(s["mq"], s["ms"], g.shape)
            u = _dequantize_block(s["uq"], s["us"], g.shape)  # sqrt(v)
            m = b1 * m + (1 - b1) * g
            v = b2 * (u * u) + (1 - b2) * g * g
            uq, us = _quantize_block(torch.sqrt(v), block)
            floor = us.max() * 0.5  # half a code step: the quantization's uncertainty
            steps.append(-float(lr) * (m / bc1) / (torch.sqrt(v / bc2) + floor + eps))
            mq, ms = _quantize_block(m, block)
            state.append({"mq": mq, "ms": ms, "uq": uq, "us": us})
        return steps, {"count": count, "state": state}

    return T.GradientTransformation(init, update)


# ------------------------------------------------------- freeze mask
FROZEN = ("qkv", "proj", "fc1", "fc2")


def trainable_mask(params: Dict) -> List[bool]:
    """Per leaf (JAX's order), True = train: embeddings, layer norms and the head train; the qkv, proj,
    fc1 and fc2 weights and biases are frozen."""

    def walk(tree, frozen):
        if isinstance(tree, dict):
            return [m for k in sorted(tree) for m in walk(tree[k], frozen or k in FROZEN)]
        if isinstance(tree, (list, tuple)):
            return [m for v in tree for m in walk(v, frozen)]
        return [not frozen]

    return walk(params, False)


# ----------------------------------------------------------- loss
def finetune_loss(params: Dict, tokens: torch.Tensor, cfg: ARConfig, img_weight: float = 7.0,
                  train_text: bool = False, remat: bool = False) -> torch.Tensor:
    """Next-token cross-entropy, text logits over the text vocabulary and image logits over the image
    vocabulary; (text + w * image) / (w + 1) with train_text, else the image loss alone."""
    tokens = tokens.long()
    logits = forward(params, tokens[:, :-1], cfg, remat=remat)
    labels = tokens[:, 1:]
    tl = cfg.text_length - 1  # positions predicting text tokens
    loss_img = F.cross_entropy(logits[:, tl:, cfg.text_vocab_size:].float().flatten(0, 1),
                               (labels[:, tl:] - cfg.text_vocab_size).flatten())
    if not train_text:
        return loss_img
    loss_text = F.cross_entropy(logits[:, :tl, : cfg.text_vocab_size].float().flatten(0, 1),
                                labels[:, :tl].flatten())
    return (loss_text + img_weight * loss_img) / (img_weight + 1.0)


# ----------------------------------------------------------- harness
@dataclasses.dataclass(frozen=True)
class FinetuneConfig:
    lr: float = 1e-5
    steps: int = 500
    grad_clip: float = 0.24
    img_weight: float = 7.0
    train_text: bool = False
    adam8bit: bool = False
    gradient_checkpointing: bool = False
    warmup_frac: float = 0.3  # one-cycle ramp fraction
    final_div_factor: float = 500.0


def make_optimizer(params: Dict, cfg: FinetuneConfig) -> T.GradientTransformation:
    # optax's one-cycle divides by integer interval sizes that collapse to 0 below ~10 steps (a NaN
    # rate): the horizon is floored, as maua_tpu floors it
    sched = T.cosine_onecycle_schedule(transition_steps=max(cfg.steps, 10), peak_value=cfg.lr,
                                       pct_start=cfg.warmup_frac, final_div_factor=cfg.final_div_factor)
    inner = quantized_adam(sched) if cfg.adam8bit else T.adamw(sched)
    labels = ["train" if m else "freeze" for m in trainable_mask(params)]
    return T.chain(T.clip_by_global_norm(cfg.grad_clip),
                   T.multi_transform({"train": inner, "freeze": T.set_to_zero()}, labels))


def init_finetune_state(params: Dict, cfg: FinetuneConfig) -> Dict:
    return {"params": params, "opt": make_optimizer(params, cfg).init(tree_leaves(params)), "step": 0}


def finetune_step(state: Dict, tokens: torch.Tensor, ar_cfg: ARConfig, ft_cfg: FinetuneConfig):
    """One step over (B, total_length) full-vocabulary token rows (text, then image ids offset by
    text_vocab_size). Returns (state, loss)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(state["params"])]
    params = tree_unflatten(state["params"], leaves)
    tokens = torch.as_tensor(tokens, device=leaves[0].device)
    loss = finetune_loss(params, tokens, ar_cfg, ft_cfg.img_weight, ft_cfg.train_text,
                         remat=ft_cfg.gradient_checkpointing)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)  # frame_emb: unused outside video
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    with torch.no_grad():
        updates, opt = make_optimizer(state["params"], ft_cfg).update(grads, state["opt"],
                                                                      [p.detach() for p in leaves])
        new = [p.detach() + u for p, u in zip(leaves, updates)]
    return {"params": tree_unflatten(state["params"], new), "opt": opt, "step": state["step"] + 1}, loss.detach()


def _paths(tree, prefix: str = ""):
    """(jax.tree_util.keystr path, leaf) of nested dicts and lists, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def save_checkpoint(path: str, state: Dict) -> None:
    """A flat .npz: one array per leaf, keyed by its keystr path (maua_tpu's format)."""
    np.savez(path, **{p: (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf))
                      for p, leaf in _paths(state)})


def restore_checkpoint(path: str, state: Dict) -> Dict:
    """`state`'s structure filled from a save_checkpoint (or maua_tpu) .npz, each leaf in its dtype,
    shape and device."""
    data = np.load(path)

    def leaf(p, like):
        if isinstance(like, torch.Tensor):
            return torch.from_numpy(np.array(data[p])).to(like.dtype).reshape(like.shape).to(like.device)
        return type(like)(data[p])

    return tree_unflatten(state, [leaf(p, like) for p, like in _paths(state)])


def finetune(params: Dict, batches: Iterator[np.ndarray], ar_cfg: ARConfig, ft_cfg: Optional[FinetuneConfig] = None,
             save_path: Optional[str] = None, verbose: bool = True):
    """Iterate (B, T) token batches for ft_cfg.steps steps; a KeyboardInterrupt saves a partial
    checkpoint (`*_keyboardinterrupt.npz`) and re-raises. Returns (params, losses)."""
    ft_cfg = ft_cfg or FinetuneConfig()
    state = init_finetune_state(params, ft_cfg)
    losses = []
    try:
        for tokens in batches:
            state, loss = finetune_step(state, tokens, ar_cfg, ft_cfg)
            losses.append(float(loss))
            if verbose and len(losses) % 50 == 0:
                print(f"step {len(losses)}: loss {losses[-1]:.4f}")
            if len(losses) >= ft_cfg.steps:
                break
    except KeyboardInterrupt:
        if save_path:
            save_checkpoint(save_path.replace(".npz", "_keyboardinterrupt.npz"), state)
        raise
    if save_path:
        save_checkpoint(save_path, state)
    return state["params"], losses
