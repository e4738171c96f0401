"""Pipeline parallelism (GPipe) over a mesh axis.

Port of `maua_tpu/parallel/pipeline.py`. The layers' parameters are
stacked with a leading stage axis (`stack_stage_params`); stage s lives on
the device of index s along the mesh's pipeline axis. `pipelined_apply`
runs maua_tpu's tick schedule: M + S - 1 ticks; at each, every stage
applies its layers to its current activation (stage 0 to microbatch
clip(t, 0, M - 1)), the last stage writes microbatch t - (S - 1) when it
is one, and the activations move one stage on. Stages that share a device
run in turn on it. It is differentiable; with `remat` each layer's
activations are recomputed in the backward pass (torch.utils.checkpoint).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, List

import torch

from .mesh import Mesh, tree_map


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _stack(trees: List):
    """Trees of one structure -> one tree whose leaves stack theirs on a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([t[i] for t in trees]) for i in range(len(first)))
    return torch.stack(trees)


def stack_stage_params(blocks: List, n_stages: int):
    """L per-layer trees of one structure -> one tree with leaves (n_stages, L // n_stages, ...)."""
    n_layers = len(blocks)
    if n_layers % n_stages != 0:
        raise ValueError(f"{n_layers} layers not divisible into {n_stages} stages")
    per = n_layers // n_stages
    return tree_map(lambda x: x.reshape((n_stages, per) + x.shape[1:]), _stack(blocks))


def _index(tree, i: int):
    return tree_map(lambda x: x[i], tree)


def scan_layers(layer_fn: Callable, stage_params, x):
    """A stage's stacked layers (leading axis: layers of the stage) applied in order."""
    for i in range(_leaves(stage_params)[0].shape[0]):
        x = layer_fn(_index(stage_params, i), x)
    return x


def pipelined_apply(mesh: Mesh, axis: str, stage_params, stage_fn: Callable, x: torch.Tensor,
                    num_microbatches: int) -> torch.Tensor:
    """x (B, ...) through S = mesh.shape[axis] stages, `stage_fn(params_s, x_mb) -> y_mb` keeping the
    microbatch's shape; `stage_params` leaves lead with S. The result is on x's device."""
    n_stages = mesh.shape[axis]
    batch = x.shape[0]
    if batch % num_microbatches != 0:
        raise ValueError(f"batch {batch} not divisible by {num_microbatches} microbatches")
    devices = mesh.axis_devices(axis)
    params = [tree_map(lambda a, s=s: a[s].to(devices[s]), stage_params) for s in range(n_stages)]
    xmb = x.reshape((num_microbatches, batch // num_microbatches) + x.shape[1:])
    states = [torch.zeros_like(xmb[0], device=d) for d in devices]
    outputs = [None] * num_microbatches
    for t in range(num_microbatches + n_stages - 1):
        feed = xmb[min(max(t, 0), num_microbatches - 1)].to(devices[0])
        ys = [stage_fn(params[s], feed if s == 0 else states[s]) for s in range(n_stages)]
        out_t = t - (n_stages - 1)
        if out_t >= 0:  # the last stage's masked write
            outputs[out_t] = ys[-1].to(x.device)
        states = [ys[(s - 1) % n_stages].to(devices[s]) for s in range(n_stages)]  # ppermute s -> s + 1
    return torch.cat(outputs, 0).reshape(x.shape)


def pipeline_forward(params, tokens: torch.Tensor, cfg, mesh: Mesh, axis: str = "stage",
                     num_microbatches: int = 4, remat: bool = False) -> torch.Tensor:
    """`autoregressive.transformer.forward`'s logits with the blocks split into mesh.shape[axis]
    stages and pipelined over `num_microbatches` microbatches of the batch; embedding and head
    replicated."""
    from ..autoregressive.transformer import _ln, position_table, transformer_block

    t = tokens.shape[1]
    x = params["tok_emb"][tokens.long()] + position_table(params, cfg, t)[None]
    mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    masks = {}

    def layer_fn(blk, h):
        m = masks.setdefault(h.device, mask.to(h.device))
        if remat:
            from torch.utils.checkpoint import checkpoint

            return checkpoint(transformer_block, blk, h, cfg, m, use_reentrant=False)
        return transformer_block(blk, h, cfg, m)

    stacked = stack_stage_params(params["blocks"], mesh.shape[axis])
    x = pipelined_apply(mesh, axis, stacked, partial(scan_layers, layer_fn), x, num_microbatches)
    return _ln(params["ln_f"], x) @ params["head"]["w"]
