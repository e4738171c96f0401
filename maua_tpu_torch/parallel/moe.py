"""Mixture-of-experts FFN with expert parallelism over a mesh axis.

Port of `maua_tpu/parallel/moe.py`. Routing is top-k token choice with
softmax gates renormalized over the chosen experts, plus the Switch
load-balancing loss n_experts * sum_e frac_e * pbar_e. `moe_apply` is the
dense path: every expert on every token, combined by the gate matrix.
`moe_apply_ep` is the expert-parallel one: the expert axis's shards each
hold n_experts / S experts and compute them, on their device, for the
tokens they see; the gated partial sums are added (maua_tpu's `psum`).
With `data_axis` the tokens are split over that axis too, and the routing
statistics are averaged over the data shards before the loss's product
(the loss is bilinear in them). Shards that share a device run in turn on
it. Both paths are differentiable.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .mesh import Mesh


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    width: int = 64
    hidden: int = 128
    n_experts: int = 4
    top_k: int = 2


EXPERT_LEAVES = ("w1", "b1", "w2", "b2")


def init_moe(cfg: MoEConfig, gen: torch.Generator) -> Dict:
    """Random parameters with maua_tpu's init distributions, drawn from `gen` on its device."""
    dev = gen.device

    def randn(*shape, std):
        return torch.randn(*shape, generator=gen, device=dev) * std

    return {
        "router": randn(cfg.width, cfg.n_experts, std=1.0 / math.sqrt(cfg.width)),
        "w1": randn(cfg.n_experts, cfg.width, cfg.hidden, std=1.0 / math.sqrt(cfg.width)),
        "b1": torch.zeros(cfg.n_experts, cfg.hidden, device=dev),
        "w2": randn(cfg.n_experts, cfg.hidden, cfg.width, std=1.0 / math.sqrt(cfg.hidden)),
        "b2": torch.zeros(cfg.n_experts, cfg.width, device=dev),
    }


def router_stats(params: Dict, x: torch.Tensor, cfg: MoEConfig):
    """(tokens, width) -> (gates, frac, pbar): the dense gate matrix (tokens, n_experts), zero outside
    each token's top-k experts and softmax-renormalized inside them, the per-expert fraction of tokens
    whose best expert it is, and the mean router probability."""
    logits = x.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    if cfg.top_k >= cfg.n_experts:
        gates = probs
    else:
        vals, idxs = torch.topk(logits, cfg.top_k, dim=-1)
        gates = torch.zeros_like(logits).scatter(1, idxs, torch.softmax(vals, dim=-1))
    frac = F.one_hot(torch.argmax(logits, -1), cfg.n_experts).float().mean(0)
    return gates.to(x.dtype), frac, probs.mean(0)


def _aux_loss(frac: torch.Tensor, pbar: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Switch aux loss: n_experts * sum_e f_e * p_e."""
    return cfg.n_experts * torch.sum(frac * pbar)


def router_gates(params: Dict, x: torch.Tensor, cfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens, width) -> (gates, aux_loss). See `router_stats`."""
    gates, frac, pbar = router_stats(params, x, cfg)
    return gates, _aux_loss(frac, pbar, cfg)


def _expert_ffn(w1, b1, w2, b2, x):
    """Experts' FFN on all tokens: (N, W) x (E, W, H) -> (N, E, W), gelu's tanh form (jax.nn.gelu's)."""
    h = F.gelu(torch.einsum("nw,ewh->neh", x, w1) + b1[None], approximate="tanh")
    return torch.einsum("neh,ehw->new", h, w2) + b2[None]


def moe_apply(params: Dict, x: torch.Tensor, cfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense path: (out with x's shape, aux_loss)."""
    tok = x.reshape(-1, cfg.width)
    gates, aux = router_gates(params, tok, cfg)
    y = _expert_ffn(params["w1"], params["b1"], params["w2"], params["b2"], tok)
    return torch.einsum("ne,new->nw", gates, y).reshape(x.shape), aux


def ep_shardings(params: Dict, mesh: Mesh, axis: str = "expert") -> Dict:
    """The parameters as the expert axis holds them: each expert-indexed leaf split along its leading
    dim into the axis's shards, each on its device (a list, one entry a shard); the router whole on the
    mesh's first device."""
    s = mesh.shape[axis]
    devs = mesh.axis_devices(axis)
    return {k: [c.to(d) for c, d in zip(v.chunk(s, 0), devs)] if k in EXPERT_LEAVES else v.to(devs[0])
            for k, v in params.items()}


def moe_apply_ep(params: Dict, x: torch.Tensor, cfg: MoEConfig, mesh: Mesh, axis: str = "expert",
                 data_axis: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel path: shard e of `axis` computes experts [e * n_local, (e + 1) * n_local) on
    its device for its tokens, and the gated partial sums are added; with `data_axis` the tokens are
    split over it and frac and pbar averaged over its shards before the aux product. Equal to
    `moe_apply` up to the order of the sums. Returns (out with x's shape, aux_loss)."""
    n_shards = mesh.shape[axis]
    n_local = cfg.n_experts // n_shards
    if n_local * n_shards != cfg.n_experts:
        raise ValueError(f"{cfg.n_experts} experts not divisible over {n_shards} devices")
    tok = x.reshape(-1, cfg.width)
    n_data = mesh.shape[data_axis] if data_axis else 1
    if tok.shape[0] % n_data:
        raise ValueError(f"{tok.shape[0]} tokens not divisible over {n_data} data shards")
    shards = tok.chunk(n_data, 0)
    stats = []
    for d, t in enumerate(shards):
        dev = mesh.device_at(**({data_axis: d} if data_axis else {}))
        stats.append(router_stats({"router": params["router"].to(dev)}, t.to(dev), cfg))
    home = x.device
    frac = torch.stack([f.to(home) for _, f, _ in stats]).mean(0)  # pmean over the data axis
    pbar = torch.stack([p.to(home) for _, _, p in stats]).mean(0)
    aux = _aux_loss(frac, pbar, cfg)
    outs = []
    for d, (t, (gates, _, _)) in enumerate(zip(shards, stats)):
        out = None
        for e in range(n_shards):
            dev = mesh.device_at(**{axis: e, **({data_axis: d} if data_axis else {})})
            lo, hi = e * n_local, (e + 1) * n_local
            w = [params[k][lo:hi].to(dev) for k in EXPERT_LEAVES]
            y = _expert_ffn(*w, t.to(dev))
            part = torch.einsum("ne,new->nw", gates[:, lo:hi].to(dev), y).to(home)
            out = part if out is None else out + part  # psum over the expert axis
        outs.append(out)
    return torch.cat(outs, 0).reshape(x.shape), aux
