"""BERT-style text encoder for GLID3XL conditioning, and its WordPiece tokenizer.

Port of `maua_tpu/text/bert.py` (BERTConfig, WordPieceTokenizer,
init_params, params_from_torch, encode, BERTEmbedder): the latent-diffusion
BERTEmbedder, a WordPiece tokenizer and a pre-LN transformer encoder (token
and learned position embeddings, self-attention and exact-erf GELU
feed-forward blocks, a final layer norm) giving a (B, max_len, width)
context. The tokenizer reads a bert-base-uncased style vocab.txt when one is
given; without one, a token's id is a stable md5 hash into the vocabulary,
the same ids as the JAX package's (offline-runnable, not checkpoint
faithful). Parameters are the JAX package's tree with linear weights
(out, in); `maua_tpu_torch.bridge.bert_params_to_torch` carries that
package's tree over. Attention over 77 tokens is plain (f32 scores and
softmax): it never takes the kernel route.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import re
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..utility import resolve_device, to_device


@dataclasses.dataclass(frozen=True)
class BERTConfig:
    vocab_size: int = 30522
    max_len: int = 77
    width: int = 1280
    layers: int = 32
    heads: int = 8

    @property
    def head_dim(self) -> int:
        return self.width // self.heads


# ------------------------------------------------------------ tokenizer
class WordPieceTokenizer:
    """Greedy longest-match-first WordPiece ('bert-base-uncased' style) over
    `vocab_path`'s vocab.txt; without a vocab file each word is one token whose
    id is a stable hash into [999, vocab_size - 1)."""

    PAD, UNK, CLS, SEP = 0, 100, 101, 102

    def __init__(self, vocab_path: Optional[str] = None, vocab_size: int = 30522):
        self.vocab: Optional[Dict[str, int]] = None
        self.vocab_size = vocab_size
        if vocab_path is not None:
            with open(vocab_path) as f:
                self.vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
            self.vocab_size = len(self.vocab)

    def _basic(self, text: str) -> List[str]:
        return re.findall(r"[a-z0-9]+|[^\sa-z0-9]", text.lower().strip())

    def _wordpiece(self, word: str) -> List[str]:
        if self.vocab is None:
            return [word]
        pieces, start = [], 0
        while start < len(word):
            end, piece = len(word), None
            while start < end:
                sub = word[start:end] if start == 0 else "##" + word[start:end]
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return ["[UNK]"]
            pieces.append(piece)
            start = end
        return pieces

    def _id(self, token: str) -> int:
        if self.vocab is not None:
            return self.vocab.get(token, self.UNK)
        h = int(hashlib.md5(token.encode()).hexdigest()[:8], 16)
        return 999 + h % (self.vocab_size - 1000)

    def __call__(self, text: str, max_len: int = 77) -> np.ndarray:
        """text -> (max_len,) int32: [CLS], the pieces' ids, [SEP], padded with [PAD]."""
        toks = [self.CLS]
        for word in self._basic(text):
            toks.extend(self._id(p) for p in self._wordpiece(word))
        toks = toks[: max_len - 1] + [self.SEP]
        out = np.full(max_len, self.PAD, np.int32)
        out[: len(toks)] = toks
        return out


# ------------------------------------------------------------- encoder
def init_params(cfg: BERTConfig, gen: torch.Generator) -> Dict:
    """Random parameters with the JAX package's init distributions, drawn from `gen`."""
    w, dev = cfg.width, gen.device

    def normal(*shape, std):
        return torch.randn(shape, generator=gen, device=dev) * std

    def ln():
        return {"scale": torch.ones(w, device=dev), "bias": torch.zeros(w, device=dev)}

    p = {"token_emb": normal(cfg.vocab_size, w, std=0.02), "pos_emb": normal(cfg.max_len, w, std=0.01),
         "norm": ln(), "blocks": []}
    for _ in range(cfg.layers):
        p["blocks"].append({
            "ln1": ln(),
            "q": {"w": normal(w, w, std=1 / math.sqrt(w))},
            "k": {"w": normal(w, w, std=1 / math.sqrt(w))},
            "v": {"w": normal(w, w, std=1 / math.sqrt(w))},
            "out": {"w": normal(w, w, std=1 / math.sqrt(w)), "b": torch.zeros(w, device=dev)},
            "ln2": ln(),
            "fc1": {"w": normal(4 * w, w, std=1 / math.sqrt(w)), "b": torch.zeros(4 * w, device=dev)},
            "fc2": {"w": normal(w, 4 * w, std=1 / math.sqrt(4 * w)), "b": torch.zeros(w, device=dev)},
        })
    return p


def params_from_torch(sd, cfg: BERTConfig) -> Dict:
    """An x-transformers TransformerWrapper state dict (glid-3-xl's bert.pt:
    `transformer.token_emb`, `transformer.pos_emb.emb`,
    `transformer.attn_layers.layers.{2i}.1.to_{q,k,v,out}`,
    `...{2i+1}.1.net...`, `transformer.norm`; the feed-forward's first linear
    `net.0.proj`, `net.0.0` or `net.0`) -> params, f32 on the CPU."""
    sd = {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in sd.items()}
    pre = "transformer." if any(k.startswith("transformer.") for k in sd) else ""

    def v(name):
        return sd[pre + name]

    def ln(name):
        return {"scale": v(f"{name}.weight"), "bias": v(f"{name}.bias")}

    p = {"token_emb": v("token_emb.weight"), "pos_emb": v("pos_emb.emb.weight")[: cfg.max_len], "norm": ln("norm"),
         "blocks": []}
    for i in range(cfg.layers):
        a, f = f"attn_layers.layers.{2 * i}", f"attn_layers.layers.{2 * i + 1}"
        ff1 = next((c for c in (f"{f}.1.net.0.proj", f"{f}.1.net.0.0", f"{f}.1.net.0")
                    if pre + c + ".weight" in sd), None)
        if ff1 is None:
            raise KeyError(f"no FF input linear found for layer {i}")
        p["blocks"].append({
            "ln1": ln(f"{a}.0"),
            "q": {"w": v(f"{a}.1.to_q.weight")},
            "k": {"w": v(f"{a}.1.to_k.weight")},
            "v": {"w": v(f"{a}.1.to_v.weight")},
            "out": {"w": v(f"{a}.1.to_out.weight"), "b": v(f"{a}.1.to_out.bias")},
            "ln2": ln(f"{f}.0"),
            "fc1": {"w": v(f"{ff1}.weight"), "b": v(f"{ff1}.bias")},
            "fc2": {"w": v(f"{f}.1.net.2.weight"), "b": v(f"{f}.1.net.2.bias")},
        })
    return p


def _ln(p, x):
    return F.layer_norm(x.float(), (x.shape[-1],), p["scale"], p["bias"], 1e-5).to(x.dtype)


def encode(params: Dict, tokens, cfg: BERTConfig) -> torch.Tensor:
    """tokens (B, max_len) -> context (B, max_len, width)."""
    emb = params["token_emb"]
    tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=emb.device)
    b, t = tokens.shape
    x = emb[tokens] + params["pos_emb"][None, :t]

    def heads(h, p):
        return F.linear(h, p["w"]).reshape(b, t, cfg.heads, cfg.head_dim).transpose(1, 2)

    for blk in params["blocks"]:
        h = _ln(blk["ln1"], x)
        q, k, v = heads(h, blk["q"]), heads(h, blk["k"]), heads(h, blk["v"])
        att = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(cfg.head_dim)
        att = torch.softmax(att, dim=-1).to(x.dtype)
        o = torch.matmul(att, v).transpose(1, 2).reshape(b, t, cfg.width)
        x = x + F.linear(o, blk["out"]["w"], blk["out"]["b"])
        h = _ln(blk["ln2"], x)
        x = x + F.linear(F.gelu(F.linear(h, blk["fc1"]["w"], blk["fc1"]["b"])), blk["fc2"]["w"], blk["fc2"]["b"])
    return _ln(params["norm"], x)


class BERTEmbedder(torch.nn.Module):
    """The tokenizer and the encoder on `device` (cuda unless told otherwise):
    texts -> (len(texts), max_len, width) f32. Parameters are `params` (the
    port's tree), else converted from a torch `checkpoint`, else drawn from a
    torch.Generator seeded with `seed` on the device."""

    def __init__(self, cfg: Optional[BERTConfig] = None, params: Optional[Dict] = None,
                 vocab_path: Optional[str] = None, checkpoint: Optional[str] = None, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg or BERTConfig()
        self.device = resolve_device(device)
        self.tokenizer = WordPieceTokenizer(vocab_path, self.cfg.vocab_size)
        if params is None and checkpoint is not None:
            sd = torch.load(checkpoint, map_location="cpu", weights_only=False)
            sd = sd.get("state_dict", sd) if isinstance(sd, dict) else sd
            params = params_from_torch({k: vv.numpy() for k, vv in sd.items()}, self.cfg)
        if params is None:
            params = init_params(self.cfg, torch.Generator(device=self.device).manual_seed(seed))
        self.params = to_device(params, self.device)

    @torch.no_grad()
    def forward(self, texts: Sequence[str]) -> torch.Tensor:
        toks = np.stack([self.tokenizer(t, self.cfg.max_len) for t in texts])
        return encode(self.params, toks, self.cfg)
