"""CLIP text encoder (the ViT-L/14 text tower) in PyTorch, and its tokenizers.

Port of `maua_tpu/text/clip_text.py`. The BPE tokenizer reads the
standard `bpe_simple_vocab_16e6.txt.gz` merges file when one is named by
the MAUA_CLIP_BPE environment variable or lies at
`modelzoo/bpe_simple_vocab_16e6.txt.gz`; otherwise a deterministic hash
tokenizer stands in (blake2b of each lower-cased word), which gives the
JAX package's ids exactly and suits random-init models only. Attention
here is plain: a causal mask over 77 tokens never takes the kernel route.
"""

from __future__ import annotations

import dataclasses
import gzip
import hashlib
import html
import math
import os
from functools import lru_cache
from typing import Dict, List, Optional

import numpy as np
import torch

from ..diffusion.models.unet import _linear, _norm_init, layer_norm, linear


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    width: int = 768
    layers: int = 12
    heads: int = 12
    context_length: int = 77
    dtype: str = "float32"


# ------------------------------------------------------------ tokenizer
@lru_cache()
def bytes_to_unicode():
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _find_bpe_file() -> Optional[str]:
    for c in (os.environ.get("MAUA_CLIP_BPE", ""), "modelzoo/bpe_simple_vocab_16e6.txt.gz"):
        if c and os.path.exists(c):
            return c
    return None


class BPETokenizer:
    """OpenAI CLIP byte-pair tokenizer (the standard algorithm)."""

    def __init__(self, bpe_path: str):
        import regex as re

        self.re = re
        merges = gzip.open(bpe_path).read().decode("utf-8").split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = bytes_to_unicode()
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
            re.IGNORECASE,
        )

    def bpe(self, token):
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = set(zip(word[:-1], word[1:]))
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = set(zip(word[:-1], word[1:]))
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = html.unescape(html.unescape(text.strip())).lower()
        bpe_tokens = []
        for token in self.re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens


class HashTokenizer:
    """Deterministic stand-in when no BPE vocab file is present: words hash
    into the vocab range. Not compatible with pretrained checkpoints."""

    def __init__(self, vocab_size: int = 49408):
        self.vocab_size = vocab_size

    def encode(self, text: str) -> List[int]:
        return [int(hashlib.blake2b(word.encode(), digest_size=4).hexdigest(), 16) % (self.vocab_size - 2)
                for word in text.lower().split()]


_TOKENIZER = None


def get_tokenizer():
    global _TOKENIZER
    if _TOKENIZER is None:
        path = _find_bpe_file()
        _TOKENIZER = HashTokenizer()
        if path is not None:
            try:
                _TOKENIZER = BPETokenizer(path)
            except (ImportError, OSError, ValueError):  # no `regex` module, or an unreadable vocab file
                pass
    return _TOKENIZER


SOT, EOT = 49406, 49407


def tokenize(texts, context_length: int = 77) -> np.ndarray:
    """texts -> (N, context_length) int32, SOT + ids + EOT, padded with EOT."""
    if isinstance(texts, str):
        texts = [texts]
    tok = get_tokenizer()
    out = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        ids = [SOT] + tok.encode(text)[: context_length - 2] + [EOT]
        out[i, : len(ids)] = ids
        out[i, len(ids):] = EOT
    return out


# ---------------------------------------------------------------- model
def init_params(cfg: CLIPTextConfig, gen: torch.Generator) -> Dict:
    """Random parameters with the JAX package's init distributions, drawn from `gen`."""
    w, dev = cfg.width, gen.device
    p = {
        "token_embedding": torch.randn(cfg.vocab_size, w, generator=gen, device=dev) * 0.02,
        "positional_embedding": torch.randn(cfg.context_length, w, generator=gen, device=dev) * 0.01,
        "ln_final": _norm_init(w, dev),
        "blocks": [],
    }
    for _ in range(cfg.layers):
        p["blocks"].append({
            "ln1": _norm_init(w, dev),
            "q": _linear(gen, w, w),
            "k": _linear(gen, w, w),
            "v": _linear(gen, w, w),
            "out": _linear(gen, w, w),
            "ln2": _norm_init(w, dev),
            "fc1": _linear(gen, w, w * 4),
            "fc2": _linear(gen, w * 4, w),
        })
    return p


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def encode_text(params: Dict, tokens, cfg: CLIPTextConfig = CLIPTextConfig()) -> torch.Tensor:
    """tokens (N, L) -> last hidden states (N, L, width), f32: the SD
    conditioning tensor (FrozenCLIPEmbedder semantics)."""
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    emb = params["token_embedding"]
    tokens = tokens.to(device=emb.device, dtype=torch.long) if isinstance(tokens, torch.Tensor) \
        else torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=emb.device)
    x = emb[tokens].to(dtype)
    x = x + params["positional_embedding"][: x.shape[1]].to(dtype)
    n, length, w = x.shape
    mask = torch.ones(length, length, dtype=torch.bool, device=x.device).tril()
    heads = cfg.heads
    hd = w // heads
    for blk in params["blocks"]:
        h = layer_norm(blk["ln1"], x)
        q, k, v = (linear(blk[name], h).reshape(n, length, heads, hd).transpose(1, 2) for name in "qkv")
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
        logits = torch.where(mask, logits, torch.tensor(-1e9, dtype=torch.float32, device=x.device))
        probs = torch.softmax(logits, dim=-1).to(dtype)
        att = torch.matmul(probs, v).transpose(1, 2).reshape(n, length, w)
        x = x + linear(blk["out"], att)
        x = x + linear(blk["fc2"], _quick_gelu(linear(blk["fc1"], layer_norm(blk["ln2"], x))))
    return layer_norm(params["ln_final"], x).float()

