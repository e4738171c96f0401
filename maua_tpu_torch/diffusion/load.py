"""Stable Diffusion checkpoint loading: CompVis and Hugging Face state
dicts -> the port's UNet, VAE and CLIP-text parameter dicts.

Port of `maua_tpu/diffusion/load.py` (unet_params_from_compvis,
vae_params_from_compvis, clip_text_params_from_hf,
split_compvis_checkpoint, load_stable_diffusion). A checkpoint's torch
layout is the port's own (linear (out, in), conv OIHW), so the
converters rename and copy; 1x1 attention projections stored as linear
or conv1d weights become OIHW convs. Parameters come back as f32 CPU
tensors.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _w(a) -> torch.Tensor:
    """`a` as a contiguous f32 CPU tensor (sharing its memory where it already is one)."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _wb(sd, name):
    """A linear or conv layer: its weight and bias as they are stored."""
    return {"w": _w(sd[f"{name}.weight"]), "b": _w(sd[f"{name}.bias"])}


def _conv1x1(sd, name):
    """A 1x1 conv stored as a linear (co, ci) or conv1d (co, ci, 1) weight, as OIHW."""
    w = np.asarray(sd[f"{name}.weight"])
    return {"w": _w(w.reshape(w.shape[0], w.shape[1], 1, 1)), "b": _w(sd[f"{name}.bias"])}


def _norm(sd, name):
    return {"scale": _w(sd[f"{name}.weight"]), "bias": _w(sd[f"{name}.bias"])}


def _resblock(sd, p):
    out = {
        "norm1": _norm(sd, f"{p}.in_layers.0"),
        "conv1": _wb(sd, f"{p}.in_layers.2"),
        "emb": _wb(sd, f"{p}.emb_layers.1"),
        "norm2": _norm(sd, f"{p}.out_layers.0"),
        "conv2": _wb(sd, f"{p}.out_layers.3"),
    }
    if f"{p}.skip_connection.weight" in sd:
        out["skip"] = _wb(sd, f"{p}.skip_connection")
    return out


def _crossattn(sd, p):
    return {
        "to_q": {"w": _w(sd[f"{p}.to_q.weight"])},
        "to_k": {"w": _w(sd[f"{p}.to_k.weight"])},
        "to_v": {"w": _w(sd[f"{p}.to_v.weight"])},
        "to_out": _wb(sd, f"{p}.to_out.0"),
    }


def _spatial_transformer(sd, p, depth=1):
    blocks = []
    for d in range(depth):
        bp = f"{p}.transformer_blocks.{d}"
        blocks.append({
            "norm1": _norm(sd, f"{bp}.norm1"),
            "attn1": _crossattn(sd, f"{bp}.attn1"),
            "norm2": _norm(sd, f"{bp}.norm2"),
            "attn2": _crossattn(sd, f"{bp}.attn2"),
            "norm3": _norm(sd, f"{bp}.norm3"),
            "ff_in": _wb(sd, f"{bp}.ff.net.0.proj"),
            "ff_out": _wb(sd, f"{bp}.ff.net.2"),
        })
    return {
        "spatial": {
            "norm": _norm(sd, f"{p}.norm"),
            "proj_in": _wb(sd, f"{p}.proj_in"),
            "blocks": blocks,
            "proj_out": _wb(sd, f"{p}.proj_out"),
        },
    }


def _selfattn(sd, p):
    return {"self": {"norm": _norm(sd, f"{p}.norm"), "qkv": _conv1x1(sd, f"{p}.qkv"),
                     "proj": _conv1x1(sd, f"{p}.proj_out")}}


def unet_params_from_compvis(sd: Dict[str, np.ndarray], cfg) -> Dict:
    """CompVis LDM / SD UNet ('model.diffusion_model.*' stripped) -> the
    port's `diffusion.models.unet` parameters."""

    def has(k):
        return k in sd

    p = {
        "time_mlp1": _wb(sd, "time_embed.0"),
        "time_mlp2": _wb(sd, "time_embed.2"),
        "conv_in": _wb(sd, "input_blocks.0.0"),
    }

    def attn_at(prefix):
        if has(f"{prefix}.norm.weight") and has(f"{prefix}.proj_in.weight"):
            return _spatial_transformer(sd, prefix, cfg.transformer_depth)
        if has(f"{prefix}.qkv.weight"):
            return _selfattn(sd, prefix)
        return None

    downs = []
    i = 1
    while has(f"input_blocks.{i}.0.in_layers.0.weight") or has(f"input_blocks.{i}.0.op.weight"):
        base = f"input_blocks.{i}"
        if has(f"{base}.0.op.weight"):
            downs.append({"down": _wb(sd, f"{base}.0.op")})
        elif has(f"{base}.0.in_layers.0.weight") and not has(f"{base}.1.norm.weight") and has(f"{base}.0.h_upd.weight"):
            downs.append({"down_res": _resblock(sd, f"{base}.0")})
        else:
            blk = {"res": _resblock(sd, f"{base}.0")}
            attn = attn_at(f"{base}.1")
            if attn is not None:
                blk["attn"] = attn
            downs.append(blk)
        i += 1
    p["downs"] = downs

    p["mid"] = {
        "res1": _resblock(sd, "middle_block.0"),
        "attn": attn_at("middle_block.1"),
        "res2": _resblock(sd, "middle_block.2"),
    }

    ups = []
    i = 0
    while has(f"output_blocks.{i}.0.in_layers.0.weight"):
        base = f"output_blocks.{i}"
        blk = {"res": _resblock(sd, f"{base}.0")}
        attn = attn_at(f"{base}.1")
        if attn is not None:
            blk["attn"] = attn
        for j in (1, 2):  # the upsampler sits at index 1 or 2
            if has(f"{base}.{j}.conv.weight"):
                blk["up"] = _wb(sd, f"{base}.{j}.conv")
        i += 1
        ups.append(blk)
    p["ups"] = ups

    p["norm_out"] = _norm(sd, "out.0")
    p["conv_out"] = _wb(sd, "out.2")
    return p


def vae_params_from_compvis(sd: Dict[str, np.ndarray], cfg) -> Dict:
    """CompVis AutoencoderKL ('first_stage_model.*' stripped) -> the port's
    `diffusion.models.vae` parameters."""

    def vres(p):
        out = {
            "norm1": _norm(sd, f"{p}.norm1"),
            "conv1": _wb(sd, f"{p}.conv1"),
            "norm2": _norm(sd, f"{p}.norm2"),
            "conv2": _wb(sd, f"{p}.conv2"),
        }
        if f"{p}.nin_shortcut.weight" in sd:
            out["skip"] = _wb(sd, f"{p}.nin_shortcut")
        return out

    def vattn(p):
        return {
            "norm": _norm(sd, f"{p}.norm"),
            "q": _wb(sd, f"{p}.q"),
            "k": _wb(sd, f"{p}.k"),
            "v": _wb(sd, f"{p}.v"),
            "proj": _wb(sd, f"{p}.proj_out"),
        }

    enc = {"conv_in": _wb(sd, "encoder.conv_in")}
    blocks = []
    for level in range(len(cfg.channel_mult)):
        for b in range(cfg.num_res_blocks):
            blocks.append({"res": vres(f"encoder.down.{level}.block.{b}")})
        if f"encoder.down.{level}.downsample.conv.weight" in sd:
            blocks.append({"down": _wb(sd, f"encoder.down.{level}.downsample.conv")})
    enc["blocks"] = blocks
    enc["mid"] = {"res1": vres("encoder.mid.block_1"), "attn": vattn("encoder.mid.attn_1"),
                  "res2": vres("encoder.mid.block_2")}
    enc["norm_out"] = _norm(sd, "encoder.norm_out")
    enc["conv_out"] = _wb(sd, "encoder.conv_out")
    enc["quant_conv"] = _wb(sd, "quant_conv")

    dec = {"post_quant_conv": _wb(sd, "post_quant_conv"), "conv_in": _wb(sd, "decoder.conv_in")}
    dec["mid"] = {"res1": vres("decoder.mid.block_1"), "attn": vattn("decoder.mid.attn_1"),
                  "res2": vres("decoder.mid.block_2")}
    dblocks = []
    for level in range(len(cfg.channel_mult) - 1, -1, -1):
        for b in range(cfg.num_res_blocks + 1):
            dblocks.append({"res": vres(f"decoder.up.{level}.block.{b}")})
        if f"decoder.up.{level}.upsample.conv.weight" in sd:
            dblocks.append({"up": _wb(sd, f"decoder.up.{level}.upsample.conv")})
    dec["blocks"] = dblocks
    dec["norm_out"] = _norm(sd, "decoder.norm_out")
    dec["conv_out"] = _wb(sd, "decoder.conv_out")
    return {"encoder": enc, "decoder": dec}


def clip_text_params_from_hf(sd: Dict[str, np.ndarray], cfg) -> Dict:
    """HF CLIPTextModel ('text_model.*' stripped) -> the port's
    `text.clip_text` parameters."""
    p = {
        "token_embedding": _w(sd["embeddings.token_embedding.weight"]),
        "positional_embedding": _w(sd["embeddings.position_embedding.weight"]),
        "ln_final": _norm(sd, "final_layer_norm"),
        "blocks": [],
    }
    for i in range(cfg.layers):
        b = f"encoder.layers.{i}"
        p["blocks"].append({
            "ln1": _norm(sd, f"{b}.layer_norm1"),
            "q": _wb(sd, f"{b}.self_attn.q_proj"),
            "k": _wb(sd, f"{b}.self_attn.k_proj"),
            "v": _wb(sd, f"{b}.self_attn.v_proj"),
            "out": _wb(sd, f"{b}.self_attn.out_proj"),
            "ln2": _norm(sd, f"{b}.layer_norm2"),
            "fc1": _wb(sd, f"{b}.mlp.fc1"),
            "fc2": _wb(sd, f"{b}.mlp.fc2"),
        })
    return p


def split_compvis_checkpoint(sd: Dict[str, np.ndarray]):
    """Split a full CompVis SD checkpoint into (unet_sd, vae_sd, text_sd)
    with their prefixes stripped."""
    unet, vae, text = {}, {}, {}
    for k, v in sd.items():
        if k.startswith("model.diffusion_model."):
            unet[k[len("model.diffusion_model."):]] = v
        elif k.startswith("first_stage_model."):
            vae[k[len("first_stage_model."):]] = v
        elif k.startswith("cond_stage_model.transformer.text_model."):
            text[k[len("cond_stage_model.transformer.text_model."):]] = v
    return unet, vae, text


def load_stable_diffusion(path: str, unet_cfg=None, vae_cfg=None, text_cfg=None):
    """A full SD checkpoint file -> (unet_params, vae_params, text_params),
    f32 CPU tensors (text_params None when the file has no text encoder)."""
    from ..text.clip_text import CLIPTextConfig
    from .models.unet import SD1_UNET
    from .models.vae import VAEConfig

    unet_cfg = unet_cfg or SD1_UNET
    vae_cfg = vae_cfg or VAEConfig()
    text_cfg = text_cfg or CLIPTextConfig()
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.get("state_dict", obj)
    sd = {k: v.float().numpy() for k, v in sd.items() if hasattr(v, "numpy")}
    unet_sd, vae_sd, text_sd = split_compvis_checkpoint(sd)
    return (
        unet_params_from_compvis(unet_sd, unet_cfg),
        vae_params_from_compvis(vae_sd, vae_cfg),
        clip_text_params_from_hf(text_sd, text_cfg) if text_sd else None,
    )
