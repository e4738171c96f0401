"""The port's Stable Diffusion loader (maua_tpu_torch/diffusion/load.py)
against maua_tpu's.

Synthetic CompVis UNet and VAE state dicts and a Hugging Face CLIP-text
state dict at tiny configs, random from numpy seeds (no checkpoint is
downloaded), go through both packages' converters; the trees must be
equal through `bridge.diffusion_params_to_torch`, exactly: both read the
same float32 values and only rename and transpose them. A tiny UNet
evaluation on the port's loaded trees equals the one on the JAX-converted
trees bit for bit (the same parameters through the same code). The
checkpoint writer of chip_smoke.py, which builds the full-width file on
the card, is checked here at SD 1.x's structure with narrow widths.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from maua_tpu.diffusion import load as JL
from maua_tpu.diffusion.models import unet as JU
from maua_tpu.diffusion.models import vae as JV
from maua_tpu.text import clip_text as JT
from maua_tpu_torch import bridge
from maua_tpu_torch.diffusion import load as TL
from maua_tpu_torch.diffusion.models import unet as TU
from maua_tpu_torch.diffusion.models import vae as TV
from maua_tpu_torch.text import clip_text as TT

UNET_KW = dict(in_channels=4, out_channels=4, model_channels=16, channel_mult=(1, 2), num_res_blocks=1,
               attention_resolutions=(2,), num_heads=2, context_dim=32)
VAE_KW = dict(base_channels=8, channel_mult=(1, 2), num_res_blocks=1)
TEXT_KW = dict(width=32, layers=1, heads=2, context_length=8)


def assert_same_tree(port, jax_tree):
    ref = bridge.diffusion_params_to_torch(jax.device_get(jax_tree))

    def walk(a, b, path):
        assert type(a) is type(b), path
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}[{i}]")
        else:
            assert a.dtype == torch.float32 and torch.equal(a, b), path

    walk(port, ref, "params")


class RandomStateDict:
    """Random CompVis-named tensors, as tests/test_diffusion_extras.py builds them."""

    def __init__(self, seed):
        self.rs, self.sd = np.random.RandomState(seed), {}

    def lin(self, name, ci, co, bias=True):
        self.sd[f"{name}.weight"] = self.rs.randn(co, ci).astype(np.float32) * 0.05
        if bias:
            self.sd[f"{name}.bias"] = self.rs.randn(co).astype(np.float32) * 0.05

    def conv(self, name, ci, co, k=3):
        self.sd[f"{name}.weight"] = self.rs.randn(co, ci, k, k).astype(np.float32) * 0.05
        self.sd[f"{name}.bias"] = self.rs.randn(co).astype(np.float32) * 0.05

    def norm(self, name, c):
        self.sd[f"{name}.weight"] = 1 + self.rs.randn(c).astype(np.float32) * 0.1
        self.sd[f"{name}.bias"] = self.rs.randn(c).astype(np.float32) * 0.1


def compvis_unet(seed=4):
    """The tiny UNet (UNET_KW): one resblock per level, a downsample, a
    spatial transformer at level 1, the middle block and four output blocks."""
    b = RandomStateDict(seed)
    mc, ctx = UNET_KW["model_channels"], UNET_KW["context_dim"]
    emb = mc * 4

    def res(name, ci, co):
        b.norm(f"{name}.in_layers.0", ci)
        b.conv(f"{name}.in_layers.2", ci, co)
        b.lin(f"{name}.emb_layers.1", emb, co)
        b.norm(f"{name}.out_layers.0", co)
        b.conv(f"{name}.out_layers.3", co, co)
        if ci != co:
            b.conv(f"{name}.skip_connection", ci, co, k=1)

    def spatial(name, c):
        b.norm(f"{name}.norm", c)
        b.conv(f"{name}.proj_in", c, c, k=1)
        bp = f"{name}.transformer_blocks.0"
        for n in ("norm1", "norm2", "norm3"):
            b.norm(f"{bp}.{n}", c)
        for attn, d_in in (("attn1", c), ("attn2", ctx)):
            b.lin(f"{bp}.{attn}.to_q", c, c, bias=False)
            b.lin(f"{bp}.{attn}.to_k", d_in, c, bias=False)
            b.lin(f"{bp}.{attn}.to_v", d_in, c, bias=False)
            b.lin(f"{bp}.{attn}.to_out.0", c, c)
        b.lin(f"{bp}.ff.net.0.proj", c, c * 8)
        b.lin(f"{bp}.ff.net.2", c * 4, c)
        b.conv(f"{name}.proj_out", c, c, k=1)

    b.lin("time_embed.0", mc, emb)
    b.lin("time_embed.2", emb, emb)
    b.conv("input_blocks.0.0", 4, mc)
    res("input_blocks.1.0", mc, mc)
    b.conv("input_blocks.2.0.op", mc, mc)
    res("input_blocks.3.0", mc, 2 * mc)
    spatial("input_blocks.3.1", 2 * mc)
    res("middle_block.0", 2 * mc, 2 * mc)
    spatial("middle_block.1", 2 * mc)
    res("middle_block.2", 2 * mc, 2 * mc)
    res("output_blocks.0.0", 4 * mc, 2 * mc)
    spatial("output_blocks.0.1", 2 * mc)
    res("output_blocks.1.0", 3 * mc, 2 * mc)
    spatial("output_blocks.1.1", 2 * mc)
    b.conv("output_blocks.1.2.conv", 2 * mc, 2 * mc)
    res("output_blocks.2.0", 3 * mc, mc)
    res("output_blocks.3.0", 2 * mc, mc)
    b.norm("out.0", mc)
    b.conv("out.2", mc, 4)
    return b.sd


def compvis_vae(seed=6):
    """The tiny AutoencoderKL (VAE_KW): base 8, levels (1, 2), one resblock
    per encoder level and two per decoder level, single-head mid attention."""
    b = RandomStateDict(seed)
    c0, c1, z = 8, 16, 4

    def res(name, ci, co):
        b.norm(f"{name}.norm1", ci)
        b.conv(f"{name}.conv1", ci, co)
        b.norm(f"{name}.norm2", co)
        b.conv(f"{name}.conv2", co, co)
        if ci != co:
            b.conv(f"{name}.nin_shortcut", ci, co, k=1)

    def mid(name, c):
        res(f"{name}.block_1", c, c)
        b.norm(f"{name}.attn_1.norm", c)
        for k in ("q", "k", "v", "proj_out"):
            b.conv(f"{name}.attn_1.{k}", c, c, k=1)
        res(f"{name}.block_2", c, c)

    b.conv("encoder.conv_in", 3, c0)
    res("encoder.down.0.block.0", c0, c0)
    b.conv("encoder.down.0.downsample.conv", c0, c0)
    res("encoder.down.1.block.0", c0, c1)
    mid("encoder.mid", c1)
    b.norm("encoder.norm_out", c1)
    b.conv("encoder.conv_out", c1, 2 * z)
    b.conv("quant_conv", 2 * z, 2 * z, k=1)
    b.conv("post_quant_conv", z, z, k=1)
    b.conv("decoder.conv_in", z, c1)
    mid("decoder.mid", c1)
    res("decoder.up.1.block.0", c1, c1)
    res("decoder.up.1.block.1", c1, c1)
    b.conv("decoder.up.1.upsample.conv", c1, c1)
    res("decoder.up.0.block.0", c1, c0)
    res("decoder.up.0.block.1", c0, c0)
    b.norm("decoder.norm_out", c0)
    b.conv("decoder.conv_out", c0, 3)
    return b.sd


def hf_clip_text(seed=5):
    """The tiny CLIP text tower (TEXT_KW) under Hugging Face CLIPTextModel's names."""
    b, w = RandomStateDict(seed), TEXT_KW["width"]
    vocab = JT.CLIPTextConfig(**TEXT_KW).vocab_size
    b.sd["embeddings.token_embedding.weight"] = b.rs.randn(vocab, w).astype(np.float32) * 0.02
    b.sd["embeddings.position_embedding.weight"] = b.rs.randn(TEXT_KW["context_length"], w).astype(np.float32) * 0.01
    b.norm("final_layer_norm", w)
    for i in range(TEXT_KW["layers"]):
        layer = f"encoder.layers.{i}"
        b.norm(f"{layer}.layer_norm1", w)
        b.norm(f"{layer}.layer_norm2", w)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            b.lin(f"{layer}.self_attn.{proj}", w, w)
        b.lin(f"{layer}.mlp.fc1", w, 4 * w)
        b.lin(f"{layer}.mlp.fc2", 4 * w, w)
    return b.sd


def compvis_checkpoint(dtype):
    """A full CompVis checkpoint dict of torch tensors: the tiny UNet, VAE
    and text tower under their prefixes, in `dtype`, plus keys the loader
    skips (EMA weights, a step count)."""
    sd = {}
    for prefix, part in (("model.diffusion_model.", compvis_unet()), ("first_stage_model.", compvis_vae()),
                         ("cond_stage_model.transformer.text_model.", hf_clip_text())):
        sd.update({prefix + k: torch.from_numpy(v).to(dtype) for k, v in part.items()})
    sd["model_ema.decay"] = torch.tensor(0.9999)
    return {"state_dict": sd, "global_step": 470000}


@pytest.fixture(scope="module")
def configs():
    return ((JU.UNetConfig(**UNET_KW), JV.VAEConfig(**VAE_KW), JT.CLIPTextConfig(**TEXT_KW)),
            (TU.UNetConfig(**UNET_KW), TV.VAEConfig(**VAE_KW), TT.CLIPTextConfig(**TEXT_KW)))


def test_unet_converter_matches_jax(configs):
    (jcfg, _, _), (tcfg, _, _) = configs
    sd = compvis_unet()
    assert_same_tree(TL.unet_params_from_compvis(sd, tcfg), JL.unet_params_from_compvis(sd, jcfg))


def test_vae_converter_matches_jax(configs):
    (_, jcfg, _), (_, tcfg, _) = configs
    sd = compvis_vae()
    assert_same_tree(TL.vae_params_from_compvis(sd, tcfg), JL.vae_params_from_compvis(sd, jcfg))


def test_text_converter_matches_jax(configs):
    (_, _, jcfg), (_, _, tcfg) = configs
    sd = hf_clip_text()
    assert_same_tree(TL.clip_text_params_from_hf(sd, tcfg), JL.clip_text_params_from_hf(sd, jcfg))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32], ids=["fp16", "f32"])
def test_load_stable_diffusion_matches_jax(tmp_path, configs, dtype):
    """A torch.save'd CompVis checkpoint (fp16 as the public SD 1.x files
    ship, and f32): split and loaded by both packages, the same trees."""
    ckpt = compvis_checkpoint(dtype)
    path = str(tmp_path / "sd.ckpt")
    torch.save(ckpt, path)
    numpy_sd = {k: v.float().numpy() for k, v in ckpt["state_dict"].items()}
    for a, b in zip(TL.split_compvis_checkpoint(numpy_sd), JL.split_compvis_checkpoint(numpy_sd)):
        assert a.keys() == b.keys() and len(a) > 0
    jcfgs, tcfgs = configs
    port = TL.load_stable_diffusion(path, *tcfgs)
    ref = JL.load_stable_diffusion(path, *jcfgs)
    for a, b in zip(port, ref):
        assert_same_tree(a, b)
    no_text = {k: v for k, v in ckpt["state_dict"].items() if not k.startswith("cond_stage_model.")}
    torch.save(no_text, path)
    assert TL.load_stable_diffusion(path, *tcfgs)[2] is None


def test_unet_evaluation_on_loaded_trees_matches_the_jax_converted_ones(tmp_path, configs):
    jcfgs, tcfgs = configs
    path = str(tmp_path / "sd.ckpt")
    torch.save(compvis_checkpoint(torch.float16), path)
    unet, vae, text = TL.load_stable_diffusion(path, *tcfgs)
    junet = bridge.diffusion_params_to_torch(jax.device_get(JL.load_stable_diffusion(path, *jcfgs)[0]))
    rs = np.random.RandomState(9)
    x = torch.from_numpy(rs.randn(2, 4, 8, 8).astype(np.float32))
    t = torch.tensor([10.0, 500.0])
    context = torch.from_numpy(rs.randn(2, 4, UNET_KW["context_dim"]).astype(np.float32))
    out = TU.forward(unet, x, t, tcfgs[0], context)
    assert out.shape == (2, 4, 8, 8) and bool(torch.isfinite(out).all())
    assert torch.equal(out, TU.forward(junet, x, t, tcfgs[0], context))
    img = TV.decode(vae, out, tcfgs[1])
    assert img.shape == (2, 3, 16, 16) and bool(torch.isfinite(img).all())


def test_chip_smoke_writes_what_the_loaders_read(tmp_path):
    """chip_smoke.compvis_state_dict (the writer of the card's full-width
    checkpoint) at SD 1.x's structure with narrow widths: the port's and
    maua_tpu's loaders both read back the fp16-rounded source trees."""
    ucfg = TU.UNetConfig(model_channels=32, num_heads=2, context_dim=32)
    vcfg = TV.VAEConfig(base_channels=32)
    tcfg = TT.CLIPTextConfig(width=32, layers=2, heads=2, context_length=8, vocab_size=64)
    gen = torch.Generator().manual_seed(0)
    src = [TU.init_params(ucfg, gen), TV.init_params(vcfg, gen), TT.init_params(tcfg, gen)]
    src = chip_smoke.tree_map(lambda t: (t + 0.01 * torch.randn(t.shape, generator=gen)).half(), src)
    path = str(tmp_path / "sd.ckpt")
    torch.save({"state_dict": chip_smoke.compvis_state_dict(*src)}, path)
    want = chip_smoke.tree_map(lambda t: t.float(), src)
    port = TL.load_stable_diffusion(path, ucfg, vcfg, tcfg)
    assert sum(chip_smoke.assert_trees_equal(a, b, n) for a, b, n in zip(port, want, ("unet", "vae", "text"))) > 300
    jcfgs = (JU.UNetConfig(model_channels=32, num_heads=2, context_dim=32), JV.VAEConfig(base_channels=32),
             JT.CLIPTextConfig(width=32, layers=2, heads=2, context_length=8, vocab_size=64))
    for a, b in zip(port, JL.load_stable_diffusion(path, *jcfgs)):
        assert_same_tree(a, b)


@pytest.mark.parametrize("ndim", [2, 3, 4], ids=["linear", "conv1d", "conv2d"])
def test_self_attention_projections_become_1x1_convs(ndim):
    """A guided-diffusion UNet's self-attention stores qkv and proj_out as
    conv1d weights (co, ci, 1); linear (co, ci) and conv2d (co, ci, 1, 1)
    forms occur too. The port makes a 1x1 OIHW conv of each. maua_tpu's
    converter transposes a 2- or 3-dimensional weight with four axes and
    raises (a fault of the reference, ROADMAP C), so it is compared at
    four dimensions only."""
    b = RandomStateDict(11)
    b.norm("attn.norm", 16)
    b.lin("attn.qkv", 16, 48)
    b.lin("attn.proj_out", 16, 16)
    for k in ("attn.qkv.weight", "attn.proj_out.weight"):
        b.sd[k] = b.sd[k].reshape(b.sd[k].shape + (1,) * (ndim - 2))
    out = TL._selfattn(b.sd, "attn")["self"]
    for name, key in (("qkv", "attn.qkv"), ("proj", "attn.proj_out")):
        w = torch.from_numpy(b.sd[f"{key}.weight"].reshape(-1, 16))
        assert torch.equal(out[name]["w"], w[:, :, None, None])
    if ndim == 4:
        assert_same_tree(out, JL._selfattn(b.sd, "attn")["self"])
    else:
        with pytest.raises(ValueError):
            JL._selfattn(b.sd, "attn")
