"""The port's BERT text encoder, GLIDE and GLID3XL against maua_tpu's, on the CPU.

The tiny configurations of tests/test_latent_glide.py (GLIDE's 16^2 base
and 32^2 upsampler, the 32^2 latent UNet and VAE, the 8-token CLIP text
encoder) and tests/test_bert.py's 32-wide BERT. Every parameter is a numpy
draw in maua_tpu's pytree, carried over by the bridge; JAX's draws (GLIDE's
two stages' starting noise, the latent's) are handed to the port.

Tolerances, f32: the tokenizer's ids exactly; the BERT encoder 1e-5 of its
largest output; each whole path's image PSNR >= 40 dB against maua_tpu
(peak 2, the [-1, 1] range; the max abs error is printed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.diffusion.models import unet as JU
from maua_tpu.diffusion.models import vae as JV
from maua_tpu.diffusion.processors.glide import GLID3XL as JaxGLID3XL
from maua_tpu.diffusion.processors.glide import GLIDE as JaxGLIDE
from maua_tpu.diffusion.processors.glide import GLIDE_BASE as J_BASE
from maua_tpu.diffusion.processors.glide import GLIDE_UPSAMPLE as J_UPSAMPLE
from maua_tpu.prompt import TextPrompt as JTextPrompt
from maua_tpu.text import bert as JB
from maua_tpu.text import clip_text as JT
from maua_tpu_torch import bridge
from maua_tpu_torch.diffusion import image as TI
from maua_tpu_torch.diffusion.models import unet as TU
from maua_tpu_torch.diffusion.models import vae as TV
from maua_tpu_torch.diffusion.processors.glide import GLID3XL, GLIDE, GLIDE_BASE, GLIDE_UPSAMPLE
from maua_tpu_torch.prompt import TextPrompt
from maua_tpu_torch.text import bert as TB
from maua_tpu_torch.text import clip_text as TT
from test_bert import CFG, _torch_sd
from test_torch_diffusion import _psnr, port_cfg, random_params

TINY_UNET = JU.UNetConfig(in_channels=4, out_channels=4, model_channels=16, channel_mult=(1, 2), num_res_blocks=1,
                          attention_resolutions=(2,), num_heads=2, context_dim=32)
TINY_VAE = JV.VAEConfig(base_channels=8, channel_mult=(1, 2), num_res_blocks=1)
TINY_TEXT = JT.CLIPTextConfig(width=32, layers=1, heads=2, context_length=8)
TINY_BASE = JU.UNetConfig(in_channels=3, out_channels=6, model_channels=16, channel_mult=(1, 2), num_res_blocks=1,
                          attention_resolutions=(2,), num_heads=2, context_dim=32, use_scale_shift_norm=True)
TINY_UP = JU.UNetConfig(in_channels=6, out_channels=6, model_channels=16, channel_mult=(1, 2), num_res_blocks=1,
                        attention_resolutions=(2,), num_heads=2, context_dim=32, use_scale_shift_norm=True)


def _whole(out, ref, what):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    print(f"{what}: max abs err {np.abs(out - ref).max():.3g}, PSNR {_psnr(out, ref):.1f} dB")
    assert _psnr(out, ref) >= 40.0
    assert np.abs(ref).max() > 0.05


# ------------------------------------------------------------------ BERT
def test_tokenizer_ids_match(tmp_path):
    vocab = ["[PAD]"] + [f"unused{i}" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]"] + [
        "hello", "world", "un", "##believ", "##able", "!", "a", "fox"]
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n")
    texts = ["Hello unbelievable world!", "a red fox, jumping; über", "", "x" * 40, "hello " * 30]
    for vocab_path in (str(path), None):  # the vocab file, then the hash fallback
        want, got = JB.WordPieceTokenizer(vocab_path), TB.WordPieceTokenizer(vocab_path)
        assert got.vocab_size == want.vocab_size
        for text in texts:
            for max_len in (12, 77):
                np.testing.assert_array_equal(got(text, max_len), want(text, max_len))
    ids = TB.WordPieceTokenizer(str(path))("Hello unbelievable world!", max_len=12)
    assert list(ids[:9]) == [101, 103, 105, 106, 107, 104, 108, 102, 0]


def test_bert_encoder_matches():
    sd = _torch_sd(CFG, seed=1)
    jparams = JB.params_from_torch({k: v.numpy() for k, v in sd.items()}, CFG)
    tparams = TB.params_from_torch({k: v.numpy() for k, v in sd.items()}, port_cfg(TB.BERTConfig, CFG))
    torch.testing.assert_close(bridge.bert_params_to_torch(jparams), tparams, rtol=0, atol=0)
    tokens = np.random.default_rng(2).integers(0, CFG.vocab_size, (2, CFG.max_len))
    want = np.asarray(JB.encode(jparams, jnp.asarray(tokens), CFG))
    got = TB.encode(tparams, tokens, port_cfg(TB.BERTConfig, CFG)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # the embedder: the tokenizer (hash ids over the full vocabulary) and the encoder, on the named device
    ecfg = JB.BERTConfig(max_len=16, width=32, layers=1, heads=4)
    eparams = random_params(lambda k: JB.init_params(k, ecfg), 58)
    emb = TB.BERTEmbedder(port_cfg(TB.BERTConfig, ecfg), params=bridge.bert_params_to_torch(eparams), device="cpu")
    out = emb(["a red fox", ""])
    want = np.asarray(JB.BERTEmbedder(ecfg, params=eparams)(["a red fox", ""]))
    assert isinstance(emb, torch.nn.Module) and out.shape == (2, 16, 32)
    assert np.abs(out.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    drawn = TB.BERTEmbedder(port_cfg(TB.BERTConfig, ecfg), device="cpu", seed=3)
    assert drawn.params["blocks"][0]["fc1"]["w"].shape == (4 * 32, 32)
    again = TB.BERTEmbedder(port_cfg(TB.BERTConfig, ecfg), device="cpu", seed=3)
    torch.testing.assert_close(drawn(["a"]), again(["a"]))


# ------------------------------------------------------------------ GLIDE
@pytest.fixture(scope="module")
def glide_pair():
    base = random_params(lambda k: JU.init_params(k, TINY_BASE), 50)
    up = random_params(lambda k: JU.init_params(k, TINY_UP), 51)
    text = random_params(lambda k: JT.init_params(k, TINY_TEXT), 52)
    kw = dict(timesteps=3, base_size=16, image_size=32)
    jg = JaxGLIDE(base_cfg=TINY_BASE, up_cfg=TINY_UP, text_cfg=TINY_TEXT, base_params=base, up_params=up,
                  text_params=text, **kw)
    tg = GLIDE(base_cfg=port_cfg(TU.UNetConfig, TINY_BASE), up_cfg=port_cfg(TU.UNetConfig, TINY_UP),
               text_cfg=port_cfg(TT.CLIPTextConfig, TINY_TEXT), base_params=bridge.diffusion_params_to_torch(base),
               up_params=bridge.diffusion_params_to_torch(up), text_params=bridge.diffusion_params_to_torch(text),
               device="cpu", **kw)
    return jg, tg


@pytest.mark.parametrize("t_start", [0.0, 0.5])
def test_glide_chain_matches(glide_pair, t_start):
    jg, tg = glide_pair
    img = np.random.RandomState(53).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jg(img, [JTextPrompt("a red fox")], t_start, key=key))
    k1, _, k3, _ = jax.random.split(key, 4)
    noise = (np.asarray(jax.random.normal(k1, (1, 16, 16, 3))), np.asarray(jax.random.normal(k3, (1, 32, 32, 3))))
    out = tg(img, [TextPrompt("a red fox")], t_start, noise=noise)
    _whole(out, ref, f"GLIDE t_start {t_start}")
    assert np.abs(out.numpy()).max() <= 1.0  # the upsampler's x0 is clipped
    # the prompt is read: another text moves the image past the bar
    other = tg(img, [TextPrompt("a blue lighthouse")], t_start, noise=noise)
    assert _psnr(other.numpy(), ref) < 40.0


# ------------------------------------------------------------------ GLID3XL
def test_glid3xl_matches():
    unet = random_params(lambda k: JU.init_params(k, TINY_UNET), 54)
    vae = random_params(lambda k: JV.init_params(k, TINY_VAE), 55)
    text = random_params(lambda k: JT.init_params(k, TINY_TEXT), 56)
    bcfg = JB.BERTConfig(width=TINY_UNET.context_dim, layers=2, heads=4, max_len=TINY_TEXT.context_length)
    bparams = random_params(lambda k: JB.init_params(k, bcfg), 57)
    kw = dict(sampler="plms", timesteps=3, image_size=32)
    jg = JaxGLID3XL(unet_cfg=TINY_UNET, vae_cfg=TINY_VAE, text_cfg=TINY_TEXT, unet_params=unet, vae_params=vae,
                    text_params=text, bert=JB.BERTEmbedder(bcfg, params=bparams), **kw)
    tbert = TB.BERTEmbedder(port_cfg(TB.BERTConfig, bcfg), params=bridge.bert_params_to_torch(bparams), device="cpu")
    tg = GLID3XL(unet_cfg=port_cfg(TU.UNetConfig, TINY_UNET), vae_cfg=port_cfg(TV.VAEConfig, TINY_VAE),
                 text_cfg=port_cfg(TT.CLIPTextConfig, TINY_TEXT), unet_params=bridge.diffusion_params_to_torch(unet),
                 vae_params=bridge.diffusion_params_to_torch(vae), text_params=bridge.diffusion_params_to_torch(text),
                 bert=tbert, device="cpu", **kw)
    img = np.zeros((1, 32, 32, 3), np.float32)
    key = jax.random.PRNGKey(8)
    ref = np.asarray(jg(img, [JTextPrompt("a lighthouse")], 0.0, key=key))
    noise = np.asarray(jax.random.normal(jax.random.split(key)[0], (1, 16, 16, 4)))
    out = tg(img, [TextPrompt("a lighthouse")], 0.0, noise=noise)
    _whole(out, ref, "GLID3XL")
    # the conditioning is BERT's: the CLIP text encoder's would move the image past the bar
    tg._ld.conditioning = type(tg._ld).conditioning.__get__(tg._ld)
    assert _psnr(tg(img, [TextPrompt("a lighthouse")], 0.0, noise=noise).numpy(), ref) < 40.0


# ------------------------------------------------------------------ dispatch
def test_get_diffusion_model_builds_glide_and_glid3xl():
    small = dict(base_cfg=port_cfg(TU.UNetConfig, TINY_BASE), up_cfg=port_cfg(TU.UNetConfig, TINY_UP),
                 text_cfg=port_cfg(TT.CLIPTextConfig, TINY_TEXT), base_size=16, image_size=32, device="cpu")
    g = TI.get_diffusion_model("glide", timesteps=4, cfg_scale=2.0, **small)
    assert isinstance(g, GLIDE) and g.cfg_scale == 2.0 and len(g.timestep_map) == 4
    assert g.device == torch.device("cpu") and g.base_params["conv_in"]["w"].device == torch.device("cpu")
    # maua_tpu builds GLIDE without grad modules and drops a guidance scale silently: the port refuses it
    with pytest.raises(ValueError, match="clip_scale"):
        TI.get_diffusion_model("glide", timesteps=4, clip_scale=1.0, **small)
    with pytest.raises(ValueError, match="DDIM"):
        GLIDE(sampler="plms", **small)
    latent = dict(unet_cfg=port_cfg(TU.UNetConfig, TINY_UNET), vae_cfg=port_cfg(TV.VAEConfig, TINY_VAE),
                  text_cfg=port_cfg(TT.CLIPTextConfig, TINY_TEXT), image_size=32, device="cpu")
    m = TI.get_diffusion_model("glid3xl", timesteps=3, color_match_scale=4.0, sampler="ddim", **latent)
    assert isinstance(m, GLID3XL) and m._ld.sampler == "ddim"
    assert [(type(gm).__name__, gm.scale) for gm in m.grad_modules] == [("ColorMatchGrads", 4.0)]
    assert m.bert.cfg == TB.BERTConfig(width=32, layers=2, heads=4, max_len=8) and m.device == torch.device("cpu")
    assert TI.get_diffusion_model("glid3xl", timesteps=3, **latent)._ld.sampler == "plms"
    # the published shapes
    assert GLIDE_BASE == port_cfg(TU.UNetConfig, J_BASE) and GLIDE_UPSAMPLE == port_cfg(TU.UNetConfig, J_UPSAMPLE)


def test_glide_needs_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("glide", "glid3xl"):
        with pytest.raises(RuntimeError, match="CUDA"):
            TI.get_diffusion_model(name)
    with pytest.raises(RuntimeError, match="CUDA"):
        TB.BERTEmbedder(TB.BERTConfig(width=8, layers=1, heads=2))
