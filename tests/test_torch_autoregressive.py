"""The port's autoregressive text-to-image slice against maua_tpu's, on the CPU.

A tiny transformer (width 32, 2 layers, 4 heads, a 4 x 4 grid after 6 text
tokens, vocabularies of 96 text and 64 image ids) with every parameter of
maua_tpu's pytree drawn with numpy and carried over by the bridge; a tiny
VQ decoder (32 channels, two levels) likewise.

Token parity: JAX's PRNG cannot be reproduced in torch, so the tests
rebuild the Gumbel noise `jax.random.categorical` adds at each step (the
same subkey schedule: one split a step, a window or a chunk), assert that
argmax(JAX's filtered logits + that noise) gives maua_tpu's own samples,
hand the noise to the port and assert equal tokens position for position.
Each step's margin between the chosen and the runner-up perturbed logit
must exceed 100 times the largest difference between the two packages'
logits, so that the equality is not luck.

Tolerances, f32: logits and K/V caches 1e-5 of the largest magnitude;
decoded images 1e-4 absolute (ten f32 conv layers in another summation
order); CLIP similarities 1e-5.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.autoregressive import oversample as JO
from maua_tpu.autoregressive import rerank as JR
from maua_tpu.autoregressive import transformer as JT
from maua_tpu.autoregressive import vq as JV
from maua_tpu_torch import __main__ as cli_main
from maua_tpu_torch import bridge
from maua_tpu_torch.autoregressive import api as TAPI
from maua_tpu_torch.autoregressive import cli as TCLI
from maua_tpu_torch.autoregressive import oversample as TO
from maua_tpu_torch.autoregressive import rerank as TR
from maua_tpu_torch.autoregressive import transformer as TT
from maua_tpu_torch.autoregressive import vq as TV
from test_torch_diffusion import port_cfg, random_params

torch.set_num_threads(1)

TINY = JT.ARConfig(vocab_size=64, text_vocab_size=96, text_length=6, image_rows=4, image_cols=4, width=32,
                   layers=2, heads=4, max_frames=5)
TINY_VQ = JV.VQConfig(codebook_size=64, z_channels=4, base_channels=32, channel_mult=(1, 2), num_res_blocks=1)
TOL = 1e-5
MARGIN = 100.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# maua_tpu's functions jitted: one compile each, where op-by-op dispatch compiles every op
j_forward = jax.jit(JT.forward, static_argnames=("cfg", "remat"))
j_decode = jax.jit(JV.decode_tokens, static_argnames=("cfg", "rows", "cols"))
j_decode_video = jax.jit(JV.decode_video_tokens, static_argnames=("cfg", "rows", "cols"))
j_decode_rq = jax.jit(JV.decode_rq_tokens, static_argnames=("cfg", "rows", "cols", "depth"))
j_encode = jax.jit(JV.encode_tokens, static_argnames=("cfg",))
j_encode_rq = jax.jit(JV.encode_rq_tokens, static_argnames=("cfg", "depth"))


def rel_close(got, want, tol=TOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale


@pytest.fixture(scope="module")
def ar():
    params = random_params(lambda k: JT.init_params(k, TINY), 30)
    return params, bridge.ar_params_to_torch(params), port_cfg(TT.ARConfig, TINY)


def text_tokens(b=2, seed=0, cfg=TINY):
    return np.random.RandomState(seed).randint(0, cfg.text_vocab_size, (b, cfg.text_length)).astype(np.int32)


def gumbel_schedule(key, n_steps, shape):
    """The noise maua_tpu's samplers add: the key split once a step, jax.random.gumbel(sub, shape)."""
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(sub, shape)))
    return key, out


def draws_of(gumbels):
    """A port `draw` handing out the given noise in order (and checking its shape)."""
    it = iter(gumbels)

    def draw(shape):
        g = next(it)
        assert tuple(g.shape) == tuple(shape)
        return torch.from_numpy(np.array(g))

    return draw


def jax_filter(logits, temperature=1.0, top_k=0, top_p=0.0):
    """maua_tpu's `_sample_logits` before its draw (the same code, without the categorical)."""
    logits = logits / jnp.maximum(temperature, 1e-6)
    if top_k > 0:
        kth = jnp.sort(logits, axis=-1)[..., -top_k][..., None]
        logits = jnp.where(logits < kth, -jnp.inf, logits)
    if top_p > 0.0:
        sorted_logits = jnp.sort(logits, axis=-1)[..., ::-1]
        cum = jnp.cumsum(jax.nn.softmax(sorted_logits, -1), -1)
        cutoff = jnp.take_along_axis(sorted_logits, jnp.sum(cum < top_p, axis=-1, keepdims=True), axis=-1)
        logits = jnp.where(logits < cutoff, -jnp.inf, logits)
    return logits


def dynamic_k_filter(logits, temperature, k):
    """maua_tpu video's `_sample_dynamic_k` before its draw."""
    logits = logits / jnp.maximum(temperature, 1e-6)
    v = logits.shape[-1]
    srt = jnp.sort(logits, axis=-1)
    kth = srt[..., int(np.clip(v - k, 0, v - 1))][..., None]
    return jnp.where(logits < kth, -jnp.inf, logits)


def check_draws(jax_logits, port_logits, filtered, gumbels, tokens, sampled):
    """Each step s where `sampled[s]`: argmax(filtered[s] + gumbels[s]) == tokens[s] (JAX's own samples
    from these draws), and the top-two margin of the perturbed logits exceeds MARGIN x the largest logit
    difference between the packages. Returns the smallest margin."""
    diff = max(float(np.abs(np.asarray(j) - p.detach().numpy()).max()) for j, p in zip(jax_logits, port_logits))
    margins = []
    for s, ok in enumerate(sampled):
        if not ok:
            continue
        z = np.asarray(filtered[s]) + gumbels[s]
        np.testing.assert_array_equal(np.argmax(z, -1), np.asarray(tokens[s]))
        top2 = np.sort(z, -1)[..., -2:]
        margins.append(float((top2[..., 1] - top2[..., 0]).min()))
    assert margins and min(margins) > MARGIN * diff, (min(margins), diff)
    return min(margins)


# ------------------------------------------------------------------ the transformer
@pytest.mark.parametrize("case", ["causal", "frames", "mask", "remat"])
def test_forward_matches(ar, case):
    params, tparams, cfg = ar
    rs = np.random.RandomState(1)
    t = TINY.total_length
    tokens = rs.randint(0, TINY.total_vocab, (2, t)).astype(np.int32)
    kw, tkw = {}, {}
    if case == "frames":
        t = TINY.text_length + 3 * TINY.image_length
        tokens = rs.randint(0, TINY.total_vocab, (2, t)).astype(np.int32)
        fids = np.concatenate([np.full(TINY.text_length, -1), np.repeat([0, 2, 1], TINY.image_length)])
        kw = tkw = {"frame_ids": fids}
    if case == "mask":
        m = JO.get_conv_mask(TINY, kernel=3)
        kw, tkw = {"mask": jnp.asarray(m)}, {"mask": torch.from_numpy(m)}
    if case == "remat":
        kw = tkw = {"remat": True}
    want = j_forward(params, jnp.asarray(tokens), TINY, **kw)
    got = TT.forward(tparams, torch.from_numpy(tokens), cfg, **tkw)
    rel_close(got, want)


def test_block_gelu_is_the_tanh_form(ar):
    """jax.nn.gelu is the tanh approximation by default; the block matches it, where PyTorch's default
    (erf) GELU would miss by far more than the tolerance."""
    params, tparams, cfg = ar
    x = np.random.RandomState(2).randn(2, 5, TINY.width).astype(np.float32) * 3
    mask = np.tril(np.ones((5, 5), bool))
    want = np.asarray(JT.transformer_block(params["blocks"][0], jnp.asarray(x), TINY, jnp.asarray(mask)))
    got = TT.transformer_block(tparams["blocks"][0], torch.from_numpy(x), cfg, torch.from_numpy(mask))
    rel_close(got, want)
    u = torch.linspace(-4, 4, 101)
    assert torch.allclose(torch.nn.functional.gelu(u, approximate="tanh"),
                          torch.from_numpy(np.array(jax.nn.gelu(jnp.asarray(u.numpy())))), atol=1e-6)
    assert (torch.nn.functional.gelu(u) - torch.nn.functional.gelu(u, approximate="tanh")).abs().max() > 1e-4


def test_kv_prefill_and_step_match(ar):
    params, tparams, cfg = ar
    rs = np.random.RandomState(3)
    total, n = TINY.total_length, TINY.text_length - 1
    x = rs.randn(2, n, TINY.width).astype(np.float32)
    want = JT.kv_prefill(params, TINY, jnp.asarray(x), total)
    got = TT.kv_prefill(tparams, cfg, torch.from_numpy(x), total)
    for (jk, jv), (tk, tv) in zip(want, got):
        rel_close(tk.transpose(1, 2), jk)
        rel_close(tv.transpose(1, 2), jv)
    xs = rs.randn(2, TINY.width).astype(np.float32)
    jl, jc = JT.kv_step(params, TINY, jnp.asarray(xs), n, want, total)
    tl, tc = TT.kv_step(tparams, cfg, torch.from_numpy(xs), n, got)
    rel_close(tl, jl)
    for (jk, _), (tk, _) in zip(jc, tc):
        rel_close(tk.transpose(1, 2)[:, : n + 1], jk[:, : n + 1])


def test_position_table_matches(ar):
    params, tparams, cfg = ar
    rel_close(TT.position_table(tparams, cfg, TINY.total_length), JT.position_table(params, TINY, TINY.total_length))
    fids = np.concatenate([np.full(TINY.text_length, -1), np.repeat([0, 2, 4, 1, 3], TINY.image_length)])
    t = len(fids)
    rel_close(TT.position_table(tparams, cfg, t, fids), JT.position_table(params, TINY, t, jnp.asarray(fids)))


@pytest.mark.parametrize("temperature,top_k,top_p", [(1.0, 0, 0.0), (0.7, 5, 0.0), (1.3, 0, 0.6), (1.0, 7, 0.9)])
def test_sampling_filters_match(temperature, top_k, top_p):
    """Ties at the k-th value are kept (the logits are rounded to halves, so the k-th value repeats)."""
    logits = np.round(np.random.RandomState(4).randn(3, 40).astype(np.float32) * 4) / 2
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(JT._sample_logits(key, jnp.asarray(logits), temperature, top_k, top_p))
        g = np.asarray(jax.random.gumbel(key, logits.shape))
        got = TT.sample_logits(torch.from_numpy(logits), draws_of([g]), temperature, top_k, top_p)
        np.testing.assert_array_equal(got.numpy(), want)
    kept = TT.filter_logits(torch.from_numpy(logits), temperature, top_k, top_p)
    np.testing.assert_array_equal(np.isfinite(kept.numpy()), np.isfinite(np.asarray(
        jax_filter(jnp.asarray(logits), temperature, top_k, top_p))))


def step_logits(params, tparams, cfg, tokens):
    """Each image step's logits (JAX, the port) from one forward of the final tokens (B, total)."""
    want = j_forward(params, jnp.asarray(tokens, jnp.int32), TINY)
    got = TT.forward(tparams, torch.from_numpy(np.asarray(tokens)).long(), cfg)
    tl, tv = TINY.text_length, TINY.text_vocab_size
    return ([want[:, tl + i - 1, tv:] for i in range(tokens.shape[1] - tl)],
            [got[:, tl + i - 1, tv:] for i in range(tokens.shape[1] - tl)])


@pytest.mark.parametrize("cached", [True, False])
@pytest.mark.parametrize("forced", [False, True])
def test_generate_tokens_equal_given_the_draws(ar, cached, forced):
    params, tparams, cfg = ar
    text = text_tokens(2, seed=5)
    key = jax.random.PRNGKey(6)
    kw = dict(temperature=0.9, top_k=9, top_p=0.0)
    fkw, tfkw, sampled = {}, {}, [True] * TINY.image_length
    if forced:
        ft = np.random.RandomState(7).randint(0, TINY.vocab_size, (2, TINY.image_length)).astype(np.int32)
        fm = np.zeros(TINY.image_length, bool)
        fm[[0, 1, 4, 5, 9]] = True
        fkw = dict(forced_tokens=jnp.asarray(ft), forced_mask=jnp.asarray(fm))
        tfkw = dict(forced_tokens=torch.from_numpy(ft), forced_mask=fm)
        sampled = list(~fm)
    want = np.asarray(JT.generate_tokens(params, jnp.asarray(text), TINY, key, cached=cached, **kw, **fkw))
    _, gumbels = gumbel_schedule(key, TINY.image_length, (2, TINY.vocab_size))
    got = TT.generate_tokens(tparams, torch.from_numpy(text), cfg, cached=cached, draw=draws_of(gumbels),
                             **kw, **tfkw).numpy()
    np.testing.assert_array_equal(got, want)
    if forced:
        np.testing.assert_array_equal(got[:, fm], ft[:, fm])
    full = np.concatenate([text, want + TINY.text_vocab_size], 1)
    jl, tl = step_logits(params, tparams, cfg, full)
    check_draws(jl, tl, [jax_filter(x, **kw) for x in jl], gumbels, want.T, sampled)


def test_generate_from_a_generator_is_reproducible(ar):
    _, tparams, cfg = ar
    text = torch.from_numpy(text_tokens(2, seed=8))
    a = TT.generate_tokens(tparams, text, cfg, torch.Generator().manual_seed(3), top_k=8)
    b = TT.generate_tokens(tparams, text, cfg, torch.Generator().manual_seed(3), top_k=8, cached=False)
    assert a.shape == (2, TINY.image_length) and int(a.min()) >= 0 and int(a.max()) < TINY.vocab_size
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(NotImplementedError, match="platform layer"):
        TT.tp_shardings(tparams, None)


# ------------------------------------------------------------------ oversampling and masks
def test_attention_masks_equal():
    for jf, tf in ((JO.get_row_mask, TO.get_row_mask), (JO.get_col_mask, TO.get_col_mask)):
        np.testing.assert_array_equal(tf(TINY), jf(TINY))
    np.testing.assert_array_equal(TO.get_conv_mask(TINY, kernel=3), JO.get_conv_mask(TINY, kernel=3))


def test_oversample_generate_equal_given_the_draws(ar):
    """target 6 columns from 4-column windows with overlap 2: the second window's first two columns are
    teacher-forced with the first window's last two."""
    params, tparams, cfg = ar
    text = text_tokens(2, seed=9)
    key = jax.random.PRNGKey(10)
    want = np.asarray(JO.oversample_generate(params, jnp.asarray(text), TINY, key, target_cols=6, overlap=2,
                                             top_k=12))
    gumbels, k = [], key
    for _ in range(2):
        k, sub = jax.random.split(k)
        gumbels += gumbel_schedule(sub, TINY.image_length, (2, TINY.vocab_size))[1]
    got = TO.oversample_generate(tparams, torch.from_numpy(text), cfg, target_cols=6, overlap=2, top_k=12,
                                 draw=draws_of(gumbels)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 4, 6)
    # the second window's draws: its tokens are the grid's columns 2..5 (columns 0, 1 forced)
    second = np.concatenate([want[:, :, 2:4], want[:, :, 4:6]], 2).reshape(2, -1)
    full = np.concatenate([text, second + TINY.text_vocab_size], 1)
    jl, tl = step_logits(params, tparams, cfg, full)
    sampled = [c >= 2 for r in range(4) for c in range(4)]
    check_draws(jl, tl, [jax_filter(x, top_k=12) for x in jl], gumbels[TINY.image_length:], second.T, sampled)


# ------------------------------------------------------------------ the VQ decoder
@pytest.fixture(scope="module")
def vq():
    params = random_params(lambda k: JV.init_params(k, TINY_VQ), 31)
    return params, bridge.diffusion_params_to_torch(params), port_cfg(TV.VQConfig, TINY_VQ)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def test_vq_decode_and_encode_match(vq):
    params, tparams, cfg = vq
    rs = np.random.RandomState(11)
    toks = rs.randint(0, TINY_VQ.codebook_size, (3, 16))
    want = np.asarray(j_decode(params, jnp.asarray(toks), TINY_VQ, 4, 4))
    got = TV.decode_tokens(tparams, torch.from_numpy(toks), cfg, 4, 4)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-4)
    vid = rs.randint(0, TINY_VQ.codebook_size, (2, 3, 16))
    wantv = np.asarray(j_decode_video(params, jnp.asarray(vid), TINY_VQ, 4, 4))
    gotv = TV.decode_video_tokens(tparams, torch.from_numpy(vid), cfg, 4, 4)
    np.testing.assert_allclose(gotv.permute(0, 1, 3, 4, 2).numpy(), wantv, atol=1e-4)
    imgs = np.clip(rs.randn(2, 8, 8, 3).astype(np.float32) * 0.5, -1, 1)
    np.testing.assert_array_equal(TV.encode_tokens(tparams, _nchw(imgs), cfg).numpy(),
                                  np.asarray(j_encode(params, jnp.asarray(imgs), TINY_VQ)))


@pytest.mark.parametrize("depth", [1, 4])
def test_vq_residual_codes_match(vq, depth):
    params, tparams, cfg = vq
    rs = np.random.RandomState(12 + depth)
    imgs = np.clip(rs.randn(2, 8, 8, 3).astype(np.float32) * 0.5, -1, 1)
    want = np.asarray(j_encode_rq(params, jnp.asarray(imgs), TINY_VQ, depth))
    got = TV.encode_rq_tokens(tparams, _nchw(imgs), cfg, depth).numpy()
    np.testing.assert_array_equal(got, want)
    wantd = np.asarray(j_decode_rq(params, jnp.asarray(want), TINY_VQ, 4, 4, depth))
    gotd = TV.decode_rq_tokens(tparams, torch.from_numpy(got), cfg, 4, 4, depth)
    np.testing.assert_allclose(gotd.permute(0, 2, 3, 1).numpy(), wantd, atol=1e-4)


def test_vq_params_from_a_taming_state_dict(vq):
    """A taming-layout state dict (the CompVis VAE names plus `quantize.embedding.weight`) converts to
    the same decode in both packages."""
    import chip_smoke

    params, tparams, cfg = vq
    sd = chip_smoke.taming_state_dict(tparams)
    want = JV.params_from_torch({k: v.numpy() for k, v in sd.items()}, TINY_VQ)
    got = TV.params_from_torch(sd, cfg)
    toks = np.random.RandomState(14).randint(0, TINY_VQ.codebook_size, (2, 16))
    np.testing.assert_allclose(TV.decode_tokens(got, torch.from_numpy(toks), cfg, 4, 4).permute(0, 2, 3, 1).numpy(),
                               np.asarray(j_decode(want, jnp.asarray(toks), TINY_VQ, 4, 4)), atol=1e-4)
    np.testing.assert_allclose(TV.decode_tokens(got, torch.from_numpy(toks), cfg, 4, 4).numpy(),
                               TV.decode_tokens(tparams, torch.from_numpy(toks), cfg, 4, 4).numpy(), atol=1e-6)


# ------------------------------------------------------------------ CLIP rerank
@pytest.fixture(scope="module")
def clip_pair():
    """A 32-px, 2-layer CLIP in both packages with the same parameters."""
    from maua_tpu.perceptors import clip as JCLIP
    from maua_tpu.text import clip_text as JTXT
    from maua_tpu_torch.perceptors import clip as TCLIP
    from maua_tpu_torch.text import clip_text as TTXT
    from test_torch_diffusion import TINY_TEXT
    from test_torch_guidance import TINY_VISION

    vision = random_params(lambda k: JCLIP.init_vision_params(k, TINY_VISION), 20)
    text = random_params(lambda k: JTXT.init_params(k, TINY_TEXT), 21)
    proj = np.random.RandomState(22).randn(TINY_TEXT.width, TINY_VISION.embed_dim).astype(np.float32) / 8
    jp = JCLIP.CLIPPerceptor(vision_params=vision, vision_cfg=TINY_VISION, text_params=text, text_cfg=TINY_TEXT,
                             text_proj=jnp.asarray(proj))
    tp = TCLIP.CLIPPerceptor(vision_params=bridge.guidance_params_to_torch(vision),
                             vision_cfg=port_cfg(TCLIP.CLIPVisionConfig, TINY_VISION),
                             text_params=bridge.diffusion_params_to_torch(text),
                             text_cfg=port_cfg(TTXT.CLIPTextConfig, TINY_TEXT), text_proj=proj, device="cpu")
    return jp, tp


def test_clip_rerank_matches(clip_pair):
    jp, tp = clip_pair
    imgs = np.tanh(np.random.RandomState(15).randn(5, 32, 32, 3).astype(np.float32))
    want = JR.clip_rerank(jnp.asarray(imgs), "a red fox", top_n=3, perceptor=jp)
    got = TR.clip_rerank(_nchw(imgs), "a red fox", top_n=3, perceptor=tp)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("batch_size", [0, 2])
def test_generate_and_rerank_matches(ar, clip_pair, vq, batch_size):
    """Chunks of 2 over 3 candidates: the last chunk is padded to 2 and its extra dropped."""
    params, tparams, cfg = ar
    jp, tp = clip_pair
    vparams, tvparams, vcfg = vq
    text = text_tokens(1, seed=16)
    key = jax.random.PRNGKey(17)
    want = np.asarray(JR.generate_and_rerank(
        params, TINY, jnp.asarray(text), "a fox", lambda t: j_decode(vparams, jnp.asarray(t), TINY_VQ, 4, 4),
        n_candidates=3, top_n=2, key=key, perceptor=jp, batch_size=batch_size, top_k=10))
    if batch_size:
        gumbels, k = [], key
        for _ in range(2):
            k, sub = jax.random.split(k)
            gumbels += gumbel_schedule(sub, TINY.image_length, (2, TINY.vocab_size))[1]
    else:
        gumbels = gumbel_schedule(key, TINY.image_length, (3, TINY.vocab_size))[1]
    got = TR.generate_and_rerank(tparams, cfg, torch.from_numpy(text), "a fox",
                                 lambda t: TV.decode_tokens(tvparams, t, vcfg, 4, 4), n_candidates=3, top_n=2,
                                 perceptor=tp, batch_size=batch_size, draw=draws_of(gumbels), top_k=10)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-4)


# ------------------------------------------------------------------ the API client
def test_api_payload_and_response(tmp_path):
    import base64
    import io

    from PIL import Image
    from maua_tpu.autoregressive import api as JAPI

    assert TAPI.build_request_payload("a fox", 10, 0.5, 2, 1) == JAPI.build_request_payload("a fox", 10, 0.5, 2, 1)
    buf = io.BytesIO()
    Image.fromarray(np.full((4, 5, 3), 7, np.uint8)).save(buf, format="PNG")
    imgs = list(TAPI.decode_response({"images": [base64.b64encode(buf.getvalue()).decode("ascii")]}))
    assert imgs[0].size == (5, 4) and np.asarray(imgs[0])[0, 0, 0] == 7
    with pytest.raises(RuntimeError, match="network egress"):
        TAPI.request_kandinsky("a fox", "http://localhost:1")


# ------------------------------------------------------------------ the commands
def _pngs(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".png"))


def test_generate_command_native_and_oversampled(tmp_path):
    out = tmp_path / "native"
    cli_main.main(["autoregressive", "generate", "--text", "a red fox", "--num_outputs", "3", "--batch_size", "2",
                   "--output_dir", str(out), "--device", "cpu"])
    assert _pngs(out) == ["ar_0.png", "ar_1.png", "ar_2.png"]
    wide = tmp_path / "wide"
    TCLI.main(["--text", "a red fox", "--size", "384,256", "--num_outputs", "1", "--output_dir", str(wide),
               "--output_name", "w", "--device", "cpu"])
    from PIL import Image

    assert Image.open(wide / "w_0.png").size == (48, 32)  # 12 of the native 8 columns, 4 px each


@pytest.mark.parametrize("cmd", ["min", "rq"])
def test_rerank_commands(tmp_path, cmd):
    cli_main.main(["autoregressive", cmd, "a lighthouse", "--num_candidates", "3", "--num_outputs", "2",
                   "--batch_size", "2", "--make_grid", "--output_dir", str(tmp_path), "--device", "cpu"])
    stem = "a_lighthouse_" + ("mindalle" if cmd == "min" else "rq")
    assert _pngs(tmp_path) == [f"{stem}_0.png", f"{stem}_1.png", f"{stem}_grid.png"]


def test_api_command_dry_run(capsys):
    cli_main.main(["autoregressive", "api", "--text", "a fox", "--num_outputs", "2"])
    out = capsys.readouterr().out
    assert "'images_num': 2" in out and "'text': 'a fox'" in out


def test_commands_default_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main.main(["autoregressive", "generate", "--text", "a fox", "--output_dir", str(tmp_path)])


_TOKENS_AND_PNG = """
import hashlib, os, sys
sys.path.insert(0, {repo!r})
from maua_tpu.autoregressive import cli as J
from maua_tpu.autoregressive.transformer import ARConfig as JC
from maua_tpu_torch.autoregressive import cli as T
from maua_tpu_torch.autoregressive.transformer import ARConfig as TC
cfg = dict(width=128, layers=2, heads=4, image_rows=8, image_cols=8, text_length=16)
print("jax", J._text_tokens("sunset over the sea", JC(**cfg)).tolist())
print("torch", T._text_tokens("sunset over the sea", TC(**cfg)).tolist())
T.main(["--text", "sunset over the sea", "--num_outputs", "1", "--output_dir", sys.argv[1], "--device", "cpu"])
print("png", hashlib.sha256(open(os.path.join(sys.argv[1], "ar_0.png"), "rb").read()).hexdigest())
"""


def test_prompt_tokens_and_images_reproduce_across_processes(tmp_path):
    """The port's prompt tokens and PNG bytes are the same under two PYTHONHASHSEEDs, where maua_tpu's
    `_text_tokens` (Python's salted str hash) differs between them."""
    script = tmp_path / "run.py"
    script.write_text(_TOKENS_AND_PNG.format(repo=REPO))
    outs = []
    for seed in ("1", "2"):
        env = {**os.environ, "PYTHONHASHSEED": seed, "JAX_PLATFORMS": "cpu"}
        res = subprocess.run([sys.executable, str(script), str(tmp_path / seed)], env=env, capture_output=True,
                             text=True, timeout=300)
        assert res.returncode == 0, res.stderr[-2000:]
        outs.append(dict(line.split(" ", 1) for line in res.stdout.splitlines()
                         if line.split(" ", 1)[0] in ("jax", "torch", "png")))
    assert outs[0]["torch"] == outs[1]["torch"] and outs[0]["png"] == outs[1]["png"]
    assert outs[0]["jax"] != outs[1]["jax"]


def test_generate_command_upscale_and_stretch(tmp_path):
    """--upscale 2 through RealESRGAN-x4plus (random weights: no checkpoint in the model zoo) and a lanczos
    resample to 2x; --stretch_size resizes the PNG."""
    TCLI.main(["generate", "--text", "a fox", "--num_outputs", "1", "--upscale", "2", "--output_dir",
               str(tmp_path / "up"), "--device", "cpu"])
    TCLI.main(["generate", "--text", "a fox", "--num_outputs", "1", "--stretch_size", "50,40", "--output_dir",
               str(tmp_path / "st"), "--device", "cpu"])
    from PIL import Image

    assert Image.open(tmp_path / "up" / "ar_0.png").size == (64, 64)
    assert Image.open(tmp_path / "st" / "ar_0.png").size == (50, 40)
