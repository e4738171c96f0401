"""The port's autoregressive text-to-video against maua_tpu's, on the CPU.

The tiny transformer and VQ decoder of test_torch_autoregressive.py (a 4 x 4
grid, 5 frame slots). Token parity as there: the Gumbel noise of maua_tpu's
key schedule (one split a window, then one a step) is rebuilt, checked to
give maua_tpu's own samples from its logits (guider mix and per-position
top-k included), and handed to the port; every step's top-two margin must
exceed 100 x the largest logit difference between the packages. Frames:
uint8, equal except where the f32 decode lands within 1e-4 of a rounding
boundary (at most 1 level).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.autoregressive import video as JVID
from maua_tpu_torch import __main__ as cli_main
from maua_tpu_torch.autoregressive import video as TVID
from test_torch_autoregressive import (MARGIN, TINY, TINY_VQ, ar, check_draws, draws_of,  # noqa: F401
                                       dynamic_k_filter, gumbel_schedule, j_forward, text_tokens, vq)

torch.set_num_threads(1)


def fill_logits(params, tparams, cfg, filled, frame_ids, boi_mask, guider_filled=None, alpha=1.0):
    """Each position's next-token image logits of a filled sequence (JAX, the port), with the guider mix."""
    boi = JVID.boi_token(TINY)

    def both(tokens):
        inputs = np.where(boi_mask[None], boi, tokens)
        j = j_forward(params, jnp.asarray(inputs, jnp.int32), TINY, frame_ids=jnp.asarray(frame_ids))
        t = TVID.forward(tparams, torch.from_numpy(inputs).long(), cfg, frame_ids=frame_ids)
        return j[..., TINY.text_vocab_size:], t[..., TINY.text_vocab_size:]

    j, t = both(filled)
    if guider_filled is not None:
        gj, gt = both(guider_filled)
        j, t = gj + (j - gj) * alpha, gt + (t - gt) * alpha
    return j, t


def check_fill(params, tparams, cfg, seq, fids, boi, filled, gumbels, temperature, top_k, tk1=None, gseq=None,
               alpha=1.0):
    """check_draws over one filling_sequence: steps p from the context length to T."""
    ctx = int(np.argmax(np.concatenate([seq < 0, np.ones((seq.shape[0], 1), bool)], 1), 1).min())
    gfilled = None
    if gseq is not None:
        gfilled = filled.copy()
        gfilled[:, : TINY.text_length] = gseq[:, : TINY.text_length]
    j, t = fill_logits(params, tparams, cfg, filled, fids, boi, gfilled, alpha)
    steps = range(ctx, seq.shape[1])
    ks = [top_k if p >= TINY.text_length + TINY.image_length or tk1 is None else tk1 for p in steps]
    return check_draws([j[:, p - 1] for p in steps], [t[:, p - 1] for p in steps],
                       [dynamic_k_filter(j[:, p - 1], temperature, k) for p, k in zip(steps, ks)], gumbels,
                       (filled[:, list(steps)] - TINY.text_vocab_size).T, [bool((seq[:, p] < 0).all()) for p in steps])


@pytest.mark.parametrize("cached", [True, False])
@pytest.mark.parametrize("guider", [False, True])
def test_filling_sequence_equal_given_the_draws(ar, cached, guider):
    """Two frames after the text, the first frame given for batch row 0 only (so the context ends at
    the text), a guider with generic text and alpha 1.7, and a first-frame top-k of 3 against 11."""
    params, tparams, cfg = ar
    text = text_tokens(2, seed=20)
    seq, fids, boi = JVID.build_video_sequence(TINY, text, 2)
    tseq, tfids, tboi = TVID.build_video_sequence(cfg, text, 2)
    np.testing.assert_array_equal(tseq, seq)
    np.testing.assert_array_equal(tfids, fids)
    np.testing.assert_array_equal(tboi, boi)
    seq[0, TINY.text_length: TINY.text_length + 5] = TINY.text_vocab_size + np.arange(5)
    gseq = None
    kw = dict(temperature=0.8, top_k=11, top_k_first_frame=3)
    if guider:
        gseq = seq.copy()
        gseq[:, : TINY.text_length] = text_tokens(2, seed=21)
        kw["guidance_alpha"] = 1.7
    key = jax.random.PRNGKey(22)
    want = np.asarray(JVID.filling_sequence(params, seq, fids, boi, TINY, key, guider_seq=gseq, cached=cached, **kw))
    ctx = TINY.text_length
    _, gumbels = gumbel_schedule(key, seq.shape[1] - ctx, (2, TINY.vocab_size))
    got = TVID.filling_sequence(tparams, seq, fids, boi, cfg, guider_seq=gseq, cached=cached,
                                draw=draws_of(gumbels), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, ctx: ctx + 5], seq[0, ctx: ctx + 5])
    check_fill(params, tparams, cfg, seq, fids, boi, want, gumbels, 0.8, 11, tk1=3, gseq=gseq,
               alpha=kw.get("guidance_alpha", 1.0))


def test_video_tokens_slide_their_window(ar):
    """Four frames through a window of 3: one fill of 3 frames, then one more with two frames given."""
    params, tparams, cfg = ar
    text = text_tokens(1, seed=23)
    key = jax.random.PRNGKey(24)
    want = np.asarray(JVID.generate_video_tokens(params, text, TINY, 4, key, window=3, top_k=9))
    L, tl = TINY.image_length, TINY.text_length
    gumbels, windows, k = [], [], key
    for w in range(2):
        k, sub = jax.random.split(k)
        ctx = tl if w == 0 else tl + 2 * L
        g = gumbel_schedule(sub, tl + 3 * L - ctx, (1, TINY.vocab_size))[1]
        gumbels += g
        windows.append(g)
    got = TVID.generate_video_tokens(tparams, text, cfg, 4, window=3, top_k=9, draw=draws_of(gumbels)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (4, 1, L)
    # the second window: frames 1 and 2 given, frame 3 sampled
    seq, fids, boi = JVID.build_video_sequence(TINY, text, 3, given_frames=want[1:3].transpose(1, 0, 2))
    filled = seq.copy()
    filled[:, tl + 2 * L:] = want[3] + TINY.text_vocab_size
    check_fill(params, tparams, cfg, seq, fids, boi, filled, windows[1], 1.0, 9)


def test_interpolate_frames_equal_given_the_draws(ar):
    """Five keyframes -> nine frames: two windows at slots [0, 2, 4, 1, 3], merged in temporal order."""
    params, tparams, cfg = ar
    text = text_tokens(2, seed=25)
    keys = np.random.RandomState(26).randint(0, TINY.vocab_size, (5, 2, TINY.image_length))
    key = jax.random.PRNGKey(27)
    want = np.asarray(JVID.interpolate_frames(params, keys, text, TINY, key, top_k=7))
    L, tl = TINY.image_length, TINY.text_length
    gumbels, k = [], key
    for _ in range(2):
        k, sub = jax.random.split(k)
        gumbels.append(gumbel_schedule(sub, 2 * L, (2, TINY.vocab_size))[1])
    got = TVID.interpolate_frames(tparams, keys, text, cfg, top_k=7, draw=draws_of(gumbels[0] + gumbels[1])).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (9, 2, L)
    np.testing.assert_array_equal(got[::2], keys)
    order = np.array([0, 2, 4, 1, 3])
    for w in range(2):
        given = keys[2 * w: 2 * w + 3].transpose(1, 0, 2)
        seq, fids, boi = JVID.build_video_sequence(TINY, text, 5, given_frames=given, frame_order=order)
        filled = seq.copy()
        filled[:, tl + 3 * L: tl + 4 * L] = want[4 * w + 1] + TINY.text_vocab_size
        filled[:, tl + 4 * L:] = want[4 * w + 3] + TINY.text_vocab_size
        check_fill(params, tparams, cfg, seq, fids, boi, filled, gumbels[w], 1.0, 7)


def test_generate_video_frames(ar, vq):
    """Both stages and the decode: the port's uint8 frames against maua_tpu's on the same draws."""
    params, tparams, cfg = ar
    vparams, tvparams, vcfg = vq
    text = text_tokens(1, seed=28)
    key = jax.random.PRNGKey(29)
    want = np.asarray(JVID.generate_video(params, text, TINY, vparams, TINY_VQ, n_keyframes=3, key=key, top_k=9))
    L, tl = TINY.image_length, TINY.text_length
    k, k1 = jax.random.split(key)
    _, sub = jax.random.split(k1)
    gumbels = gumbel_schedule(sub, 3 * L, (1, TINY.vocab_size))[1]
    k, k2 = jax.random.split(k)
    _, sub = jax.random.split(k2)
    gumbels += gumbel_schedule(sub, 2 * L, (1, TINY.vocab_size))[1]
    got = TVID.generate_video(tparams, text, cfg, tvparams, vcfg, n_keyframes=3, top_k=9, draw=draws_of(gumbels))
    assert got.shape == want.shape == (5, 1, 8, 8, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    from maua_tpu_torch.autoregressive import transformer as TT
    from maua_tpu_torch.parallel.mesh import make_mesh

    sharded = TVID.sharded_generate(tparams, text, cfg, make_mesh(devices=["cpu"]), top_k=9, draw=draws_of(gumbels))
    np.testing.assert_array_equal(sharded.numpy(), TT.generate_tokens(tparams, text, cfg, top_k=9,
                                                                        draw=draws_of(gumbels)).numpy())


def test_video_command(tmp_path):
    """The CLI's configuration end to end on the CPU, with the guider: five PNG frames and an mp4."""
    out = tmp_path / "v"
    cli_main.main(["autoregressive", "video", "--text", "a bird in flight", "--guidance_alpha", "1.5",
                   "--out_dir", str(out), "--device", "cpu"])
    frames = sorted(f for f in os.listdir(out) if f.startswith("frame_"))
    assert frames == [f"frame_{i:04d}.png" for i in range(5)]
    assert os.path.getsize(out / "video.mp4") > 0
