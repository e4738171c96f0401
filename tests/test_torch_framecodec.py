"""The port's DCT frame codec (maua_tpu_torch/ops/framecodec.py) and its dct delivery route against maua_tpu's.

Plans (`calibrate`, `calibrate_chunk`, `calibrate_chunk_device`) must equal maua_tpu's field by field; packed
words byte for byte on the same symbols. Streams must equal maua_tpu's jitted encode byte for byte, except where
a quantized coefficient differs because maua_tpu's XLA einsum and the port's ordered f32 sum round a value to
different sides of a quantization tie (|x/q - (k + 1/2)| < 1e-5 in maua_tpu's f32 coefficient): each such
difference is located and shown to be a tie, and the port's coefficient-domain encoder run on maua_tpu's own
coefficients must give maua_tpu's stream exactly. Both decoders (numpy and the C++ ones) must give maua_tpu's
bytes on maua_tpu's streams. Sizes are maua_tpu's test sizes: 64^2 and 128^2, T 4 to 8.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.ops import framecodec as JF
from maua_tpu.ops import video as JV
from maua_tpu_torch.ops import framecodec as TF
from maua_tpu_torch.ops import video as TV
from test_framecodec import _blend_frames, _heavy_tail_frames, _smooth_morph_frames, _test_frames

TIE = 1e-5  # a coefficient this close to a quantization midpoint may round either way in f32


def psnr(a, b, peak=255.0):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 10 * np.log10(peak * peak / max(mse, 1e-12))


def i420(frames):
    return TV.rgb_to_yuv420(torch.from_numpy(frames)).numpy()


@pytest.fixture(scope="module")
def morph():
    return _smooth_morph_frames(T=8, noise=2.0)


@pytest.fixture(scope="module")
def heavy():
    return _heavy_tail_frames()


@pytest.fixture(scope="module")
def jax_coefs():
    """maua_tpu's quantized chunk coefficients as its jitted encode_chunk computes them, per codec."""

    @jax.jit
    def planes(rgb):
        return JF._yuv_planes_device(rgb)

    def coefs(frames, codec):
        ci = codec.intra
        out = []
        for pl, lev, q in zip(planes(jnp.asarray(frames)), (ci.levels_y, ci.levels_c, ci.levels_c),
                              (ci.qstep_y, ci.qstep_c, ci.qstep_c)):
            x = np.asarray(jax.jit(JF._block_dct_device)(pl))
            mi = jnp.asarray((np.asarray(lev, np.int64) - 1) // 2, jnp.float32)
            c = np.asarray(jax.jit(lambda a: jnp.clip(jnp.round(a / q), -mi, mi).astype(jnp.int32))(x))
            out.append((x, q, c))
        return out

    return coefs


def jax_chunk(frames, codec):
    intra, deltas = jax.jit(lambda x: JF.encode_chunk(x, codec))(jnp.asarray(frames))
    return np.asarray(intra), np.asarray(deltas)


def tie_differences(port_coefs, jax_planes) -> int:
    """The number of quantized coefficients where the port differs from maua_tpu; each must sit at a tie of
    maua_tpu's own f32 coefficient, and differ by one step."""
    n = 0
    for got, (x, q, want) in zip(port_coefs, jax_planes):
        got = got.numpy()
        diff = got != want
        if diff.any():
            r = x[diff].astype(np.float64) / q
            assert np.all(np.abs(r - (np.floor(r) + 0.5)) < TIE), r
            assert np.all(np.abs(got[diff] - want[diff]) == 1)
        n += int(diff.sum())
    return n


def test_tables_are_maua_tpus():
    assert np.array_equal(TF._DCT, JF._DCT) and np.array_equal(TF._ZIGZAG, JF._ZIGZAG)
    for levels in (JF.default_config(32, 32).levels_y, (1, 7, 300, 2**20, 5) + (3,) * 59):
        for strip in (1, 2, 4):
            assert TF._plan_words(levels, strip) == JF._plan_words(levels, strip)


@pytest.mark.parametrize("chroma_step", [1, 2])
@pytest.mark.parametrize("order2", ["force", False])
def test_host_plans_equal_maua_tpus(morph, chroma_step, order2):
    assert dataclasses.asdict(TF.calibrate(morph[:2])) == dataclasses.asdict(JF.calibrate(morph[:2]))
    assert dataclasses.asdict(TF.default_config(64, 128, 1.3)) == dataclasses.asdict(JF.default_config(64, 128, 1.3))
    for escape in ("force", False):
        kw = dict(escape=escape, order2=order2, chroma_step=chroma_step)
        want = JF.calibrate_chunk(morph[:6], **kw)
        got = TF.calibrate_chunk(morph[:6], **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), kw


@pytest.mark.parametrize("chroma_step", [1, 2])
@pytest.mark.parametrize("order2", ["force", False])
def test_device_plans_equal_maua_tpus(morph, chroma_step, order2):
    kw = dict(quality=1.1, escape="force", order2=order2, chroma_step=chroma_step)
    want = JF.calibrate_chunk_device(jnp.asarray(morph), **kw)
    got = TF.calibrate_chunk_device(torch.from_numpy(morph), **kw)
    assert got.chroma_step == chroma_step and got.esc_cap_y > 0
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_pack_device_is_byte_exact(morph):
    rs = np.random.RandomState(1)
    plans = [JF.default_config(32, 32), JF.calibrate_chunk(morph[:6], escape="force").delta]
    for cfg in plans:
        for lev, grp, strip, nb in ((cfg.levels_y, cfg.groups_y, cfg.strip_y, cfg.n_blocks_y),
                                    (cfg.levels_c, cfg.groups_c, cfg.strip_c, cfg.n_blocks_c)):
            L = np.asarray(lev, np.int64)
            q = (rs.randint(0, 1 << 30, size=(3, nb, 64)) % L[None, None, :]).astype(np.int32)
            q[0] = L - 1  # every slot at its largest value: the words near 2^32
            want = np.asarray(JF._pack_device(jnp.asarray(q), lev, grp, strip))
            got = TF._pack_device(torch.from_numpy(q), lev, grp, strip).numpy()
            assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_encode_frames_matches_and_round_trips():
    frames = _test_frames()
    for cfg in (JF.default_config(64, 64), JF.calibrate(frames)):
        want = np.asarray(jax.jit(lambda x: JF.encode_frames(x, cfg))(jnp.asarray(frames)))
        got = TF.encode_frames(torch.from_numpy(frames), cfg).numpy()
        assert got.shape == (2, cfg.frame_bytes)
        if not np.array_equal(got, want):  # only through a coefficient at a tie
            sym = [TF._host_unpack_sym(p[:, :cfg.plane_bytes_y], cfg.n_blocks_y, cfg.levels_y, cfg.groups_y,
                                       cfg.strip_y) for p in (got, want)]
            assert (sym[0] != sym[1]).sum() <= 2
        dec = TF.decode_frames(got, cfg)
        assert np.array_equal(dec, TF.decode_frames(got, cfg, decoder="numpy")) or \
            np.abs(dec.astype(int) - TF.decode_frames(got, cfg, decoder="numpy")).max() <= 1
        assert psnr(dec, i420(frames)) >= 40.0
        rgb = TF.decode_frames(got, cfg, out="rgb")
        assert rgb.shape == frames.shape and psnr(rgb, frames) > 28.0


@pytest.fixture(scope="module")
def chunk_cases(morph, heavy):
    """(name, frames, codec, maua_tpu's stream): escapes with order 2, chroma halving, clipped coding, an escape
    overflow; each encoded once by maua_tpu's jitted encode_chunk."""
    esc = JF.calibrate_chunk(heavy[:4], escape="force")
    cases = [("order2", morph, JF.calibrate_chunk(morph[:6], escape="force", order2="force", chroma_step=1)),
             ("chroma2", morph, JF.calibrate_chunk(morph[:6], escape="force", chroma_step=2)),
             ("clipped", morph, JF.calibrate_chunk(morph[:4], escape=False, order2=False)),
             ("escapes", heavy, esc), ("overflow", heavy, dataclasses.replace(esc, esc_cap_y=8))]
    return [(name, frames, codec, jax_chunk(frames, codec)) for name, frames, codec in cases]


def test_encode_chunk_streams_equal_maua_tpus(chunk_cases, jax_coefs):
    ties = {}
    for name, frames, codec, want in chunk_cases:
        jc = jax_coefs(frames, codec)
        # the port's coefficient-domain encoder on maua_tpu's coefficients gives maua_tpu's stream exactly
        on_jax = TF.encode_chunk_coefficients(tuple(torch.from_numpy(c.copy()) for _, _, c in jc), codec, len(frames))
        assert all(np.array_equal(g.numpy(), w) for g, w in zip(on_jax, want)), name
        # the port's own coefficients differ only at ties, and where they agree so do the streams
        coefs = TF.chunk_coefficients(torch.from_numpy(frames), codec)
        ties[name] = tie_differences(coefs, jc)
        got = TF.encode_chunk(torch.from_numpy(frames), codec)
        assert got[1].shape == (codec.delta_bytes(len(frames)),)
        if ties[name] == 0:
            assert all(np.array_equal(g.numpy(), w) for g, w in zip(got, want)), name
    print("quantized coefficients at a tie, port vs maua_tpu:", ties)


def test_decoders_give_maua_tpus_bytes(chunk_cases, monkeypatch):
    from maua_tpu import native as JN

    monkeypatch.setattr(JF, "_NATIVE_CHUNK_FN", None)
    monkeypatch.setattr(JF, "_NATIVE_CHUNK_CHECKED", True)
    monkeypatch.setattr(JF, "_NATIVE_FN", None)
    monkeypatch.setattr(JF, "_NATIVE_CHECKED", True)
    for name, frames, codec, (intra, deltas) in chunk_cases:
        T = len(frames)
        got = TF.decode_chunk(intra, deltas, codec, decoder="numpy")
        assert np.array_equal(got, JF.decode_chunk(intra, deltas, codec)), name
        native = TF.decode_chunk(intra, deltas, codec)
        assert np.array_equal(native, JN.framecodec_decode_chunk_u8(intra, deltas, codec, T)), name
        diff = np.abs(native.astype(np.int32) - got.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01, name
        floor = 30.0 if name == "overflow" else 40.0
        assert min(psnr(native[t], r) for t, r in enumerate(i420(frames))) >= floor, name
    frames = _test_frames()
    cfg = JF.calibrate(frames)
    packed = np.asarray(JF.encode_frames(jnp.asarray(frames), cfg))
    assert np.array_equal(TF.decode_frames(packed, cfg, decoder="numpy"), JF.decode_frames(packed, cfg))
    for p, q in zip(TF._decode_planes(packed, cfg), JN.framecodec_decode_planes(packed, cfg)):
        assert np.array_equal(p, q)


def test_simd_and_scalar_chunk_decoders_agree(morph):
    from maua_tpu_torch import native

    frames = np.concatenate([morph, morph[::-1]])[:5]
    codec = TF.calibrate_chunk(frames[:3], chroma_step=2, escape="force", order2="force")
    intra, deltas = (t.numpy() for t in TF.encode_chunk(torch.from_numpy(frames), codec))
    fast = native.framecodec_decode_chunk_u8(intra, deltas, codec, 5)
    scalar = native.framecodec_decode_chunk_u8(intra, deltas, codec, 5, simd=False)
    diff = np.abs(fast.astype(np.int32) - scalar.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def test_escape_overflow_degrades_and_corrects_itself_with_order2():
    """A squeezed escape capacity degrades to clipping; the closed loop keeps the last frame's error near the
    early frames' (maua_tpu's test_escape_overflow_selfcorrects_with_order2), and the stream is maua_tpu's."""
    frames = _smooth_morph_frames(T=8, noise=1.0).copy()
    rs = np.random.RandomState(7)
    for t in range(2, 8):
        pts = rs.randint(0, 128, size=(40, 2))
        frames[t, pts[:, 0], pts[:, 1]] = rs.randint(0, 256, size=(40, 3))
    codec = TF.calibrate_chunk(frames[:5], escape="force", order2="force")
    assert codec.order2_y and any(codec.order2_y) and codec.esc_cap_y > 8
    tiny = dataclasses.replace(codec, esc_cap_y=max(1, codec.esc_cap_y // 8),
                               esc_cap_c=max(1, codec.esc_cap_c // 8) if codec.esc_cap_c else 0)
    intra, deltas = (t.numpy() for t in TF.encode_chunk(torch.from_numpy(frames), tiny))
    assert deltas.shape == (tiny.delta_bytes(8),)
    want = jax_chunk(frames, tiny)
    assert np.array_equal(intra, want[0]) and np.array_equal(deltas, want[1])
    dec = TF.decode_chunk(intra, deltas, tiny, decoder="numpy")
    ref = i420(frames)
    assert psnr(dec, ref) > 30.0
    mse = ((dec.astype(np.float64) - ref) ** 2).reshape(8, -1).mean(axis=1)
    assert mse[-1] <= 5.0 * np.median(mse[1:4]) + 1.0, mse.tolist()
    assert np.abs(TF.decode_chunk(intra, deltas, tiny).astype(int) - dec).max() <= 1


def test_device_calibration_clamps_escape_counts_at_four_frames_with_chroma_halving():
    """C4: at T == 4 with chroma_step 2, maua_tpu's histogram counts three chroma deltas where its plan codes
    one, so its escape counts n - cumsum(h) and its chroma escape capacity go negative
    (maua_tpu/ops/framecodec.py:641, :719-722; here -2393, a plan no encoder can fill). The port clamps them at
    0: a valid plan whose round trip holds >= 40 dB. The content is a linear crossfade, on which "auto" picks
    the halving. maua_tpu's plan is read as the witness; its encode is not run for this case."""
    frames = _blend_frames(T=4)
    assert JF.calibrate_chunk_device(jnp.asarray(frames), escape="force").esc_cap_c < 0
    codec = TF.calibrate_chunk_device(torch.from_numpy(frames), escape="force")
    assert codec.chroma_step == 2 and codec.chroma_keyframes(4) == [0, 2, 3]
    assert any(lv % 2 == 0 and lv > 1 for lv in codec.delta.levels_c) and codec.esc_cap_c >= 64
    assert codec.esc_cap_y >= 0
    intra, deltas = (t.numpy() for t in TF.encode_chunk(torch.from_numpy(frames), codec))
    assert deltas.shape == (codec.delta_bytes(4),)
    dec = TF.decode_chunk(intra, deltas, codec)
    assert np.abs(dec.astype(int) - TF.decode_chunk(intra, deltas, codec, decoder="numpy")).max() <= 1
    assert min(psnr(dec[t], r) for t, r in enumerate(i420(frames))) >= 40.0


def test_single_frame_chunks_encode_where_maua_tpu_raises():
    """A batch of one frame (batch_size 1, or a render halved to 1 by the out-of-memory retry) is a chunk with
    no deltas: maua_tpu's encode_chunk raises (ZeroDivisionError in reshaping its empty delta words); the
    port's ships the intra frame and an empty delta stream, and the route delivers it."""
    frames = _test_frames(B=3)
    codec = TF.calibrate_chunk(frames[:1])
    with pytest.raises(ZeroDivisionError):
        JF.encode_chunk(jnp.asarray(frames[:1]), JF.calibrate_chunk(frames[:1]))
    intra, deltas = TF.encode_chunk(torch.from_numpy(frames[:1]), codec)
    assert deltas.numel() == 0 and intra.numel() == codec.intra.frame_bytes
    assert psnr(TF.decode_chunk(intra.numpy(), deltas.numpy(), codec)[0], i420(frames[:1])[0]) >= 40.0
    out = list(TV.pipelined_frames(((torch.from_numpy(f[None]), 1) for f in frames), "dct"))
    assert len(out) == 3 and min(psnr(o, r) for o, r in zip(out, i420(frames))) >= 40.0


def test_unaligned_sizes_are_refused_and_dct_delivery_goes_yuv420p():
    with pytest.raises(ValueError, match="16-aligned"):
        TF.default_config(60, 64)
    frames = _test_frames(B=2, H=24, W=24)  # even, not 16-aligned
    with pytest.raises(ValueError, match="16-aligned"):
        TF.calibrate_chunk_device(torch.from_numpy(frames))
    out = list(TV.pipelined_frames(iter([(torch.from_numpy(frames), 2)]), "dct"))
    assert len(out) == 2 and all(np.array_equal(o, r) for o, r in zip(out, i420(frames)))


def test_dct_pipelined_frames_match_maua_tpus_route():
    """Where the first batch's plan holds every chunk (as here), the route's frames are maua_tpu's."""
    frames = _smooth_morph_frames(T=8)

    def batches(asarray):
        yield asarray(frames[:4]), 4
        yield asarray(np.concatenate([frames[4:7], frames[6:7]])), 3  # a padded tail

    got = list(TV.pipelined_frames(batches(torch.from_numpy), "dct"))
    want = list(JV.pipelined_frames(batches(jnp.asarray), "dct"))
    assert len(got) == 7 and all(np.array_equal(g, w) for g, w in zip(got, want))
    assert min(psnr(g, r) for g, r in zip(got, i420(frames))) >= 40.0


def test_dct_route_encodes_again_a_chunk_its_plan_does_not_hold(monkeypatch):
    """A smooth first batch, then sparse large jumps the first plan never saw: maua_tpu's route keeps the first
    plan and clips (its frames fall below 30 dB); the port's sees the chunk's clip error, calibrates a plan on
    that chunk, encodes it again and keeps the new plan: every frame >= 40 dB, the first chunk maua_tpu's."""
    smooth = _smooth_morph_frames(T=8, noise=1.0)
    jumps = _heavy_tail_frames(T=8, p_jump=0.02, seed=3)
    ref = i420(np.concatenate([smooth, jumps]))
    plans = []
    calibrate = TF.calibrate_chunk_device
    monkeypatch.setattr(TF, "calibrate_chunk_device", lambda *a, **k: plans.append(calibrate(*a, **k)) or plans[-1])

    def batches(asarray):
        yield asarray(smooth), 8
        yield asarray(jumps), 8
        yield asarray(jumps[::-1].copy()), 8  # the second plan holds this one

    got = list(TV.pipelined_frames(batches(torch.from_numpy), "dct"))
    want = list(JV.pipelined_frames(batches(jnp.asarray), "dct"))
    assert len(plans) == 2 and len(got) == 24
    assert min(psnr(g, r) for g, r in zip(got, np.concatenate([ref, ref[8:][::-1]]))) >= 40.0
    assert all(np.array_equal(g, w) for g, w in zip(got[:8], want[:8]))
    assert min(psnr(w, r) for w, r in zip(want[8:16], ref[8:])) < 30.0
    stale = TF.encode_chunk(torch.from_numpy(jumps), plans[0], clip_error=True)[2]
    assert float(stale) > TV.CLIP_MSE_SHARE * plans[0].delta.qstep_y ** 2 / 12
    assert float(TF.encode_chunk(torch.from_numpy(jumps), plans[1], clip_error=True)[2]) == 0.0


def test_fetch_helpers_on_the_host():
    x = torch.arange(4 * 1024 * 512, dtype=torch.int32).reshape(16, -1)
    parts = TV.presplit(x, n_streams=4)
    assert len(parts) == 4 and sum(p.shape[0] for p in parts) == 16
    assert np.array_equal(TV.fetch_parallel(x, n_streams=4), x.numpy())
    assert len(TV.presplit(torch.ones(3, 4))) == 1  # small tensors stay whole
    assert np.array_equal(TV.fetch_slices(TV.presplit(torch.ones(3, 4))), np.ones((3, 4)))


@pytest.mark.parametrize("output_size", [None, (40, 24), (30, 21)], ids=["aligned", "even", "odd"])
def test_ffmpeg_renderer_delivers_dct(monkeypatch, tmp_path, output_size):
    """The FFMPEG renderer with pix_fmt="dct" over a 32^2 StyleGAN2 on the CPU, 10 frames in batches of 4 (a
    padded tail), written through OpenCV (no ffmpeg binary): dct at 32^2, yuv420p at 40 x 24 (even, not
    16-aligned), rgb24 at 30 x 21 (odd), each read back with every frame."""
    import shutil

    from maua_tpu_torch.audiovisual.render import FFMPEG
    from maua_tpu_torch.gan import stylegan2 as T2
    from maua_tpu_torch.gan import wrappers as TW
    from test_torch_video import read_back

    monkeypatch.setattr(shutil, "which", lambda name, *a, **k: None)
    cfg = T2.SG2Config(img_resolution=32, channel_base=256, channel_max=32, z_dim=32, w_dim=32, mapping_layers=2)
    model = TW.StyleGAN2(cfg=cfg, params=T2.init_params(cfg, torch.Generator().manual_seed(0)), device="cpu",
                         output_size=output_size)
    latents = model.get_w_latents("0-10")
    routes = []
    real = TV.pipelined_frames
    monkeypatch.setattr(TV, "pipelined_frames", lambda b, fmt="rgb24", **k: routes.append(fmt) or real(b, fmt, **k))
    path = tmp_path / "out.mp4"
    assert FFMPEG(str(path), fps=24, batch_size=4, pix_fmt="dct")(model.render, {"latent_w_plus": latents}) == str(path)
    w, h = output_size or (32, 32)
    assert read_back(path) == (10, (w + w % 2, h + h % 2))
    assert routes == {None: ["dct"], (40, 24): ["dct", "yuv420p"], (30, 21): ["dct", "yuv420p", "rgb24"]}[output_size]
