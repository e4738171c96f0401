"""DCT frame codec for the device-to-host frame delivery: encode on the frames' device, decode on the host.

Port of `maua_tpu/ops/framecodec.py`. `ops/video.rgb_to_yuv420` halves the
bytes of rgb24; this codec ships quantized DCT coefficients instead of
samples, at >= 40 dB against the uncompressed I420 frame:

- encode (torch, on the tensor's device): RGB -> planar YUV 4:2:0 -> 8x8
  orthonormal DCT -> per-position uniform quantization -> mixed-radix
  packing into uint32 words, as little-endian bytes. Only the packed
  stream is copied to the host.
- video chunks are DPCM in the quantized-coefficient domain
  (`encode_chunk`): frame 0 ships intra, each later frame the integer
  delta against the decoder's exact reconstruction, so the decoder's
  running sum has exactly one quantization error and no drift. The
  clip and escape decision runs closed-loop, frame by frame on the
  device, so a clipped or dropped delta feeds back into the next frame's.
- decode (host): the C++ chunk decoder of `maua_tpu_torch/native.py`
  (scalar, or AVX-512 where the build has it), which writes the I420
  bytes ffmpeg reads as `-pix_fmt yuv420p` rawvideo. A failure raises.
  The numpy decoder is the plain version, chosen with `decoder="numpy"`.

Rate control is calibrated, not entropy coded: every zigzag position gets
a static level count from the measured coefficient spread (`calibrate`,
`calibrate_chunk` on the host, `calibrate_chunk_device` with its
statistics computed on the device), so the stream's size is fixed by the
plan. Delta positions may be escape coded (an even level count: a base
alphabet plus one escape symbol, the exact int16 value in a side stream of
calibrated capacity) and may ship second differences (order 2) where they
are cheaper. The plans, the stream layout and the host decoders are
maua_tpu's.

The device arithmetic is plain f32 in a fixed order and never goes through
a matmul, so TF32 or a GEMM's summation order cannot move a coefficient
across a quantization boundary: the card's stream equals the CPU's. Each
8x8 DCT pass is the weighted sum over the 8 taps in order (maua_tpu's two
einsums, rows first), and a coefficient is quantized by multiplying with
the f32 reciprocal of the step, which is how XLA compiles maua_tpu's
division by a constant. Against maua_tpu the quantized coefficients can
therefore differ only where XLA's einsum and this sum round a value to
different sides of a quantization tie.

`encode_chunk(..., clip_error=True)` also returns the largest mean squared
error that clipping added to a plane of a frame; the dct route of
`ops/video.pipelined_frames` encodes a chunk again under a plan that holds it
when that error is large (maua_tpu keeps the first batch's plan and clips).

`calibrate_chunk_device` clamps the escape counts and capacities at 0: with
temporal chroma halving and fewer than 5 frames, maua_tpu's histogram
counts more deltas than its plan codes, and its counts and capacity go
negative (`maua_tpu/ops/framecodec.py:641`, :719-722).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "CodecConfig", "ChunkCodec", "default_config", "calibrate", "calibrate_chunk", "calibrate_chunk_device",
    "encode_frames", "decode_frames", "encode_chunk", "decode_chunk", "yuv420_to_rgb",
]

def _host_array(frames) -> np.ndarray:
    """Frames as a host numpy array (a tensor is copied from its device)."""
    if isinstance(frames, torch.Tensor):
        return frames.detach().cpu().numpy()
    return np.asarray(frames)


def _dct_matrix() -> np.ndarray:
    """Orthonormal 8x8 DCT-II matrix (D @ x @ D.T transforms a block)."""
    k = np.arange(8)
    D = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16.0)
    D[0] *= 1.0 / np.sqrt(2.0)
    return (D * 0.5).astype(np.float32)


_DCT = _dct_matrix()


def _zigzag_order() -> np.ndarray:
    """Indices that reorder a row-major 8x8 block into zigzag scan."""
    idx = sorted(range(64), key=lambda n: (
        (n // 8) + (n % 8),
        (n // 8) if ((n // 8) + (n % 8)) % 2 else (n % 8),
    ))
    return np.asarray(idx, np.int32)


_ZIGZAG = _zigzag_order()


def _levels_from_sigma(sigma: np.ndarray, qstep: float, clip_sigmas: float) -> np.ndarray:
    """Odd level count per position: covers +-clip_sigmas*sigma at step
    qstep. Spread below half a step -> 1 level (position dropped)."""
    m = np.ceil(np.maximum(clip_sigmas * np.asarray(sigma, np.float64) - qstep / 2.0, 0.0) / qstep)
    return (2 * m.astype(np.int64) + 1).astype(np.int64)


def _strip_of(n_blocks: int) -> int:
    """Blocks jointly packed per word group: the largest of 4/2/1 that
    divides the plane's block count (16-aligned planes give 4)."""
    for s in (4, 2, 1):
        if n_blocks % s == 0:
            return s
    return 1


def _plan_words(levels: np.ndarray, strip: int,
                word_bits: int = 32) -> Tuple[Tuple[Tuple[int, int, int], ...], ...]:
    """Lay out the mixed-radix words for one strip of `strip` blocks.

    Returns a tuple of words; each word is a tuple of slots
    (idx, radix, prediv) with idx in [0, strip*64) indexing
    (block_in_strip * 64 + position). A position whose level count L
    does not fit the current word's remaining capacity is SPLIT: this
    word stores the digit (v // prediv) % radix and the next word(s)
    carry the rest (v < L <= product of its slot radices, so the
    decoder's sum of digit*prediv reconstructs v exactly). Packing is
    sequential with splits, so waste is < 1 bit per word; 1-level
    positions are omitted entirely (zero bits)."""
    cap = 1 << word_bits
    words: list = []
    cur: list = []
    prod = 1
    for b in range(strip):
        for i, l in enumerate(np.asarray(levels, np.int64)):
            rem = int(l)
            if rem <= 1:
                continue
            idx = b * 64 + i
            prediv = 1
            while rem > 1:
                rmax = cap // prod
                if rmax < 2:
                    words.append(tuple(cur))
                    cur, prod, rmax = [], 1, cap
                r = min(rem, rmax)
                cur.append((idx, r, prediv))
                prod *= r
                prediv *= r
                rem = -(-rem // r)  # ceil(rem / r)
    if cur:
        words.append(tuple(cur))
    return tuple(words)


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Static rate/quality plan for one plane geometry.

    levels: odd level count per zigzag position (1 = dropped). qstep:
    uniform quantization step (pixel units). groups: strip-level
    mixed-radix word layout from `_plan_words` (tuple of words; each
    word a tuple of (idx, radix, prediv) slots over strip*64
    positions). height/width: plane size."""

    height: int
    width: int
    qstep_y: float
    qstep_c: float
    levels_y: Tuple[int, ...]
    levels_c: Tuple[int, ...]
    groups_y: Tuple[Tuple[Tuple[int, int, int], ...], ...]
    groups_c: Tuple[Tuple[Tuple[int, int, int], ...], ...]

    @property
    def n_blocks_y(self) -> int:
        return (self.height // 8) * (self.width // 8)

    @property
    def n_blocks_c(self) -> int:
        return (self.height // 16) * (self.width // 16)

    @property
    def strip_y(self) -> int:
        return _strip_of(self.n_blocks_y)

    @property
    def strip_c(self) -> int:
        return _strip_of(self.n_blocks_c)

    @property
    def words_y(self) -> int:
        """uint32 words per luma STRIP (strip_y blocks)."""
        return len(self.groups_y)

    @property
    def words_c(self) -> int:
        """uint32 words per chroma STRIP (strip_c blocks)."""
        return len(self.groups_c)

    @property
    def plane_bytes_y(self) -> int:
        return 4 * (self.n_blocks_y // self.strip_y) * self.words_y

    @property
    def plane_bytes_c(self) -> int:
        return 4 * (self.n_blocks_c // self.strip_c) * self.words_c

    @property
    def frame_bytes(self) -> int:
        return self.plane_bytes_y + 2 * self.plane_bytes_c

    @property
    def bits_per_pixel(self) -> float:
        return 8.0 * self.frame_bytes / (self.height * self.width)


def _make_config(H: int, W: int, sig_y, sig_c, qstep: float, clip_sigmas: float) -> CodecConfig:
    ly = _levels_from_sigma(sig_y, qstep, clip_sigmas)
    lc = _levels_from_sigma(sig_c, qstep, clip_sigmas)
    # DC always keeps full range (a clipped DC is a visible block, a
    # clipped AC is a soft ripple): block DC spans +-1024 in [-128,127]
    ly[0] = max(ly[0], _levels_from_sigma(np.asarray([1024.0 / clip_sigmas]), qstep, clip_sigmas)[0])
    nb_y = (H // 8) * (W // 8)
    nb_c = (H // 16) * (W // 16)
    return CodecConfig(
        height=H, width=W, qstep_y=float(qstep), qstep_c=float(qstep),
        levels_y=tuple(int(x) for x in ly), levels_c=tuple(int(x) for x in lc),
        groups_y=_plan_words(ly, _strip_of(nb_y)), groups_c=_plan_words(lc, _strip_of(nb_c)),
    )


def _default_sigma() -> np.ndarray:
    """Conservative per-position coefficient spread (row-major (u,v)
    indexing, pixel units, [-128,127] samples): low frequencies carry
    most energy; the tail floor of 16 absorbs per-pixel noise (StyleGAN
    noise injection has a flat spectrum). `calibrate` replaces this
    with measured values."""
    pos = np.arange(64)
    d = pos // 8 + pos % 8  # diagonal number 0..14
    sigma = 180.0 * (0.55 ** d.astype(np.float64)) + 16.0
    sigma[0] = 360.0
    return sigma.astype(np.float32)


def default_config(height: int, width: int, quality: float = 1.0) -> CodecConfig:
    """Uncalibrated plan from the conservative spread model. quality
    scales the quantization step: 1.0 = step 7 in pixel units (MSE 49/12
    -> ~41 dB); smaller = finer."""
    if height % 16 or width % 16:
        raise ValueError(f"frame codec needs 16-aligned dimensions, got {height}x{width}")
    sig = _default_sigma()
    return _make_config(height, width, sig, sig * 0.6, 7.0 * quality, 4.0)


def _measured_sigma(planes: Sequence[np.ndarray], clip_sigmas: float) -> np.ndarray:
    """Robust per-position spread over sample planes: max|.|/clip
    blended with std so one outlier block doesn't inflate the budget."""
    cos = [np.asarray(_host_block_dct(p)).reshape(-1, 64) for p in planes]
    flat = np.concatenate(cos, axis=0)
    return np.maximum(np.abs(flat).max(axis=0) / clip_sigmas, flat.std(axis=0)).astype(np.float32)


def calibrate(frames, quality: float = 1.0, clip_sigmas: float = 4.5) -> CodecConfig:
    """Build a CodecConfig from sample frames ((B,H,W,3) uint8 RGB,
    host or device). Measures the per-position coefficient spread of
    the actual content so high-frequency positions get exactly the
    levels they need."""
    rgb = _host_array(frames)
    if rgb.ndim == 3:
        rgb = rgb[None]
    B, H, W, _ = rgb.shape
    if H % 16 or W % 16:
        raise ValueError(f"frame codec needs 16-aligned dimensions, got {H}x{W}")
    y, u, v = _host_yuv_planes(rgb)
    sig_y = _measured_sigma([y], clip_sigmas)
    sig_c = _measured_sigma([u, v], clip_sigmas)
    return _make_config(H, W, sig_y, sig_c, 7.0 * quality, clip_sigmas)




# --------------------------------------------------------------- device encode
def _yuv_planes_device(rgb: torch.Tensor):
    """(B, H, W, 3) uint8 -> centered f32 planes y (B, H, W), u and v (B, H/2, W/2) on rgb's device, in
    ops/video.rgb_to_yuv420's BT.601 limited-range arithmetic (so the decode reproduces its I420 bytes)."""
    x = rgb.to(torch.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    yf = 0.299 * r + 0.587 * g + 0.114 * b
    luma = 16.0 + yf * (219.0 / 255.0)
    cb = 128.0 + (b - yf) * (224.0 / 255.0 * 0.5 / (1.0 - 0.114))
    cr = 128.0 + (r - yf) * (224.0 / 255.0 * 0.5 / (1.0 - 0.299))

    def sub(c):  # the mean of each 2x2 block, summed by rows as XLA sums it
        return ((c[:, 0::2, 0::2] + c[:, 0::2, 1::2]) + (c[:, 1::2, 0::2] + c[:, 1::2, 1::2])) * 0.25

    return luma - 128.0, sub(cb) - 128.0, sub(cr) - 128.0


@functools.lru_cache(maxsize=8)
def _dct_taps(device: torch.device) -> Tuple[torch.Tensor, ...]:
    """The DCT matrix's columns as broadcastable f32 tensors on `device`: taps[i] holds D[:, i]."""
    D = torch.from_numpy(_DCT).to(device)
    return tuple(D[:, i].contiguous() for i in range(8))


def _block_dct_device(plane: torch.Tensor) -> torch.Tensor:
    """(B, H, W) f32 -> (B, n_blocks, 64) row-major block coefficients: D @ block @ D.T, each pass a sum over
    the 8 taps in order (elementwise f32, the same on every device)."""
    B, H, W = plane.shape
    taps = _dct_taps(plane.device)
    x = plane.reshape(B, H // 8, 8, W // 8, 8)
    acc = None  # rows: y[b, h, u, w, j] = sum_i D[u, i] x[b, h, i, w, j]
    for i in range(8):
        t = taps[i].view(1, 1, 8, 1, 1) * x[:, :, i: i + 1]
        acc = t if acc is None else acc + t
    out = None  # columns: z[b, h, u, w, v] = sum_j D[v, j] y[b, h, u, w, j]
    for j in range(8):
        t = taps[j].view(1, 1, 1, 1, 8) * acc[..., j: j + 1]
        out = t if out is None else out + t
    return out.permute(0, 1, 3, 2, 4).reshape(B, -1, 64)


def _scaled(x: torch.Tensor, qstep: float) -> torch.Tensor:
    """x / qstep as XLA compiles a division by a constant: a product with the step's f32 reciprocal (a 0-dim
    tensor on x's device, so that no backend rewrites it again)."""
    recip = np.float32(1.0) / np.float32(qstep)
    return x * torch.tensor(recip, dtype=torch.float32, device=x.device)


def _quantize_device(coefs: torch.Tensor, qstep: float, levels: Tuple[int, ...]):
    """Quantize and clip to the static level grid: (unsigned int32 indices in [0, L-1], dequantized f32)."""
    m = torch.as_tensor((np.asarray(levels, np.int64) - 1) // 2, dtype=torch.float32, device=coefs.device)
    qi = torch.clamp(torch.round(_scaled(coefs, qstep)), -m, m)
    return (qi + m).to(torch.int32), qi * qstep


@functools.lru_cache(maxsize=64)
def _pack_tables(levels: Tuple[int, ...], groups, device: torch.device):
    """A plan's slots as flat tensors on `device`: each slot's strip position, divisor (prediv), radix, its
    stride inside its word and its word."""
    idx, prediv, radix, stride, word = [], [], [], [], []
    for gi, grp in enumerate(groups):
        s = 1
        for i, r, pd in grp:
            idx.append(i)
            prediv.append(pd)
            radix.append(r)
            stride.append(s)
            word.append(gi)
            s *= int(r)

    def t(a):
        return torch.tensor(a, dtype=torch.int64, device=device)

    return t(idx), t(prediv), t(radix), t(stride), t(word)


def _pack_device(q_unsigned: torch.Tensor, levels: Tuple[int, ...], groups, strip: int) -> torch.Tensor:
    """(B, nb, 64) unsigned indices -> (B, strips * words * 4) uint8: strip-level mixed-radix words as
    little-endian bytes. A slot (idx, radix, prediv) stores the digit (v // prediv) % radix at its stride;
    every slot's digit comes from one gather and the words from one index_add, in int64 (every word is below
    2^32, which int32 cannot hold)."""
    B, nb, _ = q_unsigned.shape
    ns = nb // strip
    if not groups:
        return q_unsigned.new_zeros((B, 0), dtype=torch.uint8)
    idx, prediv, radix, stride, word = _pack_tables(tuple(int(v) for v in levels), groups, q_unsigned.device)
    qs = q_unsigned.reshape(B, ns, strip * 64).to(torch.int64)
    digits = torch.div(qs.index_select(2, idx), prediv, rounding_mode="floor").remainder(radix) * stride
    words = torch.zeros((B, ns, len(groups)), dtype=torch.int64, device=qs.device).index_add_(2, word, digits)
    by = torch.stack([(words >> (8 * k)) & 0xFF for k in range(4)], dim=3).to(torch.uint8)
    return by.reshape(B, ns * len(groups) * 4)


def _encode_plane(plane, qstep: float, levels, groups, strip: int):
    qu, recon = _quantize_device(_block_dct_device(plane), qstep, levels)
    return _pack_device(qu, levels, groups, strip), recon


def encode_frames(rgb: torch.Tensor, cfg: CodecConfig) -> torch.Tensor:
    """Intra-frame encode on rgb's device: (B, H, W, 3) uint8 RGB -> (B, frame_bytes) uint8 packed stream."""
    B, H, W, _ = rgb.shape
    if (H, W) != (cfg.height, cfg.width):
        raise ValueError(f"frames are {H}x{W}, the plan {cfg.height}x{cfg.width}")
    y, u, v = _yuv_planes_device(rgb)
    py, _ = _encode_plane(y, cfg.qstep_y, cfg.levels_y, cfg.groups_y, cfg.strip_y)
    pu, _ = _encode_plane(u, cfg.qstep_c, cfg.levels_c, cfg.groups_c, cfg.strip_c)
    pv, _ = _encode_plane(v, cfg.qstep_c, cfg.levels_c, cfg.groups_c, cfg.strip_c)
    return torch.cat([py, pu, pv], dim=1)


# ----------------------------------------------------------- DPCM chunk codec
@dataclasses.dataclass(frozen=True)
class ChunkCodec:
    """Intra plan for the first frame of a chunk + delta plan for the
    rest (coefficient-domain DPCM). Build with `calibrate_chunk`.

    chroma_step=2 ships chroma deltas only at every second frame
    (temporal 2x chroma subsampling — skipped frames reconstruct by
    linear interpolation between keyframes). calibrate_chunk enables it
    only when the measured interpolation error on the sample chunk is
    well inside the quantizer's own error budget.

    esc_cap_y / esc_cap_c: calibrated exception-stream capacity PER
    DELTA FRAME per plane for the escape-coded delta positions (even
    level counts in `delta.levels_*`); 0 disables the escape sections
    entirely (pure clipped coding, the pre-escape stream layout).

    order2_y / order2_c: per-zigzag-position prediction order flags
    (64 ints, 1 = the position ships second differences and the
    decoder integrates it twice; empty tuple = all order-1, the
    pre-order-2 stream semantics)."""

    intra: CodecConfig
    delta: CodecConfig
    chroma_step: int = 1
    esc_cap_y: int = 0
    esc_cap_c: int = 0
    order2_y: Tuple[int, ...] = ()
    order2_c: Tuple[int, ...] = ()

    @property
    def luma_delta_bytes(self) -> int:
        return self.delta.plane_bytes_y

    @property
    def chroma_delta_bytes(self) -> int:
        return self.delta.plane_bytes_c

    def chroma_keyframes(self, n_frames: int):
        ks = list(range(0, n_frames, self.chroma_step))
        if ks[-1] != n_frames - 1:
            ks.append(n_frames - 1)
        return ks

    def esc_section_bytes(self, n_delta_frames: int, plane: str) -> Tuple[int, int]:
        """(counts_bytes, values_bytes) of one plane's escape sections
        for `n_delta_frames` coded delta frames. counts: uint16 per
        (frame, strip); values: int16 * cap * frames + 2 pad bytes (the
        SIMD decoder's masked 32-bit gather may touch 2 bytes past the
        last value)."""
        cap = self.esc_cap_y if plane == "y" else self.esc_cap_c
        if cap == 0 or n_delta_frames == 0:
            return 0, 0
        ns = (self.delta.n_blocks_y // self.delta.strip_y if plane == "y"
              else self.delta.n_blocks_c // self.delta.strip_c)
        return 2 * ns * n_delta_frames, 2 * cap * n_delta_frames + 2

    def delta_bytes(self, n_frames: int) -> int:
        n_ck = len(self.chroma_keyframes(n_frames))
        base = (n_frames - 1) * self.luma_delta_bytes + 2 * (n_ck - 1) * self.chroma_delta_bytes
        cy, vy = self.esc_section_bytes(n_frames - 1, "y")
        cc, vc = self.esc_section_bytes(n_ck - 1, "c")
        return base + cy + vy + 2 * (cc + vc)

    def frames_for_delta_bytes(self, total: int) -> int:
        for t in range(1, 100000):
            if self.delta_bytes(t) == total:
                return t
        raise ValueError(f"no frame count matches {total} delta bytes")

    def chunk_bytes(self, n_frames: int) -> int:
        return self.intra.frame_bytes + self.delta_bytes(n_frames)

    def bits_per_pixel(self, n_frames: int) -> float:
        return 8.0 * self.chunk_bytes(n_frames) / (n_frames * self.intra.height * self.intra.width)


def _levels_from_deltas(a: np.ndarray, live: np.ndarray, margin: float) -> np.ndarray:
    """|deltas| (N, 64) -> odd level counts covering the observed range
    with a multiplicative safety margin (a clipped out-of-range delta
    distorts the rest of its chunk — no closed-loop correction until
    the next intra frame; the delivered PSNR gates in bench.py/tests
    bound the damage)."""
    # 99.9th-percentile range, not max: one busy block must not set
    # every block's bit budget (max-based allocation measured ~2 bits/
    # coef fatter on real content). The ~1e-3 of deltas beyond the
    # range clip to it — a localized, chunk-bounded block artifact the
    # PSNR gate absorbs. Measured on the 1024^2 SG2 latent-interp
    # bench content: quantile 0.999 + margin 1.3 delivers 40.85 dB at
    # 8.87 bpp vs 40.91 dB at 9.59 bpp for 0.9999 + 1.5 — the fat
    # tail coverage bought 0.06 dB for 8% of the stream. A tail
    # quantile estimated from a small calibration set is pure noise
    # (it IS the sample max, which still underestimates the population
    # tail), so small samples fall back to max coverage with the old
    # conservative margin.
    if a.shape[0] >= 10_000:
        dq = np.quantile(a, 0.999, axis=0) * margin
    else:
        dq = a.max(axis=0) * max(margin, 1.5)
    m = np.where(live, np.maximum(np.ceil(dq).astype(np.int64), 1), 0)
    return 2 * m + 1


def _plane_diffs(planes, qstep: float, levels_i) -> Tuple[np.ndarray, np.ndarray, int]:
    """Quantized-coefficient temporal differences of sample planes:
    (d1, d2, n_blocks) with d1/d2 flattened to (N, 64). d2 is the
    second difference under the C[-1] := C[0] convention (its first
    frame IS d1's first frame), exactly what `encode_chunk` ships for
    order-2 positions."""
    C = _host_quantize_int(_host_block_dct(planes), qstep, levels_i)
    d1 = C[1:] - C[:-1]
    d2 = np.concatenate([d1[:1], d1[1:] - d1[:-1]], axis=0) if d1.shape[0] else d1
    return d1.reshape(-1, 64), d2.reshape(-1, 64), C.shape[1]


def _delta_levels(planes, qstep: float, levels_i, margin: float) -> np.ndarray:
    """Observed order-1 integer-coefficient deltas -> odd level counts
    (back-compat wrapper over `_levels_from_deltas`)."""
    d1, _, _ = _plane_diffs(planes, qstep, levels_i)
    live = np.asarray(levels_i, np.int64) > 1
    return _levels_from_deltas(np.abs(d1), live, margin)


def _host_quantize_int(coefs, qstep: float, levels) -> np.ndarray:
    m = ((np.asarray(levels, np.int64) - 1) // 2).astype(np.float64)
    return np.clip(np.round(np.asarray(coefs, np.float64) / qstep), -m, m).astype(np.int64)


def _escape_plan(d: np.ndarray, live: np.ndarray, margin: float,
                 esc_bits: float = 18.0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-position escape-coded plan over observed integer deltas d
    (N, 64): choose the base bound m minimizing log2(2m+2) + P(|d|>m) *
    esc_bits (the exact int16 exception plus amortized counts/slack
    overhead), falling back to the clipped plan (odd 2M+1) where that
    is cheaper. Returns (levels — parity encodes the mode —, the
    per-position expected bits/symbol, and the per-position escape
    probability)."""
    a = np.abs(d)
    clipped = _levels_from_deltas(a, live, margin)
    levels = np.asarray(clipped, np.int64).copy()
    cost = np.where(live, np.log2(np.maximum(clipped.astype(np.float64), 1.0)), 0.0)
    esc_p = np.zeros(64)
    for i in np.nonzero(live)[0]:
        col = np.sort(a[:, i])
        n = col.size
        hi = int(col[-1])
        qs = col[np.minimum((np.asarray([0.3, 0.5, 0.65, 0.8, 0.9, 0.95,
                                         0.98, 0.99, 0.995, 0.999]) * n).astype(np.int64), n - 1)]
        best = (float(cost[i]), None, 0.0)  # clipped cost
        for m in np.unique(np.concatenate([[0, hi], qs])):
            p = float(np.mean(a[:, i] > m))
            c = np.log2(2.0 * m + 2.0) + p * esc_bits
            if c < best[0]:
                best = (c, int(m), p)
        if best[1] is not None:
            levels[i] = 2 * best[1] + 2  # even = escape mode
            cost[i], esc_p[i] = best[0], best[2]
    return levels, cost, esc_p




# -------------------------------------------- device-side calibration
_ESC_HIST_BINS = 256


def _hist_abs(d: torch.Tensor):
    """|d| (N, 64) integer deltas -> (per-position histogram of min(|d|, 255), per-position max, per-position
    0.999 quantile of |d| as jnp.quantile interpolates it)."""
    from ..native import quantile_sorted

    a = d.abs()
    cl = torch.clamp(a, max=_ESC_HIST_BINS - 1).to(torch.int64)
    idx = (torch.arange(64, device=d.device)[None, :] * _ESC_HIST_BINS + cl).reshape(-1)
    hist = torch.bincount(idx, minlength=64 * _ESC_HIST_BINS).reshape(64, _ESC_HIST_BINS)
    q999 = quantile_sorted(torch.sort(a.to(torch.float32), dim=0).values, 0.999, dim=0)
    return hist, a.amax(dim=0), q999


def _plane_stats(pl: torch.Tensor, qstep: float) -> Dict[str, torch.Tensor]:
    C = _block_dct_device(pl)
    flat = C.reshape(-1, 64)
    out = {"sig_absmax": flat.abs().amax(dim=0), "sig_std": torch.std(flat, dim=0, correction=0)}
    if C.shape[0] < 2:
        return out
    Ci = torch.round(_scaled(C, qstep)).to(torch.int32)  # unclipped: the intra clip range is not known yet
    d1 = (Ci[1:] - Ci[:-1]).reshape(-1, 64)
    if Ci.shape[0] >= 3:
        d2 = torch.cat([Ci[1:2] - Ci[0:1], Ci[2:] - 2 * Ci[1:-1] + Ci[:-2]], dim=0).reshape(-1, 64)
    else:
        d2 = d1
    out["h1"], out["max1"], out["q999_1"] = _hist_abs(d1)
    out["h2"], out["max2"], out["q999_2"] = _hist_abs(d2)
    return out


def _calib_stats(rgb: torch.Tensor, quality: float) -> Dict:
    """A chunk's calibration statistics on rgb's device (per-position spreads, delta histograms, maxima and
    0.999 quantiles; the chroma interpolation error), copied to the host as numpy: ~400 KB, where the host
    path copies the whole chunk."""
    qstep = 7.0 * quality
    y, u, v = _yuv_planes_device(rgb)
    out = {"y": _plane_stats(y, qstep), "u": _plane_stats(u, qstep), "v": _plane_stats(v, qstep)}
    if u.shape[0] >= 5:
        out["u2"] = _plane_stats(u[::2], qstep)
        out["v2"] = _plane_stats(v[::2], qstep)
    if u.shape[0] >= 4:
        out["interp_mse_c"] = 0.5 * (torch.mean(((u[:-2] + u[2:]) * 0.5 - u[1:-1]) ** 2)
                                     + torch.mean(((v[:-2] + v[2:]) * 0.5 - v[1:-1]) ** 2))

    def host(t):
        return {k: host(v) for k, v in t.items()} if isinstance(t, dict) else t.cpu().numpy()

    return host(out)



def _levels_from_hist(st, order: int, live: np.ndarray, n: int, margin: float) -> np.ndarray:
    """`_levels_from_deltas` on the device's histogram evidence."""
    mx = np.asarray(st[f"max{order}"], np.float64)
    q = np.asarray(st[f"q999_{order}"], np.float64)
    dq = q * margin if n >= 10_000 else mx * max(margin, 1.5)
    m = np.where(live, np.maximum(np.ceil(dq).astype(np.int64), 1), 0)
    return 2 * m + 1


def _escape_plan_hist(st, order: int, live: np.ndarray, n: int, margin: float, esc_bits: float = 18.0):
    """`_escape_plan` on the device's histogram evidence: every base bound m in [0, 255] is evaluated from the
    exact histogram. The escape counts n - cumsum(h) are clamped at 0: the histogram may hold more deltas
    than the n the plan codes (chroma halving on fewer than 5 frames), where maua_tpu's go negative."""
    h = np.asarray(st[f"h{order}"], np.int64)
    mx = np.asarray(st[f"max{order}"], np.int64)
    clipped = _levels_from_hist(st, order, live, n, margin)
    levels = np.asarray(clipped, np.int64).copy()
    cost = np.where(live, np.log2(np.maximum(clipped.astype(np.float64), 1.0)), 0.0)
    esc_p = np.zeros(64)
    exceed = np.maximum(n - np.cumsum(h, axis=1), 0)  # count(|d| > m), m in 0..255
    for i in np.nonzero(live)[0]:
        hi = min(int(mx[i]), _ESC_HIST_BINS - 2)
        ms = np.arange(hi + 1)
        p = exceed[i, ms] / max(n, 1)
        c = np.log2(2.0 * ms + 2.0) + p * esc_bits
        j = int(np.argmin(c))
        if c[j] < cost[i] - 1e-12:
            levels[i] = 2 * int(ms[j]) + 2
            cost[i], esc_p[i] = float(c[j]), float(p[j])
    return levels, cost, esc_p


def calibrate_chunk_device(frames: torch.Tensor, quality: float = 1.0, clip_sigmas: float = 4.5,
                           delta_margin: float = 1.3, chroma_step: str = "auto", escape: bool = True,
                           esc_cap_margin: float = 1.2, order2: str = "auto") -> ChunkCodec:
    """`calibrate_chunk` with its statistics computed on the frames' device.

    frames: (T, H, W, 3) uint8 tensor. One pass on the device yields per-position histograms, quantiles and
    spreads; the host builds the plan from them. Plans differ from the host path's only by (a) escape sweeps
    over the exact histogram, (b) unclipped delta statistics, (c) max(std_u, std_v) as the shared chroma
    spread (the last two conservative). Escape counts and capacities are clamped at 0 (see the module's
    docstring)."""
    T, H, W, _ = frames.shape
    if H % 16 or W % 16:
        raise ValueError(f"frame codec needs 16-aligned dimensions, got {H}x{W}")
    st = _calib_stats(frames, float(quality))
    qstep = 7.0 * quality

    def sig(s):
        return np.maximum(s["sig_absmax"] / clip_sigmas, s["sig_std"]).astype(np.float32)

    sig_c = np.maximum(sig(st["u"]), sig(st["v"]))
    intra = _make_config(H, W, sig(st["y"]), sig_c, qstep, clip_sigmas)
    if T < 2:
        return ChunkCodec(intra=intra, delta=intra)

    step = 1
    if chroma_step == "auto" and T >= 4:
        if float(st["interp_mse_c"]) <= intra.qstep_c**2 / 24.0:
            step = 2
    elif chroma_step in (2, "2"):
        step = 2
    su, sv = (st["u2"], st["v2"]) if (step > 1 and "u2" in st) else (st["u"], st["v"])

    nb_y = (H // 8) * (W // 8)
    nb_c = (H // 16) * (W // 16)
    Tc = -(-T // step)
    n_y = (T - 1) * nb_y
    n_c = (Tc - 1) * nb_c
    live_y = np.asarray(intra.levels_y, np.int64) > 1
    live_c = np.asarray(intra.levels_c, np.int64) > 1
    try_o2 = order2 in ("auto", "force", True) and T >= 3
    try_o2_c = try_o2 and Tc >= 3
    o2y = np.zeros(64, bool)
    o2c = np.zeros(64, bool)
    cap_y = cap_c = 0
    if escape and (n_y >= 10_000 or escape == "force"):
        ly1, cy1, ry1 = _escape_plan_hist(st["y"], 1, live_y, n_y, delta_margin)
        lu1, cu1, ru1 = _escape_plan_hist(su, 1, live_c, n_c, delta_margin)
        lv1, cv1, rv1 = _escape_plan_hist(sv, 1, live_c, n_c, delta_margin)
        ly, ry_pos = ly1, ry1
        lu, ru_pos, lv, rv_pos = lu1, ru1, lv1, rv1
        if try_o2:
            ly2, cy2, ry2 = _escape_plan_hist(st["y"], 2, live_y, n_y, delta_margin)
            o2y = cy2 < cy1 - 1e-9
            ly = np.where(o2y, ly2, ly1)
            ry_pos = np.where(o2y, ry2, ry1)
        if try_o2_c:
            lu2, cu2, ru2 = _escape_plan_hist(su, 2, live_c, n_c, delta_margin)
            lv2, cv2, rv2 = _escape_plan_hist(sv, 2, live_c, n_c, delta_margin)
            o2c = (cu2 + cv2) < (cu1 + cv1) - 1e-9
            lu, ru_pos = np.where(o2c, lu2, lu1), np.where(o2c, ru2, ru1)
            lv, rv_pos = np.where(o2c, lv2, lv1), np.where(o2c, rv2, rv1)
        lc = np.maximum(lu, lv)
        ry = float(ry_pos.sum()) * nb_y
        rc = float(np.maximum(ru_pos, rv_pos).sum()) * nb_c
        cap_y = max(int(np.ceil(ry * esc_cap_margin)) + 64, 0) if (ly % 2 == 0).any() else 0
        cap_c = max(int(np.ceil(rc * esc_cap_margin)) + 64, 0) if (lc % 2 == 0).any() else 0
    else:
        ly1 = _levels_from_hist(st["y"], 1, live_y, n_y, delta_margin)
        lu1 = _levels_from_hist(su, 1, live_c, n_c, delta_margin)
        lv1 = _levels_from_hist(sv, 1, live_c, n_c, delta_margin)
        ly, lu, lv = ly1, lu1, lv1
        if order2 in ("auto", "force", True) and try_o2:
            ly2 = _levels_from_hist(st["y"], 2, live_y, n_y, delta_margin)
            o2y = ly2 < ly1
            ly = np.where(o2y, ly2, ly1)
            if try_o2_c:
                lu2 = _levels_from_hist(su, 2, live_c, n_c, delta_margin)
                lv2 = _levels_from_hist(sv, 2, live_c, n_c, delta_margin)
                o2c = (lu2.astype(np.int64) * lv2) < (lu1.astype(np.int64) * lv1)
                lu = np.where(o2c, lu2, lu1)
                lv = np.where(o2c, lv2, lv1)
        lc = np.maximum(lu, lv)
    delta = CodecConfig(
        height=H, width=W, qstep_y=intra.qstep_y, qstep_c=intra.qstep_c,
        levels_y=tuple(int(x) for x in ly), levels_c=tuple(int(x) for x in lc),
        groups_y=_plan_words(ly, intra.strip_y), groups_c=_plan_words(lc, intra.strip_c),
    )
    return ChunkCodec(intra=intra, delta=delta, chroma_step=step, esc_cap_y=cap_y, esc_cap_c=cap_c,
                      order2_y=tuple(int(x) for x in o2y) if o2y.any() else (),
                      order2_c=tuple(int(x) for x in o2c) if o2c.any() else ())


def calibrate_chunk(frames, quality: float = 1.0, clip_sigmas: float = 4.5,
                    delta_margin: float = 1.3, chroma_step: str = "auto",
                    escape: bool = True, esc_cap_margin: float = 1.2,
                    order2: str = "auto") -> ChunkCodec:
    """Calibrate intra + delta plans from a sample chunk ((T,H,W,3)
    uint8 RGB, consecutive frames of the target content). The delta
    plan covers the observed quantized-coefficient deltas x margin; its
    qstep equals the intra qstep (deltas live on the same grid).

    chroma_step="auto" enables temporal 2x chroma subsampling (chroma
    deltas ~30% of the stream on noisy content) when the measured
    midpoint-interpolation error on the sample chunk is at most half
    the quantizer's own MSE budget; 1/2 force it off/on.

    escape=True (default) escape-codes delta positions where a smaller
    base alphabet + exact int16 exceptions beats the clipped plan
    (~14% fewer bits on bench content, and out-of-range deltas become
    exact instead of clipped); the exception capacity per delta frame
    is the measured expected escape count x esc_cap_margin (default
    1.2 — the value sections are paid in full every chunk, ~1.4% of
    the stream per 0.3 of margin, and since the closed-loop encoder
    self-corrects capacity overflow the fat 1.5x headroom bought
    nothing but bytes; measured in workspace/profiling).

    order2="auto" additionally picks, per position, the prediction
    order (first vs second temporal difference) with the lower
    expected bits/symbol — smooth interpolation content moves
    coefficients nearly linearly, so second differences are several
    times smaller at the busy positions. False forces order-1
    everywhere; "force" evaluates order-2 even on small samples (the
    escape-rate caveat above applies)."""
    rgb = _host_array(frames)
    T, H, W, _ = rgb.shape
    if H % 16 or W % 16:
        raise ValueError(f"frame codec needs 16-aligned dimensions, got {H}x{W}")
    intra = calibrate(rgb, quality=quality, clip_sigmas=clip_sigmas)
    if T < 2:  # no deltas to measure: reuse the intra plan
        return ChunkCodec(intra=intra, delta=intra)
    y, u, v = _host_yuv_planes(rgb)

    step = 1
    if chroma_step == "auto" and T >= 4:
        interp_mse = float(np.mean([
            np.mean(((c[:-2] + c[2:]) * 0.5 - c[1:-1]) ** 2) for c in (u, v)
        ]))
        if interp_mse <= intra.qstep_c**2 / 24.0:
            step = 2
    elif chroma_step in (2, "2"):
        step = 2

    us, vs = (u[::step], v[::step]) if step > 1 else (u, v)
    live_y = np.asarray(intra.levels_y, np.int64) > 1
    live_c = np.asarray(intra.levels_c, np.int64) > 1
    d1y, d2y, nb_y = _plane_diffs(y, intra.qstep_y, intra.levels_y)
    d1u, d2u, nb_c = _plane_diffs(us, intra.qstep_c, intra.levels_c)
    d1v, d2v, _ = _plane_diffs(vs, intra.qstep_c, intra.levels_c)
    # order-2 stats need more than one second difference to mean
    # anything (T >= 3 coded frames on the relevant lattice)
    try_o2 = order2 in ("auto", "force", True) and d1y.shape[0] >= 2 * nb_y
    try_o2_c = try_o2 and d1u.shape[0] >= 2 * nb_c
    o2y = np.zeros(64, bool)
    o2c = np.zeros(64, bool)
    cap_y = cap_c = 0
    # small samples make the per-position escape-rate estimates pure
    # noise — fall back to clipped coding below ~10k delta blocks
    # (escape="force" overrides, for tests/small content)
    if escape and ((T - 1) * (H // 8) * (W // 8) >= 10_000 or escape == "force"):
        ly1, cy1, ry1 = _escape_plan(d1y, live_y, delta_margin)
        lu1, cu1, ru1 = _escape_plan(d1u, live_c, delta_margin)
        lv1, cv1, rv1 = _escape_plan(d1v, live_c, delta_margin)
        ly, ry_pos = ly1, ry1
        lu, ru_pos, lv, rv_pos = lu1, ru1, lv1, rv1
        if try_o2:
            ly2, cy2, ry2 = _escape_plan(d2y, live_y, delta_margin)
            o2y = cy2 < cy1 - 1e-9
            ly = np.where(o2y, ly2, ly1)
            ry_pos = np.where(o2y, ry2, ry1)
        if try_o2_c:
            lu2, cu2, ru2 = _escape_plan(d2u, live_c, delta_margin)
            lv2, cv2, rv2 = _escape_plan(d2v, live_c, delta_margin)
            # u and v share one plan, so they share the order decision
            o2c = (cu2 + cv2) < (cu1 + cv1) - 1e-9
            lu, ru_pos = np.where(o2c, lu2, lu1), np.where(o2c, ru2, ru1)
            lv, rv_pos = np.where(o2c, lv2, lv1), np.where(o2c, rv2, rv1)
        # u and v share one plan: per position keep whichever mode/size
        # covers both (max radix; escape beats clipped when either chose it)
        lc = np.maximum(lu, lv)
        ry = float(ry_pos.sum()) * nb_y
        rc = float(np.maximum(ru_pos, rv_pos).sum()) * nb_c
        cap_y = int(np.ceil(ry * esc_cap_margin)) + 64 if (ly % 2 == 0).any() else 0
        cap_c = int(np.ceil(rc * esc_cap_margin)) + 64 if (lc % 2 == 0).any() else 0
    else:
        ly1 = _levels_from_deltas(np.abs(d1y), live_y, delta_margin)
        lu1 = _levels_from_deltas(np.abs(d1u), live_c, delta_margin)
        lv1 = _levels_from_deltas(np.abs(d1v), live_c, delta_margin)
        ly, lu, lv = ly1, lu1, lv1
        # "auto" picks order-2 here by STATIC level counts (the escape
        # branch compares expected bits/symbol instead); small-sample
        # level estimates are max-based, so the comparison is the
        # conservative one
        if order2 in ("auto", "force", True) and try_o2:
            ly2 = _levels_from_deltas(np.abs(d2y), live_y, delta_margin)
            o2y = ly2 < ly1
            ly = np.where(o2y, ly2, ly1)
            if try_o2_c:
                lu2 = _levels_from_deltas(np.abs(d2u), live_c, delta_margin)
                lv2 = _levels_from_deltas(np.abs(d2v), live_c, delta_margin)
                o2c = (lu2.astype(np.int64) * lv2) < (lu1.astype(np.int64) * lv1)
                lu = np.where(o2c, lu2, lu1)
                lv = np.where(o2c, lv2, lv1)
        lc = np.maximum(lu, lv)
    delta = CodecConfig(
        height=H, width=W, qstep_y=intra.qstep_y, qstep_c=intra.qstep_c,
        levels_y=tuple(int(x) for x in ly), levels_c=tuple(int(x) for x in lc),
        groups_y=_plan_words(ly, intra.strip_y), groups_c=_plan_words(lc, intra.strip_c),
    )
    return ChunkCodec(intra=intra, delta=delta, chroma_step=step,
                      esc_cap_y=cap_y, esc_cap_c=cap_c,
                      order2_y=tuple(int(x) for x in o2y) if o2y.any() else (),
                      order2_c=tuple(int(x) for x in o2c) if o2c.any() else ())




def _le16(x: torch.Tensor) -> torch.Tensor:
    """(...,) integers in [0, 65535] -> (..., 2) little-endian uint8."""
    return torch.stack([(x & 0xFF).to(torch.uint8), ((x >> 8) & 0xFF).to(torch.uint8)], dim=-1)


def chunk_coefficients(rgb: torch.Tensor, codec: ChunkCodec):
    """(T, H, W, 3) uint8 -> the clipped integer DCT coefficients (T, n_blocks, 64) int32 of the y, u and v
    planes under the codec's intra plan: every frame quantized in one batched pass, on rgb's device."""
    ci = codec.intra
    T, H, W, _ = rgb.shape
    if (H, W) != (ci.height, ci.width):
        raise ValueError(f"frames are {H}x{W}, the plan {ci.height}x{ci.width}")

    def quantized(pl, levels, qstep):
        mi = torch.as_tensor((np.asarray(levels, np.int64) - 1) // 2, dtype=torch.float32, device=pl.device)
        return torch.clamp(torch.round(_scaled(_block_dct_device(pl), qstep)), -mi, mi).to(torch.int32)

    y, u, v = _yuv_planes_device(rgb)
    return (quantized(y, ci.levels_y, ci.qstep_y), quantized(u, ci.levels_c, ci.qstep_c),
            quantized(v, ci.levels_c, ci.qstep_c))


def _encode_plane_chunk(C: torch.Tensor, lev_i, grp_i, lev_d, grp_d, strip: int, cap_frame: int,
                        keyframes=None, order2=None):
    """One plane of a chunk from its integer coefficients C (T, nb, 64): (intra bytes (1, n), delta bytes
    (F, n), escape counts' bytes or None, escape values' bytes or None, the largest sum of squared clip
    errors (shipped minus ideal delta, in quantization steps) of one frame: a 0-dim int64 tensor).

    Closed-loop delta coding, one frame at a time on C's device: the carry is the decoder's exact
    reconstruction R (and the velocity V of order-2 positions), and each frame ships C_t minus the
    prediction from them. When nothing clips and every escape fits the capacity, this is the open-loop frame
    difference bit for bit; a clipped delta or a dropped escape feeds back into the next frame's delta. For
    order-1 positions V is the shipped delta itself, so one rule covers both orders: V' = o2 ? V + sd : sd,
    R' = R + V'."""
    dev = C.device
    mi = torch.as_tensor((np.asarray(lev_i, np.int64) - 1) // 2, dtype=torch.int32, device=dev)
    intra_p = _pack_device(C[:1] + mi, lev_i, grp_i, strip)
    if keyframes is not None:
        C = C[torch.as_tensor(keyframes, device=dev)]
    lev_np = np.asarray(lev_d, np.int64)
    md = torch.as_tensor((lev_np - 1) // 2, dtype=torch.int64, device=dev)  # m in both modes
    o2 = np.zeros(64, bool) if not order2 else np.asarray(order2, bool)
    o2j = torch.as_tensor(o2, device=dev)
    esc_np = (lev_np % 2 == 0) & (lev_np > 1)
    F, nb = C.shape[0] - 1, C.shape[1]
    worst = torch.zeros((), dtype=torch.int64, device=dev)
    if F <= 0:
        return intra_p, _pack_device(C.new_zeros((0, nb, 64)), lev_d, grp_d, strip), None, None, worst
    C = C.to(torch.int64)
    R, V = C[0], torch.zeros_like(C[0])
    syms = []
    if cap_frame == 0 or not esc_np.any():
        for t in range(1, F + 1):
            ideal = C[t] - R - torch.where(o2j[None, :], V, 0)
            sd = torch.clamp(ideal, -md, md)
            V = torch.where(o2j[None, :], V + sd, sd)
            R = R + V
            syms.append(sd + md)
            worst = torch.maximum(worst, ((sd - ideal) ** 2).sum())
        return intra_p, _pack_device(torch.stack(syms), lev_d, grp_d, strip), None, None, worst

    ns = nb // strip
    cap_t = cap_frame * F
    escj = torch.as_tensor(esc_np, device=dev)
    has_o2 = bool(o2.any()) and F > 1
    is2 = o2j[None, :].expand(nb, 64).reshape(-1)
    used = torch.zeros((), dtype=torch.int64, device=dev)
    buf = torch.zeros(cap_t + 1, dtype=torch.int64, device=dev)
    counts = []
    for t in range(1, F + 1):
        ideal = C[t] - R - torch.where(o2j[None, :], V, 0)
        clipped = torch.clamp(ideal, -md, md)
        # escape ranks in (strip, symbol) scan order: C order over (nb, 64), blocks being consecutive within a
        # strip, as the decoders walk it. The capacity is the chunk's: a busy frame borrows later headroom.
        over = escj[None, :] & (ideal.abs() > md)
        flat = over.reshape(-1)
        avail = cap_t - used
        if has_o2:
            # an overflow drops order-1 escapes first: a dropped order-2 escape distorts the velocity
            r2 = torch.cumsum((flat & is2).to(torch.int64), 0)
            r1 = torch.cumsum((flat & ~is2).to(torch.int64), 0)
            keep = flat & torch.where(is2, r2 - 1 < avail, r2[-1] + r1 - 1 < avail)
        else:
            keep = flat & (torch.cumsum(flat.to(torch.int64), 0) - 1 < avail)
        keep2 = keep.reshape(over.shape)
        sd = torch.where(keep2, ideal, clipped)
        V = torch.where(o2j[None, :], V + sd, sd)
        R = R + V
        syms.append(torch.where(keep2, 2 * md + 1, clipped + md))
        # the exact values land at their ranks; every other symbol adds 0 to the discard slot cap_t
        rank = torch.cumsum(keep.to(torch.int64), 0) - 1 + used
        buf.index_add_(0, torch.where(keep, rank, cap_t), torch.where(keep, ideal.reshape(-1), 0))
        counts.append(keep2.reshape(ns, strip * 64).sum(-1))
        used = used + keep.sum()
        worst = torch.maximum(worst, ((sd - ideal) ** 2).sum())
    delta_p = _pack_device(torch.stack(syms), lev_d, grp_d, strip)
    vals16 = buf[:cap_t] & 0xFFFF  # two's complement int16 bytes of the (possibly negative) values
    # 2 pad bytes: the AVX-512 decoder's masked 32-bit gather may read 2 bytes past the last value
    val_bytes = torch.cat([_le16(vals16).reshape(-1), torch.zeros(2, dtype=torch.uint8, device=dev)])
    return intra_p, delta_p, _le16(torch.stack(counts)).reshape(-1), val_bytes, worst


def encode_chunk_coefficients(coefs, codec: ChunkCodec, n_frames: int, clip_error: bool = False):
    """The DPCM stream of a chunk from its integer coefficients (`chunk_coefficients`); with `clip_error`,
    also the largest mean squared error that clipping added to one plane of one coded frame, in pixel units
    (a 0-dim f32 tensor on the coefficients' device). The DCT is orthonormal, so a delta shipped k steps off
    its ideal adds (k * qstep)^2 to the plane's squared error, which the closed loop takes back in the next
    frame."""
    ci, cd = codec.intra, codec.delta
    ks = codec.chroma_keyframes(n_frames) if codec.chroma_step > 1 else None
    cy, cu, cv = coefs
    iy, dy, ey, vy, xy = _encode_plane_chunk(cy, ci.levels_y, ci.groups_y, cd.levels_y, cd.groups_y, ci.strip_y,
                                             codec.esc_cap_y, order2=codec.order2_y)
    iu, du, eu, vu, xu = _encode_plane_chunk(cu, ci.levels_c, ci.groups_c, cd.levels_c, cd.groups_c, ci.strip_c,
                                             codec.esc_cap_c, ks, order2=codec.order2_c)
    iv, dv, ev, vv, xv = _encode_plane_chunk(cv, ci.levels_c, ci.groups_c, cd.levels_c, cd.groups_c, ci.strip_c,
                                             codec.esc_cap_c, ks, order2=codec.order2_c)
    intra = torch.cat([iy, iu, iv], dim=1)[0]
    parts = [dy.reshape(-1), du.reshape(-1), dv.reshape(-1)]
    parts += [sec for sec in (ey, vy, eu, vu, ev, vv) if sec is not None]
    if clip_error:
        ny, nc = ci.height * ci.width, ci.height * ci.width // 4
        mse = torch.stack([xy.double() * cd.qstep_y**2 / ny, xu.double() * cd.qstep_c**2 / nc,
                           xv.double() * cd.qstep_c**2 / nc]).amax().float()
        return intra, torch.cat(parts), mse
    return intra, torch.cat(parts)


def encode_chunk(rgb: torch.Tensor, codec: ChunkCodec, clip_error: bool = False):
    """DPCM chunk encode on rgb's device: (T, H, W, 3) uint8 -> (intra bytes (frame_bytes_i,), delta bytes
    (codec.delta_bytes(T),)), both uint8 tensors on that device; with `clip_error`, also the largest mean
    squared error clipping added to a plane of a frame (`encode_chunk_coefficients`).

    Every frame's coefficients quantize in one batched pass; frame 0 ships intra and frames 1..T-1 integer
    deltas, closed-loop (`_encode_plane_chunk`). The delta stream is [luma deltas (T-1 frames) | u deltas | v
    deltas | per-plane escape sections (counts, values; `ChunkCodec.esc_section_bytes`)]; with chroma_step 2
    the chroma sections hold the keyframe lattice's deltas only (`ChunkCodec.chroma_keyframes`)."""
    return encode_chunk_coefficients(chunk_coefficients(rgb, codec), codec, rgb.shape[0], clip_error)



# ----------------------------------------------------------------- host decode
DECODERS = ("native", "numpy")


def _check_decoder(decoder: str) -> None:
    if decoder not in DECODERS:
        raise ValueError(f"decoder must be one of {DECODERS}, got {decoder!r}")


def decode_chunk(intra, deltas, codec: ChunkCodec, out: str = "yuv420", decoder: str = "native") -> np.ndarray:
    """Host decode of a DPCM chunk -> (T, 3H/2, W) uint8 yuv420p frames (or (T, H, W, 3) RGB with out="rgb").

    decoder="native" (the main path): one C++ pass per plane unpacks, inverse-transforms, accumulates each
    block's DPCM chain, interpolates skipped chroma frames and writes uint8 into the I420 layout
    (`native.framecodec_decode_chunk_u8`); it raises if the host kernels do not build. decoder="numpy" is the
    plain version: one running sum over the batch-decoded delta planes and a linear interpolation of the
    chroma midframes (it agrees with the native decoder within one gray level on under 1 % of the bytes)."""
    _check_decoder(decoder)
    if out not in ("yuv420", "rgb"):
        raise ValueError(f"unknown output format {out!r}")
    intra = np.asarray(intra, np.uint8).reshape(-1)
    flat = np.zeros((0,), np.uint8) if deltas is None else np.asarray(deltas, np.uint8).reshape(-1)
    T = codec.frames_for_delta_bytes(flat.size)
    if decoder == "native":
        from .. import native

        yuv = native.framecodec_decode_chunk_u8(intra, flat, codec, T)
        return yuv if out == "yuv420" else yuv420_to_rgb(yuv)
    ci, cd = codec.intra, codec.delta
    H, W = ci.height, ci.width
    iy, iu, iv = _decode_planes(intra[None], ci, "numpy")
    if T == 1:
        return _planes_to_output(iy, iu, iv, H, W, out)
    ks = codec.chroma_keyframes(T)
    n_ck = len(ks)
    sy = (T - 1) * codec.luma_delta_bytes
    sc = (n_ck - 1) * codec.chroma_delta_bytes
    # the escape sections trail the three base sections: [counts_y values_y counts_u values_u counts_v values_v]
    ecy, evy = codec.esc_section_bytes(T - 1, "y")
    ecc, evc = codec.esc_section_bytes(n_ck - 1, "c")
    off = sy + 2 * sc
    esc_vals = []
    for cbytes, vbytes in ((ecy, evy), (ecc, evc), (ecc, evc)):
        if vbytes == 0:
            esc_vals.append(None)
            off += cbytes + vbytes
            continue
        vs = flat[off + cbytes: off + cbytes + vbytes - 2]
        esc_vals.append(np.frombuffer(vs.tobytes(), dtype="<i2").astype(np.int64))
        off += cbytes + vbytes

    def unpack_deltas(section, nb, levels, groups, qstep, strip, vals, order2):
        sym = _host_unpack_sym(section, nb, levels, groups, strip)
        lev = np.asarray(levels, np.int64)
        q = sym - ((lev - 1) // 2)[None, None, :]
        escp = (lev % 2 == 0) & (lev > 1)
        if vals is not None and escp.any():
            flatm = (escp[None, None, :] & (sym == (lev - 1)[None, None, :])).reshape(-1)
            ranks = np.cumsum(flatm) - 1
            qf = q.reshape(-1)
            qf[flatm] = vals[ranks[flatm]]
        if order2:
            # order-2 positions shipped second differences: integrate once here; the running sum over the
            # pixel planes below is the second integration (exact in the integer domain)
            o2 = np.asarray(order2, bool)
            q[:, :, o2] = np.cumsum(q[:, :, o2], axis=0)
        return (q * qstep).astype(np.float32)

    dy = unpack_deltas(flat[:sy].reshape(T - 1, -1), cd.n_blocks_y, cd.levels_y, cd.groups_y, cd.qstep_y,
                       cd.strip_y, esc_vals[0], codec.order2_y)
    du = unpack_deltas(flat[sy: sy + sc].reshape(n_ck - 1, -1), cd.n_blocks_c, cd.levels_c, cd.groups_c,
                       cd.qstep_c, cd.strip_c, esc_vals[1], codec.order2_c)
    dv = unpack_deltas(flat[sy + sc: sy + 2 * sc].reshape(n_ck - 1, -1), cd.n_blocks_c, cd.levels_c, cd.groups_c,
                       cd.qstep_c, cd.strip_c, esc_vals[2], codec.order2_c)
    y = np.concatenate([iy, _host_idct(dy, H, W)], axis=0).cumsum(axis=0, dtype=np.float32)
    uk = np.concatenate([iu, _host_idct(du, H // 2, W // 2)], axis=0).cumsum(axis=0, dtype=np.float32)
    vk = np.concatenate([iv, _host_idct(dv, H // 2, W // 2)], axis=0).cumsum(axis=0, dtype=np.float32)
    return _planes_to_output(y, _expand_chroma(uk, ks, T), _expand_chroma(vk, ks, T), H, W, out)


def _expand_chroma(keyplanes: np.ndarray, ks, T: int) -> np.ndarray:
    """(n_ck, h, w) keyframe planes -> (T, h, w) with skipped frames
    linearly interpolated between their surrounding keyframes."""
    if len(ks) == T:
        return keyplanes
    out = np.empty((T,) + keyplanes.shape[1:], np.float32)
    for idx, t in enumerate(ks):
        out[t] = keyplanes[idx]
    for idx in range(1, len(ks)):
        a, b = ks[idx - 1], ks[idx]
        for j in range(a + 1, b):
            w = (j - a) / (b - a)
            out[j] = (1.0 - w) * keyplanes[idx - 1] + w * keyplanes[idx]
    return out


def _host_yuv_planes(rgb_u8: np.ndarray):
    x = rgb_u8.astype(np.float32)
    B, H, W, _ = x.shape
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    yf = 0.299 * r + 0.587 * g + 0.114 * b
    luma = 16.0 + yf * (219.0 / 255.0)
    cb = 128.0 + (b - yf) * (224.0 / 255.0 * 0.5 / (1.0 - 0.114))
    cr = 128.0 + (r - yf) * (224.0 / 255.0 * 0.5 / (1.0 - 0.299))
    sub = lambda c: c.reshape(B, H // 2, 2, W // 2, 2).mean(axis=(2, 4))
    return luma - 128.0, sub(cb) - 128.0, sub(cr) - 128.0


def _host_block_dct(plane: np.ndarray) -> np.ndarray:
    plane = np.asarray(plane, np.float32)
    B, H, W = plane.shape
    x = plane.reshape(B, H // 8, 8, W // 8, 8)
    x = np.einsum("ui,bhiwj->bhuwj", _DCT, x)
    x = np.einsum("vj,bhuwj->bhuwv", _DCT, x)
    return x.transpose(0, 1, 3, 2, 4).reshape(B, -1, 64)


def _host_unpack_sym(section: np.ndarray, nb: int, levels: Tuple[int, ...],
                     groups, strip: int) -> np.ndarray:
    """(B, strips*words*4) uint8 -> (B, nb, 64) UNSIGNED symbols (int64).
    Digits of split positions accumulate as digit * prediv."""
    B = section.shape[0]
    ns = nb // strip
    nw = len(groups)
    words = section.reshape(B, ns, nw, 4).astype(np.uint32)
    words = words[..., 0] | (words[..., 1] << 8) | (words[..., 2] << 16) | (words[..., 3] << 24)
    acc = np.zeros((B, ns, strip * 64), np.int64)
    for gi, grp in enumerate(groups):
        w = words[:, :, gi].copy()
        for idx, radix, prediv in grp:
            acc[:, :, idx] += (w % radix).astype(np.int64) * prediv
            w //= radix
    return acc.reshape(B, nb, 64)


def _host_unpack(section: np.ndarray, nb: int, levels: Tuple[int, ...],
                 groups, qstep: float, strip: int) -> np.ndarray:
    """(B, strips*words*4) uint8 -> (B, nb, 64) dequantized f32
    (clipped-mode sections: centering offset (L-1)//2)."""
    sym = _host_unpack_sym(section, nb, levels, groups, strip)
    mid = ((np.asarray(levels, np.int64) - 1) // 2)
    return ((sym - mid[None, None, :]) * qstep).astype(np.float32)


def _host_idct(coefs: np.ndarray, H: int, W: int) -> np.ndarray:
    B = coefs.shape[0]
    x = coefs.reshape(B, H // 8, W // 8, 8, 8)
    x = np.einsum("iu,bhwuv->bhwiv", _DCT.T, x)
    x = np.einsum("jv,bhwiv->bhwij", _DCT.T, x)
    return x.transpose(0, 1, 3, 2, 4).reshape(B, H, W)


def _decode_planes(packed: np.ndarray, cfg: CodecConfig, decoder: str = "native"):
    """(B, frame_bytes) -> centered f32 planes (y, u, v), by the C++ plane decoder or by numpy."""
    _check_decoder(decoder)
    if decoder == "native":
        from .. import native

        return native.framecodec_decode_planes(packed, cfg)
    H, W = cfg.height, cfg.width
    sy = cfg.plane_bytes_y
    sc = cfg.plane_bytes_c
    qy = _host_unpack(packed[:, :sy], cfg.n_blocks_y, cfg.levels_y, cfg.groups_y, cfg.qstep_y, cfg.strip_y)
    qu = _host_unpack(packed[:, sy: sy + sc], cfg.n_blocks_c, cfg.levels_c, cfg.groups_c, cfg.qstep_c, cfg.strip_c)
    qv = _host_unpack(packed[:, sy + sc:], cfg.n_blocks_c, cfg.levels_c, cfg.groups_c, cfg.qstep_c, cfg.strip_c)
    return _host_idct(qy, H, W), _host_idct(qu, H // 2, W // 2), _host_idct(qv, H // 2, W // 2)


def _planes_to_output(y, u, v, H: int, W: int, out: str) -> np.ndarray:
    B = y.shape[0]
    # +0.5-and-truncate rounding (matches the C++ decoder; np.round's
    # banker rounding is also ~20x slower)
    to8 = lambda p: np.clip(p + 128.5, 0.0, 255.0).astype(np.uint8)
    yuv = np.concatenate(
        [to8(y).reshape(B, -1), to8(u).reshape(B, -1), to8(v).reshape(B, -1)], axis=1
    ).reshape(B, 3 * H // 2, W)
    if out == "yuv420":
        return yuv
    if out == "rgb":
        return yuv420_to_rgb(yuv)
    raise ValueError(f"unknown output format {out!r}")


def decode_frames(packed, cfg: CodecConfig, out: str = "yuv420", decoder: str = "native") -> np.ndarray:
    """Host intra decode: (B, frame_bytes) uint8 -> yuv420p frames (B, 3H/2, W) uint8 (the ffmpeg rawvideo
    layout) or RGB (B, H, W, 3) with out="rgb"; decoder="numpy" is the plain version."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    packed = np.ascontiguousarray(np.asarray(packed, np.uint8))
    if packed.ndim == 1:
        packed = packed[None]
    if packed.shape[1] != cfg.frame_bytes:
        raise ValueError(f"{packed.shape[1]} bytes a frame, the plan has {cfg.frame_bytes}")
    y, u, v = _decode_planes(packed, cfg, decoder)
    return _planes_to_output(y, u, v, cfg.height, cfg.width, out)


def yuv420_to_rgb(yuv: np.ndarray) -> np.ndarray:
    """(B, 3H/2, W) I420 uint8 -> (B, H, W, 3) uint8 (BT.601 limited)."""
    B, H32, W = yuv.shape
    H = H32 * 2 // 3
    flat = yuv.reshape(B, -1)
    y = flat[:, : H * W].reshape(B, H, W).astype(np.float32)
    u = flat[:, H * W : H * W + H * W // 4].reshape(B, H // 2, W // 2).astype(np.float32)
    v = flat[:, H * W + H * W // 4 :].reshape(B, H // 2, W // 2).astype(np.float32)
    up = lambda c: np.repeat(np.repeat(c, 2, axis=1), 2, axis=2)
    u, v = up(u) - 128.0, up(v) - 128.0
    yf = (y - 16.0) * (255.0 / 219.0)
    r = yf + v / (224.0 / 255.0 * 0.5 / (1.0 - 0.299))
    b = yf + u / (224.0 / 255.0 * 0.5 / (1.0 - 0.114))
    g = (yf - 0.299 * r - 0.114 * b) / 0.587
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)
