"""Host C++ kernels bound with ctypes, and their torch counterparts on a tensor's device.

Port of `maua_tpu/native.py`: multi-quantiles by recursive partial
sorting (`efficient_quantile`, `kthvalue`), the raster back-substitution
that inverts an emerging (masked autoregressive) convolution
(`inverse_conv`), and the frame codec's host decoders (a scalar and an
AVX-512 chunk decoder straight into the I420 layout; an intra plane
decoder to f32). The sources are the port's own copies under
`maua_tpu_torch/csrc/*.cpp`; g++ builds them into one library in
`maua_tpu_torch/_build/` at the first call that needs it (nothing is
built at import), named by a hash of the sources and the flags, written
under a temporary name and moved into place, so that processes building
at once do not race. A failed build or a failed call raises: there is no
fallback to numpy. `_inverse_conv_py` and numpy's quantiles are the plain
versions the tests compare against.

The library's OpenMP threads follow `torch.get_num_threads()` at each
call (PyTorch's own OpenMP runtime is not the one g++ links).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("efficient_quantile.cpp", "inverse_conv.cpp", "framecodec.cpp", "framecodec_simd.cpp",
           "native_threads.cpp")
GXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-fopenmp"]

_LOCK = threading.Lock()
_LIB = None

_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)
_I64P_T = ctypes.POINTER(ctypes.c_int64)
_U8P_T = ctypes.POINTER(ctypes.c_uint8)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for s in SOURCES:
        h.update((CSRC / s).read_bytes())
    return BUILD_DIR / f"libmaua_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the host sources unless the library for them exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *GXX_FLAGS, *[str(CSRC / s) for s in SOURCES], "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: the host kernels need it ({e})") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for the host kernels:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.efficient_quantile_f32.restype = ctypes.c_int
    lib.efficient_quantile_f32.argtypes = [_F32P, ctypes.c_int64, _F64P, ctypes.c_int64, _F64P, ctypes.c_int]
    lib.kthvalue_f32.restype = ctypes.c_float
    lib.kthvalue_f32.argtypes = [_F32P, ctypes.c_int64, ctypes.c_int64]
    lib.inverse_conv_f32.restype = None
    lib.inverse_conv_f32.argtypes = [_F32P, _F32P, _F32P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    lib.framecodec_decode_plane_f32.restype = ctypes.c_int
    lib.framecodec_decode_plane_f32.argtypes = [
        _U8P_T, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _I64P_T, _I64P_T, _I64P_T, _I64P_T, _I64P_T, ctypes.c_double, _F32P]
    chunk_sig = [
        _U8P_T, _U8P_T, ctypes.c_int64, _I64P_T, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, _I64P_T, _I64P_T, _I64P_T, _I64P_T, _I64P_T, ctypes.c_double,
        ctypes.c_int64, _I64P_T, _I64P_T, _I64P_T, _I64P_T, _I64P_T, ctypes.c_double,
        _U8P_T, ctypes.c_int64,
        # escape-coded delta positions: per-(frame, strip) offsets into the exception stream and its exact
        # int16 values (NULL: no escapes); then 64 prediction-order flags (NULL: all order 1)
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int16), _I64P_T]
    lib.framecodec_decode_plane_chunk_u8.restype = ctypes.c_int
    lib.framecodec_decode_plane_chunk_u8.argtypes = chunk_sig
    # the AVX-512 chunk decoder: the same contract; 2 means this geometry cannot take the vector path
    lib.framecodec_decode_plane_chunk_u8_simd.restype = ctypes.c_int
    lib.framecodec_decode_plane_chunk_u8_simd.argtypes = chunk_sig
    lib.framecodec_simd_available.restype = ctypes.c_int
    lib.framecodec_simd_available.argtypes = []
    lib.maua_native_set_threads.restype = None
    lib.maua_native_set_threads.argtypes = [ctypes.c_int]
    return lib


def _lib() -> ctypes.CDLL:
    """The bound library (built at the first call), its threads set to torch's count."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(str(build())))
    _LIB.maua_native_set_threads(torch.get_num_threads())
    return _LIB


def available() -> bool:
    """Whether the host kernels build and load (raises nothing)."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def simd_available() -> bool:
    """Whether this build's chunk decoder has its AVX-512 path."""
    return bool(_lib().framecodec_simd_available())


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a, np.float32))


def efficient_quantile(values, qs: Sequence[float], ignore_nan: bool = False) -> np.ndarray:
    """Quantiles (float64) of a large host array by recursive partial sorting; numpy's `quantile` (or
    `nanquantile` with ignore_nan) is its plain version."""
    arr = _f32(values).reshape(-1).copy()
    q = np.ascontiguousarray(np.asarray(qs, np.float64).reshape(-1))
    out = np.empty(len(q), np.float64)
    rc = _lib().efficient_quantile_f32(arr.ctypes.data_as(_F32P), arr.size, q.ctypes.data_as(_F64P), q.size,
                                       out.ctypes.data_as(_F64P), int(ignore_nan))
    if rc != 0:
        raise ValueError(f"efficient_quantile failed with code {rc}")
    return out


def kthvalue(values, k: int) -> float:
    """The k-th smallest element (1-based); np.partition is its plain version."""
    arr = _f32(values).reshape(-1).copy()
    if not 1 <= k <= arr.size:
        raise ValueError(f"k={k} outside 1..{arr.size}")
    return float(_lib().kthvalue_f32(arr.ctypes.data_as(_F32P), arr.size, int(k)))


def inverse_conv(z, w, is_upper: bool = False, dilation: int = 1) -> np.ndarray:
    """Invert an emerging convolution on the host: x with conv(x, w) = z (same padding, correlation).
    z: (B, H, W, C), w: (K, K, C_in, C_out), a masked weight whose taps reach only positions the raster
    order has solved (see gan/models_experimental.masked_emerging_weight)."""
    z, w = _f32(z), _f32(w)
    b, h, ww, c = z.shape
    x = np.zeros_like(z)
    _lib().inverse_conv_f32(z.ctypes.data_as(_F32P), w.ctypes.data_as(_F32P), x.ctypes.data_as(_F32P),
                            b, h, ww, c, w.shape[0], int(is_upper), int(dilation))
    return x


def _inverse_conv_py(z, w, is_upper, dilation):
    """The plain version of `inverse_conv`: the same loop nest in Python."""
    z, w = _f32(z), _f32(w)
    b, height, width, channels = z.shape
    ksize = w.shape[0]
    kcenter = (ksize - 1) // 2
    x = np.zeros_like(z)
    c_range = range(channels - 1, -1, -1) if is_upper else range(channels)
    j_range = range(height) if is_upper else range(height - 1, -1, -1)
    i_range = range(width) if is_upper else range(width - 1, -1, -1)
    for bb in range(b):
        for j in j_range:
            for i in i_range:
                for c_out in c_range:
                    acc = 0.0
                    for c_in in range(channels):
                        for k in range(ksize):
                            for m in range(ksize):
                                if k == kcenter and m == kcenter and c_in == c_out:
                                    continue
                                j_ = j + (k - kcenter) * dilation
                                i_ = i + (m - kcenter) * dilation
                                if not (0 <= j_ < height and 0 <= i_ < width):
                                    continue
                                acc -= w[k, m, c_in, c_out] * x[bb, j_, i_, c_in]
                    x[bb, j, i, c_out] = (acc + z[bb, j, i, c_out]) / w[kcenter, kcenter, c_out, c_out]
    return x


def _codec_tables(levels, groups):
    """Slot tables for the C++ decoders: per-word prefix offsets and flat (gidx, radix, prediv) slot arrays
    (ops/framecodec._plan_words' layout; gidx indexes block_in_strip * 64 + position, and a split position's
    digits recombine as digit * prediv)."""
    nw = len(groups)
    lev = np.ascontiguousarray(np.asarray(levels, np.int64))
    off = np.zeros(nw + 1, np.int64)
    gidx, radix, prediv = [], [], []
    for gi, grp in enumerate(groups):
        for idx, r, pd in grp:
            gidx.append(idx)
            radix.append(r)
            prediv.append(pd)
        off[gi + 1] = len(gidx)

    def arr(a):
        return np.ascontiguousarray(np.asarray(a if a else [1], np.int64))

    return nw, lev, off, arr(gidx), arr(radix), arr(prediv)


def _i64p(a):
    return a.ctypes.data_as(_I64P_T)


def _u8p(a):
    return a.ctypes.data_as(_U8P_T)


def _decode_plane(packed: np.ndarray, H: int, W: int, levels, groups, qstep: float, strip: int) -> np.ndarray:
    """One intra plane: packed (B, strips * words * 4) uint8 -> centered f32 (B, H, W)."""
    lib = _lib()
    B = packed.shape[0]
    nw, lev, off, idx, rad, pdv = _codec_tables(levels, groups)
    out = np.empty((B, H, W), np.float32)
    packed = np.ascontiguousarray(packed)
    rc = lib.framecodec_decode_plane_f32(_u8p(packed), B, H, W, strip, nw, _i64p(off), _i64p(idx), _i64p(rad),
                                         _i64p(pdv), _i64p(lev), float(qstep), out.ctypes.data_as(_F32P))
    if rc != 0:
        raise ValueError(f"framecodec_decode_plane_f32 failed with code {rc}")
    return out


def framecodec_decode_chunk_u8(intra: np.ndarray, deltas, codec, n_frames: int, simd: bool = True) -> np.ndarray:
    """A whole DPCM chunk straight into the I420 layout: the intra frame's bytes and the flat delta stream
    ([luma | u | v] sections, chroma on the codec's keyframe lattice, then the escape sections) ->
    (T, 3H/2, W) uint8, one C++ pass per plane (unpack, inverse DCT, accumulation, chroma interpolation,
    rounding). The AVX-512 decoder takes a plane where the build has it and the geometry allows (rc 2 hands
    the plane to the scalar one); simd=False asks for the scalar decoder everywhere."""
    lib = _lib()
    ci, cd = codec.intra, codec.delta
    H, W = ci.height, ci.width
    T = int(n_frames)
    intra = np.ascontiguousarray(np.asarray(intra, np.uint8).reshape(-1))
    flat = np.ascontiguousarray(
        np.zeros((0,), np.uint8) if deltas is None else np.asarray(deltas, np.uint8).reshape(-1))
    out = np.empty((T, 3 * H // 2, W), np.uint8)
    frame_stride = out.strides[0]

    ks_full = np.ascontiguousarray(np.arange(T, dtype=np.int64))
    ks_chroma = np.ascontiguousarray(np.asarray(codec.chroma_keyframes(T), np.int64))
    sy = (T - 1) * codec.luma_delta_bytes
    sc = (len(ks_chroma) - 1) * codec.chroma_delta_bytes

    # the escape sections trail the base sections as [counts values] per plane; each (delta frame, strip)'s
    # offset into the values is the prefix sum of the uint16 counts
    def esc_arrays(off, cbytes, vbytes):
        if vbytes == 0:
            return None, None, off
        counts = np.frombuffer(flat[off: off + cbytes].tobytes(), dtype="<u2").astype(np.int64)
        offs = np.ascontiguousarray(np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32))
        vals = np.ascontiguousarray(flat[off + cbytes: off + cbytes + vbytes])
        return offs, vals, off + cbytes + vbytes

    ecy, evy = codec.esc_section_bytes(T - 1, "y")
    ecc, evc = codec.esc_section_bytes(len(ks_chroma) - 1, "c")
    eoff = sy + 2 * sc
    off_y, val_y, eoff = esc_arrays(eoff, ecy, evy)
    off_u, val_u, eoff = esc_arrays(eoff, ecc, evc)
    off_v, val_v, eoff = esc_arrays(eoff, ecc, evc)

    def order_flags(flags):
        return np.ascontiguousarray(np.asarray(flags, np.int64)) if flags else None

    o2y, o2c = order_flags(codec.order2_y), order_flags(codec.order2_c)
    planes = [
        (H, W, 0, ci.plane_bytes_y, flat[:sy], ks_full, ci.strip_y,
         ci.levels_y, ci.groups_y, ci.qstep_y, cd.levels_y, cd.groups_y, cd.qstep_y, off_y, val_y, o2y),
        (H // 2, W // 2, H * W, ci.plane_bytes_c, flat[sy: sy + sc], ks_chroma, ci.strip_c,
         ci.levels_c, ci.groups_c, ci.qstep_c, cd.levels_c, cd.groups_c, cd.qstep_c, off_u, val_u, o2c),
        (H // 2, W // 2, H * W + H * W // 4, ci.plane_bytes_c, flat[sy + sc: sy + 2 * sc], ks_chroma, ci.strip_c,
         ci.levels_c, ci.groups_c, ci.qstep_c, cd.levels_c, cd.groups_c, cd.qstep_c, off_v, val_v, o2c),
    ]
    base = out.ctypes.data
    use_simd = simd and lib.framecodec_simd_available()
    ioff = 0
    for (ph, pw, out_off, isz, dsec, ks, strip, lev_i, grp_i, q_i, lev_d, grp_d, q_d, eoffs, evals, o2) in planes:
        nw_i, li, oi, xi, ri, pi = _codec_tables(lev_i, grp_i)
        nw_d, ld, od, xd, rd, pd = _codec_tables(lev_d, grp_d)
        isec = np.ascontiguousarray(intra[ioff: ioff + isz])
        dsec = np.ascontiguousarray(dsec)
        args = (
            _u8p(isec), _u8p(dsec), len(ks), _i64p(ks), ph, pw, strip,
            nw_i, _i64p(oi), _i64p(xi), _i64p(ri), _i64p(pi), _i64p(li), float(q_i),
            nw_d, _i64p(od), _i64p(xd), _i64p(rd), _i64p(pd), _i64p(ld), float(q_d),
            ctypes.cast(base + out_off, _U8P_T), frame_stride,
            None if eoffs is None else eoffs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            None if evals is None else ctypes.cast(evals.ctypes.data, ctypes.POINTER(ctypes.c_int16)),
            None if o2 is None else _i64p(o2),
        )
        rc = lib.framecodec_decode_plane_chunk_u8_simd(*args) if use_simd else 2
        if rc == 2:  # no AVX-512 in this build, or a strip count the vector path does not take
            rc = lib.framecodec_decode_plane_chunk_u8(*args)
        if rc != 0:
            raise ValueError(f"framecodec_decode_plane_chunk_u8 failed with code {rc}")
        ioff += isz
    return out


def framecodec_decode_planes(packed: np.ndarray, cfg):
    """Intra frames (B, frame_bytes) uint8 -> centered f32 (y, u, v) planes."""
    H, W = cfg.height, cfg.width
    sy, sc = cfg.plane_bytes_y, cfg.plane_bytes_c
    y = _decode_plane(packed[:, :sy], H, W, cfg.levels_y, cfg.groups_y, cfg.qstep_y, cfg.strip_y)
    u = _decode_plane(packed[:, sy: sy + sc], H // 2, W // 2, cfg.levels_c, cfg.groups_c, cfg.qstep_c, cfg.strip_c)
    v = _decode_plane(packed[:, sy + sc:], H // 2, W // 2, cfg.levels_c, cfg.groups_c, cfg.qstep_c, cfg.strip_c)
    return y, u, v


# ------------------------------------------------------------------ on a tensor's device
def quantile_sorted(s: torch.Tensor, q, dim: int = 0) -> torch.Tensor:
    """Linear-interpolation quantiles of `s`, already sorted along `dim`, in `s`'s float dtype: jnp.quantile's
    arithmetic (positions q * (n - 1) in that dtype, the two neighbours weighted), where torch.quantile refuses
    inputs above 2^24 elements. A NaN in a slice gives NaN, as in jnp.quantile."""
    n = s.shape[dim]
    qt = torch.as_tensor(q, dtype=s.dtype, device=s.device)
    pos = qt * torch.tensor(n - 1, dtype=s.dtype, device=s.device)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1 - hw
    low = low.clamp(0, n - 1).long()
    high = high.clamp(0, n - 1).long()
    lo_v = s.index_select(dim, low.reshape(-1))
    hi_v = s.index_select(dim, high.reshape(-1))
    shape = [1] * s.dim()
    shape[dim] = -1
    out = lo_v * lw.reshape(-1).reshape(shape) + hi_v * hw.reshape(-1).reshape(shape)
    if qt.dim() == 0:
        out = out.squeeze(dim)
    return out


def quantile_device(values, qs) -> torch.Tensor:
    """Quantiles of every element of `values` by a sort on its device (the torch counterpart of
    efficient_quantile for data that lives on the card), interpolated as jnp.quantile does."""
    x = torch.as_tensor(values)
    if not x.is_floating_point():
        x = x.float()
    flat = x.reshape(-1)
    s = torch.sort(flat).values
    if torch.isnan(flat).any():
        s = torch.full_like(s, float("nan"))
    return quantile_sorted(s, qs, dim=0)


def inverse_conv_device(z, w, is_upper: bool = False, dilation: int = 1) -> torch.Tensor:
    """`inverse_conv` on the tensors' device: a raster scan over pixels in the order of the host kernel, each
    pixel's taps gathered from the already-solved neighbourhood and its centre tap solved as a triangular
    system over channels (ascending for the lower mask, descending for the upper). Sequential by nature: a
    correct loop, there for completeness; the host kernel is the one for bulk work."""
    z = torch.as_tensor(z)
    w = torch.as_tensor(w, device=z.device, dtype=z.dtype)
    b, height, width, channels = z.shape
    ksize = w.shape[0]
    kc = (ksize - 1) // 2
    pad = kc * dilation
    centre = w[kc, kc]  # (C_in, C_out): its diagonal and the strictly solved triangle
    w_off = w.clone()
    w_off[kc, kc] = 0
    xp = z.new_zeros(b, height + 2 * pad, width + 2 * pad, channels)
    span = (ksize - 1) * dilation + 1
    rows = range(height) if is_upper else range(height - 1, -1, -1)
    cols = range(width) if is_upper else range(width - 1, -1, -1)
    for j in rows:
        for i in cols:
            win = xp[:, j: j + span: dilation, i: i + span: dilation, :]  # (B, K, K, C)
            acc = torch.einsum("bkmc,kmcd->bd", win, w_off)
            # x @ centre = z - acc, centre triangular: lower mask -> upper triangular (c_in < c_out), and back
            xp[:, j + pad, i + pad, :] = torch.linalg.solve_triangular(centre, z[:, j, i, :] - acc,
                                                                       upper=not is_upper, left=False)
    return xp[:, pad: pad + height, pad: pad + width, :].contiguous()
