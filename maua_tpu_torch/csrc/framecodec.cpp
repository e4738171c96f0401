// Host-side decoder for the on-device DCT frame codec
// (maua_tpu/ops/framecodec.py). The device packs quantized 8x8 DCT
// coefficients into strip-level mixed-radix uint32 words (a STRIP is
// up to 4 adjacent blocks packed jointly; a position may SPLIT across
// words, its digits recombining as sum digit*prediv). This kernel
// unpacks, dequantizes and inverse-transforms planes, OpenMP-parallel
// over strips — the decode must keep up with the device->host fetch
// so the ffmpeg pipe (maua_tpu/ops/video.py) never stalls on it.
//
// Replaces the role of host-side swscale in the reference's rawvideo
// pipe (maua/ops/video.py:42-77); numpy fallback lives in
// framecodec._host_unpack/_host_idct.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

// Exact unsigned division by a constant via multiply-shift (libdivide
// style): q = (w * M) >> s for all w < 2^32 when M = ceil(2^s / L),
// s = 32 + ceil(log2(L)). Hardware divides dominated the unpack loop
// (~1M divmods per 1024^2 frame); this makes them two multiplies.
struct MagicDiv {
  uint64_t M;
  int s;
  uint32_t L;
  void init(uint32_t l) {
    L = l;
    int lg = 0;
    while ((1u << lg) < l) ++lg;
    s = 32 + lg;
    M = ((static_cast<unsigned __int128>(1) << s) + l - 1) / l;
  }
  inline uint32_t divmod(uint32_t w, uint32_t* rem) const {
    uint32_t q = static_cast<uint32_t>(
        (static_cast<unsigned __int128>(w) * M) >> s);
    *rem = w - q * L;
    return q;
  }
};

struct DctTable {
  float D[8][8];  // orthonormal DCT-II matrix
  DctTable() {
    const double pi = 3.14159265358979323846;
    for (int k = 0; k < 8; ++k)
      for (int n = 0; n < 8; ++n) {
        double v = 0.5 * std::cos((2 * n + 1) * k * pi / 16.0);
        if (k == 0) v *= 1.0 / std::sqrt(2.0);
        D[k][n] = static_cast<float>(v);
      }
  }
};
const DctTable kDct;

// Per-plane slot tables prepared once per call: magic divisors per
// slot plus per-position centering offsets.
struct SlotTables {
  MagicDiv* mag;     // one per slot
  int64_t nslots;
  void init(int64_t nw, const int64_t* goff, const int64_t* radix) {
    nslots = goff[nw];
    mag = new MagicDiv[nslots > 0 ? nslots : 1];
    for (int64_t k = 0; k < nslots; ++k)
      mag[k].init(static_cast<uint32_t>(radix[k]));
  }
  ~SlotTables() { delete[] mag; }
};

// Unpack one strip's words into per-position integer accumulators
// (acc[strip*64], caller-zeroed), digits recombining as digit*prediv.
inline void unpack_strip(const uint8_t* src, int64_t nw, const int64_t* goff,
                         const int64_t* gidx, const int64_t* prediv,
                         const MagicDiv* mag, int32_t* acc) {
  for (int64_t w = 0; w < nw; ++w) {
    uint32_t word = static_cast<uint32_t>(src[w * 4]) |
                    (static_cast<uint32_t>(src[w * 4 + 1]) << 8) |
                    (static_cast<uint32_t>(src[w * 4 + 2]) << 16) |
                    (static_cast<uint32_t>(src[w * 4 + 3]) << 24);
    for (int64_t k = goff[w]; k < goff[w + 1]; ++k) {
      uint32_t d;
      word = mag[k].divmod(word, &d);
      acc[gidx[k]] += static_cast<int32_t>(d) * static_cast<int32_t>(prediv[k]);
    }
  }
}

// Centered float coefficients for one block out of a strip's integer
// accumulators + the separable sparse IDCT. Tracks which coefficient
// rows/cols hold ANY nonzero and transforms only those (pass 1 over
// live rows, pass 2 over live cols): cost nc*(nr+8) 8-wide FMAs
// instead of the dense 128. `add` accumulates into px (DPCM).
inline void idct_block(const int32_t* acc, const int32_t* mid,
                       const int64_t* live, int64_t nlive, float qstep,
                       float* px, bool add) {
  float coef[64];
  std::memset(coef, 0, sizeof(coef));
  uint32_t rowmask = 0, colmask = 0;
  for (int64_t k = 0; k < nlive; ++k) {
    const int64_t i = live[k];
    const int32_t c = acc[i] - mid[i];
    if (c != 0) {
      coef[i] = static_cast<float>(c) * qstep;
      rowmask |= 1u << (i >> 3);
      colmask |= 1u << (i & 7);
    }
  }
  if (rowmask == 0) {  // all-zero block: DPCM carry unchanged
    if (!add) std::memset(px, 0, 64 * sizeof(float));
    return;
  }
  int urows[8], nr = 0, vcols[8], nc = 0;
  for (int u = 0; u < 8; ++u)
    if (rowmask >> u & 1) urows[nr++] = u;
  for (int v = 0; v < 8; ++v)
    if (colmask >> v & 1) vcols[nc++] = v;
  float tmp[8][8];  // tmp[c][i] for vcols[c]
  for (int c = 0; c < nc; ++c) {
    const int j = vcols[c];
    float a[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int t = 0; t < nr; ++t) {
      const int u = urows[t];
      const float cf = coef[u * 8 + j];
      for (int i = 0; i < 8; ++i) a[i] += cf * kDct.D[u][i];
    }
    for (int i = 0; i < 8; ++i) tmp[c][i] = a[i];
  }
  for (int i = 0; i < 8; ++i) {
    float a[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int c = 0; c < nc; ++c) {
      const float tv = tmp[c][i];
      for (int j = 0; j < 8; ++j) a[j] += tv * kDct.D[vcols[c]][j];
    }
    if (add)
      for (int j = 0; j < 8; ++j) px[i * 8 + j] += a[j];
    else
      for (int j = 0; j < 8; ++j) px[i * 8 + j] = a[j];
  }
}

// Per-position mid offsets + live position list from a 64-entry level
// table. Even level counts mark ESCAPE-coded positions (framecodec.py:
// base alphabet [-m, m] at radix 2m+2; the top symbol 2m+1 is the
// escape marker whose exact int16 value ships in a side stream).
// order2 (may be null) flags positions shipping SECOND differences:
// the decoder keeps a per-block velocity accumulator for them and
// integrates twice.
struct LevelInfo {
  int32_t mid[64];
  int64_t live[64];
  int64_t nlive = 0;
  int64_t escp[64];
  int32_t marker[64];
  int64_t nesc = 0;
  int64_t ord2[64];
  int64_t nord2 = 0;
  void init(const int64_t* levels, const int64_t* order2 = nullptr) {
    for (int i = 0; i < 64; ++i) {
      mid[i] = static_cast<int32_t>((levels[i] - 1) / 2);
      if (levels[i] > 1) {
        live[nlive++] = i;
        if (levels[i] % 2 == 0) {
          escp[nesc] = i;
          marker[nesc] = static_cast<int32_t>(levels[i] - 1);
          ++nesc;
        }
        if (order2 != nullptr && order2[i]) ord2[nord2++] = i;
      }
    }
  }
};

}  // namespace

extern "C" {

// Intra-frame plane decode to centered f32. packed: (B, ns, nw)
// little-endian uint32 words as raw bytes, ns = nb/strip strips.
// goff: nw+1 prefix offsets into the slot arrays gidx/radix/prediv
// (slot digit d contributes d*prediv to strip position gidx, indexed
// block_in_strip*64 + row-major coefficient). levels: 64 per-position
// level counts (centering). out: (B, H, W) f32 centered samples.
int framecodec_decode_plane_f32(const uint8_t* packed, int64_t B, int64_t H,
                                int64_t W, int64_t strip, int64_t nw,
                                const int64_t* goff, const int64_t* gidx,
                                const int64_t* radix, const int64_t* prediv,
                                const int64_t* levels, double qstep,
                                float* out) {
  if (H % 8 || W % 8 || strip < 1 || strip > 4) return 1;
  const int64_t bh = H / 8, bw = W / 8;
  const int64_t nb = bh * bw;
  if (nb % strip) return 1;
  const int64_t ns = nb / strip;
  const int64_t total = B * ns;
  SlotTables st;
  st.init(nw, goff, radix);
  LevelInfo li;
  li.init(levels);
  const float q = static_cast<float>(qstep);

#pragma omp parallel for schedule(static)
  for (int64_t t = 0; t < total; ++t) {
    const int64_t b = t / ns, s = t % ns;
    int32_t acc[4 * 64];
    std::memset(acc, 0, sizeof(int32_t) * strip * 64);
    unpack_strip(packed + t * nw * 4, nw, goff, gidx, prediv, st.mag, acc);
    for (int64_t k = 0; k < strip; ++k) {
      const int64_t blk = s * strip + k;
      const int64_t by = blk / bw, bx = blk % bw;
      float px[64];
      idct_block(acc + k * 64, li.mid, li.live, li.nlive, q, px, false);
      float* dst = out + (b * H + by * 8) * W + bx * 8;
      for (int i = 0; i < 8; ++i)
        for (int j = 0; j < 8; ++j) dst[i * W + j] = px[i * 8 + j];
    }
  }
  return 0;
}

// DPCM chunk decode for one plane, straight to uint8: the intra frame
// plus (nkf-1) delta frames accumulate per strip entirely in
// registers/L1; coded frames land at `keyframes[k]` and frames between
// consecutive keyframes are linearly interpolated (temporal chroma
// subsampling — for full-rate planes pass keyframes = 0..T-1). Each
// emitted frame's samples are written as clip(round(acc + 128)) into
// the caller's frame-strided output (so the bytes land directly inside
// a (T, 3H/2, W) I420 array). One pass, no float arrays in memory.
int framecodec_decode_plane_chunk_u8(
    const uint8_t* intra, const uint8_t* deltas, int64_t nkf,
    const int64_t* keyframes, int64_t H, int64_t W, int64_t strip,
    int64_t nw_i, const int64_t* goff_i, const int64_t* gidx_i,
    const int64_t* radix_i, const int64_t* prediv_i, const int64_t* levels_i,
    double qstep_i, int64_t nw_d, const int64_t* goff_d,
    const int64_t* gidx_d, const int64_t* radix_d, const int64_t* prediv_d,
    const int64_t* levels_d, double qstep_d, uint8_t* out,
    int64_t frame_stride, const int32_t* exc_off, const int16_t* exc_val,
    const int64_t* order2) {
  if (H % 8 || W % 8 || nkf < 1 || strip < 1 || strip > 4) return 1;
  const int64_t bh = H / 8, bw = W / 8;
  const int64_t nb = bh * bw;
  if (nb % strip) return 1;
  const int64_t ns = nb / strip;
  SlotTables st_i, st_d;
  st_i.init(nw_i, goff_i, radix_i);
  st_d.init(nw_d, goff_d, radix_d);
  LevelInfo li_i, li_d;
  li_i.init(levels_i);
  li_d.init(levels_d, order2);
  const float qi = static_cast<float>(qstep_i);
  const float qd = static_cast<float>(qstep_d);

#pragma omp parallel for schedule(static)
  for (int64_t s = 0; s < ns; ++s) {
    float pix[4][64];   // DPCM pixel accumulators per block of the strip
    float prev[4][64];  // previous keyframe (chroma interpolation)
    int32_t acc[4 * 64];
    int32_t vel[4 * 64];  // order-2 velocity accumulators (integer, exact)
    std::memset(vel, 0, sizeof(int32_t) * strip * 64);

    auto emit = [&](int64_t t, int64_t k, const float* px) {
      const int64_t blk = s * strip + k;
      const int64_t by = blk / bw, bx = blk % bw;
      uint8_t* dst = out + t * frame_stride + (by * 8) * W + bx * 8;
      for (int i = 0; i < 8; ++i)
        for (int j = 0; j < 8; ++j) {
          float v = px[i * 8 + j] + 128.5f;
          v = v < 0.f ? 0.f : (v > 255.f ? 255.f : v);
          dst[i * W + j] = static_cast<uint8_t>(v);
        }
    };

    std::memset(acc, 0, sizeof(int32_t) * strip * 64);
    unpack_strip(intra + s * nw_i * 4, nw_i, goff_i, gidx_i, prediv_i,
                 st_i.mag, acc);
    for (int64_t k = 0; k < strip; ++k) {
      idct_block(acc + k * 64, li_i.mid, li_i.live, li_i.nlive, qi, pix[k],
                 false);
      emit(keyframes[0], k, pix[k]);
    }
    for (int64_t f = 1; f < nkf; ++f) {
      std::memcpy(prev, pix, sizeof(float) * strip * 64);
      std::memset(acc, 0, sizeof(int32_t) * strip * 64);
      unpack_strip(deltas + ((f - 1) * ns + s) * nw_d * 4, nw_d, goff_d,
                   gidx_d, prediv_d, st_d.mag, acc);
      if (exc_val != nullptr && li_d.nesc > 0) {
        // substitute escape markers with their exact side-stream values
        // (scan order: ascending block-in-strip, ascending position —
        // matching the encoder's (frame, strip, symbol) rank order)
        int64_t ptr = exc_off[(f - 1) * ns + s];
        for (int64_t k = 0; k < strip; ++k)
          for (int64_t e = 0; e < li_d.nesc; ++e) {
            const int64_t i = li_d.escp[e];
            int32_t* a32 = &acc[k * 64 + i];
            if (*a32 == li_d.marker[e])
              *a32 = static_cast<int32_t>(exc_val[ptr++]) + li_d.mid[i];
          }
      }
      // order-2 positions: integrate the decoded second difference into
      // the velocity, then hand the velocity to the (pixel-domain)
      // DPCM accumulation as this frame's coefficient delta
      for (int64_t k = 0; k < strip; ++k)
        for (int64_t e = 0; e < li_d.nord2; ++e) {
          const int64_t i = li_d.ord2[e];
          int32_t* a32 = &acc[k * 64 + i];
          vel[k * 64 + i] += *a32 - li_d.mid[i];
          *a32 = vel[k * 64 + i] + li_d.mid[i];
        }
      const int64_t a = keyframes[f - 1], b = keyframes[f];
      for (int64_t k = 0; k < strip; ++k) {
        idct_block(acc + k * 64, li_d.mid, li_d.live, li_d.nlive, qd, pix[k],
                   true);
        for (int64_t j = a + 1; j < b; ++j) {
          const float w = static_cast<float>(j - a) / static_cast<float>(b - a);
          float px[64];
          for (int i = 0; i < 64; ++i)
            px[i] = (1.f - w) * prev[k][i] + w * pix[k][i];
          emit(j, k, px);
        }
        emit(b, k, pix[k]);
      }
    }
  }
  return 0;
}

}  // extern "C"
