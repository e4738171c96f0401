// AVX-512 chunk decoder for the DCT frame codec — the scalar kernel in
// framecodec.cpp decodes ~25-38 ms/frame at 1024p on the 1-core bench
// host, which puts host decode on the e2e critical path (the decode
// must overlap the parallel device->host fetch it shares the core
// with). This version vectorizes across 16 STRIPS at once (every strip
// shares the same static word layout, so the mixed-radix unpack, the
// dense 8x8 IDCT and the DPCM accumulation are perfectly data-parallel
// across strips):
//
//  - unpack: one 16-lane gather per word, branchfree magic division
//    (libdivide u32 style: q = (((w - mulhi(M,w)) >> 1) + mulhi(M,w))
//    >> sh) per slot, digits recombining as d*prediv into transposed
//    i32 accumulators acc[pos][16].
//  - IDCT: dense two-pass 8x8 transform over 16-lane f32 vectors
//    (64 FMA-512 per pass per 16 blocks); all-zero coefficient groups
//    short-circuit.
//  - DPCM: pixel accumulators pix[pos][16] persist across the chunk's
//    frames per strip-group (L1-resident), matching the scalar
//    decoder's accumulate-in-registers design.
//  - emit: 16x16 f32 transpose networks turn lane-major pixels into
//    per-block rows, saturating cvt to uint8, 8-byte row stores into
//    the caller's I420 layout (with linear interpolation of skipped
//    chroma frames, same contract as the scalar kernel).
//
// Compiled only when the toolchain targets AVX-512 (the build passes
// -march=native); framecodec.cpp keeps the portable scalar fallback
// and native.py dispatches via framecodec_simd_available().
//
// Role in the reference: the host side of the rawvideo delivery pipe
// (maua/ops/video.py:42-77) — there it is swscale; here the codec is
// ours so the decoder is too.

#include <cstdint>
#include <cstring>

#if defined(__AVX512F__) && defined(__AVX512BW__)
#define MAUA_SIMD 1
#include <immintrin.h>
#else
#define MAUA_SIMD 0
#endif

extern "C" int framecodec_simd_available() { return MAUA_SIMD; }

#if MAUA_SIMD

namespace {

struct DctTableS {
  float D[8][8];
  DctTableS() {
    const double pi = 3.14159265358979323846;
    for (int k = 0; k < 8; ++k)
      for (int n = 0; n < 8; ++n) {
        double v = 0.5 * __builtin_cos((2 * n + 1) * k * pi / 16.0);
        if (k == 0) v *= 0.70710678118654752440;
        D[k][n] = static_cast<float>(v);
      }
  }
};
const DctTableS kDctS;

// libdivide-style branchfree unsigned 32-bit division: with
// M = floor(2^(32+lg)/L) - 2^32 + 1 (always fits u32 for L >= 2,
// lg = ceil(log2 L)) and sh = lg - 1:
//   t = mulhi(M, w); q = ((w - t) >> 1 + t) >> sh  ==  w / L  exactly.
struct VMagic {
  uint32_t M;
  int sh;
  uint32_t L;
  void init(uint32_t l) {
    L = l;
    int lg = 0;
    while ((1u << lg) < l) ++lg;
    if (lg == 0) lg = 1;  // L == 1 never packed, guard anyway
    sh = lg - 1;
    M = static_cast<uint32_t>(
        ((static_cast<unsigned __int128>(1) << (32 + lg)) / l) - (static_cast<uint64_t>(1) << 32) + 1);
  }
};

// mulhi of 16 u32 lanes.
static inline __m512i mulhi_epu32(__m512i a, __m512i b) {
  const __m512i lo = _mm512_mul_epu32(a, b);                       // even lanes
  const __m512i hi = _mm512_mul_epu32(_mm512_srli_epi64(a, 32),
                                      _mm512_srli_epi64(b, 32));   // odd lanes
  // take the high 32 bits of each 64-bit product, re-interleave
  const __m512i lo_h = _mm512_srli_epi64(lo, 32);
  return _mm512_mask_blend_epi32(0xAAAA, lo_h, hi);
}

static inline __m512i vdiv(__m512i w, const VMagic& m) {
  const __m512i t = mulhi_epu32(w, _mm512_set1_epi32(static_cast<int>(m.M)));
  const __m512i q = _mm512_add_epi32(_mm512_srli_epi32(_mm512_sub_epi32(w, t), 1), t);
  return _mm512_srli_epi32(q, m.sh);
}

// Transpose a 16x16 f32 tile held in r[0..15] in place.
static inline void transpose16(__m512 r[16]) {
  __m512 t[16];
  for (int i = 0; i < 8; ++i) {
    t[2 * i] = _mm512_unpacklo_ps(r[2 * i], r[2 * i + 1]);
    t[2 * i + 1] = _mm512_unpackhi_ps(r[2 * i], r[2 * i + 1]);
  }
  for (int i = 0; i < 4; ++i) {
    r[4 * i] = _mm512_castpd_ps(_mm512_unpacklo_pd(_mm512_castps_pd(t[4 * i]),
                                                   _mm512_castps_pd(t[4 * i + 2])));
    r[4 * i + 1] = _mm512_castpd_ps(_mm512_unpackhi_pd(_mm512_castps_pd(t[4 * i]),
                                                       _mm512_castps_pd(t[4 * i + 2])));
    r[4 * i + 2] = _mm512_castpd_ps(_mm512_unpacklo_pd(_mm512_castps_pd(t[4 * i + 1]),
                                                       _mm512_castps_pd(t[4 * i + 3])));
    r[4 * i + 3] = _mm512_castpd_ps(_mm512_unpackhi_pd(_mm512_castps_pd(t[4 * i + 1]),
                                                       _mm512_castps_pd(t[4 * i + 3])));
  }
  const __m512i idx_lo = _mm512_setr_epi32(0, 1, 2, 3, 16, 17, 18, 19, 8, 9, 10, 11, 24, 25, 26, 27);
  const __m512i idx_hi = _mm512_setr_epi32(4, 5, 6, 7, 20, 21, 22, 23, 12, 13, 14, 15, 28, 29, 30, 31);
  for (int i = 0; i < 4; ++i) {
    t[i] = _mm512_permutex2var_ps(r[i], idx_lo, r[i + 4]);
    t[i + 4] = _mm512_permutex2var_ps(r[i], idx_hi, r[i + 4]);
    t[i + 8] = _mm512_permutex2var_ps(r[i + 8], idx_lo, r[i + 12]);
    t[i + 12] = _mm512_permutex2var_ps(r[i + 8], idx_hi, r[i + 12]);
  }
  const __m512i idx2_lo = _mm512_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7, 16, 17, 18, 19, 20, 21, 22, 23);
  const __m512i idx2_hi = _mm512_setr_epi32(8, 9, 10, 11, 12, 13, 14, 15, 24, 25, 26, 27, 28, 29, 30, 31);
  for (int i = 0; i < 8; ++i) {
    r[i] = _mm512_permutex2var_ps(t[i], idx2_lo, t[i + 8]);
    r[i + 8] = _mm512_permutex2var_ps(t[i], idx2_hi, t[i + 8]);
  }
}

struct PlaneTables {
  VMagic* mag;
  int32_t* gidx;
  int32_t* prediv;
  int64_t nslots;
  const int64_t* goff;
  int64_t nw;
  float mid[64];  // centering offset per position (as float for fused dequant)
  int32_t midi[64];
  int32_t escp[64];    // escape-coded positions (even level counts)
  int32_t marker[64];  // escape marker symbol per escape position
  int64_t nesc = 0;
  int32_t ord2[64];  // order-2 (second-difference) positions
  int64_t nord2 = 0;
  void init(int64_t nw_, const int64_t* goff_, const int64_t* gidx_,
            const int64_t* radix_, const int64_t* prediv_, const int64_t* levels,
            const int64_t* order2 = nullptr) {
    nw = nw_;
    goff = goff_;
    nslots = goff_[nw_];
    const int64_t n = nslots > 0 ? nslots : 1;
    mag = new VMagic[n];
    gidx = new int32_t[n];
    prediv = new int32_t[n];
    for (int64_t k = 0; k < nslots; ++k) {
      mag[k].init(static_cast<uint32_t>(radix_[k]));
      gidx[k] = static_cast<int32_t>(gidx_[k]);
      prediv[k] = static_cast<int32_t>(prediv_[k]);
    }
    for (int i = 0; i < 64; ++i) {
      midi[i] = static_cast<int32_t>((levels[i] - 1) / 2);
      mid[i] = static_cast<float>(midi[i]);
      if (levels[i] > 1 && levels[i] % 2 == 0) {
        escp[nesc] = i;
        marker[nesc] = static_cast<int32_t>(levels[i] - 1);
        ++nesc;
      }
      if (order2 != nullptr && order2[i] && levels[i] > 1) ord2[nord2++] = i;
    }
  }
  ~PlaneTables() {
    delete[] mag;
    delete[] gidx;
    delete[] prediv;
  }
};

// Unpack one word layout for 16 strips: src points at the first
// strip's words, stride is nw*4 bytes between consecutive strips.
// acc[pos] (pos < strip*64) accumulates d * prediv per lane.
static inline void unpack_group(const uint8_t* src, int64_t stride,
                                const PlaneTables& pt, __m512i* acc,
                                int64_t npos) {
  for (int64_t p = 0; p < npos; ++p) acc[p] = _mm512_setzero_si512();
  const __m512i vstride = _mm512_mullo_epi32(
      _mm512_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
      _mm512_set1_epi32(static_cast<int>(stride)));
  for (int64_t w = 0; w < pt.nw; ++w) {
    __m512i word = _mm512_i32gather_epi32(vstride, src + w * 4, 1);
    const int64_t k0 = pt.goff[w], k1 = pt.goff[w + 1];
    for (int64_t k = k0; k < k1; ++k) {
      const VMagic& m = pt.mag[k];
      const __m512i q = vdiv(word, m);
      __m512i d = _mm512_sub_epi32(word, _mm512_mullo_epi32(q, _mm512_set1_epi32(static_cast<int>(m.L))));
      const int32_t pd = pt.prediv[k];
      if (pd > 1) d = _mm512_mullo_epi32(d, _mm512_set1_epi32(pd));
      acc[pt.gidx[k]] = _mm512_add_epi32(acc[pt.gidx[k]], d);
      word = q;
    }
  }
}

// Dense 8x8 IDCT of one block-slot over 16 lanes; coef[64] -> out
// added into pix[64] (add=true) or stored (add=false). Skips work when
// every lane of every coefficient is zero.
static inline void idct16(const __m512i* acc, const int32_t* mid, float qstep,
                          __m512* pix, bool add) {
  __m512 c[64];
  __m512i nz = _mm512_setzero_si512();
  const __m512 q = _mm512_set1_ps(qstep);
  for (int i = 0; i < 64; ++i) {
    const __m512i ci = _mm512_sub_epi32(acc[i], _mm512_set1_epi32(mid[i]));
    nz = _mm512_or_si512(nz, ci);
    c[i] = _mm512_mul_ps(_mm512_cvtepi32_ps(ci), q);
  }
  if (_mm512_test_epi32_mask(nz, nz) == 0) {
    if (!add)
      for (int i = 0; i < 64; ++i) pix[i] = _mm512_setzero_ps();
    return;
  }
  __m512 t[64];
  for (int i = 0; i < 8; ++i) {
    __m512 a0 = _mm512_setzero_ps(), a1 = a0, a2 = a0, a3 = a0, a4 = a0, a5 = a0, a6 = a0, a7 = a0;
    for (int u = 0; u < 8; ++u) {
      const __m512 d = _mm512_set1_ps(kDctS.D[u][i]);
      a0 = _mm512_fmadd_ps(d, c[u * 8 + 0], a0);
      a1 = _mm512_fmadd_ps(d, c[u * 8 + 1], a1);
      a2 = _mm512_fmadd_ps(d, c[u * 8 + 2], a2);
      a3 = _mm512_fmadd_ps(d, c[u * 8 + 3], a3);
      a4 = _mm512_fmadd_ps(d, c[u * 8 + 4], a4);
      a5 = _mm512_fmadd_ps(d, c[u * 8 + 5], a5);
      a6 = _mm512_fmadd_ps(d, c[u * 8 + 6], a6);
      a7 = _mm512_fmadd_ps(d, c[u * 8 + 7], a7);
    }
    t[i * 8 + 0] = a0; t[i * 8 + 1] = a1; t[i * 8 + 2] = a2; t[i * 8 + 3] = a3;
    t[i * 8 + 4] = a4; t[i * 8 + 5] = a5; t[i * 8 + 6] = a6; t[i * 8 + 7] = a7;
  }
  for (int i = 0; i < 8; ++i) {
    __m512 a0, a1, a2, a3, a4, a5, a6, a7;
    if (add) {
      a0 = pix[i * 8 + 0]; a1 = pix[i * 8 + 1]; a2 = pix[i * 8 + 2]; a3 = pix[i * 8 + 3];
      a4 = pix[i * 8 + 4]; a5 = pix[i * 8 + 5]; a6 = pix[i * 8 + 6]; a7 = pix[i * 8 + 7];
    } else {
      a0 = a1 = a2 = a3 = a4 = a5 = a6 = a7 = _mm512_setzero_ps();
    }
    for (int v = 0; v < 8; ++v) {
      const __m512 tv = t[i * 8 + v];
      a0 = _mm512_fmadd_ps(tv, _mm512_set1_ps(kDctS.D[v][0]), a0);
      a1 = _mm512_fmadd_ps(tv, _mm512_set1_ps(kDctS.D[v][1]), a1);
      a2 = _mm512_fmadd_ps(tv, _mm512_set1_ps(kDctS.D[v][2]), a2);
      a3 = _mm512_fmadd_ps(tv, _mm512_set1_ps(kDctS.D[v][3]), a3);
      a4 = _mm512_fmadd_ps(tv, _mm512_set1_ps(kDctS.D[v][4]), a4);
      a5 = _mm512_fmadd_ps(tv, _mm512_set1_ps(kDctS.D[v][5]), a5);
      a6 = _mm512_fmadd_ps(tv, _mm512_set1_ps(kDctS.D[v][6]), a6);
      a7 = _mm512_fmadd_ps(tv, _mm512_set1_ps(kDctS.D[v][7]), a7);
    }
    pix[i * 8 + 0] = a0; pix[i * 8 + 1] = a1; pix[i * 8 + 2] = a2; pix[i * 8 + 3] = a3;
    pix[i * 8 + 4] = a4; pix[i * 8 + 5] = a5; pix[i * 8 + 6] = a6; pix[i * 8 + 7] = a7;
  }
}

// Emit 16 blocks (one block-slot across 16 lanes) into the I420
// layout at frame t. vals[pos] holds pix + 128.5 pre-add? No: raw
// centered pixels; the +128.5 offset and clamp happen here.
static inline void emit16(const __m512* pix, uint8_t* out, int64_t frame_off,
                          int64_t W, int64_t bw, int64_t blk0, int64_t strip,
                          int64_t k) {
  // gather the 4 16x16 tiles and transpose them lane-major
  __m512 tile[4][16];
  for (int tq = 0; tq < 4; ++tq) {
    for (int p = 0; p < 16; ++p) tile[tq][p] = pix[tq * 16 + p];
    transpose16(tile[tq]);
  }
  const __m512 off = _mm512_set1_ps(128.5f);
  const __m512 zero = _mm512_setzero_ps();
  const __m512 maxv = _mm512_set1_ps(255.0f);
  for (int lane = 0; lane < 16; ++lane) {
    const int64_t blk = blk0 + lane * strip + k;
    const int64_t by = blk / bw, bx = blk % bw;
    uint8_t* dst = out + frame_off + (by * 8) * W + bx * 8;
    for (int tq = 0; tq < 4; ++tq) {  // 16 pixels = 2 rows per tile chunk
      __m512 v = _mm512_min_ps(_mm512_max_ps(_mm512_add_ps(tile[tq][lane], off), zero), maxv);
      const __m128i b = _mm512_cvtusepi32_epi8(_mm512_cvttps_epi32(v));
      // rows 2*tq and 2*tq+1 (8 bytes each)
      _mm_storel_epi64(reinterpret_cast<__m128i*>(dst + (2 * tq) * W), b);
      _mm_storeh_pi(reinterpret_cast<__m64*>(dst + (2 * tq + 1) * W), _mm_castsi128_ps(b));
    }
  }
}

}  // namespace

extern "C" {

// SIMD DPCM chunk decode for one plane (same contract as
// framecodec_decode_plane_chunk_u8 in framecodec.cpp). Requires
// AVX-512; returns 2 if the geometry can't take the vector path so the
// caller can fall back to the scalar kernel.
int framecodec_decode_plane_chunk_u8_simd(
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
  if (ns % 16) return 2;  // scalar fallback handles ragged strip counts
  const int64_t npos = strip * 64;

  PlaneTables pt_i, pt_d;
  pt_i.init(nw_i, goff_i, gidx_i, radix_i, prediv_i, levels_i);
  pt_d.init(nw_d, goff_d, gidx_d, radix_d, prediv_d, levels_d, order2);
  const float qi = static_cast<float>(qstep_i);
  const float qd = static_cast<float>(qstep_d);

  const int64_t ng = ns / 16;
#pragma omp parallel for schedule(static)
  for (int64_t g = 0; g < ng; ++g) {
    __m512i acc[4 * 64];
    __m512i vel[4 * 64];  // order-2 velocity accumulators (integer, exact)
    __m512 pix[4][64];   // DPCM accumulators per block-slot
    __m512 prev[4][64];  // previous keyframe (chroma interpolation)
    const int64_t blk0 = g * 16 * strip;
    for (int64_t k = 0; k < strip; ++k)
      for (int64_t e = 0; e < pt_d.nord2; ++e)
        vel[k * 64 + pt_d.ord2[e]] = _mm512_setzero_si512();

    unpack_group(intra + g * 16 * nw_i * 4, nw_i * 4, pt_i, acc, npos);
    for (int64_t k = 0; k < strip; ++k) {
      idct16(acc + k * 64, pt_i.midi, qi, pix[k], false);
      emit16(pix[k], out, keyframes[0] * frame_stride, W, bw, blk0, strip, k);
    }
    for (int64_t f = 1; f < nkf; ++f) {
      const int64_t a = keyframes[f - 1], b = keyframes[f];
      const bool interp = (b - a) > 1;
      if (interp) std::memcpy(prev, pix, sizeof(pix));
      unpack_group(deltas + ((f - 1) * ns + g * 16) * nw_d * 4, nw_d * 4,
                   pt_d, acc, npos);
      if (exc_val != nullptr && pt_d.nesc > 0) {
        // escape fix-up: every lane (strip) owns an independent run of
        // the exception stream, walked in ascending (block, position)
        // order — one compare per escape position, masked gather +
        // pointer bump only when a lane actually hit the marker. The
        // 32-bit gather reads 2 bytes past the final int16 value; the
        // encoder pads the section by 2 bytes for exactly this.
        __m512i ptr = _mm512_loadu_si512(
            reinterpret_cast<const void*>(exc_off + (f - 1) * ns + g * 16));
        const __m512i one = _mm512_set1_epi32(1);
        for (int64_t k = 0; k < strip; ++k)
          for (int64_t e = 0; e < pt_d.nesc; ++e) {
            const int i = pt_d.escp[e];
            const int idx = static_cast<int>(k * 64 + i);
            const __mmask16 m = _mm512_cmpeq_epi32_mask(
                acc[idx], _mm512_set1_epi32(pt_d.marker[e]));
            if (m) {
              __m512i v = _mm512_mask_i32gather_epi32(
                  _mm512_setzero_si512(), m, ptr,
                  reinterpret_cast<const void*>(exc_val), 2);
              v = _mm512_srai_epi32(_mm512_slli_epi32(v, 16), 16);
              v = _mm512_add_epi32(v, _mm512_set1_epi32(pt_d.midi[i]));
              acc[idx] = _mm512_mask_mov_epi32(acc[idx], m, v);
              ptr = _mm512_mask_add_epi32(ptr, m, ptr, one);
            }
          }
      }
      // order-2 positions: fold this frame's decoded second difference
      // into the velocity, then present the velocity as the coefficient
      // delta the pixel-domain DPCM below accumulates
      for (int64_t k = 0; k < strip; ++k)
        for (int64_t e = 0; e < pt_d.nord2; ++e) {
          const int i = pt_d.ord2[e];
          const int idx = static_cast<int>(k * 64 + i);
          const __m512i c = _mm512_sub_epi32(acc[idx],
                                             _mm512_set1_epi32(pt_d.midi[i]));
          vel[idx] = _mm512_add_epi32(vel[idx], c);
          acc[idx] = _mm512_add_epi32(vel[idx], _mm512_set1_epi32(pt_d.midi[i]));
        }
      for (int64_t k = 0; k < strip; ++k) {
        idct16(acc + k * 64, pt_d.midi, qd, pix[k], true);
        for (int64_t j = a + 1; j < b; ++j) {
          const float wj = static_cast<float>(j - a) / static_cast<float>(b - a);
          const __m512 w1 = _mm512_set1_ps(wj), w0 = _mm512_set1_ps(1.0f - wj);
          __m512 mix[64];
          for (int i = 0; i < 64; ++i)
            mix[i] = _mm512_fmadd_ps(w1, pix[k][i], _mm512_mul_ps(w0, prev[k][i]));
          emit16(mix, out, j * frame_stride, W, bw, blk0, strip, k);
        }
        emit16(pix[k], out, b * frame_stride, W, bw, blk0, strip, k);
      }
    }
  }
  return 0;
}

}  // extern "C"

#else  // !MAUA_SIMD

extern "C" int framecodec_decode_plane_chunk_u8_simd(
    const uint8_t*, const uint8_t*, int64_t, const int64_t*, int64_t, int64_t,
    int64_t, int64_t, const int64_t*, const int64_t*, const int64_t*,
    const int64_t*, const int64_t*, double, int64_t, const int64_t*,
    const int64_t*, const int64_t*, const int64_t*, const int64_t*, double,
    uint8_t*, int64_t, const int32_t*, const int16_t*, const int64_t*) {
  return 2;
}

#endif
