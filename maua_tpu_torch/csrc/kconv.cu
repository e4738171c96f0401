// SAME-padded stride-1 3x3 convolution with a fused modulated-conv
// epilogue, NHWC input, sm_90a.
//
// Replaces the Pallas TPU kernel `maua_tpu/kernels/kconv.py`
// (`kconv3x3` -> `_kconv`, body from `_make_kernel`). For input x
// (B, H, W, Ci) and weights w (3, 3, Ci, Co):
//
//   xs = x * style[b, ci]                  (when style; rounded to x's type)
//   y  = sum_{dy, dx, ci} xs[b, h + dy - 1, w + dx - 1, ci] w[dy, dx, ci, co]
//   y  = y * demod[b, co] + bias[co]       (each when given)
//   y  = (y >= 0 ? y : alpha y) * gain     (when alpha is given)
//
// in f32, stored in x's type (f32 or bf16).
//
// Bound: 2 B H W 9 Ci Co flops against reading x and writing y once, so
// 9 Ci Co / (Ci + Co) flops per byte in bf16 and half that in f32. At the
// SG3 tail in bf16 that is 282 (layer 10, 81 -> 51 channels), 177 and 144
// (layers 11 and 12), under the 295 at which the card's bf16 tensor cores
// (989 TFLOP/s over 3.35 TB/s) would outrun its memory: bytes bound. In
// f32 (ridge 67 TFLOP/s over 3.35 TB/s, 20) and at RRDB's last growth conv
// (192 -> 64 channels, 432 in bf16) it is operations bound. Two kernels,
// both implicit GEMMs (M pixels, N output channels, K the nine taps times
// Ci), walking K in chunks of input channels, double-buffered by cp.async:
//
// f32, `kconv_f32` (on the CUDA cores, exact f32 products: no TF32, since
// the kernel is held to 1e-5): FFMA bound, so the design is the one of an
// SGEMM on the CUDA cores, a register outer product fed by 128-bit
// shared-memory reads. A block owns 8 rows x 32 columns of one image x
// BN = 8 NW output channels, one warp per 8 channels (NW = 4 or 8, so
// BN = 32 where Co <= 32, else 64; a warp whose channels lie past Co only
// stages, so the SG3 tail's 51 costs 7 warps' FMAs).
// Each lane owns 8 neighbouring pixels of one row x its warp's 8
// channels, 64 accumulators. Per chunk of 8 input channels the block
// stages the 10 x 34 halo (channel-major planes, rows 16-byte aligned) and
// the 9 x 8 x BN weight slice. Per input channel and tap row a lane reads
// its 12 halo floats (three 128-bit reads, used by the three column taps)
// and per tap its 8 weights (two 128-bit reads that the warp shares): 192
// FFMAs per nine 128-bit reads. The weights come repacked by the wrapper
// as (Co / BN, Ci / 8, 9, 8, BN) tiles, zero-padded, by 16-byte cp.async;
// the halo by 4-byte cp.async, which transposes NHWC into the planes and
// takes any Ci, aligned or not (81 and 51 at the SG3 tail), zero-filled
// outside the image and past Ci, with the style multiplied in place after
// the copy lands. A chunk's FMAs stop at Ci, so a ragged last chunk costs
// its channels only.
//
// bf16, `kconv_tc` (on the tensor cores, mma.sync m16n8k16, f32
// accumulate): a block owns 16 rows x 16 columns of one image (M, one
// 16-pixel row per m16 tile, two rows per warp) x N = 64 output channels
// (32 where Co <= 32, so that 32-channel layers waste none). The K loop
// walks the input channels in chunks of 16; per chunk it stages the
// 18 x 18 x 16 halo and the 9 x 16 x N weight slice in bf16 shared
// memory, double-buffered, and the nine taps are nine k16 steps of the
// MMA: the TPU kernel packed the taps into its matmul contraction, here
// they are the MMA's K dimension. An A fragment's ldmatrix rows are 16
// neighbouring pixels of the halo at (row + dy, column + dx); pixels are
// 24 bf16 (three 16-byte units) apart and weight rows N + 8, odd unit
// counts, so every ldmatrix is conflict-free. The weights come repacked
// by the wrapper as (Co / N, Ci / 16, 9, 16, N) tiles, zero-padded, and
// arrive by 16-byte cp.async; the halo does too where a pixel's channels
// are 16-byte aligned (Ci % 8 == 0), zero-filled outside the image and
// past Ci, with the style multiplied in place after the copy lands;
// otherwise (Ci = 81, 51 at the SG3 tail) by 2-byte loads, eight in
// flight per thread, with the style applied on load.
//
// Both: demod, bias and lrelu * gain are applied on the f32 accumulators
// at store. The launch goes on the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kRows = 8;    // f32: output rows per block, one per lane quad
constexpr int kCols = 16;   // bf16: output columns per block

struct Params {
  const void* x;         // (B, H, W, Ci)
  const void* w;         // packed tiles (Co / N, Ci / K, 9, K, N), N = 32 or 64: f32 K = 8, bf16 K = 16
  const float* bias;     // (Co,) or null
  const float* style;    // (B, Ci) or null, already rounded to x's type
  const float* demod;    // (B, Co) or null
  void* y;               // (B, H, W, Co)
  int B, H, W, Ci, Co, co_blocks;
  float alpha, gain;
  int has_act;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

// 16 bytes from src, or zeros where `bytes` is 0 (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes)
               : "memory");
}
// 4 bytes from src, or zeros where `bytes` is 0
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Allows `bytes` of dynamic shared memory for `kernel` on the current device, once per device: `allowed`
// is the instance's own mask of devices.
int allow_smem(const void* kernel, int bytes, std::atomic<unsigned long long>& allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return 1006;
  if (!(allowed.load() >> dev & 1ull)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    allowed.fetch_or(1ull << dev);
  }
  return 0;
}


// ---- f32 on the CUDA cores ----

constexpr int kF32Chunk = 8;                  // input channels per K step
constexpr int kF32Cols = 32;                  // output columns per block: four lanes of 8
constexpr int kF32HR = kRows + 2, kF32HW = kF32Cols + 2;  // halo rows and columns
constexpr int kF32HC = 36;                    // floats per halo row: 16-byte aligned, room for a lane's 12
// floats per halo plane (one input channel), 12 mod 32: the 8 planes that a warp's copies of one pixel
// write fall in distinct banks
constexpr int kF32Plane = kF32HR * kF32HC + (44 - kF32HR * kF32HC % 32) % 32;
constexpr int kF32Halo = kF32Chunk * kF32Plane;  // floats of one halo stage
template <int NW>
constexpr int f32_smem_bytes() {  // two stages of halo and weights
  return 2 * (kF32Halo + 9 * kF32Chunk * 8 * NW) * (int)sizeof(float);
}

// at most 128 registers: two blocks an SM at 8 warps, four at 4 (16 warps)
template <int NW>
__global__ void __launch_bounds__(32 * NW, 16 / NW) kconv_f32(Params p) {
  constexpr int BN = 8 * NW, WTILE = 9 * kF32Chunk * BN, NT = 32 * NW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // [2][kF32Chunk][kF32Plane]
  float* ws = xs + 2 * kF32Halo;                   // [2][9][kF32Chunk][BN]

  const float* w = static_cast<const float*>(p.w);
  float* y = static_cast<float*>(p.y);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int w0 = blockIdx.x * kF32Cols, h0 = blockIdx.y * kRows;
  const int b = blockIdx.z / p.co_blocks, ct = blockIdx.z - b * p.co_blocks, co0 = ct * BN + 8 * warp;
  const int chunks = (p.Ci + kF32Chunk - 1) / kF32Chunk;
  const float* xb = static_cast<const float*>(p.x) + (long long)b * p.H * p.W * p.Ci;

  // chunk c of the input channels into stage st: the weight tile by 16-byte copies, the halo by 4-byte
  // copies, a pixel's 8 channels from 8 neighbouring threads
  auto stage = [&](int c, int st) {
    const float* wsrc = w + ((long long)ct * chunks + c) * WTILE;
    float* wdst = ws + st * WTILE;
    for (int e = tid; e < WTILE / 4; e += NT) cp_async16(wdst + 4 * e, wsrc + 4 * e);
    float* xdst = xs + st * kF32Halo;
    const int ci0 = c * kF32Chunk;
    for (int e = tid; e < kF32Chunk * kF32HR * kF32HW; e += NT) {
      const int ci = e % kF32Chunk, pix = e / kF32Chunk, r = pix / kF32HW, col = pix - r * kF32HW;
      const int h = h0 + r - 1, ww = w0 + col - 1;
      const bool in = ci0 + ci < p.Ci && h >= 0 && h < p.H && ww >= 0 && ww < p.W;
      const float* src = in ? xb + ((long long)h * p.W + ww) * p.Ci + ci0 + ci : xb;
      cp_async4(xdst + ci * kF32Plane + r * kF32HC + col, src, in ? 4 : 0);
    }
  };
  // each thread scales, in place, the halo floats that it copied itself (visible to it after its wait),
  // before the barrier that publishes the stage; they are all of one input channel, ci0 + tid % 8 (NT % 8 == 0)
  auto style_in_place = [&](int st, float sv) {
    float* xdst = xs + st * kF32Halo + (tid % kF32Chunk) * kF32Plane;
    for (int e = tid; e < kF32Chunk * kF32HR * kF32HW; e += NT) {
      const int pix = e / kF32Chunk, r = pix / kF32HW, col = pix - r * kF32HW;
      xdst[r * kF32HC + col] *= sv;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // this lane's pixels: row lane / 4 of the tile, columns c0 .. c0 + 7; its halo reads start there
  const int r = lane >> 2, c0 = 8 * (lane & 3);
  const bool busy = co0 < p.Co;  // a warp whose channels all lie past Co only stages

  stage(0, 0);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    const int st = c & 1;
    if (c + 1 < chunks) {  // the next chunk into the other stage, freed by the barrier that ended step c - 1
      stage(c + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (p.style) {
      const int cs = c * kF32Chunk + tid % kF32Chunk;  // the input channel of the halo floats this thread copied
      if (cs < p.Ci) style_in_place(st, __ldg(p.style + (long long)b * p.Ci + cs));
    }
    __syncthreads();
    const float* xt = xs + st * kF32Halo + r * kF32HC + c0;
    const float* wt = ws + st * WTILE + 8 * warp;
    const int nci = busy ? min(kF32Chunk, p.Ci - c * kF32Chunk) : 0;
#pragma unroll 2
    for (int ci = 0; ci < nci; ++ci) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float4* rp = reinterpret_cast<const float4*>(xt + ci * kF32Plane + dy * kF32HC);
        const float4 q0 = rp[0], q1 = rp[1], q2 = rp[2];
        const float row[12] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x, q2.y, q2.z, q2.w};
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4* wp = reinterpret_cast<const float4*>(wt + ((dy * 3 + dx) * kF32Chunk + ci) * BN);
          const float4 b0 = wp[0], b1 = wp[1];
          const float wv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(row[i + dx], wv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before step c + 1 refills it
  }

  const int h = h0 + r;
  if (!busy || h >= p.H) return;
  float dm[8], bs[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool in = co0 + j < p.Co;
    dm[j] = p.demod && in ? __ldg(p.demod + (long long)b * p.Co + co0 + j) : 1.f;
    bs[j] = p.bias && in ? __ldg(p.bias + co0 + j) : 0.f;
  }
  const bool vec = p.Co % 4 == 0 && co0 + 8 <= p.Co;  // two 16-byte stores a pixel
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ww = w0 + c0 + i;
    if (ww >= p.W) break;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = acc[i][j] * dm[j] + bs[j];
      if (p.has_act) v[j] = (v[j] >= 0.f ? v[j] : v[j] * p.alpha) * p.gain;
    }
    float* dst = y + (((long long)b * p.H + h) * p.W + ww) * p.Co + co0;
    if (vec) {
      reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (co0 + j < p.Co) dst[j] = v[j];
    }
  }
}

template <int NW>
int launch_f32_width(const Params& p0, cudaStream_t s) {
  Params p = p0;
  p.co_blocks = (p.Co + 8 * NW - 1) / (8 * NW);
  const long long nz = (long long)p.B * p.co_blocks;
  if (nz > 65535) return 1003;
  static std::atomic<unsigned long long> allowed{0};
  const int err = allow_smem((const void*)kconv_f32<NW>, f32_smem_bytes<NW>(), allowed);
  if (err) return err;
  dim3 grid((p.W + kF32Cols - 1) / kF32Cols, (p.H + kRows - 1) / kRows, (unsigned)nz);
  kconv_f32<NW><<<grid, 32 * NW, f32_smem_bytes<NW>(), s>>>(p);
  return (int)cudaGetLastError();
}

// output tiles of 32 channels where Co <= 32, else 64 (the layout `pack_weights` gives the weights); at
// Co = 51 the eighth warp of a 64-channel tile has no channels and only stages (as fast as a 56-channel
// tile of seven warps, measured on an H100)
int launch_f32(const Params& p, cudaStream_t s) {
  return p.Co <= 32 ? launch_f32_width<4>(p, s) : launch_f32_width<8>(p, s);
}


// ---- bf16 on the tensor cores ----

using bf16 = __nv_bfloat16;
constexpr int kTcChunk = 16;         // input channels per K step: one k16 of the MMA per tap
constexpr int kPix = 24;             // bf16 per halo pixel in shared memory (48 bytes)
constexpr int kRw = 2;               // output rows per warp: a block owns 8 * kRw rows

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a b for one m16n8k16 tile: a is 16 x 16 (row), b 16 x 8 (col), bf16; c f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 (low half first) times s0, s1, each product rounded to bf16
__device__ __forceinline__ unsigned scale_pair(unsigned v, float s0, float s1) {
  __nv_bfloat162 r = __floats2bfloat162_rn(__uint_as_float(v << 16) * s0, __uint_as_float(v & 0xffff0000u) * s1);
  return *reinterpret_cast<unsigned*>(&r);
}

constexpr int kTcHalo = (8 * kRw + 2) * (kCols + 2) * kPix;  // bf16 of one halo stage
// bf16 per weight row (one input channel of one tap) for CO output channels: 80 or 144 bytes, odd unit counts
__host__ __device__ constexpr int tc_wrow(int co) { return co + 8; }
template <int CO>
__host__ __device__ constexpr int tc_smem_bytes() {  // two stages of halo and weights
  return 2 * (kTcHalo + 9 * kTcChunk * tc_wrow(CO)) * (int)sizeof(bf16);
}

// VEC: the halo by 16-byte cp.async (Ci % 8 == 0, x 16-byte aligned)
template <bool VEC, int CO>
__device__ __forceinline__ void kconv_tc_body(const Params& p) {
  constexpr int HR = 8 * kRw + 2, HC = kCols + 2, HALO = kTcHalo;
  constexpr int NT = CO / 8, WROW = tc_wrow(CO), WTILE = 9 * kTcChunk * WROW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [2][HR * HC][kPix]
  bf16* ws = xs + 2 * HALO;                      // [2][9 * 16][WROW]

  const bf16* x = static_cast<const bf16*>(p.x);
  const bf16* w = static_cast<const bf16*>(p.w);
  bf16* y = static_cast<bf16*>(p.y);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int w0 = blockIdx.x * kCols, h0 = blockIdx.y * 8 * kRw;
  const int b = blockIdx.z / p.co_blocks, ct = blockIdx.z - b * p.co_blocks, co0 = ct * CO;
  const int chunks = (p.Ci + kTcChunk - 1) / kTcChunk;
  const bf16 zero = __float2bfloat16_rn(0.f);

  // chunk c of the input channels into stage st: weights always by cp.async, the halo by cp.async (VEC)
  // or by plain loads with the style applied
  auto stage = [&](int c, int st) {
    const bf16* wsrc = w + ((long long)ct * chunks + c) * (9 * kTcChunk * CO);
    bf16* wdst = ws + st * WTILE;
    for (int e = tid; e < 9 * kTcChunk * NT; e += 256)
      cp_async16(wdst + (e / NT) * WROW + 8 * (e % NT), wsrc + 8 * e);
    bf16* xdst = xs + st * HALO;
    const int ci0 = c * kTcChunk;
    if (VEC) {
      for (int e = tid; e < HR * HC * 2; e += 256) {
        const int pix = e >> 1, half = e & 1, r = pix / HC, col = pix - r * HC;
        const int h = h0 + r - 1, ww = w0 + col - 1, ci = ci0 + 8 * half;
        const bool in = ci < p.Ci && h >= 0 && h < p.H && ww >= 0 && ww < p.W;
        const bf16* src = in ? x + (((long long)b * p.H + h) * p.W + ww) * p.Ci + ci : x;
        cp_async16(xdst + pix * kPix + 8 * half, src, in ? 16 : 0);
      }
    } else {
      // thread tid loads input channel ci0 + tid % 16 of every 16th halo pixel, eight loads in flight at once
      constexpr int NPIX = HR * HC, PER = (NPIX + 15) / 16;
      const int cl = tid & 15, ci = ci0 + cl;
      const bool cin = ci < p.Ci;
      const float sv = p.style && cin ? __ldg(p.style + (long long)b * p.Ci + ci) : 1.f;
      const bf16* xb = x + (long long)b * p.H * p.W * p.Ci + ci;
#pragma unroll 1
      for (int i0 = 0; i0 < PER; i0 += 8) {
        bf16 v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int pix = (tid >> 4) + 16 * (i0 + i), r = pix / HC, col = pix - r * HC;
          const int h = h0 + r - 1, ww = w0 + col - 1;
          v[i] = zero;
          if (pix < NPIX && cin && h >= 0 && h < p.H && ww >= 0 && ww < p.W) v[i] = xb[((long long)h * p.W + ww) * p.Ci];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int pix = (tid >> 4) + 16 * (i0 + i);
          if (pix < NPIX) xdst[pix * kPix + cl] = p.style ? __float2bfloat16_rn(__bfloat162float(v[i]) * sv) : v[i];
        }
      }
    }
  };
  // VEC: each thread scales, in place, the 16-byte pieces of the halo that it copied itself (visible to it
  // after its wait), before the barrier that publishes the stage
  auto style_in_place = [&](int c, int st) {
    bf16* xdst = xs + st * HALO;
    for (int e = tid; e < HR * HC * 2; e += 256) {
      const int ci = c * kTcChunk + 8 * (e & 1);
      if (ci >= p.Ci) continue;
      const float* sp = p.style + (long long)b * p.Ci + ci;
      uint4* piece = reinterpret_cast<uint4*>(xdst + (e >> 1) * kPix + 8 * (e & 1));
      uint4 v = *piece;
      v.x = scale_pair(v.x, __ldg(sp), __ldg(sp + 1));
      v.y = scale_pair(v.y, __ldg(sp + 2), __ldg(sp + 3));
      v.z = scale_pair(v.z, __ldg(sp + 4), __ldg(sp + 5));
      v.w = scale_pair(v.w, __ldg(sp + 6), __ldg(sp + 7));
      *piece = v;
    }
  };

  float acc[kRw][NT][4];
#pragma unroll
  for (int i = 0; i < kRw; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  // ldmatrix row addresses of this lane: A, 16 pixels x 16 channels of the halo; B (via .trans), 16 input
  // channels x two n8 tiles of output channels
  const int a_off = (lane & 15) * kPix + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * WROW + (lane >> 4) * 8;

  stage(0, 0);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    const int st = c & 1;
    if (c + 1 < chunks) {  // the next chunk into the other stage, freed by the barrier that ended step c - 1
      stage(c + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (VEC && p.style) style_in_place(c, st);
    __syncthreads();
    const bf16* xt = xs + st * HALO + warp * kRw * HC * kPix + a_off;
    const bf16* wt = ws + st * WTILE + b_off;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - 3 * dy;
      unsigned bf[NT / 2][4];
#pragma unroll
      for (int n = 0; n < NT / 2; ++n) ldmatrix_x4_trans(bf[n], wt + tap * kTcChunk * WROW + 16 * n);
#pragma unroll
      for (int i = 0; i < kRw; ++i) {
        unsigned a[4];
        ldmatrix_x4(a, xt + ((i + dy) * HC + dx) * kPix);
#pragma unroll
        for (int n = 0; n < NT / 2; ++n) {
          mma_bf16(acc[i][2 * n], a, bf[n][0], bf[n][1]);
          mma_bf16(acc[i][2 * n + 1], a, bf[n][2], bf[n][3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before step c + 1 refills it
  }

  // lane (g, t) holds pixels g and g + 8 of its row, output channels 8 j + 2 t and + 1
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const bool pairs = p.Co % 2 == 0;  // bf16 pairs are 4-byte aligned
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int co = co0 + 8 * j + t2;
    if (co >= p.Co) continue;
    const bool two = co + 1 < p.Co;
    const float dm0 = p.demod ? __ldg(p.demod + (long long)b * p.Co + co) : 1.f;
    const float dm1 = p.demod && two ? __ldg(p.demod + (long long)b * p.Co + co + 1) : 1.f;
    const float bs0 = p.bias ? __ldg(p.bias + co) : 0.f;
    const float bs1 = p.bias && two ? __ldg(p.bias + co + 1) : 0.f;
#pragma unroll
    for (int i = 0; i < kRw; ++i) {
      const int h = h0 + warp * kRw + i;
      if (h >= p.H) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ww = w0 + g + 8 * half;
        if (ww >= p.W) continue;
        float v0 = acc[i][j][2 * half] * dm0 + bs0, v1 = acc[i][j][2 * half + 1] * dm1 + bs1;
        if (p.has_act) {
          v0 = (v0 >= 0.f ? v0 : v0 * p.alpha) * p.gain;
          v1 = (v1 >= 0.f ? v1 : v1 * p.alpha) * p.gain;
        }
        bf16* dst = y + (((long long)b * p.H + h) * p.W + ww) * p.Co + co;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
        } else {
          dst[0] = __float2bfloat16_rn(v0);
          if (two) dst[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// ptxas picks each instance's registers. Built as `kconv_tc`, the 64-channel instance with 2-byte halo loads
// came out with more than 128 registers (one block an SM) or with spills on an H100; `kconv_tc_capped` asks
// for two blocks an SM (at most 128 registers), which builds it without spills, and slows the others.
template <bool VEC, int CO>
__global__ void __launch_bounds__(256) kconv_tc(Params p) { kconv_tc_body<VEC, CO>(p); }
template <bool VEC, int CO>
__global__ void __launch_bounds__(256, 2) kconv_tc_capped(Params p) { kconv_tc_body<VEC, CO>(p); }

template <bool VEC, int CO>
int launch_tc_instance(const Params& p, dim3 grid, cudaStream_t s) {
  void (*kernel)(Params);
  if constexpr (CO == 64 && !VEC) kernel = kconv_tc_capped<VEC, CO>;
  else kernel = kconv_tc<VEC, CO>;
  static std::atomic<unsigned long long> allowed{0};
  const int err = allow_smem((const void*)kernel, tc_smem_bytes<CO>(), allowed);
  if (err) return err;
  kernel<<<grid, 256, tc_smem_bytes<CO>(), s>>>(p);
  return (int)cudaGetLastError();
}

template <int CO>
int launch_tc_width(const Params& p0, cudaStream_t s) {
  Params p = p0;
  p.co_blocks = (p.Co + CO - 1) / CO;
  const long long nz = (long long)p.B * p.co_blocks;
  if (nz > 65535) return 1003;
  const bool vec = p.Ci % 8 == 0 && reinterpret_cast<uintptr_t>(p.x) % 16 == 0;
  dim3 grid((p.W + kCols - 1) / kCols, (p.H + 8 * kRw - 1) / (8 * kRw), (unsigned)nz);
  return vec ? launch_tc_instance<true, CO>(p, grid, s) : launch_tc_instance<false, CO>(p, grid, s);
}

// output tiles of 32 channels where Co <= 32, else 64 (the layout `pack_weights` gives the weights)
int launch_tc(const Params& p, cudaStream_t s) {
  return p.Co <= 32 ? launch_tc_width<32>(p, s) : launch_tc_width<64>(p, s);
}

}  // namespace

// w packed as (ceil(Co / T), ceil(Ci / K), 9, K, T), zero-padded, 16-byte aligned, T = 32 where Co <= 32, else
// 64: dtype 0 = f32 with K = 8; 1 = bf16 with K = 16. Returns 0, a cudaError_t, 1003 (bad sizes), 1004 (bad
// dtype) or 1006 (device index over 63).
extern "C" int maua_kconv3x3(const void* x, const void* w, const float* bias, const float* style, const float* demod,
                             void* y, int dtype, int B, int H, int W, int Ci, int Co, float alpha, float gain,
                             int has_act, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Ci <= 0 || Co <= 0 || (H + kRows - 1) / kRows > 65535) return 1003;
  Params p{x, w, bias, style, demod, y, B, H, W, Ci, Co, 0, alpha, gain, has_act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(p, s);
  if (dtype == 1) return launch_tc(p, s);
  return 1004;
}
