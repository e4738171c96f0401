// Filtered leaky ReLU for StyleGAN3 synthesis, NCHW, sm_90a.
//
// Replaces the Pallas TPU kernel `maua_tpu/kernels/filtered_lrelu.py`
// (`filtered_lrelu_pallas` -> `_flrelu_bchw`, the polyphase MXU
// formulation; reference chain `maua_tpu/gan/stylegan3.py`
// `_filtered_lrelu_direct` with the affines of `_filtered_lrelu`).
// Per (b, c) plane of x (H, W):
//
//   x'  = x * pre_scale[b, c] + pre_add[b, c]     on the H x W pixels only
//   t   = upfirdn(x', f_up, up, 'same' pad (pu, ut-1-pu), gain up^2)
//                                                  (H*up, W*up), up in {2, 4}
//   t   = (t >= 0 ? t : 0.2 t) * sqrt(2)
//   y   = upfirdn(t, f_down, down 2, 'same' pad (pd, dt-1-pd))
//   y   = y * post_scale[b, c]                     (H*up/2, W*up/2)
//
// with ut = 6 * up up-taps, dt = 12 down-taps, pu = (ut-1)/2,
// pd = (dt-1)/2, every filter separable (1-D, applied along H and W) and
// correlated (not flipped), as `upfirdn2d` does. Only a window of y
// (`crop`: its origin and size) is written, contiguous; StyleGAN3 keeps
// the centre of each layer's output and drops the rest. Storage is f32 or
// bf16; arithmetic is f32 and the output is rounded once. No clamp: the
// JAX StyleGAN3 applies none.
//
// Design. One block of 256 threads makes one TH x TW = 56 x 64 output
// tile of one plane (blockIdx.z walks the planes). The tile needs
// NT = 2 TH + 10 = 122 oversampled (tmp) rows and 2 TW + 10 = 138 tmp
// columns. Three passes, two shared buffers:
//   A. the input tile (37 x 41 at up 4, 69 x 75 at up 2), loaded with the
//      pre affine applied and the padding zeroed, is up-FIR'd along H,
//      polyphase (each tmp row takes 6 multiply-adds of its column), into
//      a (122, input columns) buffer; tmp rows outside the H*up grid are
//      zero (the down-FIR's padding);
//   B. one thread per (tmp row, 16 output columns): it loads the 17
//      (up 4) or 27 (up 2) inputs of its segment once, makes the 42 tmp
//      samples the segment needs one at a time in a register (6
//      multiply-adds each, lrelu, zero outside the W*up grid on the
//      tiles that touch it), and adds each to the 16 stride-2 down-FIR
//      sums it feeds (sqrt(2) folded into these taps); the (122, 64)
//      result goes to the second buffer. The 122 x 138 oversampled tile
//      never exists, in shared memory or anywhere else;
//   C. one thread per (8 output rows, one column): the H down-FIR from
//      26 values of its column, post scale, one rounding, store.
// Every index of the unrolled inner loops is a compile-time constant, so
// the filter taps (kernel parameters) are constant-bank operands of the
// multiply-adds, and the loads of B and C are one per 16 or 8 outputs'
// worth of inputs. Row strides are odd, so the column walks of A and the
// row walks of B take one shared-memory wavefront. Buffers: 50.5 KiB
// (up 4, four blocks an SM) and 66.7 KiB (up 2, three). A partial tile
// at the window's edge skips the rows and segments no kept output needs.
//
// Bound. The direct separable polyphase form (up-H, up-W, down-W,
// down-H) takes 6 + 24 + 24 + 12 = 66 multiply-adds per output at up 4
// and 12 + 24 + 24 + 12 = 72 at up 2, so the up-4 layers of a 1024^2
// frame batch are bound by f32 operations on the CUDA cores, not by
// bytes: the 532^2 -> 1064^2 layer (81 channels, batch 8) has 4.8e10
// multiply-adds, 1.4 ms at 67 TFLOP/s, against 0.55 ms for its 1.8 GB at
// 3.35 TB/s. This design does 2 * 122/56 = 2.18 tmp rows per output row
// (the H halo) and 42 tmp columns per 16 outputs (the W halo): about 80
// multiply-adds per output at up 4 plus one lrelu (2 operations) per tmp
// sample and ~10 shared-memory accesses, against 83 multiply-adds and
// ~20 shared-memory accesses of the four-pass design it replaces.
// PERF.md has its times beside the bound. The launch goes on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int TH = 56;        // output tile rows
constexpr int TW = 64;        // output tile columns
constexpr int U = 16;         // output columns per pass-B item
constexpr int V = 8;          // output rows per pass-C item
constexpr int THREADS = 256;
constexpr int DT = 12;        // down taps
constexpr int PD = (DT - 1) / 2;
constexpr int TAPS = 6;       // up taps per polyphase phase
constexpr int MAX_UT = 24;    // up taps at up 4
constexpr int JB = 4;         // polyphase groups per pass-A item
constexpr int NT = 2 * TH + DT - 2;   // tmp rows of a tile: 122
constexpr int NTW = 2 * TW + DT - 2;  // tmp columns of a tile: 138
constexpr int NB = 2 * U + DT - 2;    // tmp columns of a pass-B item: 42
constexpr int SB = TW + 1;            // odd row stride of the pass-B buffer
constexpr float SQRT2 = 1.41421356237309515f;
constexpr float ALPHA = 0.2f;

static_assert(TH % V == 0 && TW % U == 0, "items tile the output tile");
static_assert(2 * V * (TH / V - 1) + 2 * V + DT - 2 <= NT, "pass C reads inside the pass-B buffer");

constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int UP>
struct Geo {
  static constexpr int UT = 6 * UP;
  static constexpr int PU = (UT - 1) / 2;
  static constexpr int NG = (NT - 1 + UP - 1) / UP + 1;      // polyphase groups that cover the tmp rows
  static constexpr int NBLK = (NG + JB - 1) / JB;            // pass-A items per input column
  static constexpr int NIH = NBLK * JB + TAPS - 1;           // input rows loaded: 37 (up 4), 69 (up 2)
  static constexpr int NV = (NB - 1 + UP - 1) / UP + TAPS;   // inputs of a pass-B item: 17 (up 4), 27 (up 2)
  static constexpr int SEG_IN = 2 * U / UP;                  // input columns between two pass-B items
  static constexpr int NIW = (TW / U - 1) * SEG_IN + NV;     // input columns loaded: 41, 75
  static constexpr int SA = NIW | 1;                         // odd row stride of the input and pass-A buffers
  static constexpr int A = NT * SA;                          // pass-A buffer
  static constexpr int B = cmax(NIH * SA, NT * SB);          // input tile, then pass-B buffer
  static constexpr int BYTES = 4 * (A + B);
  // A tile's input origin is (2 * origin - PD - PU) / UP: exact, so that
  // group j of the tmp rows takes input rows j .. j + TAPS - 1.
  static_assert((PD + PU) % UP == 0, "tile origin must fall on an input sample");
  static_assert((2 * TH) % UP == 0 && (2 * TW) % UP == 0 && (2 * U) % UP == 0, "tiles start on input samples");
};

struct Taps {
  float up[MAX_UT];  // f_up * up (the gain up^2, split over the two axes)
  float down_w[DT];  // f_down * sqrt(2): the lrelu's gain, applied by the W down-FIR
  float down_h[DT];  // f_down
};

struct Args {
  const float* pre_scale;   // (planes,) or null
  const float* pre_add;     // (planes,) or null
  const float* post_scale;  // (planes,) or null
  long long planes;
  int H, W;                 // input plane
  int cy, cx, Ho, Wo;       // the written window of the (H*up/2, W*up/2) output: origin, size
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Pass B for one tmp row and U output columns: ra points at the segment's
// first input (after pass A), rb at its first output. Tmp column i of the
// segment is UP * jj - r with jj = ceil(i / UP), and takes inputs
// jj .. jj + TAPS - 1; it feeds output u through tap i - 2 u. With MASK,
// tmp columns outside [lo, hi) are zero (outside the W*up grid).
template <int UP, bool MASK>
__device__ __forceinline__ void w_pass(const float* ra, float* rb, int lo, int hi, const Taps& f) {
  using G = Geo<UP>;
  float vin[G::NV];
#pragma unroll
  for (int t = 0; t < G::NV; ++t) vin[t] = ra[t];
  float acc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) acc[u] = 0.f;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int jj = (i + UP - 1) / UP, r = UP * jj - i;
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < TAPS; ++k) t = fmaf(f.up[r + UP * k], vin[jj + k], t);
    t = fmaxf(t, ALPHA * t);
    if (MASK && (i < lo || i >= hi)) t = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = i - 2 * u;
      if (s >= 0 && s < DT) acc[u] = fmaf(f.down_w[s], t, acc[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) rb[u] = acc[u];
}

template <int UP, typename T>
__global__ void __launch_bounds__(THREADS) flrelu_kernel(const T* __restrict__ x, T* __restrict__ y,
                                                         const Args a, const Taps f) {
  using G = Geo<UP>;
  extern __shared__ float smem[];
  float* const sa = smem;         // (NT, SA) after pass A
  float* const sx = smem + G::A;  // (NIH, SA) input tile ...
  float* const sb = smem + G::A;  // ... then (NT, SB) after pass B

  const int tid = threadIdx.x;
  const int wy0 = blockIdx.y * TH, wx0 = blockIdx.x * TW;  // tile origin in the window
  const int rows = min(TH, a.Ho - wy0), cols = min(TW, a.Wo - wx0);
  const int my0 = 2 * (a.cy + wy0) - PD, mx0 = 2 * (a.cx + wx0) - PD;  // tmp origin
  const int iy0 = (my0 - G::PU) / UP, ix0 = (mx0 - G::PU) / UP;        // input origin (exact)
  // tmp rows of the tile inside the H*up grid; tmp columns inside the W*up grid
  const int row_lo = -my0, row_hi = a.H * UP - my0, col_lo = -mx0, col_hi = a.W * UP - mx0;
  const bool interior = mx0 >= 0 && mx0 + NTW <= a.W * UP;
  // what the kept outputs of a partial tile need: tmp rows, pass-B segments, input columns
  const int nt = 2 * rows + DT - 2;
  const int nseg = (cols + U - 1) / U;
  const int niw = (nseg - 1) * G::SEG_IN + G::NV;

  // Each pass ends in __syncthreads(), so when a thread starts loading the
  // next plane every thread has left pass C, the last reader of sb.
  for (long long plane = blockIdx.z; plane < a.planes; plane += gridDim.z) {
    const float ps = a.pre_scale ? __ldg(a.pre_scale + plane) : 1.f;
    const float pa = a.pre_add ? __ldg(a.pre_add + plane) : 0.f;
    const float po = a.post_scale ? __ldg(a.post_scale + plane) : 1.f;
    const T* xp = x + plane * (long long)a.H * a.W;
    T* yp = y + plane * (long long)a.Ho * a.Wo;

    // input tile + halo; the affine applies to image pixels, the padding is zero
    for (int e = tid; e < G::NIH * G::NIW; e += THREADS) {
      const int i = e / G::NIW, c = e - i * G::NIW;
      const int gi = iy0 + i, gc = ix0 + c;
      sx[i * G::SA + c] = gi >= 0 && gi < a.H && gc >= 0 && gc < a.W
                              ? fmaf(to_f32(xp[(long long)gi * a.W + gc]), ps, pa) : 0.f;
    }
    __syncthreads();

    // A. up-FIR along H: JB polyphase groups of one input column per item
    for (int idx = tid; idx < G::NBLK * G::NIW; idx += THREADS) {
      const int blk = idx / G::NIW, c = idx - blk * G::NIW;
      const int j0 = blk * JB;
      if (c >= niw || UP * j0 - (UP - 1) >= nt) continue;
      float vin[JB + TAPS - 1];
#pragma unroll
      for (int t = 0; t < JB + TAPS - 1; ++t) vin[t] = sx[(j0 + t) * G::SA + c];
#pragma unroll
      for (int g = 0; g < JB; ++g) {
#pragma unroll
        for (int r = 0; r < UP; ++r) {
          const int m = UP * (j0 + g) - r;
          if (m >= 0 && m < NT) {
            float acc = 0.f;
#pragma unroll
            for (int k = 0; k < TAPS; ++k) acc = fmaf(f.up[r + UP * k], vin[g + k], acc);
            sa[m * G::SA + c] = m >= row_lo && m < row_hi ? acc : 0.f;
          }
        }
      }
    }
    __syncthreads();

    // B. up-FIR along W, lrelu, down-FIR along W: one tmp row and U output columns per item (a warp
    //    takes 32 rows of one segment)
    for (int idx = tid; idx < (TW / U) * NT; idx += THREADS) {
      const int seg = idx / NT, m = idx - seg * NT;
      if (m >= nt || seg >= nseg) continue;
      const float* ra = sa + m * G::SA + seg * G::SEG_IN;
      float* rb = sb + m * SB + seg * U;
      if (interior) {
        w_pass<UP, false>(ra, rb, 0, 0, f);
      } else {
        const int c0 = 2 * seg * U;  // the segment's first tmp column in the tile
        w_pass<UP, true>(ra, rb, col_lo - c0, col_hi - c0, f);
      }
    }
    __syncthreads();

    // C. down-FIR along H at output rows V g .. V g + V - 1 of one column, post scale, store
    for (int idx = tid; idx < (TH / V) * TW; idx += THREADS) {
      const int g = idx / TW, c = idx - g * TW;
      if (c >= cols || g * V >= rows) continue;
      float vin[2 * V + DT - 2];
#pragma unroll
      for (int t = 0; t < 2 * V + DT - 2; ++t) vin[t] = sb[(2 * V * g + t) * SB + c];
      T* out = yp + (long long)(wy0 + V * g) * a.Wo + wx0 + c;
#pragma unroll
      for (int u = 0; u < V; ++u) {
        float acc = 0.f;
#pragma unroll
        for (int s = 0; s < DT; ++s) acc = fmaf(f.down_h[s], vin[2 * u + s], acc);
        if (V * g + u < rows) out[(long long)u * a.Wo] = from_f32<T>(acc * po);
      }
    }
    __syncthreads();
  }
}

template <int UP, typename T>
cudaError_t launch(const void* x, void* y, const Args& a, const Taps& f, cudaStream_t stream) {
  using G = Geo<UP>;
  auto kernel = flrelu_kernel<UP, T>;
  static std::atomic<unsigned long long> allowed{0};  // above 48 KB, allowed once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(allowed.load() >> dev & 1ull)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::BYTES);
    if (err != cudaSuccess) return err;
    allowed.fetch_or(1ull << dev);
  }
  const long long planes = a.planes < 65535 ? a.planes : 65535;
  dim3 grid((a.Wo + TW - 1) / TW, (a.Ho + TH - 1) / TH, (unsigned)planes);
  kernel<<<grid, THREADS, G::BYTES, stream>>>(static_cast<const T*>(x), static_cast<T*>(y), a, f);
  return cudaGetLastError();
}

}  // namespace

// x: device pointer to (planes, h, w), contiguous; y: to the (planes, ho, wo) window at (cy, cx) of the
// (h*up/2, w*up/2) output, contiguous (cy and cx even at up 4); dtype 0 = f32, 1 = bf16. up_taps (6*up
// floats) and down_taps (12 floats) are host arrays. pre_scale, pre_add, post_scale: device f32 (planes,)
// or null. Returns a cudaError_t (0 on success).
extern "C" int maua_filtered_lrelu(const void* x, void* y, int dtype, int up, const float* up_taps, int n_up,
                                   const float* down_taps, int n_down, const float* pre_scale,
                                   const float* pre_add, const float* post_scale, long long planes, int h,
                                   int w, int cy, int cx, int ho, int wo, void* stream) {
  if ((up != 2 && up != 4) || n_up != 6 * up || n_down != DT || (dtype != 0 && dtype != 1) || planes < 1 ||
      h < 1 || w < 1 || ho < 1 || wo < 1 || cy < 0 || cx < 0 || cy + ho > h * up / 2 || cx + wo > w * up / 2 ||
      (up == 4 && (cy % 2 || cx % 2)))
    return (int)cudaErrorInvalidValue;
  Taps f = {};
  for (int i = 0; i < n_up; ++i) f.up[i] = up_taps[i] * (float)up;
  for (int i = 0; i < DT; ++i) {
    f.down_w[i] = down_taps[i] * SQRT2;
    f.down_h[i] = down_taps[i];
  }
  Args a = {pre_scale, pre_add, post_scale, planes, h, w, cy, cx, ho, wo};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (up == 2)
    err = dtype == 0 ? launch<2, float>(x, y, a, f, s) : launch<2, __nv_bfloat16>(x, y, a, f, s);
  else
    err = dtype == 0 ? launch<4, float>(x, y, a, f, s) : launch<4, __nv_bfloat16>(x, y, a, f, s);
  return (int)err;
}
