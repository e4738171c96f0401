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
// correlated (not flipped), as `upfirdn2d` does. Storage is f32 or bf16;
// arithmetic is f32 and the output is rounded once. No clamp: the JAX
// StyleGAN3 applies none.
//
// Design. One block makes one 32 x 32 output tile of one plane
// (blockIdx.z walks the planes, so the per-plane scalars are one load
// each). The block loads its input tile and halo into shared memory with
// the pre affine applied and the padding zeroed, then runs four 1-D
// passes between two shared buffers:
//   1. up-FIR along H, polyphase: each of the up output phases of a
//      group takes only ut/up = 6 multiply-adds, and the zero-stuffed
//      grid never exists; a thread takes 4 groups of one column, reading
//      their 9 inputs once for all 4*up samples;
//   2. up-FIR along W the same way, then lrelu * sqrt(2), with the tmp
//      samples outside the (H*up, W*up) grid set to zero (they are the
//      down-FIR's padding);
//   3. down-FIR along W at the stride-2 output columns only, 4 outputs
//      per thread from 18 loads;
//   4. down-FIR along H at the stride-2 output rows, post scale, store.
// A tile needs 2*32+10 = 74 tmp rows and columns and 44 (up 2) or 25
// (up 4) input rows and columns; the buffers hold 8,880 (up 2) or 7,992
// (up 4) floats, 35.5 KB at most, so six blocks fit on an SM. Row strides
// are odd where a warp walks down a column, so those accesses take one
// shared-memory wavefront. Filter taps are kernel parameters indexed by
// compile-time constants (fully unrolled loops), i.e. constant-bank
// operands of the multiply-adds. The 2x/4x oversampled grid, 5.9 GB in
// bf16 at the 532^2 -> 1064^2 layer of a 1024^2 batch of 8, is never in
// device memory: x is read once and y written once.
//
// Bound. Counting the direct separable polyphase form (up-H, up-W,
// down-W, down-H: 6 + 24 + 24 + 12 multiply-adds per output pixel at
// up 4, 12 + 24 + 24 + 12 at up 2), the up-4 layers of a 1024^2 frame
// batch are bound by f32 operations on the CUDA cores, not by bytes:
// the 532^2 -> 1064^2 layer (81 channels, batch 8) has 4.8e10
// multiply-adds, 1.4 ms at 67 TFLOP/s, against 0.55 ms for its 1.8 GB
// at 3.35 TB/s. Here every multiply-add also costs a share of a
// shared-memory load, index arithmetic and a barrier per pass, so the
// FMA units are not what limits this design (PERF.md has its times
// beside the bound); the tensor-core reformulation is later work. The launch goes on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;      // output tile edge, rows and columns
constexpr int THREADS = 256;  // (TILE / 4) * TILE: one pass-4 item per thread
constexpr int DT = 12;        // down taps
constexpr int PD = (DT - 1) / 2;
constexpr int MAX_UT = 24;    // up taps at up 4
constexpr int JB = 4;         // polyphase groups per thread in the up passes
constexpr float SQRT2 = 1.41421356237309515f;
constexpr float ALPHA = 0.2f;

constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int UP>
struct Geo {
  static constexpr int UT = 6 * UP;                      // up taps
  static constexpr int PU = (UT - 1) / 2;
  static constexpr int TAPS = UT / UP;                   // multiply-adds per tmp sample and axis
  static constexpr int NT = 2 * TILE + DT - 2;           // tmp rows (and columns) of a tile: 74
  static constexpr int NG = (NT - 1 + UP - 1) / UP + 1;  // polyphase groups that cover them
  static constexpr int NGB = (NG + JB - 1) / JB * JB;    // ... in whole blocks of JB groups
  static constexpr int NI = NGB - 1 + TAPS;              // input rows (and columns) loaded: 44 (up 2), 25 (up 4)
  static constexpr int SI = NI | 1;                      // odd row stride of the input and pass-1 tiles
  static constexpr int ST = NT + 1;                      // odd row stride of the tmp tile
  static constexpr int SD = TILE + 1;                    // odd row stride of the pass-3 tile
  static constexpr int A = cmax(NI * SI, NT * ST);       // input tile, then tmp tile
  static constexpr int B = cmax(NT * SI, NT * SD);       // pass-1 tile, then pass-3 tile
  // A tile's input origin is (2 * origin - PD - PU) / UP: exact, so that
  // group j of the tmp rows takes input rows j .. j + TAPS - 1.
  static_assert((PD + PU) % UP == 0, "tile origin must fall on an input sample");
  static_assert((2 * TILE) % UP == 0, "tile origin must fall on an input sample");
};

struct Taps {
  float up[MAX_UT];  // f_up * up (the gain up^2, split over the two axes)
  float down[DT];
};

struct Args {
  const float* pre_scale;   // (planes,) or null
  const float* pre_add;     // (planes,) or null
  const float* post_scale;  // (planes,) or null
  long long planes;
  int H, W, Ho, Wo;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Up-FIR of one block of JB polyphase groups: v holds the JB + TAPS - 1
// inputs they read; sample UP*(j0+g) - r = sum_k f_up[r + UP*k] * v[g + k].
// emit(index, value) receives each sample that falls inside the tile.
template <int UP, typename Emit>
__device__ __forceinline__ void up_block(const float* v, int j0, const Taps& f, Emit emit) {
  using G = Geo<UP>;
#pragma unroll
  for (int g = 0; g < JB; ++g) {
#pragma unroll
    for (int r = 0; r < UP; ++r) {
      const int m = UP * (j0 + g) - r;
      if (m >= 0 && m < G::NT) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < G::TAPS; ++k) acc = fmaf(f.up[r + UP * k], v[g + k], acc);
        emit(m, acc);
      }
    }
  }
}

template <int UP, typename T>
__global__ void __launch_bounds__(THREADS) flrelu_kernel(const T* __restrict__ x, T* __restrict__ y,
                                                         const Args a, const Taps f) {
  using G = Geo<UP>;
  constexpr int NV = JB + G::TAPS - 1;  // inputs of one block of groups
  __shared__ float buf_a[G::A];
  __shared__ float buf_b[G::B];
  float* const sx = buf_a;  // (NI, SI) input tile
  float* const su = buf_b;  // (NT, SI) after pass 1
  float* const st = buf_a;  // (NT, ST) after pass 2
  float* const sd = buf_b;  // (NT, SD) after pass 3

  const int oy0 = blockIdx.y * TILE, ox0 = blockIdx.x * TILE;
  const int my0 = 2 * oy0 - PD, mx0 = 2 * ox0 - PD;  // tmp origin
  const int iy0 = (my0 - G::PU) / UP, ix0 = (mx0 - G::PU) / UP;  // input origin (exact)
  // tmp rows and columns of the tile that lie inside the (H*up, W*up) grid
  const int row_lo = -my0, row_hi = a.H * UP - my0, col_lo = -mx0, col_hi = a.W * UP - mx0;

  // Each pass ends in __syncthreads(), so when a thread starts pass 0 of
  // the next plane every thread has left pass 3, the last reader of buf_a.
  for (long long plane = blockIdx.z; plane < a.planes; plane += gridDim.z) {
    const float ps = a.pre_scale ? __ldg(a.pre_scale + plane) : 1.f;
    const float pa = a.pre_add ? __ldg(a.pre_add + plane) : 0.f;
    const float po = a.post_scale ? __ldg(a.post_scale + plane) : 1.f;
    const T* xp = x + plane * (long long)a.H * a.W;
    T* yp = y + plane * (long long)a.Ho * a.Wo;

    // 0. input tile + halo, a warp per row; the affine applies to image pixels, the padding is zero
    for (int i = threadIdx.x / 32; i < G::NI; i += THREADS / 32) {
      const int gi = iy0 + i;
      const bool row_in = gi >= 0 && gi < a.H;
      for (int c = threadIdx.x % 32; c < G::NI; c += 32) {
        const int gc = ix0 + c;
        sx[i * G::SI + c] =
            row_in && gc >= 0 && gc < a.W ? fmaf(to_f32(xp[(long long)gi * a.W + gc]), ps, pa) : 0.f;
      }
    }
    __syncthreads();

    // 1. up-FIR along H, JB groups of one input column per thread; tmp rows
    //    outside the grid are zero, so pass 2 makes zeros of them
    for (int idx = threadIdx.x; idx < (G::NGB / JB) * G::NI; idx += THREADS) {
      const int jb = idx / G::NI, c = idx - jb * G::NI;
      const int j0 = jb * JB;
      float v[NV];
#pragma unroll
      for (int t = 0; t < NV; ++t) v[t] = sx[(j0 + t) * G::SI + c];
      up_block<UP>(v, j0, f, [&](int mt, float acc) {
        su[mt * G::SI + c] = mt >= row_lo && mt < row_hi ? acc : 0.f;
      });
    }
    __syncthreads();

    // 2. up-FIR along W, JB groups of one tmp row per thread (a warp walks
    //    down a column), lrelu * sqrt(2); columns outside the grid are zero
    for (int idx = threadIdx.x; idx < G::NT * (G::NGB / JB); idx += THREADS) {
      const int mt = idx % G::NT, j0 = idx / G::NT * JB;
      float v[NV];
#pragma unroll
      for (int t = 0; t < NV; ++t) v[t] = su[mt * G::SI + j0 + t];
      up_block<UP>(v, j0, f, [&](int mx, float acc) {
        acc = (acc >= 0.f ? acc : acc * ALPHA) * SQRT2;
        st[mt * G::ST + mx] = mx >= col_lo && mx < col_hi ? acc : 0.f;
      });
    }
    __syncthreads();

    // 3. down-FIR along W at output columns 4q .. 4q+3 (tmp columns 8q .. 8q+17)
    for (int idx = threadIdx.x; idx < G::NT * (TILE / 4); idx += THREADS) {
      const int mt = idx % G::NT, q = idx / G::NT;
      float v[DT + 6];
#pragma unroll
      for (int t = 0; t < DT + 6; ++t) v[t] = st[mt * G::ST + 8 * q + t];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float acc = 0.f;
#pragma unroll
        for (int s = 0; s < DT; ++s) acc = fmaf(f.down[s], v[2 * u + s], acc);
        sd[mt * G::SD + 4 * q + u] = acc;
      }
    }
    __syncthreads();

    // 4. down-FIR along H at output rows 4q .. 4q+3, post scale, store
    {
      const int ox = threadIdx.x % TILE, q = threadIdx.x / TILE;
      float v[DT + 6];
#pragma unroll
      for (int t = 0; t < DT + 6; ++t) v[t] = sd[(8 * q + t) * G::SD + ox];
      const int gx = ox0 + ox;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float acc = 0.f;
#pragma unroll
        for (int s = 0; s < DT; ++s) acc = fmaf(f.down[s], v[2 * u + s], acc);
        const int gy = oy0 + 4 * q + u;
        if (gy < a.Ho && gx < a.Wo) yp[(long long)gy * a.Wo + gx] = from_f32<T>(acc * po);
      }
    }
    __syncthreads();
  }
}

template <int UP, typename T>
cudaError_t launch(const void* x, void* y, const Args& a, const Taps& f, cudaStream_t stream) {
  const long long planes = a.planes < 65535 ? a.planes : 65535;
  dim3 grid((a.Wo + TILE - 1) / TILE, (a.Ho + TILE - 1) / TILE, (unsigned)planes);
  flrelu_kernel<UP, T><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(x), static_cast<T*>(y), a, f);
  return cudaGetLastError();
}

}  // namespace

// x, y: device pointers to (planes, h, w) and (planes, h*up/2, w*up/2),
// contiguous; dtype 0 = f32, 1 = bf16. up_taps (6*up floats) and
// down_taps (12 floats) are host arrays. pre_scale, pre_add, post_scale:
// device f32 (planes,) or null. Returns a cudaError_t (0 on success).
extern "C" int maua_filtered_lrelu(const void* x, void* y, int dtype, int up, const float* up_taps, int n_up,
                                   const float* down_taps, int n_down, const float* pre_scale,
                                   const float* pre_add, const float* post_scale, long long planes, int h,
                                   int w, void* stream) {
  if ((up != 2 && up != 4) || n_up != 6 * up || n_down != DT || (dtype != 0 && dtype != 1) || planes < 1 ||
      h < 1 || w < 1)
    return (int)cudaErrorInvalidValue;
  Taps f = {};
  for (int i = 0; i < n_up; ++i) f.up[i] = up_taps[i] * (float)up;
  for (int i = 0; i < DT; ++i) f.down[i] = down_taps[i];
  Args a = {pre_scale, pre_add, post_scale, planes, h, w, h * up / 2, w * up / 2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (up == 2)
    err = dtype == 0 ? launch<2, float>(x, y, a, f, s) : launch<2, __nv_bfloat16>(x, y, a, f, s);
  else
    err = dtype == 0 ? launch<4, float>(x, y, a, f, s) : launch<4, __nv_bfloat16>(x, y, a, f, s);
  return (int)err;
}
