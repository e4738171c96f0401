// Flash attention, softmax(q k^T * scale) v, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel maua_tpu/kernels/attention.py
// `flash_attention` (bodies `_attn_kernel_single` and `_flash_kernel`).
// Both bodies compute the same function; the TPU chose between them by
// whether K and V fit VMEM. Here one online-softmax kernel serves every
// shape on the route: q (B, H, Nq, D), k and v (B, H, Nk, D), o like q,
// f32 or bf16, with Nq and Nk multiples of 256 and D a multiple of 8 up
// to 512. Each tensor comes with its own batch, head and row strides and
// a unit stride along D, so the (B, N, H, D) layout of a linear's output,
// viewed as (B, H, N, D), is read and written in place.
//
// Semantics (those of the TPU bodies): scores and the running row sum
// in f32; p = exp(s - running max) rounded to the input dtype before the
// p.v product (a no-op in f32); the p.v sum in f32; the output
// acc / row_sum rounded to q's dtype.
//
// Bound: the work is 4 * BH * Nq * Nk * D operations on inputs of
// 4 * BH * N * D elements, so every shape of the path is bound by
// operations, not bytes. This first version computes on the CUDA cores
// in f32 (bf16 inputs are widened on load, so products are exact, as on
// a tensor core with f32 accumulation).
//
// Design: one block of 256 threads (16 x 16) owns BQ = 16 * RM query
// rows of one (batch, head) and walks the keys in tiles of BK. Q, the
// K and V tiles, and the tile's probabilities live in shared memory as
// f32, rows padded to an odd stride so that column reads hit distinct
// banks. Thread (ty, tx) owns query rows ty*RM + i for both the score
// tile (columns tx + 16 j) and the output accumulator (columns
// tx + 16 j of D, padded to 16 * NJ), so the row max and row sum stay in
// registers and are reduced across the 16 lanes of a row with shuffles.
// D = 512 in f32 needs its key tile cut to 32 rows to stay inside the
// 227 KB a block may use; anything above 48 KB is requested with
// cudaFuncSetAttribute, once per template instance and device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
  static __device__ __forceinline__ float round_p(float x) { return x; }
  static __device__ __forceinline__ float from(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    __nv_bfloat162 a = *reinterpret_cast<__nv_bfloat162*>(&raw.x);
    __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&raw.y);
    float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
    return make_float4(fa.x, fa.y, fb.x, fb.y);
  }
  static __device__ __forceinline__ float round_p(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
  static __device__ __forceinline__ __nv_bfloat16 from(float x) { return __float2bfloat16_rn(x); }
};

// strides in elements of q, k, v and o: batch, head, row (D has stride 1)
struct Layout {
  long long b[4], h[4], n[4];
};

// rows x d elements of src, rows `ld` apart -> dst rows of `stride` floats.
// The row and column of each thread's next float4 are stepped, not
// divided out, so no load address waits on an integer division.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int ld, float* dst, int rows, int d,
                                          int stride) {
  const int d4 = d >> 2;
  const int n4 = rows * d4;
  const int dr = kThreads / d4, dc = kThreads - dr * d4;
  int r = threadIdx.x / d4, c = threadIdx.x - r * d4;
#pragma unroll 4
  for (int e = threadIdx.x; e < n4; e += kThreads) {
    const float4 x = Elem<T>::load4(src + r * ld + 4 * c);
    float* p = dst + r * stride + 4 * c;
    p[0] = x.x;
    p[1] = x.y;
    p[2] = x.z;
    p[3] = x.w;
    r += dr;
    c += dc;
    if (c >= d4) {
      c -= d4;
      ++r;
    }
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// shared memory of one block, in floats, for head dim d
template <int NJ, int RM, int BK>
__host__ __device__ constexpr long smem_floats(int d) {
  return (long)(16 * RM) * (d + 1) + (long)BK * (d + 1) + (long)BK * (16 * NJ + 1) + (long)(16 * RM) * (BK + 1);
}

template <typename T, int NJ, int RM, int BK>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
                    int nh, int nq, int nk, int d, float scale, Layout L) {
  constexpr int BQ = 16 * RM;
  constexpr int CN = BK / 16;
  constexpr int DP = 16 * NJ;
  constexpr int VS = DP + 1;
  constexpr int PS = BK + 1;
  extern __shared__ float smem[];
  const int dq = d + 1;
  float* Qs = smem;            // [BQ][d + 1]
  float* Ks = Qs + BQ * dq;    // [BK][d + 1]
  float* Vs = Ks + BK * dq;    // [BK][DP + 1], columns >= d stay zero
  float* Ps = Vs + BK * VS;    // [BQ][BK + 1]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bi = blockIdx.y / nh, hi = blockIdx.y - bi * nh;
  const int q0 = blockIdx.x * BQ;
  const T* kb = k + bi * L.b[1] + hi * L.h[1];
  const T* vb = v + bi * L.b[2] + hi * L.h[2];

  load_tile<T>(q + bi * L.b[0] + hi * L.h[0] + q0 * L.n[0], (int)L.n[0], Qs, BQ, d, dq);
  for (int i = tid; i < BK * (DP - d); i += kThreads) {
    const int r = i / (DP - d);
    Vs[r * VS + d + (i - r * (DP - d))] = 0.f;
  }

  float acc[RM][NJ];
  float m[RM], l[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < nk; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T>(kb + k0 * L.n[1], (int)L.n[1], Ks, BK, d, dq);
    load_tile<T>(vb + k0 * L.n[2], (int)L.n[2], Vs, BK, d, VS);
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
    const float* qrow = Qs + (ty * RM) * dq;
    const float* krow = Ks + tx * dq;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float a[RM], b[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = qrow[i * dq + c];
#pragma unroll
      for (int j = 0; j < CN; ++j) b[j] = krow[16 * j * dq + c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        s[i][j] *= scale;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty * RM + i) * PS + tx + 16 * j] = Elem<T>::round_p(p);
      }
      l[i] = l[i] * corr + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    const float* prow = Ps + (ty * RM) * PS;
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float p[RM], vv[NJ];
#pragma unroll
      for (int i = 0; i < RM; ++i) p[i] = prow[i * PS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[kk * VS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    T* orow = o + bi * L.b[3] + hi * L.h[3] + (q0 + ty * RM + i) * L.n[3];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) orow[c] = Elem<T>::from(acc[i][j] / l[i]);
    }
  }
}

template <typename T, int NJ, int RM, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int nb, int nh, int nq, int nk, int d, float scale,
           const Layout& L, cudaStream_t stream) {
  constexpr int BQ = 16 * RM;
  if (nq % BQ != 0 || nk % BK != 0 || d > 16 * NJ) return 1001;
  auto kernel = flash_attention_fwd<T, NJ, RM, BK>;
  // the instance's most shared memory (at d = 16 NJ), allowed once per device
  static std::atomic<unsigned long long> allowed{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return 1006;
  if (!(allowed.load() >> dev & 1ull)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(sizeof(float) * smem_floats<NJ, RM, BK>(16 * NJ)));
    if (err != cudaSuccess) return (int)err;
    allowed.fetch_or(1ull << dev);
  }
  const size_t bytes = sizeof(float) * smem_floats<NJ, RM, BK>(d);
  dim3 grid(nq / BQ, nb * nh);
  kernel<<<grid, kThreads, bytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                            static_cast<const T*>(v), static_cast<T*>(o), nh, nq, nk, d, scale, L);
  return (int)cudaGetLastError();
}

// head dims up to 128: 64 query rows, 64-key tiles; up to 256: 32 rows;
// up to 512: 32 rows and 32-key tiles (shared memory)
template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int nb, int nh, int nq, int nk, int d, float scale,
             const Layout& L, cudaStream_t s) {
  if (d <= 32) return launch<T, 2, 4, 64>(q, k, v, o, nb, nh, nq, nk, d, scale, L, s);
  if (d <= 64) return launch<T, 4, 4, 64>(q, k, v, o, nb, nh, nq, nk, d, scale, L, s);
  if (d <= 80) return launch<T, 5, 4, 64>(q, k, v, o, nb, nh, nq, nk, d, scale, L, s);
  if (d <= 128) return launch<T, 8, 4, 64>(q, k, v, o, nb, nh, nq, nk, d, scale, L, s);
  if (d <= 160) return launch<T, 10, 2, 64>(q, k, v, o, nb, nh, nq, nk, d, scale, L, s);
  if (d <= 256) return launch<T, 16, 2, 64>(q, k, v, o, nb, nh, nq, nk, d, scale, L, s);
  if (d <= 512) return launch<T, 32, 2, 32>(q, k, v, o, nb, nh, nq, nk, d, scale, L, s);
  return 1002;
}

}  // namespace

// q (nb, nh, nq, d), k and v (nb, nh, nk, d), o (nb, nh, nq, d); dtype 0 = f32,
// 1 = bf16. `strides` holds 12 element strides: batch, head and row of q,
// then of k, v and o; each must be a multiple of 4, row strides under 2^24
// (offsets inside a tile are 32-bit), and each pointer 16-byte aligned. Returns 0, a cudaError_t, or 1000 + n for arguments the kernel
// does not take.
extern "C" int maua_flash_attention(const void* q, const void* k, const void* v, void* o, int dtype, int nb, int nh,
                                    int nq, int nk, int d, float scale, const long long* strides, void* stream) {
  if (nb <= 0 || nh <= 0 || (long long)nb * nh > 65535 || nq <= 0 || nk <= 0 || d <= 0 || d % 8 != 0) return 1003;
  Layout L;
  for (int t = 0; t < 4; ++t) {
    L.b[t] = strides[3 * t];
    L.h[t] = strides[3 * t + 1];
    L.n[t] = strides[3 * t + 2];
    if (L.b[t] % 4 || L.h[t] % 4 || L.n[t] % 4 || L.n[t] >= (1 << 24)) return 1005;
  }
  for (const void* p : {q, k, v, static_cast<const void*>(o)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return 1005;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, k, v, o, nb, nh, nq, nk, d, scale, L, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(q, k, v, o, nb, nh, nq, nk, d, scale, L, s);
  return 1004;
}
