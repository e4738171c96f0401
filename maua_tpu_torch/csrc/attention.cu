// Flash attention, softmax(q k^T * scale) v, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel maua_tpu/kernels/attention.py
// `flash_attention` (bodies `_attn_kernel_single` and `_flash_kernel`).
// Both bodies compute the same function; the TPU chose between them by
// whether K and V fit VMEM. Here online-softmax kernels serve every
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
// operations, not bytes. Two kernels:
//
// f32, `flash_attention_fwd` (on the CUDA cores, so that f32 results stay
// those of exact f32 products): one block of 256 threads (16 x 16) owns
// BQ = 16 * RM query rows of one (batch, head) and walks the keys in
// tiles of BK. Q, the K and V tiles, and the tile's probabilities live in
// shared memory as f32, rows padded to an odd stride so that column reads
// hit distinct banks. Thread (ty, tx) owns query rows ty*RM + i for both
// the score tile (columns tx + 16 j) and the output accumulator (columns
// tx + 16 j of D, padded to 16 * NJ), so the row max and row sum stay in
// registers and are reduced across the 16 lanes of a row with shuffles.
// D = 512 in f32 needs its key tile cut to 32 rows to stay inside the
// 227 KB a block may use; anything above 48 KB is requested with
// cudaFuncSetAttribute, once per template instance and device.
//
// bf16, `flash_attention_tc` (FlashAttention-2's shape on the tensor
// cores' warp-level mma.sync m16n8k16, bf16 in, f32 accumulate): a block
// of 2 or 4 warps owns 16 query rows per warp of one (batch, head) and
// walks the keys in tiles of BK = 64 (32 when D > 160). Q and the K and V
// tiles stay bf16 in shared memory, each row padded by 8 elements so that
// the eight 16-byte rows of an ldmatrix fall on distinct banks; D is
// padded with zero columns, never stored, to the instance's width. Tiles
// arrive by 16-byte cp.async copies (zero-filled past D) into three
// stages, so tiles t + 1 and t + 2 are in flight while tile t is
// multiplied, with one barrier per tile. S = Q K^T reads Q and K with
// ldmatrix (K's rows are the B operand's columns); the online softmax
// runs on the score fragments in registers (a lane holds two rows, whose
// max and sum are reduced over its quad with shuffles); p is rounded to
// bf16 and repacked from the accumulator fragment into the A fragment of
// O += P V in registers, V read with ldmatrix.trans. The output of a
// warp's 16 rows costs DV / 2 f32 registers a lane, so above D = 160 each
// block owns a 128-column slice of the output and recomputes S for it
// (grid z); where 64-row blocks would not fill the card's 132 SMs once,
// blocks take 32 rows.

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


// ---- bf16 on the tensor cores ----

using bf16 = __nv_bfloat16;
constexpr int kMaxHeadDim = 512;
constexpr int kRowPad = 8;  // bf16 elements added to every shared-memory row: an odd number of 16-byte units

__device__ __forceinline__ unsigned smem_addr(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

// 16 bytes from src, or zeros where `bytes` is 0 (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half: the lower column
  return *reinterpret_cast<unsigned*>(&v);
}

// `rows` rows of CH 16-byte chunks (CH > 0: a compile-time count, else `ch`) into dst (rows `stride` apart):
// the first `valid` chunks of a row from src (rows `ld` elements apart), the rest zeros
template <int CH>
__device__ __forceinline__ void copy_rows(bf16* dst, int stride, const bf16* src, long long ld, int rows, int ch,
                                          int valid) {
  const int chunks = CH > 0 ? CH : ch;
  for (int e = threadIdx.x; e < rows * chunks; e += blockDim.x) {
    const int r = e / chunks, c = e - r * chunks;
    const bool in = c < valid;
    cp_async16(dst + r * stride + 8 * c, in ? src + r * ld + 8 * c : src, in ? 16 : 0);
  }
}

constexpr int kStages = 3;  // K and V tiles in flight: the one being multiplied and the next two

// shared memory of one block in bytes: Q, then the stages of K and of V
__host__ __device__ constexpr long tc_smem_bytes(int bq, int bk, int dqk, int dv) {
  return 2L * ((long)bq * (dqk + kRowPad) + (long)kStages * bk * (dqk + kRowPad + dv + kRowPad));
}

__device__ __forceinline__ float fast_exp2(float x) {  // 2^x to 2^-22 relative, 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// DV: output columns per block (a multiple of 16). SLICED: the output is cut into DV-column slices and
// dqk (D rounded up to 16, up to 512) is a runtime count, with 32-key tiles; else one slice, dqk == DV
// (columns past D are zero), and 64-key tiles.
template <int DV, bool SLICED>
__global__ void __launch_bounds__(128)
flash_attention_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                   bf16* __restrict__ o, int nh, int nk, int d, int dqk, float scale_log2, Layout L) {
  constexpr int BK = SLICED ? 32 : 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bq = blockDim.x / 2;  // 16 rows per warp
  const int qs = dqk + kRowPad, vs = DV + kRowPad;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [bq][qs]
  bf16* Ks = Qs + bq * qs;                       // [kStages][BK][qs]
  bf16* Vs = Ks + kStages * BK * qs;             // [kStages][BK][vs]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bi = blockIdx.y / nh, hi = blockIdx.y - bi * nh;
  const int q0 = blockIdx.x * bq, c0 = blockIdx.z * DV;
  const int dv = min(DV, d - c0);  // columns of V and o in this block's slice, a multiple of 8
  const bf16* kb = k + bi * L.b[1] + hi * L.h[1];
  const bf16* vb = v + bi * L.b[2] + hi * L.h[2] + c0;

  // tile t of K and V goes to stage t % kStages, one commit group per tile (Q joins tile 0's). Q's and K's
  // columns d..dqk and V's dv..DV are zero-filled, so they add nothing.
  constexpr int QCH = SLICED ? 0 : DV / 8;  // 16-byte chunks of a Q or K row, where known at compile time
  auto load_tile = [&](int t) {
    const int st = t % kStages;
    copy_rows<QCH>(Ks + st * BK * qs, qs, kb + t * BK * L.n[1], L.n[1], BK, dqk / 8, d / 8);
    copy_rows<DV / 8>(Vs + st * BK * vs, vs, vb + t * BK * L.n[2], L.n[2], BK, DV / 8, dv / 8);
    cp_async_commit();
  };
  const int ntiles = nk / BK;
  copy_rows<QCH>(Qs, qs, q + bi * L.b[0] + hi * L.h[0] + q0 * L.n[0], L.n[0], bq, dqk / 8, d / 8);
  load_tile(0);
  if (ntiles > 1) load_tile(1);

  float acc[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8 of the warp's 16 (g = lane / 4)

  // ldmatrix row addresses of this lane: Q (A, 16 x 16), K (B, two n8 tiles), V (B via .trans, two n8 tiles)
  const bf16* qa = Qs + (warp * 16 + (lane & 15)) * qs + (lane >> 4) * 8;
  const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * qs + ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * vs + (lane >> 4) * 8;

  for (int t = 0; t < ntiles; ++t) {
    // tile t has landed (tile t + 1 may still be in flight) ...
    if (t + 1 < ntiles) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();
    // ... and every warp is past step t - 1, so tile t + 2 may refill that step's stage
    if (t + 2 < ntiles) load_tile(t + 2);
    const int st = t % kStages;
    const bf16* Kt = Ks + st * BK * qs;
    const bf16* Vt = Vs + st * BK * vs;

    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    auto qk_step = [&](int kd) {
      unsigned a[4];
      ldmatrix_x4(a, qa + kd);
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        unsigned b[4];
        ldmatrix_x4(b, Kt + 16 * j * qs + k_off + kd);
        mma_bf16(s[2 * j], a, b[0], b[1]);
        mma_bf16(s[2 * j + 1], a, b[2], b[3]);
      }
    };
    if (SLICED) {
#pragma unroll 4
      for (int kd = 0; kd < dqk; kd += 16) qk_step(kd);
    } else {
#pragma unroll
      for (int kd = 0; kd < DV; kd += 16) qk_step(kd);
    }

    // online softmax in base 2: s * scale * log2(e), p = 2^(s - m)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = fast_exp2(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }
    // p: the row sums take it in f32, the product rounded to bf16, as the A fragments of P V
    unsigned pa[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p0 = fast_exp2(s[j][0] - m[0]), p1 = fast_exp2(s[j][1] - m[0]);
      const float p2 = fast_exp2(s[j][2] - m[1]), p3 = fast_exp2(s[j][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pa[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < DV / 16; ++n) {
        unsigned b[4];
        ldmatrix_x4_trans(b, Vt + 16 * kk * vs + v_off + 16 * n);
        mma_bf16(acc[2 * n], pa[kk], b[0], b[1]);
        mma_bf16(acc[2 * n + 1], pa[kk], b[2], b[3]);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / l[i];
  }
  const int row = q0 + warp * 16 + (lane >> 2), col = c0 + 2 * (lane & 3);
  bf16* o0 = o + bi * L.b[3] + hi * L.h[3] + row * L.n[3] + col;
  bf16* o1 = o0 + 8 * L.n[3];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    if (8 * j < dv) {
      *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) = __floats2bfloat162_rn(acc[j][0] * inv[0], acc[j][1] * inv[0]);
      *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j) = __floats2bfloat162_rn(acc[j][2] * inv[1], acc[j][3] * inv[1]);
    }
  }
}

template <int DV, bool SLICED>
int launch_tc(const void* q, const void* k, const void* v, void* o, int nb, int nh, int nq, int nk, int d,
              float scale, const Layout& L, cudaStream_t stream) {
  constexpr int BK = SLICED ? 32 : 64;
  const int dqk = SLICED ? (d + 15) & ~15 : DV;
  const int slices = (d + DV - 1) / DV;
  // 64 query rows a block, or 32 where 64-row blocks would not fill the card once
  const int bq = (long long)(nq / 64) * nb * nh * slices < 132 ? 32 : 64;
  if (nq % bq != 0 || nk % BK != 0 || d > (SLICED ? kMaxHeadDim : DV)) return 1001;
  auto kernel = flash_attention_tc<DV, SLICED>;
  // the instance's most shared memory (64 rows, the largest D it serves), allowed once per device
  static std::atomic<unsigned long long> allowed{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return 1006;
  if (!(allowed.load() >> dev & 1ull)) {
    const int dmax = SLICED ? kMaxHeadDim : DV;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)tc_smem_bytes(64, BK, dmax, DV));
    if (err != cudaSuccess) return (int)err;
    allowed.fetch_or(1ull << dev);
  }
  dim3 grid(nq / bq, nb * nh, slices);
  kernel<<<grid, 2 * bq, tc_smem_bytes(bq, BK, dqk, DV), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<bf16*>(o),
      nh, nk, d, dqk, scale * 1.4426950408889634f, L);
  return (int)cudaGetLastError();
}

// D rounded up to 16 picks the instance; above 160 the output is cut into 128-column slices
int dispatch_tc(const void* q, const void* k, const void* v, void* o, int nb, int nh, int nq, int nk, int d,
                float scale, const Layout& L, cudaStream_t s) {
  const int dqk = (d + 15) & ~15;
  if (dqk <= 32) return launch_tc<32, false>(q, k, v, o, nb, nh, nq, nk, d, scale, L, s);
  if (dqk <= 64) return launch_tc<64, false>(q, k, v, o, nb, nh, nq, nk, d, scale, L, s);
  if (dqk <= 80) return launch_tc<80, false>(q, k, v, o, nb, nh, nq, nk, d, scale, L, s);
  if (dqk <= 128) return launch_tc<128, false>(q, k, v, o, nb, nh, nq, nk, d, scale, L, s);
  if (dqk <= 160) return launch_tc<160, false>(q, k, v, o, nb, nh, nq, nk, d, scale, L, s);
  if (d <= kMaxHeadDim) return launch_tc<128, true>(q, k, v, o, nb, nh, nq, nk, d, scale, L, s);
  return 1002;
}

}  // namespace

// q (nb, nh, nq, d), k and v (nb, nh, nk, d), o (nb, nh, nq, d); dtype 0 = f32,
// 1 = bf16. `strides` holds 12 element strides: batch, head and row of q,
// then of k, v and o; each must be a multiple of 16 bytes (4 f32 or 8 bf16
// elements), row strides under 2^24 elements (offsets inside a tile are
// 32-bit), and each pointer 16-byte aligned. Returns 0, a cudaError_t, or
// 1000 + n for arguments the kernel does not take.
extern "C" int maua_flash_attention(const void* q, const void* k, const void* v, void* o, int dtype, int nb, int nh,
                                    int nq, int nk, int d, float scale, const long long* strides, void* stream) {
  if (nb <= 0 || nh <= 0 || (long long)nb * nh > 65535 || nq <= 0 || nk <= 0 || d <= 0 || d % 8 != 0) return 1003;
  if (dtype != 0 && dtype != 1) return 1004;
  const int elem = dtype == 0 ? 4 : 2;
  Layout L;
  for (int t = 0; t < 4; ++t) {
    L.b[t] = strides[3 * t];
    L.h[t] = strides[3 * t + 1];
    L.n[t] = strides[3 * t + 2];
    if ((L.b[t] * elem) % 16 || (L.h[t] * elem) % 16 || (L.n[t] * elem) % 16 || L.n[t] >= (1 << 24)) return 1005;
  }
  for (const void* p : {q, k, v, static_cast<const void*>(o)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return 1005;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, k, v, o, nb, nh, nq, nk, d, scale, L, s);
  return dispatch_tc(q, k, v, o, nb, nh, nq, nk, d, scale, L, s);
}
