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
// operations, not bytes: at 67 TFLOP/s (f32 on the CUDA cores) 0.080 ms
// for the UNet's (2, 8, 1024, 80), 0.010 ms for (2, 8, 256, 160) and
// 0.513 ms for the VAE's (1, 1, 4096, 512). Two kernels:
//
// f32, `flash_attention_f32` (on the CUDA cores, so that f32 results stay
// those of exact f32 products; TF32 would not): register blocking as in
// an SGEMM. One block of 256 threads (16 x 16) owns BQ = 16 TM query rows
// of one (batch, head), TM fixed by the padded D: TM = 8 at the UNet's
// D = 80 (the UNet's 16 x 1024 query rows still give 128 blocks),
// TM = 2 from D = 160 up (the output's registers, and the UNet's
// (2, 8, 256, 160) keeps 128 blocks), TM = 4 elsewhere. It walks the
// keys in tiles of BK = 16 TN (64 keys up to D = 160, 32 above, for
// shared memory). Thread (ty, tx) owns rows
// ty TM + i of S = Q K^T and of the output, score columns tx + 16 j, and
// output columns 64 j + 4 tx + e (e < 4) and 64 (DP / 64) + 16 j + tx, with
// D padded to DP, a multiple of 16 (zero columns past D). Q and the K
// tile sit row-major in shared memory, rows an odd number of 16-byte
// chunks apart, so S reads Q and K 4 depths at a time with 128-bit loads
// (Q's a broadcast to the 16 lanes of a row, K's on distinct banks): one
// load per 5-11 multiply-adds, where the design this replaced read
// scalars, one per two. Where a thread has 4 or 8 scores, each sums its
// depths in 4 or 2 interleaved partial sums (shorter dependent chains, and
// a rounding error that grows over D / 4 terms). p = 2^(s scale log2(e) - running max)
// (ex2.approx) goes to shared memory as P [BQ][BK + 4]; P V reads 4 keys
// of P per 128-bit load and each V row with 128-bit loads. The row max
// and sum are reduced over a row's 16 lanes with shuffles and stay in
// registers, as does the output accumulator. K and V tiles arrive by
// 16-byte cp.async into one buffer each: K tile t + 1 lands while P V of
// tile t runs, V tile t + 1 while Q K^T of tile t + 1 runs. Shared memory
// is 117 KiB for the UNet's D = 80 in 128-row blocks and 197.5 KiB at
// D = 512 (one block an SM); above 48 KB it is requested with
// cudaFuncSetAttribute, once per instance and device.
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
#include <type_traits>

namespace {

// strides in elements of q, k, v and o: batch, head, row (D has stride 1)
struct Layout {
  long long b[4], h[4], n[4];
};

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


// ---- f32 on the CUDA cores ----

// Shared memory of one f32 block in floats: Q and the K tile with rows of an odd count of 16-byte chunks
// (`f32_row`), the V tile with rows of DP floats, and P with rows of BK + 4 floats.
__host__ __device__ constexpr int f32_row(int dp) { return ((dp / 4) | 1) * 4; }
__host__ __device__ constexpr long f32_smem_bytes(int dp, int bq, int bk) {
  return 4L * ((long)(bq + bk) * f32_row(dp) + (long)bk * dp + (long)bq * (bk + 4));
}

template <int E>
__device__ __forceinline__ float lane4(const float4& x) {
  return E == 0 ? x.x : E == 1 ? x.y : E == 2 ? x.z : x.w;
}

__device__ __forceinline__ float row_max16(float x) {  // over the 16 lanes tx of one thread row
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// DP: D rounded up to 16 (columns d..DP arrive as zeros). 256 threads as 16 x 16: thread (ty, tx) owns
// query rows ty * TM + i (i < TM) of the block's BQ = 16 TM, score columns tx + 16 j (j < TN) of the
// tile's BK = 16 TN keys, and output columns 64 j + 4 tx + e (j < DP / 64, e < 4) and 64 (DP / 64) + 16 j
// + tx, so its rows' max and sum are reduced over its 16 lanes with shuffles and every shared-memory read
// of the inner loops is a 128-bit load or a broadcast.
// two blocks an SM (at most 128 registers a thread) where their shared memory fits, else one
template <int DP, int TM, int TN>
__global__ void __launch_bounds__(256, f32_smem_bytes(DP, 16 * TM, 16 * TN) <= 113 * 1024 ? 2 : 1)
flash_attention_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                    float* __restrict__ o, int nh, int nk, int d, float scale_log2, Layout L) {
  constexpr int BQ = 16 * TM, BK = 16 * TN, SK = f32_row(DP), SP = BK + 4, CH = DP / 4;
  constexpr int DJ = DP / 16, A4 = DJ / 4, B1 = DJ % 4;
  constexpr int NP = TM * TN <= 4 ? 4 : TM * TN <= 8 ? 2 : 1;
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;           // [BQ][SK]
  float* Ks = Qs + BQ * SK;  // [BK][SK]
  float* Vs = Ks + BK * SK;  // [BK][DP]
  float* Ps = Vs + BK * DP;  // [BQ][SP]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bi = blockIdx.y / nh, hi = blockIdx.y - bi * nh;
  const int q0 = blockIdx.x * BQ;
  const float* kb = k + bi * L.b[1] + hi * L.h[1];
  const float* vb = v + bi * L.b[2] + hi * L.h[2];
  const int dch = d / 4;  // 16-byte chunks of a row that hold data; the rest are zero-filled

  // `rows` rows of CH chunks from src (rows `ld` floats apart) into dst (rows `stride` apart)
  auto copy = [&](float* dst, int stride, const float* src, long long ld, int rows) {
    for (int e = tid; e < rows * CH; e += 256) {
      const int r = e / CH, c = e - r * CH;
      const bool in = c < dch;
      cp_async16(dst + r * stride + 4 * c, in ? src + r * ld + 4 * c : src, in ? 16 : 0);
    }
  };
  // Commit groups, in order: Q with K tile 0, V tile 0, then K tile t + 1 while P V of tile t runs and
  // V tile t + 1 while Q K^T of tile t + 1 runs. Each tile has one K and one V buffer.
  const int ntiles = nk / BK;
  copy(Qs, SK, q + bi * L.b[0] + hi * L.h[0] + (long long)q0 * L.n[0], L.n[0], BQ);
  copy(Ks, SK, kb, L.n[1], BK);
  cp_async_commit();
  copy(Vs, DP, vb, L.n[2], BK);
  cp_async_commit();

  float acc[TM][DJ], m[TM], l[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }
  const float* qrow = Qs + ty * TM * SK;
  const float* krow = Ks + tx * SK;
  const float* prow = Ps + ty * TM * SP;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<1>();  // K tile t has landed (V tile t may still be in flight)
    __syncthreads();

    // NP partial sums per score (depths c + e with e % NP fixed) where a thread has few scores: shorter
    // dependent chains of multiply-adds, and a rounding error that grows over D / NP terms, not D
    float sp[NP][TM][TN];
#pragma unroll
    for (int e = 0; e < NP; ++e)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) sp[e][i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; c += 4) {
      float4 kv[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) kv[j] = *reinterpret_cast<const float4*>(krow + 16 * j * SK + c);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qrow + i * SK + c);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          sp[0][i][j] = fmaf(qv.x, kv[j].x, sp[0][i][j]);
          sp[1 % NP][i][j] = fmaf(qv.y, kv[j].y, sp[1 % NP][i][j]);
          sp[2 % NP][i][j] = fmaf(qv.z, kv[j].z, sp[2 % NP][i][j]);
          sp[3 % NP][i][j] = fmaf(qv.w, kv[j].w, sp[3 % NP][i][j]);
        }
      }
    }
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        s[i][j] = NP == 4 ? (sp[0][i][j] + sp[1 % NP][i][j]) + (sp[2 % NP][i][j] + sp[3 % NP][i][j])
                : NP == 2 ? sp[0][i][j] + sp[1 % NP][i][j] : sp[0][i][j];

    // online softmax in base 2: s * scale * log2(e), p = 2^(s - running max)
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        s[i][j] *= scale_log2;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max16(mx);
      const float corr = fast_exp2(m[i] - mx);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = fast_exp2(s[i][j] - mx);
        sum += p;
        Ps[(ty * TM + i) * SP + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + row_sum16(sum);
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();  // P is written, and every thread is done with K tile t
    if (t + 1 < ntiles) {
      copy(Ks, SK, kb + (long long)(t + 1) * BK * L.n[1], L.n[1], BK);
      cp_async_commit();
      cp_async_wait<1>();  // V tile t has landed (K tile t + 1 may still be in flight)
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) pv[i] = *reinterpret_cast<const float4*>(prow + i * SP + kk);
      auto key = [&](auto e_) {
        constexpr int E = decltype(e_)::value;
        const float* vr = Vs + (kk + E) * DP;
        float vv[DJ];
#pragma unroll
        for (int j = 0; j < A4; ++j) {
          const float4 x = *reinterpret_cast<const float4*>(vr + 64 * j + 4 * tx);
          vv[4 * j] = x.x;
          vv[4 * j + 1] = x.y;
          vv[4 * j + 2] = x.z;
          vv[4 * j + 3] = x.w;
        }
#pragma unroll
        for (int j = 0; j < B1; ++j) vv[4 * A4 + j] = vr[64 * A4 + 16 * j + tx];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float p = lane4<E>(pv[i]);
#pragma unroll
          for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
        }
      };
      key(std::integral_constant<int, 0>{});
      key(std::integral_constant<int, 1>{});
      key(std::integral_constant<int, 2>{});
      key(std::integral_constant<int, 3>{});
    }
    __syncthreads();  // every thread is done with V tile t and with P
    if (t + 1 < ntiles) {
      copy(Vs, DP, vb + (long long)(t + 1) * BK * L.n[2], L.n[2], BK);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float* orow = o + bi * L.b[3] + hi * L.h[3] + (long long)(q0 + ty * TM + i) * L.n[3];
#pragma unroll
    for (int j = 0; j < A4; ++j) {
      const int c = 64 * j + 4 * tx;
      if (c < d)
        *reinterpret_cast<float4*>(orow + c) = make_float4(acc[i][4 * j] / l[i], acc[i][4 * j + 1] / l[i],
                                                           acc[i][4 * j + 2] / l[i], acc[i][4 * j + 3] / l[i]);
    }
#pragma unroll
    for (int j = 0; j < B1; ++j) {
      const int c = 64 * A4 + 16 * j + tx;
      if (c < d) orow[c] = acc[i][4 * A4 + j] / l[i];
    }
  }
}

template <int DP, int TM, int TN>
int launch_f32(const void* q, const void* k, const void* v, void* o, int nb, int nh, int nq, int nk, int d,
               float scale, const Layout& L, cudaStream_t stream) {
  constexpr int BQ = 16 * TM, BK = 16 * TN;
  if (nq % BQ != 0 || nk % BK != 0 || d > DP) return 1001;
  auto kernel = flash_attention_f32<DP, TM, TN>;
  constexpr long bytes = f32_smem_bytes(DP, BQ, BK);
  static std::atomic<unsigned long long> allowed{0};  // above 48 KB, allowed once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return 1006;
  if (!(allowed.load() >> dev & 1ull)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    allowed.fetch_or(1ull << dev);
  }
  dim3 grid(nq / BQ, nb * nh);
  kernel<<<grid, 256, bytes, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                       static_cast<const float*>(v), static_cast<float*>(o), nh, nk, d,
                                       scale * 1.4426950408889634f, L);
  return (int)cudaGetLastError();
}

// D rounded up to 16 picks the instance: 64-key tiles up to 160, 32-key tiles above (shared memory); 128-row
// blocks at D = 80 (the UNet's), 32-row blocks from 160 up (the output's registers), 64-row blocks elsewhere
int dispatch_f32(const void* q, const void* k, const void* v, void* o, int nb, int nh, int nq, int nk, int d,
                 float scale, const Layout& L, cudaStream_t s) {
  const int dp = (d + 15) & ~15;
  if (dp <= 32) return launch_f32<32, 4, 4>(q, k, v, o, nb, nh, nq, nk, d, scale, L, s);
  if (dp <= 64) return launch_f32<64, 4, 4>(q, k, v, o, nb, nh, nq, nk, d, scale, L, s);
  if (dp <= 80) return launch_f32<80, 8, 4>(q, k, v, o, nb, nh, nq, nk, d, scale, L, s);
  if (dp <= 128) return launch_f32<128, 4, 4>(q, k, v, o, nb, nh, nq, nk, d, scale, L, s);
  if (dp <= 160) return launch_f32<160, 2, 4>(q, k, v, o, nb, nh, nq, nk, d, scale, L, s);
  if (dp <= 256) return launch_f32<256, 2, 4>(q, k, v, o, nb, nh, nq, nk, d, scale, L, s);
  if (d <= kMaxHeadDim) return launch_f32<512, 2, 2>(q, k, v, o, nb, nh, nq, nk, d, scale, L, s);
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
  if (dtype == 0) return dispatch_f32(q, k, v, o, nb, nh, nq, nk, d, scale, L, s);
  return dispatch_tc(q, k, v, o, nb, nh, nq, nk, d, scale, L, s);
}
