// SAME-padded stride-1 correlation of int8 activations with int8 weights,
// exact int32 sums, f32 output; NCHW in and out, sm_90a.
//
// Replaces the XLA int8 convolutions of the JAX package's W8A8 plans:
// `maua_tpu/gan/fast_synthesis.py` `_conv_i8` (the s2d tail's cell convs)
// and the conv inside `maua_tpu/gan/stylegan3.py` `_modconv_int8` (the
// trunk), both `conv_general_dilated(..., preferred_element_type=int32)`
// followed by `.astype(float32)`. For x (B, Ci, H, W) and w (Co, Ci, k, k),
// k in {1, 3}:
//
//   y[b, co, h, w] = f32( sum_{dy, dx, ci} x[b, ci, h + dy - k/2, w + dx - k/2] w[co, ci, dy, dx] )
//
// with zeros outside the image. The sum is exact in int32 (at most
// 9 * 512 * 127^2 < 2^31 at the widest layer) and converted by
// round-to-nearest-even (`cvt.rn.f32.s32`), as XLA's convert does.
//
// Design: an implicit GEMM on the tensor cores with mma.sync
// m16n8k32.row.col.s32.s8.s8.s32 (M pixels, N output channels, K the taps
// times Ci), the tiling of `kconv_tc` in kconv.cu. A block owns 16 rows x 16
// columns of one image (one 16-pixel row per m16 tile, two rows per warp,
// eight warps) x CO = 64 output channels (32 where Co <= 32). The K loop
// walks the input channels in chunks of 32, one k32 step of the MMA per tap,
// so the taps are the MMA's K dimension. Per chunk the block stages the halo
// ((16 + k - 1)^2 pixels x 32 channels, 48 bytes a pixel) and the taps x CO x
// 32 weight slice (48 bytes a row), double-buffered: the weights, packed on
// the host as (Co / CO, Ci / 32, k^2, CO, 32) tiles, arrive by 16-byte
// cp.async; the halo is transposed from NCHW while it is staged (each thread
// packs 4 channels of one pixel, read as bytes along the image rows, into
// one 32-bit word) into the free stage before the current chunk's MMAs, while
// the SM's other block computes. (Holding the next halo in registers across
// the MMAs, or loading several words at once, spilled at 128 registers and ran
// slower on an H100.) Pixels and
// weight rows lie three 16-byte units apart, so every ldmatrix is
// conflict-free; s8 fragments of m16n8k32 have the byte layout of bf16's
// m16n8k16, so the A tile (16 pixels x 32 channels) and the B tiles (8
// channels x 32 input channels) are ldmatrix.x4 loads of b16 pairs. Channels past Ci (51, 81, 203, 323 at
// StyleGAN3 T's trunk) are zero in both operands; rows and columns past the
// image are not stored. The f32 store: a lane writes pixels g and g + 8 of
// its row for output channels 2t and 2t + 1 of each n8 tile, so a store
// instruction writes whole 32-byte sectors of NCHW rows.
//
// Bound at the StyleGAN2 tail (batch 8): the operations at 1979 TOPS dense
// int8, or the bytes of x and w read once and y (f32) written once at
// 3.35 TB/s. The launch goes on the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kChunk = 32;   // input channels per K step: one k32 of the MMA per tap
constexpr int kPixB = 48;    // bytes per halo pixel and per weight row in shared memory: 32 + 16 of padding
constexpr int kCols = 16;    // output columns per block: one m16 tile a row
constexpr int kRw = 2;       // output rows per warp
constexpr int kWarps = 8;
constexpr int kRows = kWarps * kRw;  // output rows per block
constexpr int kThreads = 32 * kWarps;

struct Params {
  const int8_t* x;  // (B, Ci, H, W)
  const int8_t* w;  // packed (Co / CO, chunks, k * k, CO, 32), zero-padded
  float* y;         // (B, Co, H, W)
  int B, Ci, H, W, Co, co_blocks, chunks;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// addr: a shared-memory address (the 32-bit form of smem_addr)
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a b for one m16n8k32 tile: a is 16 x 32 (row), b 32 x 8 (col), s8; c s32
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int KS, int CO>
struct Tile {
  static constexpr int P = KS / 2;                       // the halo's reach before the block
  static constexpr int HR = kRows + KS - 1, HC = kCols + KS - 1;
  static constexpr int NPIX = HR * HC;
  static constexpr int HALO = NPIX * kPixB;              // bytes of one halo stage
  static constexpr int TAPS = KS * KS;
  static constexpr int WTILE = TAPS * CO * kPixB;        // bytes of one weight stage
  static constexpr int ITEMS = (kChunk / 4) * NPIX;      // 4-channel words of one halo stage
  static constexpr int SMEM = 2 * (HALO + WTILE);
};

// Allows `bytes` of dynamic shared memory for `kernel` on the current device, once per device.
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

// at most 128 registers: two blocks an SM
template <int KS, int CO>
__global__ void __launch_bounds__(kThreads, 2) conv_i8_mma(Params p) {
  using T = Tile<KS, CO>;
  constexpr int NT = CO / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* xs = smem_raw;            // [2][NPIX][kPixB]
  unsigned char* ws = xs + 2 * T::HALO;    // [2][TAPS][CO][kPixB]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int w0 = blockIdx.x * kCols, h0 = blockIdx.y * kRows;
  const int b = blockIdx.z / p.co_blocks, ct = blockIdx.z - b * p.co_blocks, co0 = ct * CO;
  const long long plane = (long long)p.H * p.W;
  const int8_t* xb = p.x + (long long)b * p.Ci * plane;

  // the weight tile of chunk c into stage st, by 16-byte copies
  auto stage_weights = [&](int c, int st) {
    const int8_t* src = p.w + ((long long)ct * p.chunks + c) * (T::TAPS * CO * kChunk);
    unsigned char* dst = ws + st * T::WTILE;
    for (int e = tid; e < T::TAPS * CO * 2; e += kThreads)
      cp_async16(dst + (e >> 1) * kPixB + 16 * (e & 1), src + 16 * e);
  };
  // the halo of chunk c into stage st: item e is channels 4 grp .. 4 grp + 3 of halo pixel pix, neighbouring
  // threads on neighbouring pixels of one image row, read as bytes and stored as one word; zero outside the
  // image and past Ci
  auto stage_halo = [&](int c, int st) {
    const int ci0 = c * kChunk;
    unsigned char* dst = xs + st * T::HALO;
#pragma unroll 1  // a loop at run time: the items' offsets are not kept live across the chunk loop
    for (int e = tid; e < T::ITEMS; e += kThreads) {
      const int grp = e / T::NPIX, pix = e - grp * T::NPIX, r = pix / T::HC, col = pix - r * T::HC;
      const int h = h0 + r - T::P, ww = w0 + col - T::P, ci = ci0 + 4 * grp;
      unsigned word = 0;
      if (h >= 0 && h < p.H && ww >= 0 && ww < p.W) {
        const int8_t* src = xb + (long long)ci * plane + (long long)h * p.W + ww;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (ci + q < p.Ci) word |= (unsigned)(unsigned char)__ldg(src + q * plane) << (8 * q);
      }
      *reinterpret_cast<unsigned*>(dst + pix * kPixB + 4 * grp) = word;
    }
  };

  int acc[kRw][NT][4];
#pragma unroll
  for (int i = 0; i < kRw; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  // ldmatrix row addresses of this lane: A, 16 pixels x 32 channels (lanes 0-15 the first 16 bytes of pixels
  // 0-15, lanes 16-31 the second); B, two n8 tiles x 32 input channels (rows (lane & 7) + 8 (lane >> 4), bytes
  // 16 ((lane >> 3) & 1))
  const int a_off = (lane & 15) * kPixB + (lane >> 4) * 16;
  const int b_off = ((lane & 7) + ((lane >> 4) & 1) * 8) * kPixB + ((lane >> 3) & 1) * 16;

  stage_weights(0, 0);
  cp_async_commit();
  stage_halo(0, 0);
  for (int c = 0; c < p.chunks; ++c) {
    const int st = c & 1;
    if (c + 1 < p.chunks) {  // the next chunk into the other stage, freed by the barrier that ended step c - 1:
                             // its weights by cp.async, its halo before this step's MMAs
      stage_weights(c + 1, st ^ 1);
      cp_async_commit();
      stage_halo(c + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned xt = smem_addr(xs + st * T::HALO + warp * kRw * T::HC * kPixB + a_off);
    const unsigned wt = smem_addr(ws + st * T::WTILE + b_off);
#pragma unroll
    for (int tap = 0; tap < T::TAPS; ++tap) {
      const int dy = tap / KS, dx = tap - KS * dy;
      // both rows' A fragments, then one pair of n8 tiles of B at a time: 12 live fragment registers
      unsigned a[kRw][4];
#pragma unroll
      for (int i = 0; i < kRw; ++i) ldmatrix_x4(a[i], xt + ((i + dy) * T::HC + dx) * kPixB);
#pragma unroll
      for (int n = 0; n < NT / 2; ++n) {
        unsigned bf[4];
        ldmatrix_x4(bf, wt + (tap * CO + 16 * n) * kPixB);
#pragma unroll
        for (int i = 0; i < kRw; ++i) {
          mma_s8(acc[i][2 * n], a[i], bf[0], bf[1]);
          mma_s8(acc[i][2 * n + 1], a[i], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage st before step c + 1 refills it
  }

  // lane (g, t) holds pixels g and g + 8 of its row, output channels 8 j + 2 t and + 1; dst walks the channels
  const int g = lane >> 2, t2 = 2 * (lane & 3), hw = h0 + warp * kRw;
  float* dst = p.y + ((long long)b * p.Co + co0 + t2) * plane + (long long)hw * p.W + w0 + g;
#pragma unroll
  for (int j = 0; j < NT; ++j, dst += 8 * plane) {
    const int co = co0 + 8 * j + t2;
#pragma unroll
    for (int i = 0; i < kRw; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (hw + i >= p.H || w0 + g + 8 * half >= p.W) continue;
        float* d = dst + i * p.W + 8 * half;
        if (co < p.Co) d[0] = __int2float_rn(acc[i][j][2 * half]);
        if (co + 1 < p.Co) d[plane] = __int2float_rn(acc[i][j][2 * half + 1]);
      }
    }
  }
}

template <int KS, int CO>
int launch(Params p, cudaStream_t s) {
  using T = Tile<KS, CO>;
  p.co_blocks = (p.Co + CO - 1) / CO;
  const long long nz = (long long)p.B * p.co_blocks;
  if (nz > 65535 || (p.H + kRows - 1) / kRows > 65535) return 1003;
  static std::atomic<unsigned long long> allowed{0};
  const int err = allow_smem((const void*)conv_i8_mma<KS, CO>, T::SMEM, allowed);
  if (err) return err;
  dim3 grid((p.W + kCols - 1) / kCols, (p.H + kRows - 1) / kRows, (unsigned)nz);
  conv_i8_mma<KS, CO><<<grid, kThreads, T::SMEM, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// x int8 (B, Ci, H, W) and y f32 (B, Co, H, W), contiguous; w packed as (ceil(Co / T), ceil(Ci / 32), ks^2, T,
// 32) int8, zero-padded, 16-byte aligned, T = 32 where Co <= 32, else 64. ks is 1 or 3. Returns 0, a
// cudaError_t, 1003 (bad sizes), 1004 (a kernel size other than 1 or 3) or 1006 (device index over 63).
extern "C" int maua_conv_i8(const void* x, const void* w, float* y, int B, int Ci, int H, int W, int Co, int ks,
                            void* stream) {
  if (B <= 0 || Ci <= 0 || H <= 0 || W <= 0 || Co <= 0) return 1003;
  Params p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), y, B, Ci, H, W, Co, 0,
           (Ci + kChunk - 1) / kChunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ks == 3) return Co <= 32 ? launch<3, 32>(p, s) : launch<3, 64>(p, s);
  if (ks == 1) return Co <= 32 ? launch<1, 32>(p, s) : launch<1, 64>(p, s);
  return 1004;
}
