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
// What bounds it: at the StyleGAN2 tail (batch 8) the bytes, mostly the f32
// outputs (3.2 of the 4.2 GB the four convs move at 3.35 TB/s), except b512
// conv1 (Ci = Co = 256), which is bound by its 618 G operations at 1979 TOPS
// dense int8; StyleGAN3's trunk is bound by operations up to 276^2 and by the
// f32 outputs at 532^2 and 1044^2.
//
// Design: an implicit GEMM on the tensor cores with wgmma.mma_async
// m64nNk32.s32.s8.s8, both operands in shared memory: M is a patch of 64
// output pixels, N up to 256 output channels, K the taps times Ci in chunks
// of 32 channels. A persistent block (one an SM, 384 threads) walks output
// tiles of BR x BC pixels x NT channels; each tile's halo is staged once for
// all its NT channels (32, 64 or 128 up to those widths; past 128, 128 for
// wide images and for Co that 128-wide tiles pad less, else 256). Three
// warpgroups:
//
// - a producer keeps each chunk's activation slab, the BR + 2 halo rows of 32
//   channels as NCHW bytes, in flight two chunks ahead in a ring of three
//   stages: one TMA box over (W, H, C, B) where W % 16 == 0 (the unit
//   zero-fills outside the image and past Ci, which gives the SAME padding; the
//   box starts at column w0 - 16, since its innermost start must be 16-byte
//   aligned), else 16-byte cp.async of the aligned units that cover each row
//   (rows and channels outside zero-filled, bytes outside the row masked
//   below). It transposes each arrived slab once in shared memory into
//   channel-contiguous pixels: a thread reads one 32-bit word (4 pixels) of
//   each of 16 channels, turns them into 4 pixels x 16 channels with eight
//   __byte_perm per 4 x 4 bytes, and stores 16-byte core-matrix rows. It fences
//   them for the async proxy and signals an mbarrier; one of its threads loads
//   the chunk's weight tile, packed on the host in the layout B's descriptor
//   reads, by one bulk copy into the same ring (three stages where shared
//   memory holds them, two for 256-channel tiles and 64-channel ones);
// - two consumer warpgroups each own MT patches x NT channels of accumulators
//   (MT NT / 2 = 128 registers or fewer; setmaxnreg moves the producer's
//   registers to them). wgmma reads 8-bit operands only K-major, which is why
//   the halo is transposed: A is no-swizzle K-major, its 8-pixel core matrices
//   one halo row apart (8 x 8 patches) or 128 bytes apart (1 x 64 patches,
//   where W % 64 == 0 or W >= 256), the two 16-channel halves one plane apart, so a tap's
//   (dy, dx) shift is a 16-byte multiple added to A's start address and the
//   nine taps need no re-staging. Each chunk's wgmmas are one commit group;
//   the previous group is waited for before its stage is released, so the
//   tensor cores have a chunk queued while the producer fills the next;
// - the store: the accumulators, converted with cvt.rn.f32.s32, go through a
//   small shared buffer a warpgroup in channel-major order, 32 channels at a
//   time, and leave as 16-byte stores of whole row pieces of NCHW (32 bytes
//   of 8 x 8 patches, 256 of 1 x 64 ones: at widths like 1044 every other row
//   starts mid-sector, and short pieces write partial sectors); widths that
//   are not a multiple of 4 store element by element.
//
// The launch goes on the caller's stream and allocates nothing; the tensor
// map for the TMA route is built per call from x's pointer and shape.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>

namespace {

constexpr int kChunk = 32;     // input channels per K step: one k32 of the MMA per tap
constexpr int kThreads = 384;  // a producer warpgroup and two consumer warpgroups
constexpr int kOutPitch = 68;  // floats a channel in the store's staging buffer: 64 pixels + 4 against bank conflicts
constexpr int kProducerRegs = 72, kConsumerRegs = 216;  // setmaxnreg: 128 * 72 + 256 * 216 = 384 * 168

struct Params {
  const int8_t* x;  // (B, Ci, H, W)
  const int8_t* w;  // packed (ceil(Co / NT), chunks, k * k, 2, NT, 16), zero-padded
  float* y;         // (B, Co, H, W)
  int B, Ci, H, W, Co;
  int chunks, co_tiles, tiles_w, tiles_h, total;
  int tma;  // activations by TMA (W % 16 == 0 and x 16-byte aligned), else by cp.async
  int vec;  // 16-byte output stores (W % 4 == 0)
};

// PW: a patch (wgmma's M = 64 pixels) is 8 x 8 pixels (PW 8) or one row of 64 (PW 64, for wide images: whole
// 256-byte pieces of each output row, where rows of 8 pixels straddle 32-byte sectors at widths like 1044)
template <int KS, int NT, int PW>
struct Cfg {
  static constexpr int MT = NT >= 256 ? 1 : NT == 128 ? 2 : 4;  // patches a consumer warpgroup
  static constexpr int TILES = 2 * MT;                          // patches a block
  static constexpr int PH = 64 / PW;                            // a patch's rows
  static constexpr int TC = PW == 64 ? 1 : TILES == 2 ? 2 : 4, TR = TILES / TC;
  static constexpr int BR = PH * TR, BC = PW * TC;  // output rows and columns of a block's tile
  static constexpr int HR = BR + 2;               // halo rows: image rows h0 - 1 .. h0 + BR
  static constexpr int HC = BC + 8;               // halo columns: image columns w0 - 4 .. w0 + BC + 3
  static constexpr int QW = HC / 4;               // 4-pixel words a halo row
  static constexpr int PITCH = (HC + 18 + 15) / 16 * 16;  // bytes a slab row, cp.async: a shift < 16 + 4 of slack
  static constexpr int BOXW = (HC + 12 + 15) / 16 * 16;   // bytes a slab row, TMA: the box starts at w0 - 16
  static constexpr int TAPS = KS * KS;
  static constexpr int RAW = kChunk * HR * PITCH;  // one NCHW slab stage
  static constexpr int TST = kChunk * HR * HC;     // one transposed stage: [2][HR][HC][16]
  static constexpr int WST = TAPS * NT * kChunk;   // one weight stage: [TAPS][2][NT][16]
  static constexpr int OUT = kChunk * kOutPitch * 4;
  static constexpr int RAW0 = 128;  // after the mbarriers: full[3], empty[3], slab[3]
  // the transposed halo and the weights: a ring of three stages where shared memory holds it, else two
  static constexpr int S = RAW0 + 3 * RAW + 3 * (TST + WST) + 2 * OUT <= 232448 ? 3 : 2;
  static constexpr int T0 = RAW0 + 3 * RAW;
  static constexpr int W0 = T0 + S * TST;
  static constexpr int O0 = W0 + S * WST;
  static constexpr int SMEM = O0 + 2 * OUT;
  static_assert(SMEM <= 232448, "shared memory");
  static_assert(BOXW <= PITCH, "a TMA box fits a slab stage");
};

__device__ __forceinline__ unsigned smem_u32(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
// waits until the phase of `bar` with this parity has completed (the loop inside the asm: a loop in C would
// put the wgmmas after it on a path the compiler takes for divergent, and it would serialize them)
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\nmbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// `bytes` contiguous bytes from global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src, unsigned bytes, unsigned bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}
// one box of the 4-d tensor map at coordinates (c0, c1, c2, c3), innermost first, completing on `bar`
__device__ __forceinline__ void tma_load_4d(unsigned dst, const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                            unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}
// 16 bytes, of which the first `src_bytes` (0 or 16) are read and the rest zero-filled
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, unsigned src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a no-swizzle K-major wgmma operand at shared address `addr`: `lbo` bytes between the two 16-byte halves of K,
// `sbo` bytes between groups of 8 rows
__device__ __forceinline__ uint64_t smem_desc(unsigned addr, unsigned lbo, unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 | (uint64_t)(sbo >> 4) << 32;
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of the accumulators across the wgmma issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x N, s32) = A (64 x 32, s8) B (N x 32, s8)^T + (scale_d ? d : 0), both operands by descriptor
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20,"
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20,"
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58,"
      "%59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20,"
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58,"
      "%59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77,"
      "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96,"
      "%97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112,"
      "%113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]),
        "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]),
        "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

struct Tile {
  int b, h0, w0, ct;
};

template <int BR, int BC>
__device__ __forceinline__ Tile tile_at(const Params& p, int t) {
  Tile r;
  r.ct = t % p.co_tiles;
  t /= p.co_tiles;
  const int tw = t % p.tiles_w;
  t /= p.tiles_w;
  const int th = t % p.tiles_h;
  r.b = t / p.tiles_h;
  r.h0 = th * BR;
  r.w0 = tw * BC;
  return r;
}

template <int KS, int NT, int PW>
__global__ void __launch_bounds__(kThreads, 1) conv_i8_wgmma(const __grid_constant__ CUtensorMap xmap, const Params p) {
  using C = Cfg<KS, NT, PW>;
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned sbase = smem_u32(smem);
  const unsigned full = sbase, empty = sbase + 24, slab = sbase + 48;  // mbarriers, 8 bytes each
  // the warpgroup index through a shuffle, so that the compiler knows it is the same in a warp
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid >> 7, 0), wtid = tid & 127;
  if (tid == 0) {
    for (int s = 0; s < C::S; ++s) {
      mbar_init(full + 8 * s, 129);  // the producer's 128 threads after the transpose + the weights' expect_tx
      mbar_init(empty + 8 * s, 256);  // every consumer thread once its wgmmas of the stage completed
    }
    for (int s = 0; s < 3; ++s) mbar_init(slab + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int items = (p.total > (int)blockIdx.x ? (p.total - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0) * p.chunks;

  if (wg == 0) {
    // ---- producer: slabs two items ahead, the transpose, the weights
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const char* xlo = reinterpret_cast<const char*>(p.x);
    const char* xhi = xlo + (long long)p.B * p.Ci * p.H * p.W;
    const char* xal = reinterpret_cast<const char*>(reinterpret_cast<uintptr_t>(xlo) & ~(uintptr_t)15);
    const unsigned xlow = (unsigned)reinterpret_cast<uintptr_t>(xlo);

    // item q's slab into stage q % 3: channels chunk * 32 .. + 31, image rows h0 - 1 .. h0 + BR; columns w0 - 16 ..
    // by TMA (a box's innermost start must be 16-byte aligned: w0 - 4 is not), else the aligned 16-byte units
    // around w0 - 4 .. w0 + BC + 3 of each row
    auto issue_slab = [&](int q) {
      const Tile t = tile_at<C::BR, C::BC>(p, (int)blockIdx.x + q / p.chunks * (int)gridDim.x);
      const int ci0 = q % p.chunks * kChunk, st = q % 3;
      const unsigned dst = sbase + C::RAW0 + st * C::RAW;
      if (p.tma) {
        if (wtid == 0) {
          mbar_expect_tx(slab + 8 * st, kChunk * C::HR * C::BOXW);
          tma_load_4d(dst, &xmap, t.w0 - 16, t.h0 - 1, ci0, t.b, slab + 8 * st);
        }
        return;
      }
      for (int row = wtid; row < kChunk * C::HR; row += 128) {  // row = channel * HR + halo row
        const int ch = row / C::HR, r = row - ch * C::HR;
        const int ci = ci0 + ch, h = t.h0 - 1 + r;
        const bool inside = ci < p.Ci && h >= 0 && h < p.H;
        const char* start = xlo + (((long long)t.b * p.Ci + ci) * p.H + h) * p.W + t.w0 - 4;
        const char* src =
            inside ? reinterpret_cast<const char*>(reinterpret_cast<uintptr_t>(start) & ~(uintptr_t)15) : xal;
#pragma unroll
        for (int u = 0; u < C::PITCH / 16; ++u, src += inside ? 16 : 0)  // a unit holding a byte of x lies in x's pages
          cp_async16(dst + row * C::PITCH + 16 * u, src, inside && src + 16 > xlo && src < xhi ? 16 : 0);
      }
    };

    // item q's slab, arrived in stage q % 3, into transposed stage q % S: a thread takes 16 channels x 4 pixels,
    // reads one 32-bit word (4 pixels) of each channel, transposes them 4 x 4 bytes at a time and stores 4 pixels'
    // 16-byte core-matrix rows
    auto transpose = [&](int q) {
      const Tile t = tile_at<C::BR, C::BC>(p, (int)blockIdx.x + q / p.chunks * (int)gridDim.x);
      const int ci0 = q % p.chunks * kChunk;
      const unsigned char* raw = smem + C::RAW0 + (q % 3) * C::RAW;
      unsigned char* tr = smem + C::T0 + (q % C::S) * C::TST;
      constexpr int NQ = C::HR * C::QW;
      // TMA: every slab row holds image column w0 - 4 at byte 12; cp.async: at the low 4 bits of its address
      const int pitch = p.tma ? C::BOXW : C::PITCH;
      const unsigned hw = p.tma ? 0u : (unsigned)p.H * (unsigned)p.W;
#pragma unroll 1
      for (int it = wtid; it < 2 * NQ; it += 128) {
        const int kh = it >= NQ ? 1 : 0, f = it - kh * NQ;  // channels 16 kh .. + 15 of 4-pixel word f of the halo
        const int r = f / C::QW, qd = f - r * C::QW;
        unsigned s0 = 12;
        if (!p.tma)
          s0 = xlow + (((unsigned)t.b * (unsigned)p.Ci + (unsigned)(ci0 + 16 * kh)) * (unsigned)p.H +
                       (unsigned)(t.h0 - 1 + r)) * (unsigned)p.W + (unsigned)(t.w0 - 4);
        const unsigned o = (s0 & 15) + 4 * qd;
        const unsigned char* src = raw + (16 * kh * C::HR + r) * pitch;
        unsigned a[16];
        if ((hw & 15) == 0 && (o & 3) == 0) {  // every channel's word at the same aligned offset: the plans' shapes
#pragma unroll
          for (int c = 0; c < 16; ++c) a[c] = *reinterpret_cast<const unsigned*>(src + c * C::HR * pitch + o);
        } else {
#pragma unroll
          for (int c = 0; c < 16; ++c, s0 += hw) {
            const unsigned oc = (s0 & 15) + 4 * qd;
            const unsigned char* w = src + c * C::HR * pitch + (oc & ~3u);
            unsigned v = *reinterpret_cast<const unsigned*>(w);
            if (oc & 3) v = __funnelshift_r(v, *reinterpret_cast<const unsigned*>(w + 4), 8 * (oc & 3));
            a[c] = v;
          }
        }
        const int wc = t.w0 - 4 + 4 * qd;
        if (!p.tma && (wc < 0 || wc + 4 > p.W)) {  // columns outside the image: the units around a row hold its
          unsigned m = 0;                          // neighbours' bytes
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if ((unsigned)(wc + j) < (unsigned)p.W) m |= 0xffu << (8 * j);
#pragma unroll
          for (int c = 0; c < 16; ++c) a[c] &= m;
        }
        // channels 4 g .. 4 g + 3 of pixel j: a 4 x 4 byte transpose of a[4 g .. 4 g + 3]
        unsigned px[4][4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const unsigned t0 = __byte_perm(a[4 * g], a[4 * g + 1], 0x5140);
          const unsigned t1 = __byte_perm(a[4 * g], a[4 * g + 1], 0x7362);
          const unsigned t2 = __byte_perm(a[4 * g + 2], a[4 * g + 3], 0x5140);
          const unsigned t3 = __byte_perm(a[4 * g + 2], a[4 * g + 3], 0x7362);
          px[0][g] = __byte_perm(t0, t2, 0x5410);
          px[1][g] = __byte_perm(t0, t2, 0x7632);
          px[2][g] = __byte_perm(t1, t3, 0x5410);
          px[3][g] = __byte_perm(t1, t3, 0x7632);
        }
        unsigned char* dst = tr + kh * (C::TST / 2) + (r * C::HC + 4 * qd) * 16;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<uint4*>(dst + 16 * j) = make_uint4(px[j][0], px[j][1], px[j][2], px[j][3]);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma's async proxy
      mbar_arrive(full + 8 * (q % C::S));
    };

    if (items > 0) issue_slab(0);
    cp_async_commit();
    if (items > 1) issue_slab(1);
    cp_async_commit();
    for (int q = 0; q < items; ++q) {
      if (q + 2 < items) issue_slab(q + 2);  // into stage (q + 2) % 3, which every thread finished with at q - 1
      cp_async_commit();
      const int st = q % C::S;
      mbar_wait(empty + 8 * st, ((q / C::S) & 1) ^ 1);  // the consumers are done with item q - S
      if (wtid == 0) {
        const int tile = (int)blockIdx.x + q / p.chunks * (int)gridDim.x;
        const int ct = tile % p.co_tiles;
        mbar_expect_tx(full + 8 * st, C::WST);
        bulk_load(sbase + C::W0 + st * C::WST, p.w + ((long long)ct * p.chunks + q % p.chunks) * C::WST, C::WST,
                  full + 8 * st);
      }
      if (p.tma) {
        mbar_wait(slab + 8 * (q % 3), (q / 3) & 1);
      } else {
        cp_async_wait<2>();
        bar_sync(1, 128);
      }
      transpose(q);
      bar_sync(1, 128);  // every producer thread is done with slab stage q % 3
    }
    return;
  }

  // ---- consumers: MT patches x NT channels each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int cw = wg - 1;
  int acc[C::MT][NT / 2];
  int q = 0, pending = -1;
  for (int tile = blockIdx.x; tile < p.total; tile += gridDim.x) {
    const Tile t = tile_at<C::BR, C::BC>(p, tile);
    bool active[C::MT];  // patches inside the image: the others compute on zeros and are not stored
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) {
      const int ti = cw * C::MT + mt;
      active[mt] = t.h0 + C::PH * (ti / C::TC) < p.H && t.w0 + PW * (ti % C::TC) < p.W;
    }
    for (int chunk = 0; chunk < p.chunks; ++chunk, ++q) {
      const int st = q % C::S;
      mbar_wait(full + 8 * st, (q / C::S) & 1);
      const unsigned ta = sbase + C::T0 + st * C::TST, wb = sbase + C::W0 + st * C::WST;
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt) fence_regs(acc[mt]);
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < C::TAPS; ++tap) {
        const int dy = tap / KS + 1 - KS / 2, dx = tap % KS + 4 - KS / 2;  // the tap's halo row and column
        const uint64_t db = smem_desc(wb + tap * NT * kChunk, NT * 16, 128);
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt) {
          const int ti = cw * C::MT + mt;
          const unsigned a = ta + ((C::PH * (ti / C::TC) + dy) * C::HC + PW * (ti % C::TC) + dx) * 16;
          // the next 8 pixels of a patch: the next halo row (8 x 8) or the next 8 of the same row (1 x 64)
          wgmma_s8<NT>(acc[mt], smem_desc(a, C::TST / 2, PW == 8 ? C::HC * 16 : 128), db, chunk | tap);
        }
      }
      wgmma_commit();
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt) fence_regs(acc[mt]);
      wgmma_wait<1>();  // the previous item's wgmmas are done: release its stage
      if (pending >= 0) mbar_arrive(empty + 8 * pending);
      pending = st;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) fence_regs(acc[mt]);
    if (pending >= 0) mbar_arrive(empty + 8 * pending);
    pending = -1;

    // the store: 32 channels of a patch at a time through this warpgroup's staging buffer
    float* stage = reinterpret_cast<float*>(smem + C::O0 + cw * C::OUT);
    const int warp = wtid >> 5, g = (wtid >> 2) & 7, q4 = wtid & 3;
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) {
      if (!active[mt]) continue;
      const int ti = cw * C::MT + mt;
      const int oh0 = t.h0 + C::PH * (ti / C::TC), ow0 = t.w0 + PW * (ti % C::TC);
#pragma unroll
      for (int jb = 0; jb < NT / 32; ++jb) {
        const int co0 = t.ct * NT + 32 * jb;
        if (co0 >= p.Co) break;
        bar_sync(2 + cw, 128);  // the previous round's reads of the buffer are done
        // accumulator 4 j + (0, 1, 2, 3): pixel 16 warp + g (+ 8 for 2, 3), channel 8 j + 2 q4 (+ 1 for 1, 3);
        // pixel m of the patch is its row m / 8, column m % 8 (8 x 8) or column m (1 x 64)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * jb + jj;
          float* s0 = stage + (8 * jj + 2 * q4) * kOutPitch + 16 * warp + g;
          s0[0] = __int2float_rn(acc[mt][4 * j]);
          s0[kOutPitch] = __int2float_rn(acc[mt][4 * j + 1]);
          s0[8] = __int2float_rn(acc[mt][4 * j + 2]);
          s0[kOutPitch + 8] = __int2float_rn(acc[mt][4 * j + 3]);
        }
        bar_sync(2 + cw, 128);
        // 32 channels x 16 pieces of 4 pixels (pixels 4 i .. 4 i + 3 of the patch): 4 pieces a thread
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = wtid + 128 * k, ch = e >> 4, i = e & 15;
          const int co = co0 + ch, oh = oh0 + (PW == 8 ? i >> 1 : 0), ow = ow0 + (PW == 8 ? 4 * (i & 1) : 4 * i);
          if (co >= p.Co || oh >= p.H || ow >= p.W) continue;
          const float4 v = *reinterpret_cast<const float4*>(stage + ch * kOutPitch + 4 * i);
          float* dst = p.y + (((long long)t.b * p.Co + co) * p.H + oh) * p.W + ow;
          if (p.vec) {
            *reinterpret_cast<float4*>(dst) = v;
          } else {
            dst[0] = v.x;
            if (ow + 1 < p.W) dst[1] = v.y;
            if (ow + 2 < p.W) dst[2] = v.z;
            if (ow + 3 < p.W) dst[3] = v.w;
          }
        }
      }
    }
  }
}

// Allows `bytes` of dynamic shared memory for `kernel` on the current device, once per device.
int allow_smem(const void* kernel, int bytes, std::atomic<unsigned long long>& allowed, int dev) {
  if (!(allowed.load() >> dev & 1ull)) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    allowed.fetch_or(1ull << dev);
  }
  return 0;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no link against libcuda)
EncodeTiled encode_tiled() {
  static std::atomic<void*> fn{nullptr};
  void* f = fn.load();
  if (f == nullptr) {
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault,
                                                             &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn.store(f);
  }
  return reinterpret_cast<EncodeTiled>(f);
}

template <int KS, int NT, int PW>
int launch(Params p, cudaStream_t s) {
  using C = Cfg<KS, NT, PW>;
  p.co_tiles = (p.Co + NT - 1) / NT;
  p.tiles_w = (p.W + C::BC - 1) / C::BC;
  p.tiles_h = (p.H + C::BR - 1) / C::BR;
  const long long total = (long long)p.B * p.tiles_h * p.tiles_w * p.co_tiles;
  if (total > INT_MAX) return 1003;
  p.total = (int)total;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return 1006;
  static std::atomic<unsigned long long> allowed{0};
  const int e = allow_smem((const void*)conv_i8_wgmma<KS, NT, PW>, C::SMEM, allowed, dev);
  if (e) return e;
  CUtensorMap xmap = {};
  if (p.tma) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return 1007;
    const cuuint64_t dims[4] = {(cuuint64_t)p.W, (cuuint64_t)p.H, (cuuint64_t)p.Ci, (cuuint64_t)p.B};
    const cuuint64_t strides[3] = {(cuuint64_t)p.W, (cuuint64_t)p.W * p.H, (cuuint64_t)p.W * p.H * p.Ci};
    const cuuint32_t box[4] = {(cuuint32_t)C::BOXW, (cuuint32_t)C::HR, (cuuint32_t)kChunk, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    const CUresult r = encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<int8_t*>(p.x), dims, strides, box,
                              unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return 2000 + (int)r;
  }
  const int grid = p.total < sms ? p.total : sms;
  conv_i8_wgmma<KS, NT, PW><<<grid, kThreads, C::SMEM, s>>>(xmap, p);
  return (int)cudaGetLastError();
}

// 1 x 64 pixel patches: at most 64 columns past a row of 256 or more (kernels/conv_i8.py `wide_patches`)
bool wide_patches(int W) { return W % 64 == 0 || W >= 256; }

// output channels a block: the packed weights' tile width (kernels/conv_i8.py `tile_co` keeps the same rule).
// Past 128 channels, 1 x 64 patches take 128 (a three-stage ring fits beside them); 8 x 8 patches 256 unless
// 128-wide tiles pad Co less
int tile_co(int co, bool wide) {
  if (co <= 32) return 32;
  if (co <= 64) return 64;
  if (co <= 128 || wide) return 128;
  return (co + 127) / 128 * 128 < (co + 255) / 256 * 256 ? 128 : 256;
}

}  // namespace

// 1 where the kernel stages x by TMA (W % 16 == 0 and x 16-byte aligned), 0 where by cp.async.
extern "C" int maua_conv_i8_route(const void* x, int W) {
  return W % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 ? 1 : 0;
}

// x int8 (B, Ci, H, W) and y f32 (B, Co, H, W), contiguous; w packed as (ceil(Co / T), ceil(Ci / 32), ks^2, 2, T,
// 16) int8, zero-padded, 16-byte aligned, T = tile_co(Co, wide_patches(W)). ks is 1 or 3. Returns 0, a cudaError_t, 1003 (bad
// sizes), 1004 (a kernel size other than 1 or 3), 1006 (device index over 63), 1007 (no cuTensorMapEncodeTiled)
// or 2000 + the CUresult of a refused tensor map.
extern "C" int maua_conv_i8(const void* x, const void* w, float* y, int B, int Ci, int H, int W, int Co, int ks,
                            void* stream) {
  if (B <= 0 || Ci <= 0 || H <= 0 || W <= 0 || Co <= 0) return 1003;
  if (ks != 1 && ks != 3) return 1004;
  Params p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), y, B, Ci, H, W, Co,
           (Ci + kChunk - 1) / kChunk, 0, 0, 0, 0, maua_conv_i8_route(x, W), W % 4 == 0 ? 1 : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = wide_patches(W);
  switch (tile_co(Co, wide)) {
    case 32:
      if (wide) return ks == 3 ? launch<3, 32, 64>(p, s) : launch<1, 32, 64>(p, s);
      return ks == 3 ? launch<3, 32, 8>(p, s) : launch<1, 32, 8>(p, s);
    case 64:
      if (wide) return ks == 3 ? launch<3, 64, 64>(p, s) : launch<1, 64, 64>(p, s);
      return ks == 3 ? launch<3, 64, 8>(p, s) : launch<1, 64, 8>(p, s);
    case 128:
      if (wide) return ks == 3 ? launch<3, 128, 64>(p, s) : launch<1, 128, 64>(p, s);
      return ks == 3 ? launch<3, 128, 8>(p, s) : launch<1, 128, 8>(p, s);
    default:  // 256 channels: 8 x 8 patches only
      return ks == 3 ? launch<3, 256, 8>(p, s) : launch<1, 256, 8>(p, s);
  }
}
