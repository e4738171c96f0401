// SAME-padded stride-1 3x3 convolution with a fused modulated-conv
// epilogue, NHWC input, HWIO weights, sm_90a.
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
// (192 -> 64 channels, 432 in bf16) it is operations bound. The TPU packed
// the nine taps into the matmul contraction so that narrow channel counts
// filled its matrix unit. This first design stays on the CUDA cores in f32
// for both storage types, so in bf16 the 67 TFLOP/s of f32 FMAs, not the
// bound, sets its time: a block owns an output tile of 8 rows x 16 columns
// x 32 or 64 output channels of one image. Per chunk of 8 input channels it stages
// the 10 x 18 input halo (style applied on load, zero outside the image)
// and the 3 x 3 x 8 weight slice in shared memory as f32; each warp owns
// one output row, each lane one (or two) output channels and 16 pixels
// in registers, so every shared-memory read of the halo is a broadcast
// and the weights are read conflict-free. Demod, bias and lrelu * gain
// are applied on store. The launch goes on the caller's stream and
// allocates nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;    // output rows per block, one per warp
constexpr int kCols = 16;   // output columns per block, per thread
constexpr int kChunk = 8;   // input channels staged per step
constexpr int kHaloR = kRows + 2, kHaloC = kCols + 2;

struct Params {
  const void* x;         // (B, H, W, Ci)
  const void* w;         // (3, 3, Ci, Co), x's type
  const float* bias;     // (Co,) or null
  const float* style;    // (B, Ci) or null, already rounded to x's type
  const float* demod;    // (B, Co) or null
  void* y;               // (B, H, W, Co)
  int B, H, W, Ci, Co, co_blocks;
  float alpha, gain;
  int has_act;
};

__device__ __forceinline__ float load(const float* p, long long i) { return __ldg(p + i); }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ void store(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) { p[i] = __float2bfloat16(v); }

template <typename T, int CJ>
__global__ void __launch_bounds__(256) kconv_kernel(Params p) {
  constexpr int kCo = 32 * CJ;
  __shared__ float xs[kChunk][kHaloR][kHaloC];
  __shared__ float ws[9][kChunk][kCo];

  const T* x = static_cast<const T*>(p.x);
  const T* w = static_cast<const T*>(p.w);
  T* y = static_cast<T*>(p.y);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int w0 = blockIdx.x * kCols, h0 = blockIdx.y * kRows;
  const int b = blockIdx.z / p.co_blocks, co0 = (blockIdx.z % p.co_blocks) * kCo;

  float acc[CJ][kCols];
#pragma unroll
  for (int j = 0; j < CJ; ++j)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[j][c] = 0.f;

  for (int ci0 = 0; ci0 < p.Ci; ci0 += kChunk) {
    // the input halo of this chunk, style applied, zero outside the image
    for (int e = tid; e < kChunk * kHaloR * kHaloC; e += blockDim.x) {
      const int ci = e % kChunk, pix = e / kChunk;
      const int r = pix / kHaloC, c = pix % kHaloC;
      const int h = h0 + r - 1, ww = w0 + c - 1;
      float v = 0.f;
      if (ci0 + ci < p.Ci && h >= 0 && h < p.H && ww >= 0 && ww < p.W) {
        v = load(x, (((long long)b * p.H + h) * p.W + ww) * p.Ci + ci0 + ci);
        if (p.style) v = round_to(v * __ldg(p.style + (long long)b * p.Ci + ci0 + ci), x);
      }
      xs[ci][r][c] = v;
    }
    // the 3 x 3 x chunk x kCo weight slice
    for (int e = tid; e < 9 * kChunk * kCo; e += blockDim.x) {
      const int co = e % kCo, rest = e / kCo;
      const int ci = rest % kChunk, tap = rest / kChunk;
      float v = 0.f;
      if (ci0 + ci < p.Ci && co0 + co < p.Co) v = load(w, ((long long)tap * p.Ci + ci0 + ci) * p.Co + co0 + co);
      ws[tap][ci][co] = v;
    }
    __syncthreads();

    const int nci = min(kChunk, p.Ci - ci0);
    for (int ci = 0; ci < nci; ++ci) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float row[kHaloC];
#pragma unroll
        for (int c = 0; c < kHaloC; ++c) row[c] = xs[ci][warp + dy][c];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            const float wv = ws[dy * 3 + dx][ci][lane + 32 * j];
#pragma unroll
            for (int c = 0; c < kCols; ++c) acc[j][c] = fmaf(row[c + dx], wv, acc[j][c]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int h = h0 + warp;
  if (h >= p.H) return;
#pragma unroll
  for (int j = 0; j < CJ; ++j) {
    const int co = co0 + lane + 32 * j;
    if (co >= p.Co) continue;
    const float dm = p.demod ? __ldg(p.demod + (long long)b * p.Co + co) : 1.f;
    const float bs = p.bias ? __ldg(p.bias + co) : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int ww = w0 + c;
      if (ww >= p.W) break;
      float v = acc[j][c] * dm + bs;
      if (p.has_act) v = (v >= 0.f ? v : v * p.alpha) * p.gain;
      store(y, (((long long)b * p.H + h) * p.W + ww) * p.Co + co, v);
    }
  }
}

template <typename T>
int launch(const Params& p0, cudaStream_t s) {
  Params p = p0;
  const int cj = p.Co <= 32 ? 1 : 2;
  p.co_blocks = (p.Co + 32 * cj - 1) / (32 * cj);
  const long long nz = (long long)p.B * p.co_blocks;
  if (nz > 65535) return 1003;
  dim3 grid((p.W + kCols - 1) / kCols, (p.H + kRows - 1) / kRows, (unsigned)nz);
  if (cj == 1) kconv_kernel<T, 1><<<grid, 256, 0, s>>>(p);
  else kconv_kernel<T, 2><<<grid, 256, 0, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0 = f32, 1 = bf16. Returns 0, a cudaError_t, 1003 (bad sizes) or 1004 (bad dtype).
extern "C" int maua_kconv3x3(const void* x, const void* w, const float* bias, const float* style, const float* demod,
                             void* y, int dtype, int B, int H, int W, int Ci, int Co, float alpha, float gain,
                             int has_act, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Ci <= 0 || Co <= 0 || (H + kRows - 1) / kRows > 65535) return 1003;
  Params p{x, w, bias, style, demod, y, B, H, W, Ci, Co, 0, alpha, gain, has_act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, s);
  return 1004;
}
