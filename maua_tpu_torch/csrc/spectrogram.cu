// Mel spectrogram of a batch of 1-D signals, one frame per block, sm_90a.
//
// Replaces the Pallas TPU kernel `maua_tpu/kernels/spectrogram.py`
// (`melspectrogram_pallas`, kernel `_mel_kernel`; XLA twin
// `melspectrogram_mxu`). For each signal y (length L) and frame t:
//
//   x[i]  = y[reflect(t * hop + i - n_fft / 2)] * window[i],  i < n_fft
//   X[k]  = sum_i x[i] exp(-2 pi i k i / n_fft),               k <= n_fft / 2
//   P[k]  = (re^2 + im^2) ^ (power / 2)
//   out[m, t] = sum_k mel[m, k] P[k]
//
// with numpy's reflect rule at any length (period 2 (L - 1)) and the
// last centred frame dropped, as the reference's spectrogram does.
//
// The TPU ran the DFT as two dense matmuls on its matrix unit, because
// an FFT serialises on its vector unit. Here an FFT is the natural form:
// n_fft / 2-point complex radix-2 FFT of the packed real frame
// (z[m] = x[2m] + i x[2m + 1]) plus the split step, ~40x fewer
// operations than the dense DFT at n_fft 2048.
//
// Bound: at the path's sizes the work is tiny (180 s at hop 512 is 7,751
// frames, ~20 MB read and written, ~0.5 GFLOP), so the bound is some
// microseconds and launch latency sets the time. The design keeps each
// frame in shared memory from load to mel product: frames are gathered
// straight from the signal (the 4x overlap of hop 512 is served by L2),
// never written to device memory; twiddles come from a host table
// computed in float64; the mel product reads only each band's non-zero
// bins (packed by the wrapper), one warp per band, lanes over bins.
// The launch goes on the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Params {
  const float* y;          // (batch, length)
  const float* window;     // (n_fft,)
  const float2* twiddle;   // (n_fft / 2 + 1,): exp(-2 pi i k / n_fft)
  const int* band_lo;      // (n_mels,) first non-zero bin of each band
  const int* band_off;     // (n_mels + 1,) offsets into weights
  const float* weights;    // packed non-zero mel weights
  float* out;              // (batch, n_mels, n_frames)
  long long length, n_frames;
  int n_fft, hop, log2_half, n_mels;
  float power;
};

__device__ __forceinline__ long long reflect(long long s, long long n) {
  if (n == 1) return 0;
  const long long period = 2 * (n - 1);
  s = (s < 0 ? -s : s) % period;
  return s >= n ? period - s : s;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__global__ void __launch_bounds__(kThreads) mel_kernel(Params p) {
  extern __shared__ float2 smem[];
  const int half = p.n_fft >> 1;            // complex FFT size N
  float2* z = smem;                         // (N,) complex
  float* power = reinterpret_cast<float*>(smem + half);  // (N + 1,)

  const long long t = blockIdx.x;
  const long long b = blockIdx.y;
  const float* y = p.y + b * p.length;
  const long long start = t * p.hop - half;

  // load, window and pack the frame; store in bit-reversed order
  for (int m = threadIdx.x; m < half; m += blockDim.x) {
    const float x0 = __ldg(y + reflect(start + 2 * m, p.length)) * __ldg(p.window + 2 * m);
    const float x1 = __ldg(y + reflect(start + 2 * m + 1, p.length)) * __ldg(p.window + 2 * m + 1);
    z[__brev((unsigned)m) >> (32 - p.log2_half)] = make_float2(x0, x1);
  }
  __syncthreads();

  // radix-2 decimation-in-time stages; span 2h, twiddle exp(-2 pi i j / 2h)
  for (int h = 1; h < half; h <<= 1) {
    const int stride = p.n_fft / (2 * h);
    for (int q = threadIdx.x; q < (half >> 1); q += blockDim.x) {
      const int j = q & (h - 1);
      const int i0 = ((q - j) << 1) + j;
      const int i1 = i0 + h;
      const float2 w = __ldg(p.twiddle + j * stride);
      const float2 a = z[i0];
      const float2 c = cmul(w, z[i1]);
      z[i0] = make_float2(a.x + c.x, a.y + c.y);
      z[i1] = make_float2(a.x - c.x, a.y - c.y);
    }
    __syncthreads();
  }

  // split step: X[k] = (Z[k] + conj Z[N-k]) / 2 - i/2 W^k (Z[k] - conj Z[N-k])
  for (int k = threadIdx.x; k <= half; k += blockDim.x) {
    const float2 zk = z[k == half ? 0 : k];
    const float2 zc = z[k == 0 ? 0 : half - k];
    const float2 e = make_float2(0.5f * (zk.x + zc.x), 0.5f * (zk.y - zc.y));
    const float2 o = make_float2(0.5f * (zk.y + zc.y), -0.5f * (zk.x - zc.x));
    const float2 wo = cmul(__ldg(p.twiddle + k), o);
    const float re = e.x + wo.x, im = e.y + wo.y;
    float pw = re * re + im * im;
    if (p.power == 1.f) pw = sqrtf(pw);
    else if (p.power != 2.f) pw = powf(pw, 0.5f * p.power);
    power[k] = pw;
  }
  __syncthreads();

  // mel product over each band's non-zero bins: one warp per band
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int m = warp; m < p.n_mels; m += blockDim.x >> 5) {
    const int lo = __ldg(p.band_lo + m);
    const int off = __ldg(p.band_off + m), n = __ldg(p.band_off + m + 1) - off;
    float acc = 0.f;
    for (int i = lane; i < n; i += 32) acc += __ldg(p.weights + off + i) * power[lo + i];
    for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
    if (lane == 0) p.out[(b * p.n_mels + m) * p.n_frames + t] = acc;
  }
}

}  // namespace

// Returns 0, a cudaError_t, or 1003 (bad sizes).
extern "C" int maua_melspectrogram(const float* y, const float* window, const float* twiddle, const int* band_lo,
                                   const int* band_off, const float* weights, float* out, long long batch,
                                   long long length, int n_fft, int hop, long long n_frames, int n_mels,
                                   float power, void* stream) {
  if (n_fft < 256 || n_fft > 4096 || (n_fft & (n_fft - 1)) || hop <= 0 || length <= 0 || batch <= 0 ||
      batch > 65535 || n_frames <= 0 || n_frames > 0x7fffffffLL || n_mels <= 0)
    return 1003;
  int log2_half = 0;
  while ((2 << log2_half) < n_fft) ++log2_half;
  Params p{y, window, reinterpret_cast<const float2*>(twiddle), band_lo, band_off, weights, out,
           length, n_frames, n_fft, hop, log2_half, n_mels, power};
  const int half = n_fft / 2;
  const size_t smem = half * sizeof(float2) + (half + 1) * sizeof(float);
  mel_kernel<<<dim3((unsigned)n_frames, (unsigned)batch), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
