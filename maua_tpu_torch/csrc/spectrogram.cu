// Mel spectrogram of a batch of 1-D signals, a warp-level FFT per frame, sm_90a.
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
// the N = n_fft / 2-point complex FFT of the packed real frame
// (z[m] = x[2m] + i x[2m + 1]) plus the split step.
//
// Bound: at the path's sizes the work is tiny (180 s at hop 512 is 7,751
// frames, ~20 MB read and written, ~0.5 GFLOP), a few microseconds, so
// what sets the time is how long one frame's chain of dependent steps
// takes and how many frames an SM keeps in flight. One thread block per
// frame with ten shared-memory radix-2 stages between block barriers
// (the first design) spent its time in barriers and shared-memory round
// trips. This design keeps each frame in one group of G lanes (a warp
// where N >= 1024; 16 or 8 lanes, two or four frames a warp, below),
// and the FFT in registers, as a four-step FFT, N = R x G:
//
//   1. lane g holds z[G j + g], j < R, loaded straight from the signal
//      (8-byte loads for an interior frame whose start is aligned; one
//      reflection for an edge frame; numpy's rule at any length only for
//      a signal of at most N samples), and runs an R-point FFT in
//      registers with twiddles from a constant table;
//   2. multiplies by W_N^(g k1), by recurrence from W_N^g (the host's
//      float64-rounded table), and writes its R values to its frame's
//      row-padded buffer;
//   3. after a __syncwarp, reads R / G columns of G values and runs
//      G-point FFTs in registers: Z[k1 + R k2];
//   4. the split step gives |X[k]|^power into the frame's power buffer,
//      its twiddles W_2N^k by recurrence too (faster than reading
//      them from the table, measured on an H100).
//
// Only warp barriers separate the steps. A block holds 4 warps (4 frames
// at N >= 1024, 8 or 16 below) and one block barrier before the mel
// product: a thread per band, the block's frames in as many
// accumulators, one weight read per bin for all of them. The weights
// come band-minor (weights[i][m], zero past a band's last non-zero bin),
// so that neighbouring bands' threads read neighbouring weights, and each
// band's frames go out as one contiguous run. One template instance per
// n_fft; the launch goes on the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kWarps = 4;  // warps per block

struct Params {
  const float* y;          // (batch, length)
  const float* window;     // (n_fft,)
  const float2* twiddle;   // (n_fft / 2 + 1,): exp(-2 pi i k / n_fft)
  const int* band_lo;      // (n_mels,) first non-zero bin of each band
  const int* band_n;       // (n_mels,) bins from the first to the last non-zero one
  const float* weights;    // (max band_n, n_mels): weights[i][m] = mel[m][band_lo[m] + i]
  float* out;              // (batch, n_mels, n_frames)
  long long length, n_frames;
  int hop, n_mels;
  float power;
};

// exp(-2 pi i m / 64), m < 32: the twiddles of the register FFTs (at most 64 points)
__constant__ float2 c_w64[32] = {
    {1.f, 0.f}, {0.99518472f, -0.0980171412f}, {0.980785251f, -0.195090324f}, {0.956940353f, -0.290284663f},
    {0.923879504f, -0.382683426f}, {0.881921291f, -0.471396744f}, {0.831469595f, -0.555570245f}, {0.773010433f, -0.634393275f},
    {0.707106769f, -0.707106769f}, {0.634393275f, -0.773010433f}, {0.555570245f, -0.831469595f}, {0.471396744f, -0.881921291f},
    {0.382683426f, -0.923879504f}, {0.290284663f, -0.956940353f}, {0.195090324f, -0.980785251f}, {0.0980171412f, -0.99518472f},
    {0.f, -1.f}, {-0.0980171412f, -0.99518472f}, {-0.195090324f, -0.980785251f}, {-0.290284663f, -0.956940353f},
    {-0.382683426f, -0.923879504f}, {-0.471396744f, -0.881921291f}, {-0.555570245f, -0.831469595f}, {-0.634393275f, -0.773010433f},
    {-0.707106769f, -0.707106769f}, {-0.773010433f, -0.634393275f}, {-0.831469595f, -0.555570245f}, {-0.881921291f, -0.471396744f},
    {-0.923879504f, -0.382683426f}, {-0.956940353f, -0.290284663f}, {-0.980785251f, -0.195090324f}, {-0.99518472f, -0.0980171412f},
};

__host__ __device__ constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x >> 1); }
template <int BITS>
__device__ __forceinline__ int brev(int x) {  // a constant wherever x is
  int r = 0;
#pragma unroll
  for (int i = 0; i < BITS; ++i) r |= ((x >> i) & 1) << (BITS - 1 - i);
  return r;
}

// The shape of the instance for N = n_fft / 2 complex points.
template <int N>
struct Shape {
  static constexpr int G = N >= 1024 ? 32 : (N >= 256 ? 16 : 8);  // lanes per frame
  static constexpr int R = N / G;                                  // points per lane
  static constexpr int F = kWarps * (32 / G);                      // frames per block
  static constexpr int SROW = G + 1;                               // float2 per row of step 2's buffer
  static constexpr int POWER = 2 * R * SROW;                       // float offset of the power buffer
  static constexpr int FRAME = POWER + N + 2;                      // floats per frame (even: float2 rows)
  static constexpr int SMEM = F * FRAME * (int)sizeof(float);
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

// In-place radix-2 decimation-in-frequency FFT of n points in registers: natural order in, bit-reversed
// order out (v[p] = sum_j v_in[j] W_n^(j brev(p))). One stage per half span h; every index is a
// compile-time constant once unrolled.
template <int n, int h>
__device__ __forceinline__ void fft_stage(float2* v) {
#pragma unroll
  for (int s = 0; s < n; s += 2 * h) {
#pragma unroll
    for (int j = 0; j < h; ++j) {
      const float2 a = v[s + j], b = v[s + j + h];
      const float2 d = make_float2(a.x - b.x, a.y - b.y);
      v[s + j] = make_float2(a.x + b.x, a.y + b.y);
      if (j == 0) v[s + j + h] = d;
      else if (2 * j == h) v[s + j + h] = make_float2(d.y, -d.x);  // times -i
      else v[s + j + h] = cmul(d, c_w64[j * (32 / h)]);             // W_2h^j
    }
  }
  if constexpr (h > 1) fft_stage<n, h / 2>(v);
}

template <int n>
__device__ __forceinline__ void fft_regs(float2* v) {
  fft_stage<n, n / 2>(v);
}

template <int N>
__global__ void __launch_bounds__(kWarps * 32) mel_kernel(Params p) {
  using S = Shape<N>;
  constexpr int G = S::G, R = S::R, F = S::F, SROW = S::SROW;
  constexpr int LR = ilog2(R), LG = ilog2(G);
  extern __shared__ float4 smem4[];
  float* frames = reinterpret_cast<float*>(smem4);  // F frames of FRAME floats

  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane & (G - 1), fl = (tid >> 5) * (32 / G) + lane / G;  // lane in frame, frame in block
  const long long b = blockIdx.y, t0 = (long long)blockIdx.x * F, t = t0 + fl;
  float2* buf = reinterpret_cast<float2*>(frames + fl * S::FRAME);  // step 2's rows, then Z
  float* power = frames + fl * S::FRAME + S::POWER;
  const bool active = t < p.n_frames;  // the warp barriers below are reached by every lane

  float2 v[R];
  if (active) {
    // 1. lane g loads, windows and packs z[G j + g]: straight from the signal for an interior frame,
    //    through one reflection for an edge frame, through numpy's rule at any length for a signal of
    //    at most N samples (an edge frame then reflects more than once)
    const long long start = t * p.hop - N;
    const float* yb = p.y + b * p.length;
    const float2* win = reinterpret_cast<const float2*>(p.window);
    if (start >= 0 && start + 2 * N <= p.length) {
      const float* src = yb + start;
      if ((reinterpret_cast<uintptr_t>(src) & 7) == 0) {
        const float2* src2 = reinterpret_cast<const float2*>(src);
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const float2 s = __ldg(src2 + G * j + g), w = __ldg(win + G * j + g);
          v[j] = make_float2(s.x * w.x, s.y * w.y);
        }
      } else {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int m = G * j + g;
          const float2 w = __ldg(win + m);
          v[j] = make_float2(__ldg(src + 2 * m) * w.x, __ldg(src + 2 * m + 1) * w.y);
        }
      }
    } else if (p.length > N) {
      const long long last = p.length - 1;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int m = G * j + g;
        const float2 w = __ldg(win + m);
        const long long s0 = start + 2 * m, s1 = s0 + 1;
        v[j] = make_float2(__ldg(yb + (s0 < 0 ? -s0 : s0 > last ? 2 * last - s0 : s0)) * w.x,
                           __ldg(yb + (s1 < 0 ? -s1 : s1 > last ? 2 * last - s1 : s1)) * w.y);
      }
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int m = G * j + g;
        const float2 w = __ldg(win + m);
        v[j] = make_float2(__ldg(yb + reflect(start + 2 * m, p.length)) * w.x,
                           __ldg(yb + reflect(start + 2 * m + 1, p.length)) * w.y);
      }
    }
    fft_regs<R>(v);  // v[brev(k1)] = A[g][k1]

    // 2. twiddle by W_N^(g k1), by recurrence from W_N^g = W_2N^2g (the host's table), and store row k1,
    //    column g (R - 2 products: at most ~4e-6 relative at R = 64)
    const float2 wg = __ldg(p.twiddle + 2 * g);
    float2 w = wg;
    buf[g] = v[0];
#pragma unroll
    for (int k1 = 1; k1 < R; ++k1) {
      buf[k1 * SROW + g] = cmul(v[brev<LR>(k1)], w);
      w = cmul(w, wg);
    }
  }
  __syncwarp();
  if (active) {
    // 3. this lane's columns k1 = g + G c, G points each, then Z[k1 + R k2] in natural order
#pragma unroll
    for (int c = 0; c < R / G; ++c)
#pragma unroll
      for (int n2 = 0; n2 < G; ++n2) v[c * G + n2] = buf[(g + G * c) * SROW + n2];
  }
  __syncwarp();  // every row is read before Z overwrites the buffer
  if (active) {
#pragma unroll
    for (int c = 0; c < R / G; ++c) {
      fft_regs<G>(v + c * G);
#pragma unroll
      for (int q = 0; q < G; ++q) buf[g + G * c + R * brev<LG>(q)] = v[c * G + q];
    }
  }
  __syncwarp();
  if (active) {
    // 4. split step: X[k] = (Z[k] + conj Z[N-k]) / 2 - i/2 W_2N^k (Z[k] - conj Z[N-k]), then |X|^power
    auto bin = [&](int k, float2 wk) {
      const float2 zk = buf[k == N ? 0 : k];
      const float2 zc = buf[k == 0 ? 0 : N - k];
      const float2 e = make_float2(0.5f * (zk.x + zc.x), 0.5f * (zk.y - zc.y));
      const float2 o = make_float2(0.5f * (zk.y + zc.y), -0.5f * (zk.x - zc.x));
      const float2 wo = cmul(wk, o);
      const float re = e.x + wo.x, im = e.y + wo.y;
      float pw = re * re + im * im;
      if (p.power == 1.f) pw = sqrtf(pw);
      else if (p.power != 2.f) pw = powf(pw, 0.5f * p.power);
      power[k] = pw;
    };
    const float2 step = __ldg(p.twiddle + G);  // W_2N^G
    float2 wk = __ldg(p.twiddle + g);          // W_2N^k, by recurrence (N / G - 1 products)
#pragma unroll 4
    for (int i = 0; i < N / G; ++i) {
      bin(g + G * i, wk);
      wk = cmul(wk, step);
    }
    if (g == 0) bin(N, make_float2(-1.f, 0.f));
  }
  __syncthreads();

  // mel product: a thread per band, the block's F frames in F accumulators, one weight read per bin for all
  // of them; each band's frames go out as one contiguous run
  const int nf = (int)min((long long)F, p.n_frames - t0);
  float* out = p.out + b * p.n_mels * p.n_frames + t0;
  for (int m = tid; m < p.n_mels; m += kWarps * 32) {
    const int lo = __ldg(p.band_lo + m), n = __ldg(p.band_n + m);
    const float* pw = frames + S::POWER + lo;
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.f;
#pragma unroll 2
    for (int i = 0; i < n; ++i) {
      const float wv = __ldg(p.weights + i * p.n_mels + m);
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = fmaf(wv, pw[f * S::FRAME + i], acc[f]);
    }
    float* o = out + (long long)m * p.n_frames;
#pragma unroll
    for (int f = 0; f < F; ++f)
      if (f < nf) o[f] = acc[f];
  }
}

template <int N>
int launch(const Params& p, long long batch, cudaStream_t s) {
  using S = Shape<N>;
  static std::atomic<unsigned long long> allowed{0};  // devices on which its shared memory was allowed
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return 1006;
  if (!(allowed.load() >> dev & 1ull)) {
    err = cudaFuncSetAttribute(mel_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (err != cudaSuccess) return (int)err;
    allowed.fetch_or(1ull << dev);
  }
  const dim3 grid((unsigned)((p.n_frames + S::F - 1) / S::F), (unsigned)batch);
  mel_kernel<N><<<grid, kWarps * 32, S::SMEM, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0, a cudaError_t, 1003 (bad sizes) or 1006 (device index over 63).
extern "C" int maua_melspectrogram(const float* y, const float* window, const float* twiddle, const int* band_lo,
                                   const int* band_n, const float* weights, float* out, long long batch,
                                   long long length, int n_fft, int hop, long long n_frames, int n_mels,
                                   float power, void* stream) {
  if (n_fft < 256 || n_fft > 4096 || (n_fft & (n_fft - 1)) || hop <= 0 || length <= 0 || batch <= 0 ||
      batch > 65535 || n_frames <= 0 || n_frames > 0x7fffffffLL || n_mels <= 0)
    return 1003;
  const Params p{y, window, reinterpret_cast<const float2*>(twiddle), band_lo, band_n, weights, out,
                 length, n_frames, hop, n_mels, power};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_fft) {
    case 256: return launch<128>(p, batch, s);
    case 512: return launch<256>(p, batch, s);
    case 1024: return launch<512>(p, batch, s);
    case 2048: return launch<1024>(p, batch, s);
    default: return launch<2048>(p, batch, s);
  }
}
