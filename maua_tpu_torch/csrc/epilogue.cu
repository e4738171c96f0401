// Fused modulated-conv epilogue for StyleGAN2 synthesis, NCHW, sm_90a.
//
// Replaces the Pallas TPU kernel `maua_tpu/kernels/epilogue.py`
// (`modconv_epilogue`, body `_kernel`, reference chain `_xla_epilogue`).
// Per element of the conv output z (B, C, H, W):
//
//   y = z * post[b, c] + noise[b|0, g(c), h, w] + bias[c]
//   y = (y >= 0 ? y : alpha * y) * gain
//   y = clamp(y, -clamp, clamp)            (when has_clamp)
//   y = y * pre_next[b, c]                 (when pre_next is given)
//
// with g(c) = c / (C / G). Storage is f32 or bf16; arithmetic is f32.
// With out_i8 (the JAX chain's quant_out, `_xla_epilogue(quant_out=True)`:
// the W8A8 plans fold the next conv's activation scale 127 / amax into
// pre_next) the result is stored as int8 instead:
//
//   q = clip(rint(y), -127, 127)           (rint: round half to even)
//
// computed with unfused f32 products and sums, op for op as the plain
// version's tensor ops, so the codes equal its codes.
//
// Bound: memory bytes. The chain does ~8 flops per element and moves
// 2 * itemsize bytes per element (read z, write y); noise is C/G times
// smaller and the per-channel vectors are negligible. At a 1024^2 layer
// with C = 32, batch 8, bf16 that is 537 MB each way, ~0.32 ms at
// 3.35 TB/s. The design is one pass over z. Blocks walk one (b, c)
// plane at a time (blockIdx.y), so post, bias, pre_next and the start of
// the plane's noise row cost one load per plane and no per-element
// division. Within a plane each thread moves 16 bytes of z and y per
// step (8 bf16 or 4 f32); the vector path needs H*W % 8 == 0 and 16-byte
// aligned pointers, and a scalar variant takes any shape or alignment.
// No shared memory, no atomics; the launch goes on the caller's stream
// and allocates nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

struct Params {
  const float* post;   // (B, C)
  const float* noise;  // (B|1, G, H, W) or null
  const float* bias;   // (C,)
  const float* pre;    // (B, C) or null
  long long planes, C, HW, G, cpg;  // planes = B * C, cpg = C / G
  int noise_batched;
  float alpha, gain, clamp;
  int has_clamp;
};

// The per-plane scalars: one (b, c) plane per blockIdx.y step.
struct Plane {
  float post, bias, pre;
  const float* noise;  // this plane's noise row, or null
};

__device__ __forceinline__ Plane plane_of(long long plane, const Params& p) {
  long long b = plane / p.C;
  long long c = plane - b * p.C;
  Plane q;
  q.post = __ldg(p.post + plane);
  q.bias = __ldg(p.bias + c);
  q.pre = p.pre ? __ldg(p.pre + plane) : 1.f;
  q.noise = p.noise ? p.noise + ((p.noise_batched ? b : 0) * p.G + c / p.cpg) * p.HW : nullptr;
  return q;
}

__device__ __forceinline__ float chain(float v, float nz, const Plane& q, const Params& p) {
  v = v * q.post + nz + q.bias;
  v = v >= 0.f ? v : v * p.alpha;
  v = v * p.gain;
  if (p.has_clamp) v = fminf(fmaxf(v, -p.clamp), p.clamp);
  return v * q.pre;
}

// the chain with each product and sum rounded on its own (no fused multiply-add), then the int8 code: a code
// sits on a rounding edge wherever a contraction could move it
__device__ __forceinline__ signed char chain_i8(float v, float nz, const Plane& q, const Params& p) {
  v = __fadd_rn(__fadd_rn(__fmul_rn(v, q.post), nz), q.bias);
  v = v >= 0.f ? v : __fmul_rn(v, p.alpha);
  v = __fmul_rn(v, p.gain);
  if (p.has_clamp) v = fminf(fmaxf(v, -p.clamp), p.clamp);
  v = __fmul_rn(v, q.pre);
  return (signed char)(int)fminf(fmaxf(rintf(v), -127.f), 127.f);
}

// Vector path, f32: 4 elements (16 bytes) per thread step.
__global__ void epilogue_f32_vec(const float* __restrict__ z, float* __restrict__ y, Params p) {
  const long long nv = p.HW / 4;
  for (long long plane = blockIdx.y; plane < p.planes; plane += gridDim.y) {
    const Plane q = plane_of(plane, p);
    const float4* zp = reinterpret_cast<const float4*>(z + plane * p.HW);
    float4* yp = reinterpret_cast<float4*>(y + plane * p.HW);
    for (long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x; j < nv;
         j += (long long)gridDim.x * blockDim.x) {
      float4 v = zp[j];
      float4 n = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q.noise) n = __ldg(reinterpret_cast<const float4*>(q.noise) + j);
      v.x = chain(v.x, n.x, q, p);
      v.y = chain(v.y, n.y, q, p);
      v.z = chain(v.z, n.z, q, p);
      v.w = chain(v.w, n.w, q, p);
      yp[j] = v;
    }
  }
}

// Vector path, bf16: 8 elements (16 bytes) per thread step.
__global__ void epilogue_bf16_vec(const __nv_bfloat16* __restrict__ z, __nv_bfloat16* __restrict__ y,
                                  Params p) {
  const long long nv = p.HW / 8;
  for (long long plane = blockIdx.y; plane < p.planes; plane += gridDim.y) {
    const Plane q = plane_of(plane, p);
    const uint4* zp = reinterpret_cast<const uint4*>(z + plane * p.HW);
    uint4* yp = reinterpret_cast<uint4*>(y + plane * p.HW);
    for (long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x; j < nv;
         j += (long long)gridDim.x * blockDim.x) {
      uint4 raw = zp[j];
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
      float nz[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (q.noise) {
        const float4* n4 = reinterpret_cast<const float4*>(q.noise) + 2 * j;
        float4 a = __ldg(n4), b = __ldg(n4 + 1);
        nz[0] = a.x; nz[1] = a.y; nz[2] = a.z; nz[3] = a.w;
        nz[4] = b.x; nz[5] = b.y; nz[6] = b.z; nz[7] = b.w;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float2 f = __bfloat1622float2(h2[k]);
        f.x = chain(f.x, nz[2 * k], q, p);
        f.y = chain(f.y, nz[2 * k + 1], q, p);
        h2[k] = __floats2bfloat162_rn(f.x, f.y);
      }
      yp[j] = raw;
    }
  }
}

// Vector path, f32 in, int8 out: 16 elements (64 bytes in, 16 out) per thread step.
__global__ void epilogue_f32_i8_vec(const float* __restrict__ z, signed char* __restrict__ y, Params p) {
  const long long nv = p.HW / 16;
  for (long long plane = blockIdx.y; plane < p.planes; plane += gridDim.y) {
    const Plane q = plane_of(plane, p);
    const float4* zp = reinterpret_cast<const float4*>(z + plane * p.HW);
    uint4* yp = reinterpret_cast<uint4*>(y + plane * p.HW);
    for (long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x; j < nv;
         j += (long long)gridDim.x * blockDim.x) {
      float v[16], nz[16];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 a = zp[4 * j + k];
        v[4 * k] = a.x; v[4 * k + 1] = a.y; v[4 * k + 2] = a.z; v[4 * k + 3] = a.w;
        const float4 n = q.noise ? __ldg(reinterpret_cast<const float4*>(q.noise) + 4 * j + k)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        nz[4 * k] = n.x; nz[4 * k + 1] = n.y; nz[4 * k + 2] = n.z; nz[4 * k + 3] = n.w;
      }
      unsigned w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        w[k] = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[k] |= (unsigned)(unsigned char)chain_i8(v[4 * k + e], nz[4 * k + e], q, p) << (8 * e);
      }
      yp[j] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float* ptr, float v, float nz, const Plane& q, const Params& p) {
  *ptr = chain(v, nz, q, p);
}
__device__ __forceinline__ void from_f(__nv_bfloat16* ptr, float v, float nz, const Plane& q, const Params& p) {
  *ptr = __float2bfloat16_rn(chain(v, nz, q, p));
}
__device__ __forceinline__ void from_f(signed char* ptr, float v, float nz, const Plane& q, const Params& p) {
  *ptr = chain_i8(v, nz, q, p);
}

// Scalar path: any H*W and any alignment; the output in the input's type or int8.
template <typename T, typename U>
__global__ void epilogue_scalar(const T* __restrict__ z, U* __restrict__ y, Params p) {
  for (long long plane = blockIdx.y; plane < p.planes; plane += gridDim.y) {
    const Plane q = plane_of(plane, p);
    const T* zp = z + plane * p.HW;
    U* yp = y + plane * p.HW;
    for (long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x; j < p.HW;
         j += (long long)gridDim.x * blockDim.x) {
      float nz = q.noise ? __ldg(q.noise + j) : 0.f;
      from_f(yp + j, to_f(zp[j]), nz, q, p);
    }
  }
}

inline bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

// x covers one plane's elements (capped; the loop strides the rest),
// y walks the planes (capped at the hardware limit; the loop strides).
inline dim3 grid_for(long long per_plane, long long planes, int threads) {
  long long x = (per_plane + threads - 1) / threads;
  if (x > 1024) x = 1024;
  long long yb = planes < 65535 ? planes : 65535;
  return dim3((unsigned)(x > 0 ? x : 1), (unsigned)(yb > 0 ? yb : 1));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, of z and, unless out_i8, of y; with
// out_i8 y is int8. Pointers are device pointers; noise and pre may be null.
// Returns cudaGetLastError() after the launch.
extern "C" int maua_modconv_epilogue(const void* z, void* y, int dtype, int out_i8,
                                     const float* post, const float* noise,
                                     const float* bias, const float* pre,
                                     long long B, long long C, long long HW, long long G,
                                     int noise_batched, float alpha, float gain,
                                     float clamp, int has_clamp, void* stream) {
  if (B * C * HW == 0) return (int)cudaGetLastError();
  Params p{post, noise, bias, pre, B * C, C, HW, G, C / G, noise_batched, alpha, gain, clamp, has_clamp};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int vec = dtype == 1 ? 8 : 4;
  const bool vec_ok = HW % 8 == 0 && aligned16(z) && aligned16(y) && (!noise || aligned16(noise));
  if (out_i8) {
    if (vec_ok && HW % 16 == 0 && dtype == 0) {
      epilogue_f32_i8_vec<<<grid_for(HW / 16, B * C, threads), threads, 0, s>>>(
          static_cast<const float*>(z), static_cast<signed char*>(y), p);
    } else if (dtype == 1) {
      epilogue_scalar<__nv_bfloat16, signed char><<<grid_for(HW, B * C, threads), threads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(z), static_cast<signed char*>(y), p);
    } else {
      epilogue_scalar<float, signed char><<<grid_for(HW, B * C, threads), threads, 0, s>>>(
          static_cast<const float*>(z), static_cast<signed char*>(y), p);
    }
  } else if (vec_ok && dtype == 1) {
    epilogue_bf16_vec<<<grid_for(HW / vec, B * C, threads), threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(z), static_cast<__nv_bfloat16*>(y), p);
  } else if (vec_ok) {
    epilogue_f32_vec<<<grid_for(HW / vec, B * C, threads), threads, 0, s>>>(
        static_cast<const float*>(z), static_cast<float*>(y), p);
  } else if (dtype == 1) {
    epilogue_scalar<__nv_bfloat16, __nv_bfloat16><<<grid_for(HW, B * C, threads), threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(z), static_cast<__nv_bfloat16*>(y), p);
  } else {
    epilogue_scalar<float, float><<<grid_for(HW, B * C, threads), threads, 0, s>>>(
        static_cast<const float*>(z), static_cast<float*>(y), p);
  }
  return (int)cudaGetLastError();
}
