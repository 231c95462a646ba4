// Shared helpers of the attention kernels: 8-element vector loads and
// stores that convert between the storage type (float, bf16, or int8
// codes of a quantized page) and the float32 the kernels compute in,
// warp reductions, the head-dim dispatch of the launch functions, and the
// C-interface error helper every kernel library exports.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define KERNEL_NEG_INF (-1e30f)

// Load 8 consecutive elements starting at a 16-byte aligned address.
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// 8 consecutive int8 codes (one 8-byte load) as floats; the caller
// multiplies them by their row's scale with scale8.
__device__ __forceinline__ void load8(const int8_t* p, float* out) {
  const int2 raw = *reinterpret_cast<const int2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(b[i]);
}

__device__ __forceinline__ void scale8(float* v, float s) {
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] *= s;
}

// Store 8 consecutive floats (16-byte aligned destination).
__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// exp(s - m) for a live score, exactly 0 for a masked one (so a row
// whose every key so far is masked accumulates nothing).
__device__ __forceinline__ float masked_exp(float s, float m) {
  return s > 0.5f * KERNEL_NEG_INF ? expf(s - m) : 0.f;
}

// `return fn<P, D>(a);` for the head dims the kernels are built for.
#define KERNEL_DISPATCH_D(fn, P, D, a)             \
  switch (D) {                                     \
    case 32: return fn<P, 32>(a);                  \
    case 64: return fn<P, 64>(a);                  \
    case 128: return fn<P, 128>(a);                \
    default: return (int)cudaErrorInvalidValue;    \
  }

#define KERNEL_ERROR_STRING_FN                                   \
  extern "C" const char* kernel_error_string(int code) {         \
    return cudaGetErrorString(static_cast<cudaError_t>(code));   \
  }
