// Shared helpers of the port's CUDA kernels: 16-byte vector loads and
// stores of float32 / bfloat16 rows converted to float registers, and the
// C entry point that turns a cudaError_t into its message.
//
// Rounding: every kernel computes with explicit _rn intrinsics where the
// plain PyTorch twin rounds after each operation, so nvcc's default FMA
// contraction cannot make the kernel round differently from its twin.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PORT_API extern "C" __attribute__((visibility("default")))

PORT_API const char* port_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// round a float to the nearest bfloat16 and back
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// VEC consecutive elements; 16-byte transactions when VEC * sizeof(T) is a
// multiple of 16 (the caller guarantees 16-byte alignment then),
// element-wise otherwise
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) % 16 == 0) {
    constexpr int PER = 16 / sizeof(T);
#pragma unroll
    for (int ch = 0; ch < VEC / PER; ++ch) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[ch];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < PER; ++i) v[ch * PER + i] = to_float(e[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_float(p[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) % 16 == 0) {
    constexpr int PER = 16 / sizeof(T);
#pragma unroll
    for (int ch = 0; ch < VEC / PER; ++ch) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int i = 0; i < PER; ++i) e[i] = from_float<T>(v[ch * PER + i]);
      reinterpret_cast<uint4*>(p)[ch] = raw;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = from_float<T>(v[i]);
  }
}

// True when every pointer is 16-byte aligned and a row of D elements of
// `elem` bytes is a whole number of 16-byte vectors: the 16-byte path is
// then safe for every row of those arrays.
__host__ inline bool vec16_ok(int D, int elem, const void* const* ptrs,
                              int n) {
  if ((D * elem) % 16 != 0) return false;
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  return true;
}
