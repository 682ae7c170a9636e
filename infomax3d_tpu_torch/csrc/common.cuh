// Shared helpers of the port's CUDA kernels: 16- and 8-byte vector loads
// and stores of float32 / bfloat16 rows converted to float registers, and
// the C entry point that turns a cudaError_t into its message.
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

// VEC consecutive elements moved as W-byte words (W = 16 or 8), W / sizeof(T)
// elements per word
template <typename T, int VEC, typename Word>
__device__ __forceinline__ void load_words(const T* __restrict__ p,
                                           float (&v)[VEC]) {
  constexpr int PER = sizeof(Word) / sizeof(T);
#pragma unroll
  for (int ch = 0; ch < VEC / PER; ++ch) {
    const Word raw = reinterpret_cast<const Word*>(p)[ch];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < PER; ++i) v[ch * PER + i] = to_float(e[i]);
  }
}

template <typename T, int VEC, typename Word>
__device__ __forceinline__ void store_words(T* __restrict__ p,
                                            const float (&v)[VEC]) {
  constexpr int PER = sizeof(Word) / sizeof(T);
#pragma unroll
  for (int ch = 0; ch < VEC / PER; ++ch) {
    Word raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < PER; ++i) e[i] = from_float<T>(v[ch * PER + i]);
    reinterpret_cast<Word*>(p)[ch] = raw;
  }
}

// VEC consecutive elements; 16-byte transactions when VEC * sizeof(T) is a
// multiple of 16, 8-byte ones when it is a multiple of 8 (the caller
// guarantees that alignment then), element-wise otherwise
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) % 16 == 0) {
    load_words<T, VEC, uint4>(p, v);
  } else if constexpr (VEC * sizeof(T) % 8 == 0) {
    load_words<T, VEC, uint2>(p, v);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_float(p[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) % 16 == 0) {
    store_words<T, VEC, uint4>(p, v);
  } else if constexpr (VEC * sizeof(T) % 8 == 0) {
    store_words<T, VEC, uint2>(p, v);
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

// The elements per thread of a kernel that walks rows of D elements of T
// (and writes rows of D float32 or T): a 16-byte vector of T when a row is
// a whole number of them, else an 8-byte one (D = 300 in bf16: 600-byte
// rows, 75 vectors of 4), else 1.  Every pointer must be 16-byte aligned
// for either vector path; a float32 output row then splits into whole
// 16-byte words as well.
template <typename T>
__host__ inline int vec_width(int D, const void* const* ptrs, int n) {
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return 1;
  if ((D * sizeof(T)) % 16 == 0) return 16 / sizeof(T);
  if ((D * sizeof(T)) % 8 == 0) return 8 / sizeof(T);
  return 1;
}
