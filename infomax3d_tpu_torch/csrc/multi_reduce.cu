// CSR multi-reduce: per node, (sum, sumsq, max, min) of its incoming edge
// messages, in float32.
//
// Replaces: the Pallas kernel `_kernel` of infomax3d_tpu/ops/pallas/spmm.py
//   (wrapper `_csr_reduce_raw`, public `csr_multi_reduce`), the aggregation
//   of every PNA layer when messages are float32 (the f32 serving path, the
//   OT step's edge-update backbone) or when max_deg > 16.
// Contract, per node n and column j, over the first min(deg, K) edges of its
//   CSR range [row_ptr[n], row_ptr[n+1]) in order: sum and sumsq accumulate
//   in float32 (m * m rounded, then added), max and min are exact; every
//   output is 0 where deg == 0 (padding nodes included).  Messages may be
//   float32 or bf16; the four outputs are float32 sections of [4, N, D].
//   (The TPU kernel's bf16 rounding of max/min came from its matrix unit
//   and is not part of the contract.)
// Bound on the card: device-memory bytes: it reads each message row once
//   (E * D * 4 bytes for float32) and writes 4 * N * D * 4 bytes, against a
//   few flops per message element; 14.7 MB in and 29.5 MB out at the bench
//   shapes.  At the OT slice's shapes (~640 real edges, N = 512, D = 50) it
//   moves 0.54 MB, and the launch and the chain of dependent round trips
//   each thread waits on (row_ptr, then its rows) set its time.
// Design: one thread per (node, column vector) walks the node's rows with
//   `walk_rows` (common.cuh): U slots at a time, the chunk's U row loads in
//   flight before the first add, the adds in slot order; everything in
//   registers, vector stores, no atomics.  Vectors of 16 or 8 bytes as
//   `vec_width` allows (D = 50 in float32 takes 8 bytes), else one element.
//   U = WALK_UNROLL, blocks of WALK_THREADS; 32-bit index arithmetic where
//   max(N, E) * D < 2^31 (`walk_wide`).
#include "common.cuh"

namespace {

constexpr float NEG_BIG = -3.0e38f;
constexpr float POS_BIG = 3.0e38f;

template <typename T, int VEC, typename Idx>
__global__ void __launch_bounds__(WALK_THREADS)
multi_reduce_kernel(const T* __restrict__ msg, const int* __restrict__ row_ptr,
                    float* __restrict__ out, int N, int D, int K) {
  int n, c;
  if (!node_column<Idx, VEC>(N, D, n, c)) return;
  const int start = row_ptr[n];
  const int deg = row_ptr[n + 1] - start;

  float s1[VEC], s2[VEC], mx[VEC], mn[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    s1[k] = 0.f;
    s2[k] = 0.f;
    mx[k] = NEG_BIG;
    mn[k] = POS_BIG;
  }
  auto add = [&](const float (&m)[VEC], bool valid) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float a = valid ? m[k] : 0.f;      // + 0 leaves a sum exact
      s1[k] = __fadd_rn(s1[k], a);
      s2[k] = __fadd_rn(s2[k], __fmul_rn(a, a));
      mx[k] = fmaxf(mx[k], m[k]);              // a repeated row, if invalid
      mn[k] = fminf(mn[k], m[k]);
    }
  };
  walk_rows<T, VEC, WALK_UNROLL, false, Idx>(msg, D, c, nullptr, start,
                                             min(deg, K), add);
  const bool has = deg > 0;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    mx[k] = has ? mx[k] : 0.f;
    mn[k] = has ? mn[k] : 0.f;
  }
  const int64_t sec = static_cast<int64_t>(N) * D;
  float* o = out + static_cast<int64_t>(n) * D + c;
  store_vec<float, VEC>(o, s1);
  store_vec<float, VEC>(o + sec, s2);
  store_vec<float, VEC>(o + 2 * sec, mx);
  store_vec<float, VEC>(o + 3 * sec, mn);
}

template <typename T, int VEC>
void launch_width(const T* m, const int* rp, float* o, int N, int D, int K,
                  bool wide, cudaStream_t st) {
  const dim3 grid(walk_blocks(static_cast<int64_t>(N) * (D / VEC)));
  if (wide) {
    multi_reduce_kernel<T, VEC, int64_t><<<grid, WALK_THREADS, 0, st>>>(
        m, rp, o, N, D, K);
  } else {
    multi_reduce_kernel<T, VEC, uint32_t><<<grid, WALK_THREADS, 0, st>>>(
        m, rp, o, N, D, K);
  }
}

template <typename T>
cudaError_t launch(const void* msg, const void* row_ptr, void* out, int N,
                   int E, int D, int K, int force_wide, void* stream) {
  if (N <= 0 || D <= 0) return cudaSuccess;
  const bool wide = walk_wide(N, E, D, force_wide);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const T*>(msg);
  const auto* rp = static_cast<const int*>(row_ptr);
  auto* o = static_cast<float*>(out);
  const void* ptrs[2] = {msg, out};
  constexpr int V16 = 16 / sizeof(T), V8 = 8 / sizeof(T);
  const int vec = vec_width<T>(D, ptrs, 2);
  if (vec == V16) {
    launch_width<T, V16>(m, rp, o, N, D, K, wide, st);
  } else if (vec == V8) {
    launch_width<T, V8>(m, rp, o, N, D, K, wide, st);
  } else {
    launch_width<T, 1>(m, rp, o, N, D, K, wide, st);
  }
  return cudaGetLastError();
}

}  // namespace

// msg [E, D] (float32 or bf16), row_ptr [N + 1] int32, out [4, N, D] f32;
// wide != 0 forces 64-bit index arithmetic.
PORT_API cudaError_t multi_reduce_f32(const void* msg, const void* row_ptr,
                                      void* out, int N, int E, int D, int K,
                                      int wide, void* stream) {
  return launch<float>(msg, row_ptr, out, N, E, D, K, wide, stream);
}

PORT_API cudaError_t multi_reduce_bf16(const void* msg, const void* row_ptr,
                                       void* out, int N, int E, int D,
                                       int K, int wide, void* stream) {
  return launch<__nv_bfloat16>(msg, row_ptr, out, N, E, D, K, wide, stream);
}
