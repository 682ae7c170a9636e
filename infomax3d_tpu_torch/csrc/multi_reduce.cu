// CSR multi-reduce: per node, (sum, sumsq, max, min) of its incoming edge
// messages, in float32.
//
// Replaces: the Pallas kernel `_kernel` of infomax3d_tpu/ops/pallas/spmm.py
//   (wrapper `_csr_reduce_raw`, public `csr_multi_reduce`), the aggregation
//   of every PNA layer when messages are float32 (the f32 serving path) or
//   when max_deg > 16.
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
//   shapes.
// Design: the same CSR walk as pna_stats.cu: one thread per (node, 16-byte
//   column vector), the node's rows read in order with coalesced 16-byte
//   loads, everything in registers, 16-byte stores, no atomics.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr float NEG_BIG = -3.0e38f;
constexpr float POS_BIG = 3.0e38f;

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
multi_reduce_kernel(const T* __restrict__ msg, const int* __restrict__ row_ptr,
                    float* __restrict__ out, int N, int D, int K) {
  const int nvec = D / VEC;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= static_cast<int64_t>(N) * nvec) return;
  const int n = static_cast<int>(idx / nvec);
  const int c = static_cast<int>(idx - static_cast<int64_t>(n) * nvec) * VEC;
  const int start = row_ptr[n];
  const int deg = row_ptr[n + 1] - start;
  const int cnt = min(deg, K);

  float s1[VEC], s2[VEC], mx[VEC], mn[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    s1[k] = 0.f;
    s2[k] = 0.f;
    mx[k] = NEG_BIG;
    mn[k] = POS_BIG;
  }
  for (int s = 0; s < cnt; ++s) {
    float m[VEC];
    load_vec<T, VEC>(msg + static_cast<int64_t>(start + s) * D + c, m);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      s1[k] = __fadd_rn(s1[k], m[k]);
      s2[k] = __fadd_rn(s2[k], __fmul_rn(m[k], m[k]));
      mx[k] = fmaxf(mx[k], m[k]);
      mn[k] = fminf(mn[k], m[k]);
    }
  }
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

template <typename T>
cudaError_t launch(const void* msg, const void* row_ptr, void* out, int N,
                   int D, int K, void* stream) {
  if (N <= 0 || D <= 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const T*>(msg);
  const auto* rp = static_cast<const int*>(row_ptr);
  auto* o = static_cast<float*>(out);
  constexpr int V = 16 / sizeof(T);
  const void* in_ptr[1] = {msg};
  const void* out_ptr[1] = {out};
  if (vec16_ok(D, sizeof(T), in_ptr, 1) && vec16_ok(D, 4, out_ptr, 1)) {
    const int64_t items = static_cast<int64_t>(N) * (D / V);
    const dim3 grid(static_cast<unsigned>((items + THREADS - 1) / THREADS));
    multi_reduce_kernel<T, V><<<grid, THREADS, 0, st>>>(m, rp, o, N, D, K);
  } else {
    const int64_t items = static_cast<int64_t>(N) * D;
    const dim3 grid(static_cast<unsigned>((items + THREADS - 1) / THREADS));
    multi_reduce_kernel<T, 1><<<grid, THREADS, 0, st>>>(m, rp, o, N, D, K);
  }
  return cudaGetLastError();
}

}  // namespace

// msg [E, D] (float32 or bf16), row_ptr [N + 1] int32, out [4, N, D] f32.
PORT_API cudaError_t multi_reduce_f32(const void* msg, const void* row_ptr,
                                      void* out, int N, int D, int K,
                                      void* stream) {
  return launch<float>(msg, row_ptr, out, N, D, K, stream);
}

PORT_API cudaError_t multi_reduce_bf16(const void* msg, const void* row_ptr,
                                       void* out, int N, int D, int K,
                                       void* stream) {
  return launch<__nv_bfloat16>(msg, row_ptr, out, N, D, K, stream);
}
