// CSR sum: per node n, the float32 sum of its incoming edge messages
//   out[n] = sum of msg[e] over its CSR (receiver-sorted) range
//            e in [row_ptr[n], row_ptr[n+1])
//
// Replaces: the Pallas kernel `_sum_kernel` of infomax3d_tpu/ops/pallas/
//   spmm.py (wrapper `_csr_sum_raw`, public `csr_sum` / `csr_mean`), the
//   aggregation of every GIN layer (`edge_aggregate(g, msg, "sum")`).
// Contract: messages float32 or bf16, output float32 whatever the input
//   type (as the TPU kernel's); each sum is accumulated in float32 in range
//   order (slot 0 first).  Padding edges lie past row_ptr[N] and nodes
//   without edges (padding nodes included) get 0.
// Bound on the card: device-memory bytes: it reads each real message row
//   once and writes [N, D] float32, one add per element read; at the GIN
//   slice's shapes (E_real = 6680, N = 3328, D = 300) 4.0 MB read + 4.0 MB
//   written in bf16, 8.0 + 4.0 MB in float32.
// Design: the CSR walk of multi_reduce.cu without its other statistics: one
//   thread per (node, column vector), the node's rows read in order (a
//   warp's threads cover neighbouring vectors of one row, so its loads
//   coalesce), the sum in registers, no atomics, deterministic.  The vector
//   is 16 bytes where a row holds whole 16-byte vectors and 8 bytes where
//   it holds whole 8-byte ones (D = 300 in bf16: 600-byte rows, 75 vectors
//   of 4), else one element (`vec_width`).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
csr_sum_kernel(const T* __restrict__ msg, const int* __restrict__ row_ptr,
               float* __restrict__ out, int N, int D) {
  const int nvec = D / VEC;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= static_cast<int64_t>(N) * nvec) return;
  const int n = static_cast<int>(idx / nvec);
  const int c = static_cast<int>(idx - static_cast<int64_t>(n) * nvec) * VEC;
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  for (int e = row_ptr[n]; e < row_ptr[n + 1]; ++e) {
    float m[VEC];
    load_vec<T, VEC>(msg + static_cast<int64_t>(e) * D + c, m);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], m[k]);
  }
  store_vec<float, VEC>(out + static_cast<int64_t>(n) * D + c, acc);
}

template <typename T, int VEC>
void launch_width(const T* m, const int* rp, float* o, int N, int D,
                  cudaStream_t st) {
  const int64_t items = static_cast<int64_t>(N) * (D / VEC);
  const dim3 grid(static_cast<unsigned>((items + THREADS - 1) / THREADS));
  csr_sum_kernel<T, VEC><<<grid, THREADS, 0, st>>>(m, rp, o, N, D);
}

template <typename T>
cudaError_t launch(const void* msg, const void* row_ptr, void* out, int N,
                   int D, void* stream) {
  if (N <= 0 || D <= 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const T*>(msg);
  const auto* rp = static_cast<const int*>(row_ptr);
  auto* o = static_cast<float*>(out);
  const void* ptrs[2] = {msg, out};
  constexpr int V16 = 16 / sizeof(T), V8 = 8 / sizeof(T);
  const int vec = vec_width<T>(D, ptrs, 2);
  if (vec == V16) {
    launch_width<T, V16>(m, rp, o, N, D, st);
  } else if (vec == V8) {
    launch_width<T, V8>(m, rp, o, N, D, st);
  } else {
    launch_width<T, 1>(m, rp, o, N, D, st);
  }
  return cudaGetLastError();
}

}  // namespace

// msg [E, D] (float32 or bf16), row_ptr [N + 1] int32, out [N, D] float32.
PORT_API cudaError_t csr_sum_f32(const void* msg, const void* row_ptr,
                                 void* out, int N, int D, void* stream) {
  return launch<float>(msg, row_ptr, out, N, D, stream);
}

PORT_API cudaError_t csr_sum_bf16(const void* msg, const void* row_ptr,
                                  void* out, int N, int D, void* stream) {
  return launch<__nv_bfloat16>(msg, row_ptr, out, N, D, stream);
}
