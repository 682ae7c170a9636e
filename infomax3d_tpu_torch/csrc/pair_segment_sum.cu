// Pair segment sum, the backward of the fused edge combine: per node n,
//   d_hd[n] = sum of ct[e] over its CSR (receiver-sorted) range
//             e in [row_ptr[n], row_ptr[n+1])
//   d_hs[n] = sum of ct[csc_perm[j]] over its CSC (sender-sorted) range
//             j in [csc_row_ptr[n], csc_row_ptr[n+1])
//
// Replaces: the Pallas kernel `_snd_seg_sum_kernel` through
//   `_snd_kernel_pair` of infomax3d_tpu/ops/pallas/spmm.py (wrapper
//   `pair_segment_sum_bf16`), the combine backward of every PNA layer.
// Contract: each sum is accumulated in float32 in range order (slot 0
//   first) and rounded to the output type once.  Padding edges (receiver or
//   sender N) lie past row_ptr[N] / csc_row_ptr[N] and contribute nothing.
//   Ids are int32, so there is no bound on N (the TPU kernel packed sender
//   ids into two bf16 lanes, which held only below 2^15 nodes).
// Bound on the card: device-memory bytes.  It reads every real ct row once
//   per half (the sender half through csc_perm) and writes two [N, D]
//   arrays; at the bench shapes (E = 18432, N = 9216, D = 200, bf16) the
//   unique bytes are ~15 MB against one add per ct element read.
// Design: one thread per (node, 16-byte column vector); the thread walks
//   its node's receiver range (contiguous rows, so a warp's loads coalesce),
//   stores d_hd, then walks its sender range through csc_perm (rows of one
//   molecule, close together) and stores d_hs.  Each output element has one
//   owner: no atomics, deterministic results.  A width or pointer that does
//   not fit 16-byte vectors takes the element-wise instantiation.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T, int VEC>
__device__ __forceinline__ void accumulate(const T* __restrict__ ct,
                                           int64_t row, int D, int c,
                                           float (&acc)[VEC]) {
  float t[VEC];
  load_vec<T, VEC>(ct + row * D + c, t);
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], t[k]);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
pair_segment_sum_kernel(const T* __restrict__ ct,
                        const int* __restrict__ row_ptr,
                        const int* __restrict__ csc_row_ptr,
                        const int* __restrict__ csc_perm,
                        T* __restrict__ d_hd, T* __restrict__ d_hs, int N,
                        int D) {
  const int nvec = D / VEC;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= static_cast<int64_t>(N) * nvec) return;
  const int n = static_cast<int>(idx / nvec);
  const int c = static_cast<int>(idx - static_cast<int64_t>(n) * nvec) * VEC;
  const int64_t out = static_cast<int64_t>(n) * D + c;
  float acc[VEC];

#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  for (int e = row_ptr[n]; e < row_ptr[n + 1]; ++e)
    accumulate<T, VEC>(ct, e, D, c, acc);
  store_vec<T, VEC>(d_hd + out, acc);

#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  for (int j = csc_row_ptr[n]; j < csc_row_ptr[n + 1]; ++j)
    accumulate<T, VEC>(ct, csc_perm[j], D, c, acc);
  store_vec<T, VEC>(d_hs + out, acc);
}

template <typename T>
cudaError_t launch(const void* ct, const void* row_ptr,
                   const void* csc_row_ptr, const void* csc_perm, void* d_hd,
                   void* d_hs, int N, int D, void* stream) {
  if (N <= 0 || D <= 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  const void* ptrs[3] = {ct, d_hd, d_hs};
  constexpr int V = 16 / sizeof(T);
  const bool vec = vec16_ok(D, sizeof(T), ptrs, 3);
  const int64_t items = static_cast<int64_t>(N) * (vec ? D / V : D);
  const dim3 grid(static_cast<unsigned>((items + THREADS - 1) / THREADS));
  const auto* c = static_cast<const T*>(ct);
  const auto* rp = static_cast<const int*>(row_ptr);
  const auto* crp = static_cast<const int*>(csc_row_ptr);
  const auto* perm = static_cast<const int*>(csc_perm);
  auto* hd = static_cast<T*>(d_hd);
  auto* hs = static_cast<T*>(d_hs);
  if (vec) {
    pair_segment_sum_kernel<T, V><<<grid, THREADS, 0, st>>>(
        c, rp, crp, perm, hd, hs, N, D);
  } else {
    pair_segment_sum_kernel<T, 1><<<grid, THREADS, 0, st>>>(
        c, rp, crp, perm, hd, hs, N, D);
  }
  return cudaGetLastError();
}

}  // namespace

// ct [E, D], row_ptr / csc_row_ptr [N + 1] int32, csc_perm [E] int32,
// d_hd / d_hs [N, D] of ct's type.
PORT_API cudaError_t pair_segment_sum_bf16(const void* ct, const void* row_ptr,
                                           const void* csc_row_ptr,
                                           const void* csc_perm, void* d_hd,
                                           void* d_hs, int N, int D,
                                           void* stream) {
  return launch<__nv_bfloat16>(ct, row_ptr, csc_row_ptr, csc_perm, d_hd, d_hs,
                               N, D, stream);
}

PORT_API cudaError_t pair_segment_sum_f32(const void* ct, const void* row_ptr,
                                          const void* csc_row_ptr,
                                          const void* csc_perm, void* d_hd,
                                          void* d_hs, int N, int D,
                                          void* stream) {
  return launch<float>(ct, row_ptr, csc_row_ptr, csc_perm, d_hd, d_hs, N, D,
                       stream);
}
