// Sender-keyed segment sum, the backward of the sender gather h[senders]:
// per node n,
//   d[n] = sum of ct[csc_perm[j]] over its CSC (sender-sorted) range
//          j in [csc_row_ptr[n], csc_row_ptr[n+1])
//
// Replaces: the Pallas kernel `_snd_seg_sum_kernel` through
//   `_snd_kernel_norecv` of infomax3d_tpu/ops/pallas/spmm.py (wrapper
//   `snd_segment_sum_bf16`), the backward of `take_rows` over the senders
//   (`gather_src`) in every GIN layer.
// Contract: ct float32 or bf16; each sum is accumulated in float32 in range
//   order (slot 0 first) and rounded to ct's type once.  Padding edges
//   (sender N) lie past csc_row_ptr[N] and contribute nothing; nodes that
//   send nothing get 0.  Ids are int32, so there is no bound on N (the TPU
//   kernel packed sender ids into two bf16 lanes of its window, which held
//   only below 2^15 nodes).
// Bound on the card: device-memory bytes: it reads each real ct row once
//   (through csc_perm) and writes [N, D] of ct's type, one add per element
//   read; at the GIN slice's shapes (E_real = 6680, N = 3328, D = 300)
//   4.0 MB read + 2.0 MB written in bf16, 8.0 + 4.0 MB in float32.
// Design: the sender half of pair_segment_sum.cu: one thread per (node,
//   column vector) walks its node's sender range through csc_perm (the
//   rows of one molecule, close together; a warp's threads read
//   neighbouring vectors of one row), sums in registers and stores once;
//   each output element has one owner, so there are no atomics and the
//   result is deterministic.  Vectors of 16 or 8 bytes as `vec_width`
//   allows (D = 300 in bf16 takes the 8-byte path), else one element.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
snd_segment_sum_kernel(const T* __restrict__ ct,
                       const int* __restrict__ csc_row_ptr,
                       const int* __restrict__ csc_perm,
                       T* __restrict__ d, int N, int D) {
  const int nvec = D / VEC;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= static_cast<int64_t>(N) * nvec) return;
  const int n = static_cast<int>(idx / nvec);
  const int c = static_cast<int>(idx - static_cast<int64_t>(n) * nvec) * VEC;
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  for (int j = csc_row_ptr[n]; j < csc_row_ptr[n + 1]; ++j) {
    float t[VEC];
    load_vec<T, VEC>(ct + static_cast<int64_t>(csc_perm[j]) * D + c, t);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], t[k]);
  }
  store_vec<T, VEC>(d + static_cast<int64_t>(n) * D + c, acc);
}

template <typename T, int VEC>
void launch_width(const T* c, const int* crp, const int* perm, T* d, int N,
                  int D, cudaStream_t st) {
  const int64_t items = static_cast<int64_t>(N) * (D / VEC);
  const dim3 grid(static_cast<unsigned>((items + THREADS - 1) / THREADS));
  snd_segment_sum_kernel<T, VEC><<<grid, THREADS, 0, st>>>(c, crp, perm, d,
                                                            N, D);
}

template <typename T>
cudaError_t launch(const void* ct, const void* csc_row_ptr,
                   const void* csc_perm, void* d, int N, int D,
                   void* stream) {
  if (N <= 0 || D <= 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const T*>(ct);
  const auto* crp = static_cast<const int*>(csc_row_ptr);
  const auto* perm = static_cast<const int*>(csc_perm);
  auto* out = static_cast<T*>(d);
  const void* ptrs[2] = {ct, d};
  constexpr int V16 = 16 / sizeof(T), V8 = 8 / sizeof(T);
  const int vec = vec_width<T>(D, ptrs, 2);
  if (vec == V16) {
    launch_width<T, V16>(c, crp, perm, out, N, D, st);
  } else if (vec == V8) {
    launch_width<T, V8>(c, crp, perm, out, N, D, st);
  } else {
    launch_width<T, 1>(c, crp, perm, out, N, D, st);
  }
  return cudaGetLastError();
}

}  // namespace

// ct [E, D], csc_row_ptr [N + 1] int32, csc_perm [E] int32, d [N, D] of
// ct's type.
PORT_API cudaError_t snd_segment_sum_bf16(const void* ct,
                                          const void* csc_row_ptr,
                                          const void* csc_perm, void* d,
                                          int N, int D, void* stream) {
  return launch<__nv_bfloat16>(ct, csc_row_ptr, csc_perm, d, N, D, stream);
}

PORT_API cudaError_t snd_segment_sum_f32(const void* ct,
                                         const void* csc_row_ptr,
                                         const void* csc_perm, void* d,
                                         int N, int D, void* stream) {
  return launch<float>(ct, csc_row_ptr, csc_perm, d, N, D, stream);
}
