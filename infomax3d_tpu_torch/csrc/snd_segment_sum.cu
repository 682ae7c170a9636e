// Sender-keyed segment sum, the backward of the sender gather h[senders]:
// per node n,
//   d[n] = sum of ct[csc_perm[j]] over its CSC (sender-sorted) range
//          j in [csc_row_ptr[n], csc_row_ptr[n+1])
//
// Replaces: the Pallas kernel `_snd_seg_sum_kernel` through
//   `_snd_kernel_norecv` of infomax3d_tpu/ops/pallas/spmm.py (wrapper
//   `snd_segment_sum_bf16`), the backward of `take_rows` over the senders
//   (`gather_src`) in every GIN layer and every layer of the OT step's
//   edge-update backbone.
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
// Design: one thread per (node, column vector) walks its node's sender
//   range with `walk_rows` (common.cuh): U slots at a time, the chunk's U
//   csc_perm loads, then its U ct row loads (the rows of one molecule, close
//   together; a warp's threads read neighbouring vectors of one row), then
//   the adds in slot order; the sum in registers, one store.  Each output
//   element has one owner, so there are no atomics and the result is
//   deterministic.  At the OT slice's shapes (~640 real edges, N = 512,
//   D = 50) a launch moves 0.24 MB: its time is the launch and the chain
//   csc_row_ptr -> csc_perm -> rows.  Vectors of 16 or 8 bytes as
//   `vec_width` allows (D = 300 in bf16 and D = 50 in float32 take the
//   8-byte path), else one element.  U = WALK_UNROLL, blocks of
//   WALK_THREADS; 32-bit index arithmetic where max(N, E) * D < 2^31
//   (`walk_wide`).
#include "common.cuh"

namespace {

template <typename T, int VEC, typename Idx>
__global__ void __launch_bounds__(WALK_THREADS)
snd_segment_sum_kernel(const T* __restrict__ ct,
                       const int* __restrict__ csc_row_ptr,
                       const int* __restrict__ csc_perm,
                       T* __restrict__ d, int N, int D) {
  int n, c;
  if (!node_column<Idx, VEC>(N, D, n, c)) return;
  const int first = csc_row_ptr[n];
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  auto add = [&](const float (&t)[VEC], bool valid) {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      acc[k] = __fadd_rn(acc[k], valid ? t[k] : 0.f);   // + 0: exact
  };
  walk_rows<T, VEC, WALK_UNROLL, true, Idx>(ct, D, c, csc_perm, first,
                                            csc_row_ptr[n + 1] - first, add);
  store_vec<T, VEC>(d + static_cast<int64_t>(n) * D + c, acc);
}

template <typename T, int VEC>
void launch_width(const T* c, const int* crp, const int* perm, T* d, int N,
                  int D, bool wide, cudaStream_t st) {
  const dim3 grid(walk_blocks(static_cast<int64_t>(N) * (D / VEC)));
  if (wide) {
    snd_segment_sum_kernel<T, VEC, int64_t>
        <<<grid, WALK_THREADS, 0, st>>>(c, crp, perm, d, N, D);
  } else {
    snd_segment_sum_kernel<T, VEC, uint32_t>
        <<<grid, WALK_THREADS, 0, st>>>(c, crp, perm, d, N, D);
  }
}

template <typename T>
cudaError_t launch(const void* ct, const void* csc_row_ptr,
                   const void* csc_perm, void* d, int N, int E, int D,
                   int force_wide, void* stream) {
  if (N <= 0 || D <= 0) return cudaSuccess;
  const bool wide = walk_wide(N, E, D, force_wide);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const T*>(ct);
  const auto* crp = static_cast<const int*>(csc_row_ptr);
  const auto* perm = static_cast<const int*>(csc_perm);
  auto* out = static_cast<T*>(d);
  const void* ptrs[2] = {ct, d};
  constexpr int V16 = 16 / sizeof(T), V8 = 8 / sizeof(T);
  const int vec = vec_width<T>(D, ptrs, 2);
  if (vec == V16) {
    launch_width<T, V16>(c, crp, perm, out, N, D, wide, st);
  } else if (vec == V8) {
    launch_width<T, V8>(c, crp, perm, out, N, D, wide, st);
  } else {
    launch_width<T, 1>(c, crp, perm, out, N, D, wide, st);
  }
  return cudaGetLastError();
}

}  // namespace

// ct [E, D], csc_row_ptr [N + 1] int32, csc_perm [E] int32, d [N, D] of
// ct's type; wide != 0 forces 64-bit index arithmetic.
PORT_API cudaError_t snd_segment_sum_bf16(const void* ct,
                                          const void* csc_row_ptr,
                                          const void* csc_perm, void* d,
                                          int N, int E, int D, int wide,
                                          void* stream) {
  return launch<__nv_bfloat16>(ct, csc_row_ptr, csc_perm, d, N, E, D, wide,
                               stream);
}

PORT_API cudaError_t snd_segment_sum_f32(const void* ct,
                                         const void* csc_row_ptr,
                                         const void* csc_perm, void* d,
                                         int N, int E, int D, int wide,
                                         void* stream) {
  return launch<float>(ct, csc_row_ptr, csc_perm, d, N, E, D, wide, stream);
}
