// Fused edge combine: z[e] = hd[recv[e]] + hs[send[e]] + pe[e].
//
// Replaces: the Pallas kernel `_edge_combine_kernel` of
//   infomax3d_tpu/ops/pallas/spmm.py (wrapper `_csr_edge_combine_raw`), the
//   first pretrans layer of every PNA layer with its input [h[send] ‖
//   h[recv] ‖ e] split across the weight rows (models/base.py SplitDense).
// Contract: the three terms are summed in float32 in that order and rounded
//   to the output type once.  A term whose index is not in [0, N) is left
//   out, so padding edges (index N) get pe alone.
// Bound on the card: device-memory bytes.  Per edge it does D adds and
//   moves 3 * D * sizeof(T) bytes (two row gathers, the pe row, the output
//   row); at the bench shapes (E = 18432, N = 9216, D = 200, bf16) the
//   unique bytes are ~22 MB and the adds ~7 MFLOP, so bandwidth bounds it.
// Design: one block per tile of EDGES_PER_BLOCK edges.  The block reads the
//   tile's receiver and sender ids once into shared memory; then each thread
//   takes one 16-byte column vector (8 bf16 or 4 float32) of one edge, so
//   neighbouring threads read neighbouring 16 bytes of the same rows and
//   every load and store coalesces.  The edges of a tile are consecutive in
//   receiver-sorted order, so the hd rows they gather are few and stay in
//   L1/L2.  No shared-memory staging of the rows, no atomics.  A row width
//   that is not a whole number of 16-byte vectors (or a pointer that is not
//   16-byte aligned) takes the element-wise instantiation instead.
#include "common.cuh"

namespace {

constexpr int EDGES_PER_BLOCK = 32;
constexpr int THREADS = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
edge_combine_kernel(const T* __restrict__ hd, const T* __restrict__ hs,
                    const T* __restrict__ pe, const int* __restrict__ recv,
                    const int* __restrict__ send, T* __restrict__ out, int N,
                    int E, int D) {
  __shared__ int s_recv[EDGES_PER_BLOCK];
  __shared__ int s_send[EDGES_PER_BLOCK];
  const int e0 = blockIdx.x * EDGES_PER_BLOCK;
  const int ne = min(EDGES_PER_BLOCK, E - e0);
  for (int i = threadIdx.x; i < ne; i += blockDim.x) {
    s_recv[i] = recv[e0 + i];
    s_send[i] = send[e0 + i];
  }
  __syncthreads();

  const int nvec = D / VEC;
  for (int i = threadIdx.x; i < ne * nvec; i += blockDim.x) {
    const int le = i / nvec;
    const int c = (i - le * nvec) * VEC;
    const int r = s_recv[le];
    const int s = s_send[le];
    float acc[VEC];
    float t[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    if (r >= 0 && r < N) {
      load_vec<T, VEC>(hd + static_cast<int64_t>(r) * D + c, t);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = t[k];
    }
    if (s >= 0 && s < N) {
      load_vec<T, VEC>(hs + static_cast<int64_t>(s) * D + c, t);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], t[k]);
    }
    const int64_t row = static_cast<int64_t>(e0 + le) * D + c;
    load_vec<T, VEC>(pe + row, t);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], t[k]);
    store_vec<T, VEC>(out + row, acc);
  }
}

template <typename T>
cudaError_t launch(const void* hd, const void* hs, const void* pe,
                   const void* recv, const void* send, void* out, int N,
                   int E, int D, void* stream) {
  if (E <= 0 || D <= 0) return cudaSuccess;
  const dim3 grid((E + EDGES_PER_BLOCK - 1) / EDGES_PER_BLOCK);
  auto st = static_cast<cudaStream_t>(stream);
  const void* ptrs[4] = {hd, hs, pe, out};
  constexpr int V = 16 / sizeof(T);
  if (vec16_ok(D, sizeof(T), ptrs, 4)) {
    edge_combine_kernel<T, V><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(hd), static_cast<const T*>(hs),
        static_cast<const T*>(pe), static_cast<const int*>(recv),
        static_cast<const int*>(send), static_cast<T*>(out), N, E, D);
  } else {
    edge_combine_kernel<T, 1><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(hd), static_cast<const T*>(hs),
        static_cast<const T*>(pe), static_cast<const int*>(recv),
        static_cast<const int*>(send), static_cast<T*>(out), N, E, D);
  }
  return cudaGetLastError();
}

}  // namespace

PORT_API cudaError_t edge_combine_bf16(const void* hd, const void* hs,
                                       const void* pe, const void* recv,
                                       const void* send, void* out, int N,
                                       int E, int D, void* stream) {
  return launch<__nv_bfloat16>(hd, hs, pe, recv, send, out, N, E, D, stream);
}

PORT_API cudaError_t edge_combine_f32(const void* hd, const void* hs,
                                      const void* pe, const void* recv,
                                      const void* send, void* out, int N,
                                      int E, int D, void* stream) {
  return launch<float>(hd, hs, pe, recv, send, out, N, E, D, stream);
}
