// Two kernels over one CSR layout: per node n, the sum of its
// receiver-sorted edge rows e in [row_ptr[n], row_ptr[n+1]),
//   csr_sum:          out[n] = sum, float32 whatever the rows' type
//   csr_segment_sum:  out[n] = the sum rounded once to the rows' own type
//
// Replaces: the Pallas kernels of infomax3d_tpu/ops/pallas/spmm.py
//   `_sum_kernel` (wrapper `_csr_sum_raw`, public `csr_sum` / `csr_mean`),
//   the aggregation of every GIN layer (`edge_aggregate(g, msg, "sum")`),
//   and `_seg_sum_kernel` (wrapper `_csr_seg_sum_raw`, public
//   `csr_segment_sum_bf16`), the backward of the receiver gather
//   (`take_rows` with `row_ptr` and no `perm`, i.e. `gather_dst`), run once
//   per `PNALayerEdgeUpdate` layer.  Each keeps its own `__global__` and
//   exported symbols, so a profile tells them apart.
// Contract: rows float32 or bf16; each sum is accumulated in float32 in
//   range order (slot 0 first), and csr_segment_sum rounds it once
//   (__float2bfloat16_rn for bf16).  Padding edges lie past row_ptr[N] and
//   never enter a sum; nodes without edges (padding nodes included) get 0.
// Bound on the card: device-memory bytes: each real row is read once and
//   [N, D] written, one add per element read; at the GIN slice's shapes
//   (E_real = 6680, N = 3328, D = 300) 4.0 MB read + 4.0 MB written in bf16
//   for csr_sum; at the OT slice's (E_real ~ 640, N = 512, D = 50) well
//   under 1 MB, so the launch and the chain of dependent round trips each
//   thread waits on (row_ptr, then its rows) set csr_segment_sum's time.
// Design: one thread per (node, column vector), the node's rows read in
//   order (a warp's threads cover neighbouring vectors of one row, so its
//   loads coalesce), the sum in registers, one owner per output, no
//   atomics, deterministic.  The vector is 16 bytes where a row holds whole
//   16-byte vectors and 8 bytes where it holds whole 8-byte ones (D = 300
//   in bf16: 600-byte rows, 75 vectors of 4; D = 50 in float32: 200-byte
//   rows, 25 vectors of 2), else one element (D = 50 in bf16)
//   (`vec_width`).  The two kernels walk differently:
//   - csr_sum_kernel takes `csr_walk` below: one row loaded, then added,
//     then the next, in blocks of THREADS with 64-bit index arithmetic.  At
//     the GIN shapes it reaches most of its byte bound, so it stays so.
//   - csr_segment_sum_kernel takes `walk_rows` (common.cuh), as the
//     multi-reduce and the sender-keyed segment sum do: U = WALK_UNROLL
//     slots at a time, the chunk's row loads in flight before its first
//     add, the adds in slot order; blocks of WALK_THREADS; 32-bit index
//     arithmetic where max(N, E) * D < 2^31 (`walk_wide`).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// csr_sum_kernel's walk (the CSR sum alone): its node's rows one at a time.
template <typename T, int VEC>
__device__ __forceinline__ void csr_walk(const T* __restrict__ rows,
                                         const int* __restrict__ row_ptr,
                                         float* __restrict__ out, int N,
                                         int D) {
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
    load_vec<T, VEC>(rows + static_cast<int64_t>(e) * D + c, m);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], m[k]);
  }
  store_vec<float, VEC>(out + static_cast<int64_t>(n) * D + c, acc);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
csr_sum_kernel(const T* __restrict__ msg, const int* __restrict__ row_ptr,
               float* __restrict__ out, int N, int D) {
  csr_walk<T, VEC>(msg, row_ptr, out, N, D);
}

template <typename T, int VEC, typename Idx>
__global__ void __launch_bounds__(WALK_THREADS)
csr_segment_sum_kernel(const T* __restrict__ ct,
                       const int* __restrict__ row_ptr, T* __restrict__ out,
                       int N, int D) {
  int n, c;
  if (!node_column<Idx, VEC>(N, D, n, c)) return;
  const int start = row_ptr[n];
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  auto add = [&](const float (&v)[VEC], bool valid) {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      acc[k] = __fadd_rn(acc[k], valid ? v[k] : 0.f);   // + 0: exact
  };
  walk_rows<T, VEC, WALK_UNROLL, false, Idx>(ct, D, c, nullptr, start,
                                             row_ptr[n + 1] - start, add);
  store_vec<T, VEC>(out + static_cast<int64_t>(n) * D + c, acc);
}

// An empty kernel: its device time on a given grid is what any launch of
// that grid costs before it does work (start, one wave, drain).  Used by
// chip_smoke.py as the card's launch floor, on the grid of the OT step's
// walks (50 blocks of 256 at N = 512, D = 50 in float32); no wrapper of the
// port calls it.
__global__ void launch_floor_kernel() {}

// The next rung above the floor: the index round trip of the small CSR
// walks without their rows.  Thread idx of N * nvec (node n = idx / nvec)
// loads row_ptr[n] and row_ptr[n + 1] and stores their difference, so its
// time less the floor's is what a walk waits for its range.  Used by
// chip_smoke.py on the grid of the OT step's walks; no wrapper calls it.
__global__ void index_probe_kernel(const int* __restrict__ row_ptr,
                                   float* __restrict__ out, int N, int nvec) {
  const uint32_t idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= static_cast<uint32_t>(N) * nvec) return;
  const uint32_t n = idx / static_cast<uint32_t>(nvec);
  out[idx] = static_cast<float>(row_ptr[n + 1] - row_ptr[n]);
}

// SEGMENT: csr_segment_sum_kernel (output of the rows' type, 64-bit
// indices where `wide`), else csr_sum_kernel (float32 output).
template <bool SEGMENT, typename T, int VEC>
void launch_width(const T* r, const int* rp, void* o, int N, int D,
                  bool wide, cudaStream_t st) {
  const int64_t items = static_cast<int64_t>(N) * (D / VEC);
  if constexpr (SEGMENT) {
    const dim3 grid(walk_blocks(items));
    auto* out = static_cast<T*>(o);
    if (wide) {
      csr_segment_sum_kernel<T, VEC, int64_t>
          <<<grid, WALK_THREADS, 0, st>>>(r, rp, out, N, D);
    } else {
      csr_segment_sum_kernel<T, VEC, uint32_t>
          <<<grid, WALK_THREADS, 0, st>>>(r, rp, out, N, D);
    }
  } else {
    const dim3 grid(static_cast<unsigned>((items + THREADS - 1) / THREADS));
    csr_sum_kernel<T, VEC><<<grid, THREADS, 0, st>>>(
        r, rp, static_cast<float*>(o), N, D);
  }
}

template <bool SEGMENT, typename T>
cudaError_t launch(const void* rows, const void* row_ptr, void* out, int N,
                   int D, bool wide, void* stream) {
  if (N <= 0 || D <= 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const T*>(rows);
  const auto* rp = static_cast<const int*>(row_ptr);
  const void* ptrs[2] = {rows, out};
  constexpr int V16 = 16 / sizeof(T), V8 = 8 / sizeof(T);
  const int vec = vec_width<T>(D, ptrs, 2);
  if (vec == V16) {
    launch_width<SEGMENT, T, V16>(r, rp, out, N, D, wide, st);
  } else if (vec == V8) {
    launch_width<SEGMENT, T, V8>(r, rp, out, N, D, wide, st);
  } else {
    launch_width<SEGMENT, T, 1>(r, rp, out, N, D, wide, st);
  }
  return cudaGetLastError();
}

}  // namespace

// msg [E, D] (float32 or bf16), row_ptr [N + 1] int32, out [N, D] float32.
PORT_API cudaError_t csr_sum_f32(const void* msg, const void* row_ptr,
                                 void* out, int N, int D, void* stream) {
  return launch<false, float>(msg, row_ptr, out, N, D, false, stream);
}

PORT_API cudaError_t csr_sum_bf16(const void* msg, const void* row_ptr,
                                  void* out, int N, int D, void* stream) {
  return launch<false, __nv_bfloat16>(msg, row_ptr, out, N, D, false,
                                      stream);
}

// ct [E, D], row_ptr [N + 1] int32, out [N, D] of ct's type; wide != 0
// forces 64-bit index arithmetic.
PORT_API cudaError_t csr_segment_sum_f32(const void* ct, const void* row_ptr,
                                         void* out, int N, int E, int D,
                                         int wide, void* stream) {
  return launch<true, float>(ct, row_ptr, out, N, D,
                             walk_wide(N, E, D, wide), stream);
}

PORT_API cudaError_t csr_segment_sum_bf16(const void* ct, const void* row_ptr,
                                          void* out, int N, int E, int D,
                                          int wide, void* stream) {
  return launch<true, __nv_bfloat16>(ct, row_ptr, out, N, D,
                                     walk_wide(N, E, D, wide), stream);
}

// the index probe on the grid of N * nvec threads in blocks of `threads`;
// out [N * nvec] float32
PORT_API cudaError_t index_probe(const void* row_ptr, void* out, int N,
                                 int nvec, int threads, void* stream) {
  const int64_t items = static_cast<int64_t>(N) * nvec;
  if (items <= 0 || items >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
  index_probe_kernel<<<static_cast<unsigned>((items + threads - 1) / threads),
                       threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row_ptr), static_cast<float*>(out), N, nvec);
  return cudaGetLastError();
}

// the empty kernel on `blocks` blocks of `threads`
PORT_API cudaError_t launch_floor(int blocks, int threads, void* stream) {
  launch_floor_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
