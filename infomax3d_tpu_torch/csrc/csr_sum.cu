// Two kernels over one CSR layout: per node n, the sum of its
// receiver-sorted edge rows e in [row_ptr[n], row_ptr[n+1]),
//   csr_sum:          out[n] = sum, float32 whatever the rows' type
//   csr_segment_sum:  out[n] = the sum rounded once to the rows' own type
//
// Replaces: the Pallas kernels of infomax3d_tpu/ops/pallas/spmm.py
//   `_sum_kernel` (wrapper `_csr_sum_raw`, public `csr_sum` / `csr_mean`),
//   the aggregation of every GIN layer (`edge_aggregate(g, msg, "sum")`)
//   and of the flat Net3D (`csr_mean` over the conformers' complete
//   graphs), and `_seg_sum_kernel` (wrapper `_csr_seg_sum_raw`, public
//   `csr_segment_sum_bf16`), the backward of the receiver gather
//   (`take_rows` with `row_ptr` and no `perm`, i.e. `gather_dst`), run once
//   per `PNALayerEdgeUpdate` layer.  Each keeps its own `__global__` and
//   exported symbols, so a profile tells them apart.
// Contract: rows float32 or bf16; each sum is accumulated in float32 in
//   range order (slot 0 first, __fadd_rn from +0), and csr_segment_sum
//   rounds it once (__float2bfloat16_rn for bf16).  Padding edges lie past
//   row_ptr[N] and never enter a sum; nodes without edges (padding nodes
//   included) get 0.  One owner per output, no atomics, deterministic.
// Bound on the card: device-memory bytes: each real row is read once and
//   [N, D] written, one add per element read; at the GIN slice's shapes
//   (E_real = 6680, N = 3328, D = 300) 4.0 MB read + 4.0 MB written in bf16
//   for csr_sum; at the multi-conformer shape (QMugs, C = 3: E_real =
//   3.25 M, N = 67328, D = 20) 135.80 MB in bf16 (40-byte rows), ~266 MB in
//   float32 (80-byte rows); at the OT slice's (E_real ~ 640, N = 512,
//   D = 50) well under 1 MB, so the launch and the chain of dependent round
//   trips each thread waits on (row_ptr, then its rows) set
//   csr_segment_sum's time.
// Design: each output (node, column vector) has one thread, which adds
//   the node's rows at its columns in slot order.  The vector is 16 bytes
//   where a row holds whole 16-byte vectors and 8 bytes where it holds
//   whole 8-byte ones (D = 300 in bf16: 600-byte rows, 75 vectors of 4;
//   D = 20 in bf16: 40-byte rows, 5 vectors of 4), else one element
//   (`vec_width`).  Where the rows come from:
//   - csr_sum on long ranges (`stream_path`: the batch's E, padding edges
//     included, at least STREAM_MIN_DEGREE x N, and a node's column
//     vectors fit one block) takes `csr_sum_stream_kernel`, the Hopper
//     form of `_sum_kernel`'s VMEM window: a block owns a tile of
//     consecutive nodes, whose rows are one contiguous byte run in the
//     receiver-sorted batch.  The tile is sized by bytes, ~STREAM_TILE of
//     rows at the batch's mean in-degree, not by its largest degree.  One
//     thread copies the run, from the 16-byte word that holds its first
//     byte, into shared memory with one 1-D bulk copy (TMA) that completes
//     on an mbarrier, whatever the row width (the tensor's partial first
//     and last words element by element, so nothing past the allocation
//     is read); then every thread adds its node's rows there in slot order
//     (`walk_rows`), all the tile's nodes at once.  Rows past the stage (a
//     tile of nodes far above the mean degree) are read from device
//     memory, still in slot order.  Several blocks per SM (the stage is
//     ~24 KB) overlap one tile's copy with another's adds.  A column
//     vector is aligned to its own width, so it lies wholly inside or
//     outside the stage.
//   - csr_sum on short ranges (the GIN batch: E ~ 2 N) keeps `csr_walk`:
//     one row loaded, then added, then the next, in blocks of THREADS
//     with 64-bit index arithmetic; it reaches most of its byte bound
//     there.
//   - csr_segment_sum_kernel takes `walk_rows` (common.cuh) from device
//     memory, as the multi-reduce and the sender-keyed segment sum do:
//     U = WALK_UNROLL slots at a time, the chunk's row loads in flight
//     before its first add, the adds in slot order; blocks of
//     WALK_THREADS.
//   The stream and csr_segment_sum use 32-bit index arithmetic where
//   max(N, E) * D < 2^31 (`walk_wide`), else (or when the caller forces
//   it) 64-bit.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; tools/torch_kernel_ab.py,
//   cold L2; PERF.md §6, row 7): at the QMugs conformer shape in bf16 the
//   stream takes 0.061 ms, 67 % of the byte bound and 1.09x a plain read
//   of the same rows (`read_probe`), where the walk took 0.099 ms and
//   `walk_rows` from device memory 0.069; in float32 0.103 ms (77 %).  In
//   exploratory runs a ring of byte chunks added as they landed was
//   slower (only the ~2 nodes a chunk holds could add at a time), and at
//   the GIN shape the stream was slower warm than the walk, hence the
//   rule.
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

// --- the stream (csr_sum on long ranges) -----------------------------------

// Threads a block has at most.
constexpr int STREAM_THREADS = 128;
// Bytes of rows a tile aims at: tn = STREAM_TILE / (the batch's mean
// in-degree x row bytes) nodes, at least 1 and at most STREAM_THREADS /
// (D / VEC).  The stage holds half as much again and one word (rows past
// it, which only a tile of nodes far above the mean degree has, are read
// from device memory); it and its mbarrier fit the default 48 KB of
// shared memory, nine blocks to an SM.
constexpr int STREAM_TILE = 16384;
constexpr int STREAM_STAGE_BYTES = STREAM_TILE + STREAM_TILE / 2 + 16;
static_assert(STREAM_STAGE_BYTES + 8 <= 48 * 1024, "stage too large");
// The stream is taken where E >= STREAM_MIN_DEGREE * N.
constexpr int STREAM_MIN_DEGREE = 8;

// The path of csr_sum (see the note at the top): the stream where the
// batch's mean in-degree, padding edges counted, is at least
// STREAM_MIN_DEGREE (the conformer batches' complete graphs, ~48) and a
// node's nvec column vectors fit one block; else the walk (the GIN batch,
// ~2).
__host__ inline bool stream_path(int N, int E, int nvec) {
  return nvec <= STREAM_THREADS &&
         static_cast<int64_t>(E) >= static_cast<int64_t>(N) *
                                        STREAM_MIN_DEGREE;
}

// mbarrier `bar` (a shared-memory address) expects one arrival; the
// arrival of the thread that calls `stage_arrive` adds `bytes` to the
// transactions it waits for, which a bulk copy completes.
__device__ __forceinline__ void stage_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void stage_arrive(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// 1-D bulk copy (TMA) global -> shared of `bytes`, a multiple of 16 from
// and to 16-byte aligned addresses, completing on mbarrier `bar`
__device__ __forceinline__ void stage_copy(unsigned dst, const void* src,
                                           unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// wait until mbarrier `bar` completes its first phase
__device__ __forceinline__ void stage_wait(unsigned bar) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar) : "memory");
}

// Block b sums the tile of nodes [b * tn, min(b * tn + tn, N)); blockDim
// is tn * (D / VEC), thread (node nl, column vector c).  The tile's rows
// are staged from w0, the 16-byte word that holds the first of them, up
// to the stage's capacity; positions are in elements of T from w0.
template <typename T, int VEC, typename Idx>
__global__ void __launch_bounds__(STREAM_THREADS)
csr_sum_stream_kernel(const T* __restrict__ msg,
                      const int* __restrict__ row_ptr, float* __restrict__ out,
                      int N, int E, int D, int tn) {
  constexpr int WE = 16 / sizeof(T);             // elements of a word
  constexpr int STAGE = STREAM_STAGE_BYTES / sizeof(T);
  static_assert(STAGE % WE == 0, "the stage is whole words");
  __shared__ __align__(16) T tile[STAGE];
  __shared__ __align__(8) uint64_t landed;       // the stage's mbarrier
  const int nvec = D / VEC;
  const int nl = threadIdx.x / nvec;
  const int c = (threadIdx.x - nl * nvec) * VEC;
  const int n0 = blockIdx.x * tn, n1 = min(n0 + tn, N), n = n0 + nl;
  const bool owner = n < n1;
  const int e0 = row_ptr[n0], e1 = row_ptr[n1];
  const int first = owner ? row_ptr[n] : e0;
  const int cnt = owner ? row_ptr[n + 1] - first : 0;

  const T* r0 = msg + static_cast<Idx>(e0) * D;    // the tile's rows
  const T* r1 = msg + static_cast<Idx>(e1) * D;
  const T* end = msg + static_cast<Idx>(E) * D;    // the tensor's end
  const T* w0 = reinterpret_cast<const T*>(
      reinterpret_cast<uintptr_t>(r0) & ~uintptr_t{15});
  const Idx len = static_cast<Idx>(r1 - w0);
  const int staged = e1 > e0 ? (len < static_cast<Idx>(STAGE)
                                    ? static_cast<int>(len) : STAGE)
                             : 0;
  // the words [lo, hi) lie inside the tensor and move in one bulk copy
  // (bytes of neighbouring rows come along and are not added); the
  // tensor's partial first or last word, where the stage holds one, moves
  // element by element, the tile's own elements only
  const int words = (staged + WE - 1) / WE * WE;
  const Idx room = static_cast<Idx>(end - w0) / WE * WE;
  const int lo = w0 >= msg ? 0 : WE;
  const int hi = static_cast<Idx>(words) <= room ? words
                                                 : static_cast<int>(room);
  const unsigned bar =
      static_cast<unsigned>(__cvta_generic_to_shared(&landed));
  if (threadIdx.x == 0) stage_init(bar);
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned bytes = hi > lo ? (hi - lo) * sizeof(T) : 0u;
    stage_arrive(bar, bytes);
    if (bytes > 0)
      stage_copy(static_cast<unsigned>(__cvta_generic_to_shared(tile + lo)),
                 w0 + lo, bytes, bar);
  }
  for (int i = threadIdx.x * WE; i < words; i += blockDim.x * WE) {
    if (i >= lo && i < hi) continue;
    const T* p = w0 + i;
#pragma unroll
    for (int j = 0; j < WE; ++j)
      if (p + j >= r0 && p + j < r1) tile[i + j] = p[j];
  }
  stage_wait(bar);
  __syncthreads();                 // the element-wise words

  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  auto add = [&](const float (&v)[VEC], bool valid) {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      acc[k] = __fadd_rn(acc[k], valid ? v[k] : 0.f);   // + 0: exact
  };
  // the slots whose column vector was staged (a vector is aligned to its
  // own width, so it lies wholly inside or outside the stage), then the
  // rest from device memory, all in slot order
  const int pos = static_cast<int>(r0 - w0) + (first - e0) * D + c;
  const int here = pos < staged ? min(cnt, (staged - pos + D - 1) / D) : 0;
  walk_rows<T, VEC, WALK_UNROLL, false, int>(tile + pos, D, 0, nullptr, 0,
                                             here, add);
  walk_rows<T, VEC, WALK_UNROLL, false, Idx>(msg, D, c, nullptr, first + here,
                                             cnt - here, add);
  if (owner) store_vec<float, VEC>(out + static_cast<Idx>(n) * D + c, acc);
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

// A plain read of `words` 16-byte words, four loads per thread in flight
// at a time over a grid-stride loop, their bits folded and stored only on
// an impossible value: the least time any kernel takes to read the same
// bytes under chip_smoke.py's timing (cold L2), beside which row 7's
// stream is held.  No wrapper of the port calls it.
__global__ void read_probe_kernel(const uint4* __restrict__ p,
                                  int64_t words, unsigned* out) {
  unsigned x = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (; i + 3 * stride < words; i += 4 * stride) {
    const uint4 a = p[i], b = p[i + stride], c = p[i + 2 * stride],
                d = p[i + 3 * stride];
    x ^= a.x ^ b.y ^ c.z ^ d.w;
  }
  for (; i < words; i += stride) x ^= p[i].x;
  if (x == 0x9e3779b9u) out[0] = x;
}

// SEGMENT: csr_segment_sum_kernel (output of the rows' type), else
// csr_sum (float32 output) on its path (`stream_path`).  wide: 64-bit
// indices (the walk of csr_sum has them always).
template <bool SEGMENT, typename T, int VEC>
void launch_width(const T* r, const int* rp, void* o, int N, int E, int D,
                  bool wide, cudaStream_t st) {
  const int nvec = D / VEC;
  const int64_t items = static_cast<int64_t>(N) * nvec;
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
  } else if (stream_path(N, E, nvec)) {
    // the tile by bytes (see STREAM_TILE): tn nodes of the mean run
    const int64_t node = (static_cast<int64_t>(E) + N - 1) / N * D *
                         static_cast<int64_t>(sizeof(T));
    const int64_t fit = STREAM_TILE / node;
    const int tn = static_cast<int>(
        fit < 1 ? 1 : (fit > STREAM_THREADS / nvec ? STREAM_THREADS / nvec
                                                   : fit));
    const dim3 grid(static_cast<unsigned>((N + tn - 1) / tn));
    auto* out = static_cast<float*>(o);
    if (wide) {
      csr_sum_stream_kernel<T, VEC, int64_t>
          <<<grid, tn * nvec, 0, st>>>(r, rp, out, N, E, D, tn);
    } else {
      csr_sum_stream_kernel<T, VEC, uint32_t>
          <<<grid, tn * nvec, 0, st>>>(r, rp, out, N, E, D, tn);
    }
  } else {
    const dim3 grid(static_cast<unsigned>((items + THREADS - 1) / THREADS));
    csr_sum_kernel<T, VEC><<<grid, THREADS, 0, st>>>(
        r, rp, static_cast<float*>(o), N, D);
  }
}

template <bool SEGMENT, typename T>
cudaError_t launch(const void* rows, const void* row_ptr, void* out, int N,
                   int E, int D, int force_wide, void* stream) {
  if (N <= 0 || D <= 0) return cudaSuccess;
  const bool wide = walk_wide(N, E, D, force_wide);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const T*>(rows);
  const auto* rp = static_cast<const int*>(row_ptr);
  const void* ptrs[2] = {rows, out};
  constexpr int V16 = 16 / sizeof(T), V8 = 8 / sizeof(T);
  const int vec = vec_width<T>(D, ptrs, 2);
  if (vec == V16) {
    launch_width<SEGMENT, T, V16>(r, rp, out, N, E, D, wide, st);
  } else if (vec == V8) {
    launch_width<SEGMENT, T, V8>(r, rp, out, N, E, D, wide, st);
  } else {
    launch_width<SEGMENT, T, 1>(r, rp, out, N, E, D, wide, st);
  }
  return cudaGetLastError();
}

}  // namespace

// msg [E, D] (float32 or bf16), row_ptr [N + 1] int32, out [N, D] float32;
// wide != 0 forces 64-bit index arithmetic on the stream.
PORT_API cudaError_t csr_sum_f32(const void* msg, const void* row_ptr,
                                 void* out, int N, int E, int D, int wide,
                                 void* stream) {
  return launch<false, float>(msg, row_ptr, out, N, E, D, wide, stream);
}

PORT_API cudaError_t csr_sum_bf16(const void* msg, const void* row_ptr,
                                  void* out, int N, int E, int D, int wide,
                                  void* stream) {
  return launch<false, __nv_bfloat16>(msg, row_ptr, out, N, E, D, wide,
                                      stream);
}

// ct [E, D], row_ptr [N + 1] int32, out [N, D] of ct's type; wide != 0
// forces 64-bit index arithmetic.
PORT_API cudaError_t csr_segment_sum_f32(const void* ct, const void* row_ptr,
                                         void* out, int N, int E, int D,
                                         int wide, void* stream) {
  return launch<true, float>(ct, row_ptr, out, N, E, D, wide, stream);
}

PORT_API cudaError_t csr_segment_sum_bf16(const void* ct, const void* row_ptr,
                                          void* out, int N, int E, int D,
                                          int wide, void* stream) {
  return launch<true, __nv_bfloat16>(ct, row_ptr, out, N, E, D, wide,
                                     stream);
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

// the plain read of `bytes` (rounded down to 16) from 16-byte aligned p,
// 8 blocks of 256 threads per SM; out [1] uint32
PORT_API cudaError_t read_probe(const void* p, long long bytes, void* out,
                                void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorInvalidValue;
  read_probe_kernel<<<sms * 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(p), bytes / 16, static_cast<unsigned*>(out));
  return cudaGetLastError();
}

// the empty kernel on `blocks` blocks of `threads`
PORT_API cudaError_t launch_floor(int blocks, int threads, void* stream) {
  launch_floor_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
