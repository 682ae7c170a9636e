// Backward of the fused bf16 PNA statistics, in one launch per layer: the
// node-side combination of the cotangents, the per-edge routing and the
// affine's column sums.  Per node n with in-degree deg and each edge e of
// its CSR range [row_ptr[n], row_ptr[n+1]) at slot s = e - row_ptr[n]:
//   inv  = 1 / max(deg, 1)
//   A    = bf16(d_sum + d_mean * inv)
//   B    = bf16(d_std * inv / max(std, sqrt(1e-5)))
//   m    = bf16(x * a + b)  with the affine, else x              (f32 math)
//   d    = A + B * (m - mean) + d_max * [s == amax] + d_min * [s == amin]
//   d_x  = bf16(d * a)  with the affine, else bf16(d)
//   d_a  = sum over e of d * x,  d_b = sum over e of d   (affine only)
// where the winner slots come from the forward's enc = amax + 16 amin.  A
// missing cotangent (a null pointer) drops its term; d_x is 0 on the
// padding edges, at or beyond row_ptr[N].
//
// Replaces: the Pallas kernels `_stats_bwd_kernel` and
//   `_stats_bwd_kernel_aff` of infomax3d_tpu/ops/pallas/spmm.py (wrapper
//   `_csr_stats_bwd_raw`) together with the node-side combination of
//   `_stats_bwd`, which the JAX package runs in XLA before the kernel.
// Contract: (m - mean) is formed per edge (never distributed into A + B m,
//   which would break the exact cancellation at degree-1 nodes); every
//   operation rounds as the plain PyTorch twin does (explicit _rn
//   intrinsics, no FMA contraction).  The column sums have one fixed order,
//   independent of the grid and of the vector width: each node's edges in
//   slot order, the nodes of a tile (TN nodes) in node order, the tiles of a
//   chunk (CH tiles) in tile order, the chunks in chunk order, each level
//   starting from 0.  No atomics on the values.
// Bound on the card: device-memory bytes, each counted once: the real x
//   rows, the d_x rows (padding included), seven [N, D] bf16 node arrays
//   (mean, std, enc, d_mean, d_std, d_max, d_min), row_ptr and the affine;
//   at the bench shapes (N = 9216, E = 18432 with 18180 real, D = 200)
//   ~40.5 MB, 0.0121 ms at 3.35 TB/s, against ~20 flops per element.
// Design: the node tiles of common.cuh (TileRing), as pna_stats.cu: a
//   block of 256 threads owns a run of tiles of TN nodes, the grid is one
//   wave of runs (SMs x resident blocks: at most 128 registers a thread
//   and ~104 KB of shared memory a block at the bench shapes, so 2 blocks
//   per SM, 231 blocks of 4 tiles), the run's row_ptr slice is read once,
//   and each tile arrives in a shared-memory slot by cp.async (two slots:
//   the next tile is in flight while this one is reduced): its x rows
//   and its rows of the node arrays (mean, std, enc and the cotangents
//   present).  One thread per (node, 16-byte column vector) forms A and B
//   in registers from its node's operands and walks the node's edges: no
//   receiver or slot array is read and no node row is fetched again per
//   edge (the edge-major kernel before it loaded six node rows per edge
//   and ran 1.09 waves of work in two).  With the affine, each thread keeps
//   its node's column sums in registers; the block adds its tile's nodes
//   in order through shared memory and stores the tile's partial.  After
//   its run the block fences once and counts its tiles into a device
//   counter per chunk (CH tiles); the block that completes a chunk adds
//   the chunk's tile partials in order, and the block that completes the
//   last chunk (one more counter) adds the chunk partials in order into
//   d_a, d_b.  Each of those two sums first copies its partials into the
//   block's shared memory (free after the walk) with one cp.async.cg copy,
//   so it waits for one trip to L2, not one per partial.  Each counter is
//   reset by the block that read it last, so the next launch finds it at
//   0.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr float SQRT_EPS = 0x1.9e7c6ep-9f;   // sqrtf(1e-5f), as jnp.sqrt

struct Cotangents {
  const __nv_bfloat16 *sum, *mean, *std_, *max, *min;
};

// index of each node array in a tile slot: mean, std, enc, then the
// cotangents that are present, in the order sum, mean, std, max, min
enum { MEAN, STD, ENC, COT0 };
// the ring's slots take up to this many bytes of shared memory per block
constexpr int RING_BUDGET = 96 * 1024;

// out[c] = sum over r = 0 .. rows - 1, in order and from 0, of
// src[r * cols + c]: partials that other blocks stored (read past L1).
// They are staged in shared memory (`smem`, `smem_bytes` free) with one
// cp.async.cg copy when they fit and their rows are whole 16-byte pieces,
// so the block waits for one trip to L2 instead of one per row.
__device__ void column_sums(const float* src, int rows, int cols,
                            float* out, char* smem, int smem_bytes) {
  const int bytes = rows * cols * 4;
  if (bytes <= smem_bytes && (cols * 4) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    __syncthreads();                         // smem is free
    copy_block<16>(smem, reinterpret_cast<const char*>(src), bytes);
    copy_commit();
    copy_wait(0);
    __syncthreads();
    const float* st = reinterpret_cast<const float*>(smem);
    for (int c = threadIdx.x; c < cols; c += blockDim.x) {
      float v = 0.f;
      int r = 0;
      for (; r + 4 <= rows; r += 4) {        // 4 reads in flight, in order
        float q[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) q[k] = st[(r + k) * cols + c];
#pragma unroll
        for (int k = 0; k < 4; ++k) v = __fadd_rn(v, q[k]);
      }
      for (; r < rows; ++r) v = __fadd_rn(v, st[r * cols + c]);
      out[c] = v;
    }
    return;
  }
  for (int c = threadIdx.x; c < cols; c += blockDim.x)
    out[c] = ordered_sum(src + c, cols, 0, rows);
}

template <int VEC, int CPW>
__global__ void __launch_bounds__(THREADS, 2)
pna_stats_bwd_kernel(const __nv_bfloat16* __restrict__ x,
                     const int* __restrict__ row_ptr,
                     const __nv_bfloat16* __restrict__ mean_p,
                     const __nv_bfloat16* __restrict__ std_p,
                     const __nv_bfloat16* __restrict__ enc_p, Cotangents ct,
                     const float* __restrict__ aff_a,
                     const float* __restrict__ aff_b,
                     __nv_bfloat16* __restrict__ dx, float* __restrict__ dab,
                     float* __restrict__ tile_part,
                     float* __restrict__ chunk_part,
                     unsigned* __restrict__ counters, TileShape shape, int E,
                     int D, int CH, int smem_bytes) {
  extern __shared__ __align__(16) char smem[];
  __shared__ bool s_last;
  using bf = __nv_bfloat16;
  const int nvec = D / VEC;
  TileRing ring(shape, reinterpret_cast<const char*>(x), row_ptr, smem);
  const bf* cots[5] = {ct.sum, ct.mean, ct.std_, ct.max, ct.min};
  int at[5];                                   // slot array of each, or -1
  int narr = COT0;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    at[k] = cots[k] != nullptr ? narr : -1;
    narr += cots[k] != nullptr;
  }
  ring.arrays[MEAN] = reinterpret_cast<const char*>(mean_p);
  ring.arrays[STD] = reinterpret_cast<const char*>(std_p);
  ring.arrays[ENC] = reinterpret_cast<const char*>(enc_p);
#pragma unroll
  for (int j = COT0; j < RING_MAX_ARRAYS; ++j) {   // constant indices
    const bf* pick = nullptr;
#pragma unroll
    for (int k = 0; k < 5; ++k)
      if (at[k] == j) pick = cots[k];
    ring.arrays[j] = reinterpret_cast<const char*>(pick);
  }
  const bool has_aff = aff_a != nullptr;
  const bool has_A = at[0] >= 0 || at[1] >= 0;
  const int tiles = shape.tiles();
  float* node_part = reinterpret_cast<float*>(ring.extra());   // [TN, 2D]

  ring.walk<CPW>([&](int t, int s) {
    const int n0 = ring.first_node(t);
    const int tn = ring.end_node(t) - n0;
    for (int item = threadIdx.x; item < tn * nvec; item += THREADS) {
      const int nl = item / nvec;
      const int c = (item - nl * nvec) * VEC;
      const int start = ring.rp(n0 + nl);
      const int deg = ring.rp(n0 + nl + 1) - start;
      float v[VEC], mean[VEC], amax[VEC], amin[VEC], A[VEC], B[VEC];
      float dmx[VEC], dmn[VEC];
      load_vec<bf, VEC>(ring.array_at<bf>(s, MEAN, nl, c), mean);
      load_vec<bf, VEC>(ring.array_at<bf>(s, ENC, nl, c), v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {          // the winner slots
        amin[k] = floorf(__fmul_rn(v[k], 0.0625f));
        amax[k] = __fsub_rn(v[k], __fmul_rn(16.f, amin[k]));
      }
      if (at[3] >= 0)
        load_vec<bf, VEC>(ring.array_at<bf>(s, at[3], nl, c), dmx);
      if (at[4] >= 0)
        load_vec<bf, VEC>(ring.array_at<bf>(s, at[4], nl, c), dmn);
      float a[VEC], b[VEC], pa[VEC], pb[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        a[k] = has_aff ? __ldg(aff_a + c + k) : 1.f;
        b[k] = has_aff ? __ldg(aff_b + c + k) : 0.f;
        pa[k] = 0.f;
        pb[k] = 0.f;
        A[k] = 0.f;
      }
      const float inv = __fdiv_rn(1.f, fmaxf(static_cast<float>(deg), 1.f));
      if (at[1] >= 0) {                        // d_mean / deg
        load_vec<bf, VEC>(ring.array_at<bf>(s, at[1], nl, c), v);
#pragma unroll
        for (int k = 0; k < VEC; ++k) A[k] = __fmul_rn(v[k], inv);
      }
      if (at[0] >= 0) {                        // d_sum + ...
        load_vec<bf, VEC>(ring.array_at<bf>(s, at[0], nl, c), v);
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          A[k] = at[1] >= 0 ? __fadd_rn(v[k], A[k]) : v[k];
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) A[k] = round_bf16(A[k]);
      if (at[2] >= 0) {                        // d_std / deg / max(std, ..)
        float sd[VEC];
        load_vec<bf, VEC>(ring.array_at<bf>(s, at[2], nl, c), v);
        load_vec<bf, VEC>(ring.array_at<bf>(s, STD, nl, c), sd);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float ss = sd[k] < SQRT_EPS ? SQRT_EPS : sd[k];
          B[k] = round_bf16(__fdiv_rn(__fmul_rn(v[k], inv), ss));
        }
      }
      for (int slot = 0; slot < deg; ++slot) {
        const int e = start + slot;
        float xv[VEC], d[VEC];
        load_vec<bf, VEC>(ring.row_at<bf>(t, s, e, c), xv);
        const float p = static_cast<float>(slot);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float m =
              has_aff ? round_bf16(__fadd_rn(__fmul_rn(xv[k], a[k]), b[k]))
                      : xv[k];
          float dk = has_A ? A[k] : 0.f;
          if (at[2] >= 0)
            dk = __fadd_rn(dk, __fmul_rn(B[k], __fsub_rn(m, mean[k])));
          if (at[3] >= 0)
            dk = __fadd_rn(dk, __fmul_rn(dmx[k], p == amax[k] ? 1.f : 0.f));
          if (at[4] >= 0)
            dk = __fadd_rn(dk, __fmul_rn(dmn[k], p == amin[k] ? 1.f : 0.f));
          if (has_aff) {
            pa[k] = __fadd_rn(pa[k], __fmul_rn(dk, xv[k]));
            pb[k] = __fadd_rn(pb[k], dk);
            dk = __fmul_rn(dk, a[k]);
          }
          d[k] = dk;
        }
        store_vec<bf, VEC>(dx + static_cast<int64_t>(e) * D + c, d);
      }
      if (has_aff) {                         // vector stores: few bank trips
        store_vec<float, VEC>(node_part + nl * 2 * D + c, pa);
        store_vec<float, VEC>(node_part + nl * 2 * D + D + c, pb);
      }
    }
    if (!has_aff) return;                     // uniform over the block
    // the tile's partial: its nodes in node order
    __syncthreads();
    float* tp = tile_part + static_cast<int64_t>(t) * 2 * D;
    for (int col = threadIdx.x; col < 2 * D; col += THREADS) {
      float v = 0.f;
      int nl = 0;
      for (; nl + 4 <= tn; nl += 4) {          // 4 reads in flight, in order
        float q[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) q[k] = node_part[(nl + k) * 2 * D + col];
#pragma unroll
        for (int k = 0; k < 4; ++k) v = __fadd_rn(v, q[k]);
      }
      for (; nl < tn; ++nl) v = __fadd_rn(v, node_part[nl * 2 * D + col]);
      tp[col] = v;
    }
  });

  // padding edges: d_x = 0
  const int64_t pad0 = static_cast<int64_t>(row_ptr[shape.N]) * nvec;
  const int64_t pad1 = static_cast<int64_t>(E) * nvec;
  float zero[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) zero[k] = 0.f;
  for (int64_t i = pad0 + static_cast<int64_t>(blockIdx.x) * THREADS +
                   threadIdx.x;
       i < pad1; i += static_cast<int64_t>(gridDim.x) * THREADS)
    store_vec<bf, VEC>(dx + i * VEC, zero);
  if (!has_aff) return;
  if (tiles == 0) {                          // no node at all: sums are 0
    if (blockIdx.x == 0)
      for (int col = threadIdx.x; col < 2 * D; col += THREADS) dab[col] = 0.f;
    return;
  }

  // the column sums: this run's tile partials are stored; count them into
  // their chunks, once per block
  const int chunks = (tiles + CH - 1) / CH;
  __threadfence();
  __syncthreads();
  for (int chunk = ring.t0 / CH; chunk * CH < ring.t1; ++chunk) {
    const int c0 = chunk * CH, c1 = min(c0 + CH, tiles);
    __syncthreads();                         // s_last has been read
    if (threadIdx.x == 0) {
      const unsigned mine = min(c1, ring.t1) - max(c0, ring.t0);
      s_last = atomicAdd(counters + chunk, mine) + mine == c1 - c0;
    }
    __syncthreads();
    if (!s_last) continue;                   // uniform over the block
    // this block completed the chunk: its tiles' partials in tile order
    __threadfence();
    if (threadIdx.x == 0) counters[chunk] = 0;
    column_sums(tile_part + static_cast<int64_t>(c0) * 2 * D, c1 - c0, 2 * D,
                chunk_part + static_cast<int64_t>(chunk) * 2 * D, smem,
                smem_bytes);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      s_last = atomicAdd(counters + chunks, 1u) == chunks - 1u;
    __syncthreads();
    if (!s_last) continue;
    // ... and the last chunk: the chunks' partials in chunk order
    __threadfence();
    if (threadIdx.x == 0) counters[chunks] = 0;
    column_sums(chunk_part, chunks, 2 * D, dab, smem, smem_bytes);
  }
}

template <int VEC, int CPW>
cudaError_t launch(const __nv_bfloat16* x, const int* rp,
                   const __nv_bfloat16* mean, const __nv_bfloat16* sd,
                   const __nv_bfloat16* enc, Cotangents ct, const float* a,
                   const float* b, __nv_bfloat16* dx, float* dab, float* tp,
                   float* cp, unsigned* cnt, int N, int E, int D, int K,
                   int TN, int CH, cudaStream_t st) {
  const int present = (ct.sum != nullptr) + (ct.mean != nullptr) +
                      (ct.std_ != nullptr) + (ct.max != nullptr) +
                      (ct.min != nullptr);
  TileShape shape{N, TN, D * 2, TN * K, COT0 + present, 2, 1};
  shape.nslots = ring_slots(shape.slot_bytes(), RING_BUDGET);
  int grid = 0, smem = 0;
  const cudaError_t err =
      tile_launch(pna_stats_bwd_kernel<VEC, CPW>, THREADS,
                  a != nullptr ? TN * 2 * D * 4 : 0, &shape, &grid, &smem);
  if (err != cudaSuccess) return err;
  pna_stats_bwd_kernel<VEC, CPW><<<grid, THREADS, smem, st>>>(
      x, rp, mean, sd, enc, ct, a, b, dx, dab, tp, cp, cnt, shape, E, D, CH,
      smem);
  return cudaGetLastError();
}

}  // namespace

// x [E, D] bf16 (pre-affine with an affine), row_ptr [N + 1] int32, mean,
// std, enc [N, D] bf16 (the forward's residuals), d_sum, d_mean, d_std,
// d_max, d_min [N, D] bf16 or null, aff_a / aff_b [D] float32 (both or
// neither null), dx [E, D] bf16; with the affine, dab [2, D] float32 out,
// tile_part [tiles, 2, D] and chunk_part [chunks, 2, D] float32 scratch and
// counters [chunks + 1] unsigned, zero before the launch and after it.
// TN nodes per tile (K = the batch's largest in-degree sizes the ring's
// slots), CH tiles per chunk.
PORT_API cudaError_t pna_stats_bwd_bf16(
    const void* x, const void* row_ptr, const void* mean, const void* std_,
    const void* enc, const void* d_sum, const void* d_mean,
    const void* d_std, const void* d_max, const void* d_min,
    const void* aff_a, const void* aff_b, void* dx, void* dab,
    void* tile_part, void* chunk_part, void* counters, int N, int E, int D,
    int K, int TN, int CH, void* stream) {
  if (D <= 0) return cudaSuccess;
  if (N < 0 || E < 0 || TN < 1 || K < 1 || CH < 1)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  const Cotangents ct{static_cast<const bf*>(d_sum),
                      static_cast<const bf*>(d_mean),
                      static_cast<const bf*>(d_std),
                      static_cast<const bf*>(d_max),
                      static_cast<const bf*>(d_min)};
  const void* ptrs[10] = {x, mean, std_, enc, d_sum, d_mean, d_std, d_max,
                          d_min, dx};
  const auto* xb = static_cast<const bf*>(x);
  const auto* rp = static_cast<const int*>(row_ptr);
  const auto* mn = static_cast<const bf*>(mean);
  const auto* sd = static_cast<const bf*>(std_);
  const auto* en = static_cast<const bf*>(enc);
  const auto* a = static_cast<const float*>(aff_a);
  const auto* b = static_cast<const float*>(aff_b);
  auto* o = static_cast<bf*>(dx);
  auto* ab = static_cast<float*>(dab);
  auto* tp = static_cast<float*>(tile_part);
  auto* cp = static_cast<float*>(chunk_part);
  auto* cnt = static_cast<unsigned*>(counters);
  switch (vec_width<bf>(D, ptrs, 10)) {
    case 8:
      return launch<8, 16>(xb, rp, mn, sd, en, ct, a, b, o, ab, tp, cp, cnt,
                           N, E, D, K, TN, CH, st);
    case 4:
      return launch<4, 8>(xb, rp, mn, sd, en, ct, a, b, o, ab, tp, cp, cnt, N,
                          E, D, K, TN, CH, st);
    default:
      if (D % 2 == 0 && aligned4(ptrs, 9))
        return launch<1, 4>(xb, rp, mn, sd, en, ct, a, b, o, ab, tp, cp, cnt,
                            N, E, D, K, TN, CH, st);
      return launch<1, 2>(xb, rp, mn, sd, en, ct, a, b, o, ab, tp, cp, cnt, N,
                          E, D, K, TN, CH, st);
  }
}
