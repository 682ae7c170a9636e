// Pair segment sum, the backward of the fused edge combine: per node n,
//   d_hd[n] = sum of ct[e] over its CSR (receiver-sorted) range
//             e in [row_ptr[n], row_ptr[n+1])
//   d_hs[n] = sum of ct[csc_perm[j]] over its CSC (sender-sorted) range
//             j in [csc_row_ptr[n], csc_row_ptr[n+1])
//
// Replaces: the Pallas kernel `_snd_seg_sum_kernel` through
//   `_snd_kernel_pair` of infomax3d_tpu/ops/pallas/spmm.py:1006 (wrapper
//   `pair_segment_sum_bf16`, :1079), the combine backward of every PNA
//   layer and of the flat Net3D's message MLP.
// Contract: each sum is accumulated in float32 in range order (slot 0
//   first) and rounded to the output type once.  Padding edges (receiver or
//   sender N) lie past row_ptr[N] / csc_row_ptr[N] and contribute nothing.
//   Ids are int32, so there is no bound on N (the TPU kernel packed sender
//   ids into two bf16 lanes, which held only below 2^15 nodes).
// Bound on the card: device-memory bytes.  Counted once, it reads every
//   real ct row, both range arrays and csc_perm, and writes two [N, D]
//   arrays, one add per ct element and half: 14.8 MB at the bench shape
//   (E = 18432, N = 9216, D = 200, bf16), 149.1 MB at the multi-conformer
//   shape (QMugs, C = 3: E = 3.25 M, N = 67328, D = 20, bf16, 40-byte
//   rows).  The sender half reads ct a second time through csc_perm.  At
//   the multi-conformer shape ct (130 MB) is 2.6x the 50 MB L2 and every
//   conformer's edge block is in flight at once, so that second read comes
//   from device memory: read twice, the shape moves 279.2 MB, 0.0834 ms at
//   3.35 TB/s.
// Design: one thread per (node, column vector), the vector the widest
//   word a row is made of (`vec_width`: 16 bytes at the bench shape,
//   8 bytes at 40-byte rows, i.e. 5 threads a node at D = 20 in bf16, else
//   one element).  Each thread loads both ranges at once, then:
//   - at 16-byte vectors it walks the receiver range with `walk_rows`
//     (common.cuh; U = WALK_UNROLL rows in flight before the adds in slot
//     order), stores d_hd, then walks the sender range the same way
//     through csc_perm (the chunk's U positions, then its U rows);
//   - at narrower vectors it walks both ranges together (`walk_pair`
//     below), U = PAIR_UNROLL slots of each per chunk with the next
//     chunk's positions loaded beside the rows: one round trip per chunk of
//     the longer range, where one walk after the other waits
//     ceil(cnt_r / U) + 2 ceil(cnt_s / U).  A node of the multi-conformer
//     batch has ~46 slots per range, so the two walks one after the other
//     waited ~36 round trips with 32 bytes in flight; the paired chunk has
//     16 rows of 8 bytes (128 bytes) in flight and waits ~7.  At 16-byte
//     vectors the paired chunk doubles the registers (fewer resident
//     blocks) and lost at the bench shape, where every range is one chunk.
//   A warp covers consecutive nodes, the atoms of one molecule: its
//   receiver loads read the rows of neighbouring ranges, its sender loads
//   neighbouring rows (the edges that neighbouring senders send to one
//   receiver lie side by side in CSR order).  Each output element has one
//   owner: no atomics, deterministic results.  Blocks of WALK_THREADS;
//   32-bit index arithmetic where max(N, E) * D < 2^31 (`walk_wide`), else
//   (or when the caller forces it) 64-bit.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; tools/torch_kernel_ab.py,
//   cold L2; PERF.md §6, row 5): at the QMugs conformer shape the first
//   design (one slot at a time, each csc_perm load then its row, 2-byte
//   loads at 40-byte rows) took 0.162 ms (27 % of the bound); the two walks
//   one after the other at 8-byte vectors 0.125 ms; paired at U = 4 0.103
//   ms, at U = 8 0.092 ms (48 %; 90 % of the read-twice time): the sender
//   half's second read of ct from device memory holds it there.  U = 16
//   (80 registers, half the resident blocks) and capping the resident
//   blocks so that the in-flight edge blocks fit L2 (shared memory taken
//   to cap them comes out of L1) were slower in exploratory runs.  At the
//   bench shape 0.0117 ms against the first design's 0.0131.
#include "common.cuh"

namespace {

// The slots per chunk of the paired walk (see the note above).
constexpr int PAIR_UNROLL = 8;

// The two halves of node n at column c walked together, U slots of each
// at a time: chunk k issues the U receiver rows r0 + kU + u, the U sender
// rows through the positions q[u] = perm[s0 + kU + u] loaded by chunk
// k - 1, and the U positions of chunk k + 1, all before its adds; then
// each half adds its chunk's rows in slot order.  So a thread waits one
// round trip per chunk of the longer half (plus one for the first
// positions), where two walks one after the other wait ceil(cnt_r / U) +
// 2 ceil(cnt_s / U).  Slots past a half's count load its last row again
// (row 0 of ct for an empty half, valid since the other half has rows)
// and come with valid false, as in `walk_rows`; add_r / add_s add 0 for
// them, which leaves a sum bit for bit as it was.
template <typename T, int VEC, int U, typename Idx, typename AddR,
          typename AddS>
__device__ __forceinline__ void walk_pair(const T* __restrict__ ct, int D,
                                          int c, const int* __restrict__ perm,
                                          int r0, int cnt_r, int s0,
                                          int cnt_s, AddR&& add_r,
                                          AddS&& add_s) {
  const T* base = ct + c;
  auto position = [&](int s) {
    return cnt_s > 0 ? perm[s0 + min(s, cnt_s - 1)] : 0;
  };
  int q[U];
#pragma unroll
  for (int u = 0; u < U; ++u) q[u] = position(u);
  auto chunk = [&](int k0) {
    float vr[U][VEC], vs[U][VEC];
    int qn[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = cnt_r > 0 ? r0 + min(k0 + u, cnt_r - 1) : 0;
      load_vec<T, VEC>(base + static_cast<Idx>(r) * D, vr[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      load_vec<T, VEC>(base + static_cast<Idx>(q[u]) * D, vs[u]);
      qn[u] = position(k0 + U + u);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) add_r(vr[u], k0 + u < cnt_r);
#pragma unroll
    for (int u = 0; u < U; ++u) add_s(vs[u], k0 + u < cnt_s);
#pragma unroll
    for (int u = 0; u < U; ++u) q[u] = qn[u];
  };
  const int longer = max(cnt_r, cnt_s);
  if (longer > 0) chunk(0);
#pragma unroll 1
  for (int k0 = U; k0 < longer; k0 += U) chunk(k0);
}

template <typename T, int VEC, typename Idx>
__global__ void __launch_bounds__(WALK_THREADS)
pair_segment_sum_kernel(const T* __restrict__ ct,
                        const int* __restrict__ row_ptr,
                        const int* __restrict__ csc_row_ptr,
                        const int* __restrict__ csc_perm,
                        T* __restrict__ d_hd, T* __restrict__ d_hs, int N,
                        int D) {
  int n, c;
  if (!node_column<Idx, VEC>(N, D, n, c)) return;
  const int r0 = row_ptr[n], r1 = row_ptr[n + 1];
  const int s0 = csc_row_ptr[n], s1 = csc_row_ptr[n + 1];
  const Idx out = static_cast<Idx>(n) * D + c;
  float acc_r[VEC], acc_s[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc_r[k] = acc_s[k] = 0.f;
  auto add_r = [&](const float (&v)[VEC], bool valid) {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      acc_r[k] = __fadd_rn(acc_r[k], valid ? v[k] : 0.f);   // + 0: exact
  };
  auto add_s = [&](const float (&v)[VEC], bool valid) {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      acc_s[k] = __fadd_rn(acc_s[k], valid ? v[k] : 0.f);
  };
  if constexpr (VEC * sizeof(T) < 16) {
    walk_pair<T, VEC, PAIR_UNROLL, Idx>(ct, D, c, csc_perm, r0, r1 - r0, s0,
                                        s1 - s0, add_r, add_s);
    store_vec<T, VEC>(d_hd + out, acc_r);
  } else {
    walk_rows<T, VEC, WALK_UNROLL, false, Idx>(ct, D, c, nullptr, r0,
                                               r1 - r0, add_r);
    store_vec<T, VEC>(d_hd + out, acc_r);
    walk_rows<T, VEC, WALK_UNROLL, true, Idx>(ct, D, c, csc_perm, s0,
                                              s1 - s0, add_s);
  }
  store_vec<T, VEC>(d_hs + out, acc_s);
}

template <typename T, int VEC>
void launch_width(const T* c, const int* rp, const int* crp, const int* perm,
                  T* hd, T* hs, int N, int D, bool wide, cudaStream_t st) {
  const dim3 grid(walk_blocks(static_cast<int64_t>(N) * (D / VEC)));
  if (wide) {
    pair_segment_sum_kernel<T, VEC, int64_t>
        <<<grid, WALK_THREADS, 0, st>>>(c, rp, crp, perm, hd, hs, N, D);
  } else {
    pair_segment_sum_kernel<T, VEC, uint32_t>
        <<<grid, WALK_THREADS, 0, st>>>(c, rp, crp, perm, hd, hs, N, D);
  }
}

template <typename T>
cudaError_t launch(const void* ct, const void* row_ptr,
                   const void* csc_row_ptr, const void* csc_perm, void* d_hd,
                   void* d_hs, int N, int E, int D, int force_wide,
                   void* stream) {
  if (N <= 0 || D <= 0) return cudaSuccess;
  const bool wide = walk_wide(N, E, D, force_wide);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const T*>(ct);
  const auto* rp = static_cast<const int*>(row_ptr);
  const auto* crp = static_cast<const int*>(csc_row_ptr);
  const auto* perm = static_cast<const int*>(csc_perm);
  auto* hd = static_cast<T*>(d_hd);
  auto* hs = static_cast<T*>(d_hs);
  const void* ptrs[3] = {ct, d_hd, d_hs};
  constexpr int V16 = 16 / sizeof(T), V8 = 8 / sizeof(T);
  const int vec = vec_width<T>(D, ptrs, 3);
  if (vec == V16) {
    launch_width<T, V16>(c, rp, crp, perm, hd, hs, N, D, wide, st);
  } else if (vec == V8) {
    launch_width<T, V8>(c, rp, crp, perm, hd, hs, N, D, wide, st);
  } else {
    launch_width<T, 1>(c, rp, crp, perm, hd, hs, N, D, wide, st);
  }
  return cudaGetLastError();
}

}  // namespace

// ct [E, D], row_ptr / csc_row_ptr [N + 1] int32, csc_perm [E] int32,
// d_hd / d_hs [N, D] of ct's type; wide != 0 forces 64-bit index
// arithmetic.
PORT_API cudaError_t pair_segment_sum_bf16(const void* ct, const void* row_ptr,
                                           const void* csc_row_ptr,
                                           const void* csc_perm, void* d_hd,
                                           void* d_hs, int N, int E, int D,
                                           int wide, void* stream) {
  return launch<__nv_bfloat16>(ct, row_ptr, csc_row_ptr, csc_perm, d_hd, d_hs,
                               N, E, D, wide, stream);
}

PORT_API cudaError_t pair_segment_sum_f32(const void* ct, const void* row_ptr,
                                          const void* csc_row_ptr,
                                          const void* csc_perm, void* d_hd,
                                          void* d_hs, int N, int E, int D,
                                          int wide, void* stream) {
  return launch<float>(ct, row_ptr, csc_row_ptr, csc_perm, d_hd, d_hs, N, E,
                       D, wide, stream);
}
