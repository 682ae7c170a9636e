// Fused PNA statistics over a receiver-sorted CSR batch, in bf16.
//
// Replaces: the Pallas kernels `_stats_kernel` and `_stats_kernel_aff` of
//   infomax3d_tpu/ops/pallas/spmm.py (wrapper `_csr_stats_raw`), the
//   aggregation of every PNA layer on the bf16 path.  The affine (a, b),
//   optional, is the pretrans last BatchNorm folded in as a column affine.
// Contract, per node n and column j, over the first min(deg, K) edges of its
//   CSR range [row_ptr[n], row_ptr[n+1]) in order:
//     m    = bf16(x * a[j] + b[j])  with the affine, else x   (f32 math)
//     sum  = sum m,  sumsq = sum m*m                      (f32, in order)
//     mean = sum / max(deg, 1)
//     std  = sqrt(relu(sumsq / max(deg, 1) - mean^2) + 1e-5)
//     max, min with a strict > / <, so the first winner's slot is kept
//     enc  = amax + 16 * amin        (exact in bf16 for K <= 16)
//   written as bf16 sections [sum,] mean, std, max, min, enc of an
//   [nsec, N, D] output; mean, std, max and min are 0 where deg == 0 (this
//   includes every padding node: their ranges are empty).
// Bound on the card: device-memory bytes.  It reads each real message row
//   once (E * D * 2 bytes) and writes 5 or 6 [N, D] bf16 sections; at the
//   bench shapes (N = 9216, 18180 real edges, D = 200) 7.3 MB in and 18.4 MB
//   out against ~10 flops per message element: 25.7 MB, 0.0077 ms at
//   3.35 TB/s.
// Design: the node tiles of common.cuh (TileRing).  A block owns a run of
//   tiles of TN nodes (TN = 256 / ceil(D / 8), chosen by the wrapper: 10
//   nodes at D = 200), the grid is one wave of runs (SMs x resident
//   blocks), and the block reads its run's row_ptr slice into shared memory
//   once.  Then it keeps up to three tiles' contiguous edge rows in flight
//   into a ring of shared-memory slots with cp.async while it reduces the
//   tile that has landed: at the bench shapes a run is 4 tiles, so after
//   two trips to device memory (the slice, then the rows) every byte the
//   block reads is in flight at once, where a thread that walked its own
//   node's rows waited on row_ptr and then on each row in turn.  One thread
//   per (node, 8-byte column vector) reduces its rows from shared memory in
//   slot order, keeps the statistics in registers and stores each section
//   as one 8-byte vector.  One owner per output, no atomics, deterministic.
//   The kernel is bound by issued instructions more than by bytes (per
//   element an affine, two sums, two extrema, two divisions and a square
//   root, all IEEE-rounded): 8-byte vectors hold it to 64 registers, so 4
//   blocks (32 warps) fit an SM where 16-byte ones (106 registers) fit 2,
//   and a division by a power-of-two degree is an exact multiplication.
//   Rows of 16-byte vectors are copied in 16-byte pieces; rows that are not
//   (D = 300, D = 50) in 8- or 4-byte ones (2-byte plain copies for an odd
//   D), with single elements per thread where a row is not whole 8-byte
//   vectors.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr float NEG_BIG = -3.0e38f;
constexpr float POS_BIG = 3.0e38f;
constexpr float EPS = 1e-5f;
// the ring's slots take up to this many bytes of shared memory per block
constexpr int RING_BUDGET = 48 * 1024;

// x / d for d = max(deg, 1): where d is a power of two (most molecular
// nodes) the product with its exact reciprocal, which rounds as the
// division does; else the IEEE division
__device__ __forceinline__ float div_deg(float x, float d, bool pow2,
                                         float inv) {
  return pow2 ? __fmul_rn(x, inv) : __fdiv_rn(x, d);
}

template <int VEC, int CPW>
__global__ void __launch_bounds__(THREADS, 4)
pna_stats_kernel(const __nv_bfloat16* __restrict__ msg,
                 const int* __restrict__ row_ptr,
                 const float* __restrict__ aff_a,
                 const float* __restrict__ aff_b,
                 __nv_bfloat16* __restrict__ out, TileShape shape, int D,
                 int K, int want_sum) {
  extern __shared__ __align__(16) char smem[];
  const int nvec = D / VEC;
  const TileRing ring(shape, reinterpret_cast<const char*>(msg), row_ptr,
                      smem);
  const bool has_aff = aff_a != nullptr;
  const int64_t sec = static_cast<int64_t>(shape.N) * D;

  ring.walk<CPW>([&](int t, int s) {
    const int n0 = ring.first_node(t);
    const int items = (ring.end_node(t) - n0) * nvec;
    for (int item = threadIdx.x; item < items; item += THREADS) {
      const int nl = item / nvec;
      const int c = (item - nl * nvec) * VEC;
      const int start = ring.rp(n0 + nl);
      const int deg = ring.rp(n0 + nl + 1) - start;
      const int cnt = min(deg, K);
      float a[VEC], b[VEC];
      if (has_aff) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          a[k] = __ldg(aff_a + c + k);
          b[k] = __ldg(aff_b + c + k);
        }
      }
      float s1[VEC], s2[VEC], mx[VEC], mn[VEC], amax[VEC], amin[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        s1[k] = 0.f;
        s2[k] = 0.f;
        mx[k] = NEG_BIG;
        mn[k] = POS_BIG;
        amax[k] = 0.f;
        amin[k] = 0.f;
      }
      for (int slot = 0; slot < cnt; ++slot) {
        float m[VEC];
        load_vec<__nv_bfloat16, VEC>(
            ring.row_at<__nv_bfloat16>(t, s, start + slot, c), m);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          if (has_aff)
            m[k] = round_bf16(__fadd_rn(__fmul_rn(m[k], a[k]), b[k]));
          s1[k] = __fadd_rn(s1[k], m[k]);
          s2[k] = __fadd_rn(s2[k], __fmul_rn(m[k], m[k]));
          if (m[k] > mx[k]) {
            mx[k] = m[k];
            amax[k] = static_cast<float>(slot);
          }
          if (m[k] < mn[k]) {
            mn[k] = m[k];
            amin[k] = static_cast<float>(slot);
          }
        }
      }
      const float dsafe = fmaxf(static_cast<float>(deg), 1.f);
      const bool has = deg > 0;
      const bool pow2 = (deg & (deg - 1)) == 0;
      const float inv = pow2 ? __frcp_rn(dsafe) : 0.f;   // exact for 2^k
      float mean[VEC], stdv[VEC], enc[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float mu = div_deg(s1[k], dsafe, pow2, inv);
        const float var = fmaxf(
            __fsub_rn(div_deg(s2[k], dsafe, pow2, inv), __fmul_rn(mu, mu)),
            0.f);
        mean[k] = has ? mu : 0.f;
        stdv[k] = has ? __fsqrt_rn(__fadd_rn(var, EPS)) : 0.f;
        mx[k] = has ? mx[k] : 0.f;
        mn[k] = has ? mn[k] : 0.f;
        enc[k] = __fadd_rn(amax[k], __fmul_rn(16.f, amin[k]));
      }
      __nv_bfloat16* o = out + static_cast<int64_t>(n0 + nl) * D + c;
      if (want_sum) {
        store_vec<__nv_bfloat16, VEC>(o, s1);
        o += sec;
      }
      store_vec<__nv_bfloat16, VEC>(o, mean);
      store_vec<__nv_bfloat16, VEC>(o + sec, stdv);
      store_vec<__nv_bfloat16, VEC>(o + 2 * sec, mx);
      store_vec<__nv_bfloat16, VEC>(o + 3 * sec, mn);
      store_vec<__nv_bfloat16, VEC>(o + 4 * sec, enc);
    }
  });
}

template <int VEC, int CPW>
cudaError_t launch(const __nv_bfloat16* m, const int* rp, const float* a,
                   const float* b, __nv_bfloat16* o, int N, int D, int K,
                   int want_sum, int TN, cudaStream_t st) {
  TileShape shape{N, TN, D * 2, TN * K, 0, 2, 1};
  shape.nslots = ring_slots(shape.slot_bytes(), RING_BUDGET);
  int grid = 0, smem = 0;
  const cudaError_t err = tile_launch(pna_stats_kernel<VEC, CPW>, THREADS, 0,
                                      &shape, &grid, &smem);
  if (err != cudaSuccess) return err;
  pna_stats_kernel<VEC, CPW><<<grid, THREADS, smem, st>>>(
      m, rp, a, b, o, shape, D, K, want_sum);
  return cudaGetLastError();
}

}  // namespace

// msg [E, D] bf16, row_ptr [N + 1] int32, aff_a / aff_b [D] float32 (both
// or neither null), out [5 + want_sum, N, D] bf16; TN nodes per tile.
PORT_API cudaError_t pna_stats_bf16(const void* msg, const void* row_ptr,
                                    const void* aff_a, const void* aff_b,
                                    void* out, int N, int D, int K,
                                    int want_sum, int TN, void* stream) {
  if (N <= 0 || D <= 0) return cudaSuccess;
  if (TN < 1 || K < 1) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const void* ptrs[2] = {msg, out};
  const auto* m = static_cast<const __nv_bfloat16*>(msg);
  const auto* rp = static_cast<const int*>(row_ptr);
  const auto* a = static_cast<const float*>(aff_a);
  const auto* b = static_cast<const float*>(aff_b);
  auto* o = static_cast<__nv_bfloat16*>(out);
  switch (vec_width<__nv_bfloat16>(D, ptrs, 2)) {
    case 8:   // 16-byte rows: 16-byte copies, 8-byte vectors per thread
      return launch<4, 16>(m, rp, a, b, o, N, D, K, want_sum, TN, st);
    case 4:
      return launch<4, 8>(m, rp, a, b, o, N, D, K, want_sum, TN, st);
    default:
      if (D % 2 == 0 && aligned4(ptrs, 1))
        return launch<1, 4>(m, rp, a, b, o, N, D, K, want_sum, TN, st);
      return launch<1, 2>(m, rp, a, b, o, N, D, K, want_sum, TN, st);
  }
}
