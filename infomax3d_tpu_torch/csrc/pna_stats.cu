// Fused PNA statistics over a receiver-sorted CSR batch, in bf16.
//
// Replaces: the Pallas kernels `_stats_kernel` and `_stats_kernel_aff` of
//   infomax3d_tpu/ops/pallas/spmm.py (wrapper `_csr_stats_raw`), the
//   aggregation of every PNA layer on the bf16 path.  `aff` (optional) is
//   the pretrans last BatchNorm folded in as a column affine.
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
// Bound on the card: device-memory bytes.  It reads each message row once
//   (E * D * 2 bytes) and writes 5 or 6 [N, D] bf16 sections; at the bench
//   shapes that is 7.4 MB in and 18.4 MB out against ~10 flops per message
//   element, far below the card's flop/byte balance.
// Design: one thread per (node, 16-byte column vector of 8 bf16).  The
//   thread walks its node's at most K edges; consecutive rows of a node are
//   contiguous, so the threads of a warp read neighbouring 16-byte pieces of
//   the same rows and the loads coalesce.  All statistics live in registers
//   and each output is stored once as a 16-byte vector.  Each node belongs to
//   one thread, so there are no atomics and the result is deterministic.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr float NEG_BIG = -3.0e38f;
constexpr float POS_BIG = 3.0e38f;
constexpr float EPS = 1e-5f;

template <int VEC>
__global__ void __launch_bounds__(THREADS)
pna_stats_kernel(const __nv_bfloat16* __restrict__ msg,
                 const int* __restrict__ row_ptr,
                 const float* __restrict__ aff, __nv_bfloat16* __restrict__ out,
                 int N, int D, int K, int want_sum) {
  const int nvec = D / VEC;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= static_cast<int64_t>(N) * nvec) return;
  const int n = static_cast<int>(idx / nvec);
  const int c = static_cast<int>(idx - static_cast<int64_t>(n) * nvec) * VEC;
  const int start = row_ptr[n];
  const int deg = row_ptr[n + 1] - start;
  const int cnt = min(deg, K);

  float a[VEC], b[VEC];
  if (aff != nullptr) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      a[k] = aff[c + k];
      b[k] = aff[D + c + k];
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
  for (int s = 0; s < cnt; ++s) {
    float m[VEC];
    load_vec<__nv_bfloat16, VEC>(
        msg + static_cast<int64_t>(start + s) * D + c, m);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      if (aff != nullptr)
        m[k] = round_bf16(__fadd_rn(__fmul_rn(m[k], a[k]), b[k]));
      s1[k] = __fadd_rn(s1[k], m[k]);
      s2[k] = __fadd_rn(s2[k], __fmul_rn(m[k], m[k]));
      if (m[k] > mx[k]) {
        mx[k] = m[k];
        amax[k] = static_cast<float>(s);
      }
      if (m[k] < mn[k]) {
        mn[k] = m[k];
        amin[k] = static_cast<float>(s);
      }
    }
  }

  const float dsafe = fmaxf(static_cast<float>(deg), 1.f);
  const bool has = deg > 0;
  float mean[VEC], stdv[VEC], enc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float mu = __fdiv_rn(s1[k], dsafe);
    const float var =
        fmaxf(__fsub_rn(__fdiv_rn(s2[k], dsafe), __fmul_rn(mu, mu)), 0.f);
    mean[k] = has ? mu : 0.f;
    stdv[k] = has ? __fsqrt_rn(__fadd_rn(var, EPS)) : 0.f;
    mx[k] = has ? mx[k] : 0.f;
    mn[k] = has ? mn[k] : 0.f;
    enc[k] = __fadd_rn(amax[k], __fmul_rn(16.f, amin[k]));
  }
  const int64_t sec = static_cast<int64_t>(N) * D;
  __nv_bfloat16* o = out + static_cast<int64_t>(n) * D + c;
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

}  // namespace

// msg [E, D] bf16, row_ptr [N + 1] int32, aff [2, D] float32 or null,
// out [5 + want_sum, N, D] bf16.
PORT_API cudaError_t pna_stats_bf16(const void* msg, const void* row_ptr,
                                    const void* aff, void* out, int N, int D,
                                    int K, int want_sum, void* stream) {
  if (N <= 0 || D <= 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  const void* ptrs[2] = {msg, out};
  const auto* m = static_cast<const __nv_bfloat16*>(msg);
  const auto* rp = static_cast<const int*>(row_ptr);
  const auto* af = static_cast<const float*>(aff);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (vec16_ok(D, 2, ptrs, 2)) {
    const int64_t items = static_cast<int64_t>(N) * (D / 8);
    const dim3 grid(static_cast<unsigned>((items + THREADS - 1) / THREADS));
    pna_stats_kernel<8><<<grid, THREADS, 0, st>>>(m, rp, af, o, N, D, K,
                                                  want_sum);
  } else {
    const int64_t items = static_cast<int64_t>(N) * D;
    const dim3 grid(static_cast<unsigned>((items + THREADS - 1) / THREADS));
    pna_stats_kernel<1><<<grid, THREADS, 0, st>>>(m, rp, af, o, N, D, K,
                                                  want_sum);
  }
  return cudaGetLastError();
}
