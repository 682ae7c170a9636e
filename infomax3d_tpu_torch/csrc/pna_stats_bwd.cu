// Backward of the fused bf16 PNA statistics, per edge e with receiver r:
//   m    = bf16(x * a + b)  with the affine, else x              (f32 math)
//   d    = A[r] + B[r] * (m - mean[r])
//          + d_max[r] * [pos[e] == amax[r]] + d_min[r] * [pos[e] == amin[r]]
//   d    = 0 where r is not in [0, N) (padding edges)
//   d_x  = bf16(d * a)  with the affine, else bf16(d)
//   d_a  = sum over e of d * x,  d_b = sum over e of d   (affine only; d
//          before it is scaled by a)
// where A = d_sum + d_mean / deg and B = d_std / (deg * max(std, sqrt(eps)))
// are the node-side combinations of the cotangents (bf16, formed by the
// caller), and the winner slots come from the forward's enc = amax + 16 amin.
//
// Replaces: the Pallas kernels `_stats_bwd_kernel` and
//   `_stats_bwd_kernel_aff` of infomax3d_tpu/ops/pallas/spmm.py (wrapper
//   `_csr_stats_bwd_raw`), the aggregation backward of every PNA layer on
//   the bf16 path, with the pretrans last BatchNorm folded in as an affine.
// Contract: (m - mean) is formed per edge (never distributed into A + B m,
//   which would break the exact cancellation at degree-1 nodes); every
//   operation rounds as the plain PyTorch twin does (explicit _rn
//   intrinsics, no FMA contraction).  The column sums are deterministic:
//   each block writes float32 partials of its edges in a fixed order (edge
//   lanes, then lanes summed in order), and a second kernel adds the
//   partials block by block.  No atomics.
// Bound on the card: device-memory bytes.  Per edge it reads the x row and
//   gathers six [N, D] bf16 operand rows of its receiver, and writes the d_x
//   row: at the bench shapes (E = 18432, N = 9216, D = 200) ~37 MB against
//   ~12 flops per element.
// Design: a block takes a tile of TE = 64 consecutive (receiver-sorted)
//   edges and up to 32 16-byte column vectors: threadIdx.x is the column
//   vector, threadIdx.y one of 8 edge lanes, so a warp reads one edge's row
//   contiguously and the receiver's operand rows, shared by the node's
//   edges, stay in L1/L2.  Each lane walks every 8th edge of the tile and
//   keeps its column partials in registers; the block reduces the 8 lanes
//   through shared memory.  Widths or pointers that do not fit 16-byte
//   vectors take the element-wise instantiation.
#include "common.cuh"

namespace {

constexpr int TE = 64;      // edges per block
constexpr int LANES = 8;    // edge lanes per block (threadIdx.y)
constexpr int CV = 32;      // column vectors per block (threadIdx.x)

template <int VEC>
__global__ void __launch_bounds__(CV * LANES)
pna_stats_bwd_kernel(const __nv_bfloat16* __restrict__ x,
                     const int* __restrict__ recv,
                     const int16_t* __restrict__ pos,
                     const __nv_bfloat16* __restrict__ opA,
                     const __nv_bfloat16* __restrict__ opB,
                     const __nv_bfloat16* __restrict__ opMean,
                     const __nv_bfloat16* __restrict__ opDmax,
                     const __nv_bfloat16* __restrict__ opDmin,
                     const __nv_bfloat16* __restrict__ opEnc,
                     const float* __restrict__ aff,
                     __nv_bfloat16* __restrict__ dx,
                     float* __restrict__ part, int N, int E, int D) {
  const int nvec = D / VEC;
  const int cv = blockIdx.y * CV + threadIdx.x;
  const bool col_ok = cv < nvec;
  const int c = cv * VEC;
  const bool has_aff = aff != nullptr;

  float a[VEC], b[VEC], pa[VEC], pb[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    a[k] = (has_aff && col_ok) ? aff[c + k] : 1.f;
    b[k] = (has_aff && col_ok) ? aff[D + c + k] : 0.f;
    pa[k] = 0.f;
    pb[k] = 0.f;
  }

  const int e0 = blockIdx.x * TE;
  for (int i = 0; i < TE / LANES; ++i) {
    const int e = e0 + i * LANES + threadIdx.y;
    if (!col_ok || e >= E) continue;
    const int64_t row = static_cast<int64_t>(e) * D + c;
    float xv[VEC], d[VEC];
    load_vec<__nv_bfloat16, VEC>(x + row, xv);
    const int r = recv[e];
    if (r >= 0 && r < N) {
      const int64_t nrow = static_cast<int64_t>(r) * D + c;
      float A[VEC], B[VEC], mean[VEC], dmx[VEC], dmn[VEC], enc[VEC];
      load_vec<__nv_bfloat16, VEC>(opA + nrow, A);
      load_vec<__nv_bfloat16, VEC>(opB + nrow, B);
      load_vec<__nv_bfloat16, VEC>(opMean + nrow, mean);
      load_vec<__nv_bfloat16, VEC>(opDmax + nrow, dmx);
      load_vec<__nv_bfloat16, VEC>(opDmin + nrow, dmn);
      load_vec<__nv_bfloat16, VEC>(opEnc + nrow, enc);
      const float p = static_cast<float>(pos[e]);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float m =
            has_aff ? round_bf16(__fadd_rn(__fmul_rn(xv[k], a[k]), b[k]))
                    : xv[k];
        const float amin = floorf(enc[k] * 0.0625f);
        const float amax = __fsub_rn(enc[k], __fmul_rn(16.f, amin));
        float dk = __fadd_rn(A[k], __fmul_rn(B[k], __fsub_rn(m, mean[k])));
        dk = __fadd_rn(dk, __fmul_rn(dmx[k], p == amax ? 1.f : 0.f));
        dk = __fadd_rn(dk, __fmul_rn(dmn[k], p == amin ? 1.f : 0.f));
        d[k] = dk;
      }
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) d[k] = 0.f;
    }
    if (has_aff) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        pa[k] = __fadd_rn(pa[k], __fmul_rn(d[k], xv[k]));
        pb[k] = __fadd_rn(pb[k], d[k]);
        d[k] = __fmul_rn(d[k], a[k]);
      }
    }
    store_vec<__nv_bfloat16, VEC>(dx + row, d);
  }
  if (!has_aff) return;          // the same for every thread of the block

  // the 8 lanes' column partials -> one partial row per block, in lane order
  __shared__ float s_a[LANES][CV * VEC];
  __shared__ float s_b[LANES][CV * VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    s_a[threadIdx.y][threadIdx.x * VEC + k] = pa[k];
    s_b[threadIdx.y][threadIdx.x * VEC + k] = pb[k];
  }
  __syncthreads();
  const int64_t nblk = gridDim.x;
  for (int j = threadIdx.y * CV + threadIdx.x; j < CV * VEC;
       j += CV * LANES) {
    const int col = blockIdx.y * CV * VEC + j;
    if (col >= D) continue;
    float sa = s_a[0][j];
    float sb = s_b[0][j];
#pragma unroll
    for (int l = 1; l < LANES; ++l) {
      sa = __fadd_rn(sa, s_a[l][j]);
      sb = __fadd_rn(sb, s_b[l][j]);
    }
    part[static_cast<int64_t>(blockIdx.x) * D + col] = sa;
    part[(nblk + blockIdx.x) * D + col] = sb;
  }
}

// out[w * D + j] = sum over blocks t, in order, of part[(w * nblk + t) * D
// + j], for w = 0 (d_a) and 1 (d_b)
__global__ void column_sums_kernel(const float* __restrict__ part,
                                   float* __restrict__ out, int nblk, int D) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * D) return;
  const int w = idx / D;
  const int j = idx - w * D;
  const float* p = part + static_cast<int64_t>(w) * nblk * D + j;
  float acc = p[0];
  for (int t = 1; t < nblk; ++t)
    acc = __fadd_rn(acc, p[static_cast<int64_t>(t) * D]);
  out[idx] = acc;
}

}  // namespace

// Number of edge tiles (blocks along x): the caller sizes `part` as
// [2, tiles, D] float32 when it passes an affine.
PORT_API int pna_stats_bwd_tiles(int E) { return (E + TE - 1) / TE; }

// x [E, D] bf16, recv [E] int32, pos [E] int16, the six operands [N, D]
// bf16 (A, B, mean, d_max, d_min, enc), aff [2, D] float32 or null,
// dx [E, D] bf16, part [2, tiles, D] float32 and dab [2, D] float32 (both
// unused without aff).
PORT_API cudaError_t pna_stats_bwd_bf16(
    const void* x, const void* recv, const void* pos, const void* opA,
    const void* opB, const void* opMean, const void* opDmax,
    const void* opDmin, const void* opEnc, const void* aff, void* dx,
    void* part, void* dab, int N, int E, int D, void* stream) {
  if (E <= 0 || D <= 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  const void* ptrs[8] = {x, opA, opB, opMean, opDmax, opDmin, opEnc, dx};
  const bool vec = vec16_ok(D, 2, ptrs, 8);
  const int V = vec ? 8 : 1;
  const int nvec = D / V;
  const int tiles = (E + TE - 1) / TE;
  const dim3 grid(tiles, (nvec + CV - 1) / CV);
  const dim3 block(CV, LANES);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* rc = static_cast<const int*>(recv);
  const auto* ps = static_cast<const int16_t*>(pos);
  const auto* A = static_cast<const __nv_bfloat16*>(opA);
  const auto* B = static_cast<const __nv_bfloat16*>(opB);
  const auto* M = static_cast<const __nv_bfloat16*>(opMean);
  const auto* Dx = static_cast<const __nv_bfloat16*>(opDmax);
  const auto* Dn = static_cast<const __nv_bfloat16*>(opDmin);
  const auto* En = static_cast<const __nv_bfloat16*>(opEnc);
  const auto* af = static_cast<const float*>(aff);
  auto* out = static_cast<__nv_bfloat16*>(dx);
  auto* pt = static_cast<float*>(part);
  if (vec) {
    pna_stats_bwd_kernel<8><<<grid, block, 0, st>>>(
        xb, rc, ps, A, B, M, Dx, Dn, En, af, out, pt, N, E, D);
  } else {
    pna_stats_bwd_kernel<1><<<grid, block, 0, st>>>(
        xb, rc, ps, A, B, M, Dx, Dn, En, af, out, pt, N, E, D);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || aff == nullptr) return err;
  column_sums_kernel<<<(2 * D + 255) / 256, 256, 0, st>>>(
      pt, static_cast<float*>(dab), tiles, D);
  return cudaGetLastError();
}
