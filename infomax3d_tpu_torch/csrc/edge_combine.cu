// Fused edge combine: z[e] = hd[recv[e]] + hs[send[e]] + pe[e].
//
// Replaces: the Pallas kernel `_edge_combine_kernel` of
//   infomax3d_tpu/ops/pallas/spmm.py:1123 (wrapper `_csr_edge_combine_raw`,
//   :1181), the first pretrans layer of every PNA layer with its input
//   [h[send] ‖ h[recv] ‖ e] split across the weight rows (models/base.py
//   SplitDense), and the first layer of the flat Net3D's message MLP.
// Contract: the three terms are summed in float32 in that order, a term
//   whose index is not in [0, N) counting as +0, and rounded to the output
//   type once.  So padding edges (index N) get 0 + 0 + pe.
// Bound on the card: device-memory bytes.  Per edge it moves the pe row,
//   the output row and two int32 ids; the two gathered rows come from
//   [N, D] arrays that are read about once (consecutive edges share their
//   receiver, and the senders of one receiver are the atoms of one
//   molecule, which stay in L1/L2).  At the bench shape (E = 18432,
//   N = 9216, D = 200, bf16) that is 22.3 MB; at the multi-conformer shape
//   (QMugs, C = 3: E = 3.25 M, N = 67328, D = 20, bf16, 40-byte rows)
//   291.7 MB against 2 adds per element, so bandwidth bounds it.
// Design: one thread per 16-byte word of the flat [E * D] run of pe and
//   the output, whatever D is: the tile of 256 threads moves 4 KB of pe
//   and 4 KB of output in whole 16-byte transactions, 8 blocks (32 KB) in
//   flight per SM.  The word is cut into pieces of VG elements, VG the
//   widest word a row is made of (`vec_width`: 16 bytes where a row is a
//   whole number of them, 8 bytes at 40-byte rows, else one element), so a
//   piece lies inside one edge; each piece gathers its hd and hs rows in
//   VG-element words (two 8-byte pieces per word at D = 20 in bf16).  Each
//   thread loads its own pieces' ids (neighbouring threads read the same
//   ids, a broadcast), so the first row load waits on one round trip and
//   no barrier; the addresses of invalid ids are clamped to row 0 and the
//   term replaced by +0 after the load, so every load of a thread is in
//   flight before its first add.  A run whose length is not a whole number
//   of 16-byte words ends in one thread that moves its pieces one by one.
//   Where pe or the output is not 16-byte aligned (a view), VG and the
//   word are one element.  32-bit index arithmetic where max(N, E) * D <
//   2^31 (`walk_wide`), else (or when the caller forces it) 64-bit.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; tools/torch_kernel_ab.py,
//   cold L2; PERF.md §6, row 6): at the multi-conformer shape 0.113 ms,
//   77 % of the bound, where the first design (one block per 32 edges, ids
//   staged in shared memory behind a barrier, one thread per 16-byte
//   column vector or, at 40-byte rows, per element with 2-byte loads) took
//   0.270 ms (32 %); at the bench shape 0.0144 ms against its 0.0168.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// VG: elements of a gathered piece; VF: elements of a word of pe / out.
template <typename T, int VG, int VF, typename Idx>
__global__ void __launch_bounds__(THREADS)
edge_combine_kernel(const T* __restrict__ hd, const T* __restrict__ hs,
                    const T* __restrict__ pe, const int* __restrict__ recv,
                    const int* __restrict__ send, T* __restrict__ out, int N,
                    int E, int D) {
  constexpr int P = VF / VG;
  const Idx total = static_cast<Idx>(E) * static_cast<Idx>(D);
  const Idx f = (static_cast<Idx>(blockIdx.x) * THREADS + threadIdx.x) * VF;
  if (f >= total) return;
  const bool whole = f + VF <= total;

  // each piece's edge and column; pieces past the run (the last word only)
  // take the last edge's ids and are not stored
  int r[P], s[P], col[P];
  {
    Idx e = f / static_cast<Idx>(D);
    int c = static_cast<int>(f - e * static_cast<Idx>(D));
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const Idx ep = e < static_cast<Idx>(E) ? e : static_cast<Idx>(E - 1);
      r[p] = recv[ep];
      s[p] = send[ep];
      col[p] = c;
      c += VG;
      if (c == D) {
        c = 0;
        ++e;
      }
    }
  }

  float z[VF];
  if (whole) {
    load_vec<T, VF>(pe + f, z);
  } else {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float (&zp)[VG] = *reinterpret_cast<float(*)[VG]>(z + p * VG);
      if (f + p * VG < total) {
        load_vec<T, VG>(pe + f + p * VG, zp);
      } else {
#pragma unroll
        for (int k = 0; k < VG; ++k) zp[k] = 0.f;
      }
    }
  }

  float a[P][VG], b[P][VG];
  bool ra[P], sb[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    ra[p] = static_cast<unsigned>(r[p]) < static_cast<unsigned>(N);
    sb[p] = static_cast<unsigned>(s[p]) < static_cast<unsigned>(N);
    load_vec<T, VG>(hd + static_cast<Idx>(ra[p] ? r[p] : 0) * D + col[p],
                    a[p]);
    load_vec<T, VG>(hs + static_cast<Idx>(sb[p] ? s[p] : 0) * D + col[p],
                    b[p]);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int k = 0; k < VG; ++k) {
      const float hterm = ra[p] ? a[p][k] : 0.f;
      const float sterm = sb[p] ? b[p][k] : 0.f;
      z[p * VG + k] = __fadd_rn(__fadd_rn(hterm, sterm), z[p * VG + k]);
    }
  }

  if (whole) {
    store_vec<T, VF>(out + f, z);
  } else {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (f + p * VG < total)
        store_vec<T, VG>(out + f + p * VG,
                         *reinterpret_cast<float(*)[VG]>(z + p * VG));
    }
  }
}

template <typename T, int VG, int VF>
void launch_width(const T* hd, const T* hs, const T* pe, const int* recv,
                  const int* send, T* out, int N, int E, int D, bool wide,
                  cudaStream_t st) {
  const int64_t words = (static_cast<int64_t>(E) * D + VF - 1) / VF;
  const dim3 grid(static_cast<unsigned>((words + THREADS - 1) / THREADS));
  if (wide) {
    edge_combine_kernel<T, VG, VF, int64_t><<<grid, THREADS, 0, st>>>(
        hd, hs, pe, recv, send, out, N, E, D);
  } else {
    edge_combine_kernel<T, VG, VF, uint32_t><<<grid, THREADS, 0, st>>>(
        hd, hs, pe, recv, send, out, N, E, D);
  }
}

template <typename T>
cudaError_t launch(const void* hd, const void* hs, const void* pe,
                   const void* recv, const void* send, void* out, int N,
                   int E, int D, int force_wide, void* stream) {
  if (E <= 0 || D <= 0) return cudaSuccess;
  if (N <= 0) return cudaErrorInvalidValue;
  const bool wide = walk_wide(N, E, D, force_wide);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const T*>(hd);
  const auto* s = static_cast<const T*>(hs);
  const auto* p = static_cast<const T*>(pe);
  const auto* r = static_cast<const int*>(recv);
  const auto* sn = static_cast<const int*>(send);
  auto* o = static_cast<T*>(out);
  const void* ptrs[4] = {hd, hs, pe, out};
  constexpr int V16 = 16 / sizeof(T), V8 = 8 / sizeof(T);
  const int vg = vec_width<T>(D, ptrs, 4);
  // vec_width is 1 when a pointer is not 16-byte aligned; the flat words
  // need only pe and out aligned
  const bool flat16 = reinterpret_cast<uintptr_t>(pe) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vg == V16) {
    launch_width<T, V16, V16>(d, s, p, r, sn, o, N, E, D, wide, st);
  } else if (vg == V8) {
    launch_width<T, V8, V16>(d, s, p, r, sn, o, N, E, D, wide, st);
  } else if (flat16) {
    launch_width<T, 1, V16>(d, s, p, r, sn, o, N, E, D, wide, st);
  } else {
    launch_width<T, 1, 1>(d, s, p, r, sn, o, N, E, D, wide, st);
  }
  return cudaGetLastError();
}

}  // namespace

// hd, hs [N, D], pe [E, D], out [E, D] (bf16 or float32), recv / send [E]
// int32; wide != 0 forces 64-bit index arithmetic.
PORT_API cudaError_t edge_combine_bf16(const void* hd, const void* hs,
                                       const void* pe, const void* recv,
                                       const void* send, void* out, int N,
                                       int E, int D, int wide, void* stream) {
  return launch<__nv_bfloat16>(hd, hs, pe, recv, send, out, N, E, D, wide,
                               stream);
}

PORT_API cudaError_t edge_combine_f32(const void* hd, const void* hs,
                                      const void* pe, const void* recv,
                                      const void* send, void* out, int N,
                                      int E, int D, int wide, void* stream) {
  return launch<float>(hd, hs, pe, recv, send, out, N, E, D, wide, stream);
}
