// Shared helpers of the port's CUDA kernels: 16- and 8-byte vector loads
// and stores of float32 / bfloat16 rows converted to float registers, and
// the C entry point that turns a cudaError_t into its message.
//
// Rounding: every kernel computes with explicit _rn intrinsics where the
// plain PyTorch twin rounds after each operation, so nvcc's default FMA
// contraction cannot make the kernel round differently from its twin.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PORT_API extern "C" __attribute__((visibility("default")))

PORT_API const char* port_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// round a float to the nearest bfloat16 and back
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// VEC consecutive elements moved as W-byte words (W = 16 or 8), W / sizeof(T)
// elements per word
template <typename T, int VEC, typename Word>
__device__ __forceinline__ void load_words(const T* __restrict__ p,
                                           float (&v)[VEC]) {
  constexpr int PER = sizeof(Word) / sizeof(T);
#pragma unroll
  for (int ch = 0; ch < VEC / PER; ++ch) {
    const Word raw = reinterpret_cast<const Word*>(p)[ch];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < PER; ++i) v[ch * PER + i] = to_float(e[i]);
  }
}

template <typename T, int VEC, typename Word>
__device__ __forceinline__ void store_words(T* __restrict__ p,
                                            const float (&v)[VEC]) {
  constexpr int PER = sizeof(Word) / sizeof(T);
#pragma unroll
  for (int ch = 0; ch < VEC / PER; ++ch) {
    Word raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < PER; ++i) e[i] = from_float<T>(v[ch * PER + i]);
    reinterpret_cast<Word*>(p)[ch] = raw;
  }
}

// VEC consecutive elements; 16-byte transactions when VEC * sizeof(T) is a
// multiple of 16, 8-byte ones when it is a multiple of 8 (the caller
// guarantees that alignment then), element-wise otherwise
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) % 16 == 0) {
    load_words<T, VEC, uint4>(p, v);
  } else if constexpr (VEC * sizeof(T) % 8 == 0) {
    load_words<T, VEC, uint2>(p, v);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_float(p[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) % 16 == 0) {
    store_words<T, VEC, uint4>(p, v);
  } else if constexpr (VEC * sizeof(T) % 8 == 0) {
    store_words<T, VEC, uint2>(p, v);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = from_float<T>(v[i]);
  }
}

// True when every pointer is 16-byte aligned and a row of D elements of
// `elem` bytes is a whole number of 16-byte vectors: the 16-byte path is
// then safe for every row of those arrays.
__host__ inline bool vec16_ok(int D, int elem, const void* const* ptrs,
                              int n) {
  if ((D * elem) % 16 != 0) return false;
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  return true;
}

// The elements per thread of a kernel that walks rows of D elements of T
// (and writes rows of D float32 or T): a 16-byte vector of T when a row is
// a whole number of them, else an 8-byte one (D = 300 in bf16: 600-byte
// rows, 75 vectors of 4), else 1.  Every pointer must be 16-byte aligned
// for either vector path; a float32 output row then splits into whole
// 16-byte words as well.  Null pointers (absent inputs) count as aligned.
template <typename T>
__host__ inline int vec_width(int D, const void* const* ptrs, int n) {
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return 1;
  if ((D * sizeof(T)) % 16 == 0) return 16 / sizeof(T);
  if ((D * sizeof(T)) % 8 == 0) return 8 / sizeof(T);
  return 1;
}

// --- small CSR walks: one thread per (node, column vector) -----------------
//
// The CSR multi-reduce (multi_reduce.cu) and the sender-keyed segment sum
// (snd_segment_sum.cu) give each (node, VEC-element column vector) of an
// [N, D] output one thread, which walks the node's range of edge rows.  At
// the OT slice's shapes (~640 real edges, D = 50) a launch moves well under
// a megabyte, so its time is the launch plus the chain of dependent memory
// round trips each thread waits on.  `walk_rows` keeps that chain short:
// it takes the slots U at a time, issues the chunk's U index loads (through
// a permutation), then its U row loads, and only then adds them in slot
// order, so a node of degree <= U costs one round trip for its rows (two
// through a permutation) after its range.

// U: the slots a chunk takes.  One chunk covers every node of degree <= 4,
// which is every atom of a QM9-like or molhiv-like molecule; U = 8 and
// blocks of 128 threads were measured slower or no faster on the H100.
constexpr int WALK_UNROLL = 4;
constexpr int WALK_THREADS = 256;

// 64-bit index arithmetic where max(N, E) * D reaches 2^31 (whatever the
// vector width), or where the caller forces it; else 32-bit.
__host__ inline bool walk_wide(int N, int E, int D, int force_wide) {
  return force_wide ||
         static_cast<int64_t>(N > E ? N : E) * D >= (int64_t{1} << 31);
}

__host__ inline unsigned walk_blocks(int64_t items) {
  return static_cast<unsigned>((items + WALK_THREADS - 1) / WALK_THREADS);
}

// This thread's node n and first column c for an [N, D] output walked in
// vectors of VEC elements; false past the last item.  Idx is uint32_t
// where `walk_wide` allows 32-bit indices (a 32-bit division), else
// int64_t.
template <typename Idx, int VEC>
__device__ __forceinline__ bool node_column(int N, int D, int& n, int& c) {
  const Idx nvec = static_cast<Idx>(D / VEC);
  const Idx idx = static_cast<Idx>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<Idx>(N) * nvec) return false;
  const Idx q = idx / nvec;
  n = static_cast<int>(q);
  c = static_cast<int>(idx - q * nvec) * VEC;
  return true;
}

// The rows of slots 0, 1, ..., cnt - 1 of a range starting at `first` of
// an [*, D] array of T, at column c: row first + s, or with PERM row
// perm[first + s], each handed to add(v, valid) as VEC floats, in slot
// order, U slots at a time; row offsets in Idx.  A chunk's slots past cnt
// load the range's last row again (a valid address, already on its way)
// and come with valid false.  add uses every slot it is handed, and the
// first chunk is straight-line code ahead of the loop over the others:
// only so does nvcc issue all of a chunk's loads before its first add (a
// load used only under `valid`, or a chunk inside a loop, was scheduled
// load, add, load, add: one round trip per slot).  A sum adds 0 in place
// of an invalid slot, which leaves it bit for bit as it was (a float32 sum
// that starts at +0 never reaches -0 without flush to zero, and s + 0 == s
// for every other s); an extremum may take the repeated row, which it
// holds already.
template <typename T, int VEC, int U, bool PERM, typename Idx, typename Add>
__device__ __forceinline__ void walk_rows(const T* __restrict__ rows, int D,
                                          int c, const int* __restrict__ perm,
                                          int first, int cnt, Add&& add) {
  const T* base = PERM ? rows + c : rows + static_cast<Idx>(first) * D + c;
  auto chunk = [&](int s0) {
    Idx r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = min(s0 + u, cnt - 1);
      if constexpr (PERM) {
        r[u] = static_cast<Idx>(perm[first + s]);
      } else {
        r[u] = static_cast<Idx>(s);
      }
    }
    float v[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) load_vec<T, VEC>(base + r[u] * D, v[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) add(v[u], s0 + u < cnt);
  };
  if (cnt > 0) chunk(0);
#pragma unroll 1
  for (int s0 = U; s0 < cnt; s0 += U) chunk(s0);
}

// --- node tiles of a CSR batch, staged in shared memory -------------------
//
// The two PNA-statistics kernels (pna_stats.cu, pna_stats_bwd.cu) walk
// tiles of TN consecutive nodes.  Block b owns the contiguous run of tiles
// [b * run, (b + 1) * run); the grid is as many runs as the tiles need, at
// most SMs x resident blocks (one wave).  The block first reads its run's
// row_ptr slice into shared memory (one load per entry, all at once), so
// every tile's edge range is known without another trip to device memory.
// A tile's edge rows are contiguous in the receiver-sorted batch, rows
// [row_ptr[n0], row_ptr[n1]); they are copied with cp.async (every thread
// issues its share of 16-, 8- or 4-byte pieces), together with the tile's
// rows of up to eight [N, D] node arrays, into one of `nslots` slots, up to
// nslots - 1 tiles ahead of the tile being reduced.  A slot holds TN * K
// edge rows (K = the batch's largest in-degree), so a tile always fits;
// rows past a slot (only a node of degree above K could put them there)
// are read from device memory.

// CPW-byte asynchronous copy global -> shared (both CPW-aligned); CPW = 2
// (rows of an odd number of bf16) is a plain load and store.
template <int CPW>
__device__ __forceinline__ void copy_piece(void* dst, const void* src) {
  if constexpr (CPW == 16) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  } else if constexpr (CPW == 8 || CPW == 4) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(CPW));
  } else {
    *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
  }
}

// `bytes` bytes from global to shared by the block's threads, CPW at a time
template <int CPW>
__device__ __forceinline__ void copy_block(char* dst, const char* src,
                                           int bytes) {
  for (int i = threadIdx.x * CPW; i < bytes; i += blockDim.x * CPW)
    copy_piece<CPW>(dst + i, src + i);
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `pending` (0 to 3) committed groups of this thread are
// still in flight
__device__ __forceinline__ void copy_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::); break;
  }
}

__host__ __device__ inline int align16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

constexpr int RING_MAX_ARRAYS = 8;

// The shapes of a tile walk, the same on the host (to size the launch) and
// on the card.  Shared-memory layout: `nslots` slots, each the tile's edge
// rows (slot_rows * rowbytes) then its rows of each node array (TN *
// rowbytes each); then the run's row_ptr slice; then the kernel's own bytes.
struct TileShape {
  int N, TN, rowbytes, slot_rows, narrays, nslots, run;

  __host__ __device__ int tiles() const { return (N + TN - 1) / TN; }
  __host__ __device__ int rows_bytes() const {
    return align16(slot_rows * rowbytes);
  }
  __host__ __device__ int array_bytes() const { return align16(TN * rowbytes); }
  __host__ __device__ int slot_bytes() const {
    return rows_bytes() + narrays * array_bytes();
  }
  __host__ __device__ int slice_bytes() const {
    return align16((run * TN + 1) * 4);
  }
  __host__ __device__ int bytes() const {
    return nslots * slot_bytes() + slice_bytes();
  }
};

struct TileRing {
  TileShape sh;
  const char* rows;                           // the batch's edge rows
  const int* row_ptr;                         // [N + 1]
  const char* arrays[RING_MAX_ARRAYS];        // [N, D] node arrays, staged
  char* smem;
  int t0, t1, nb0;                            // the run's tiles, first node

  __device__ TileRing(const TileShape& shape, const char* rows_,
                      const int* row_ptr_, char* smem_)
      : sh(shape), rows(rows_), row_ptr(row_ptr_), smem(smem_) {
    t0 = blockIdx.x * sh.run;
    t1 = min(t0 + sh.run, sh.tiles());
    nb0 = t0 * sh.TN;
#pragma unroll
    for (int k = 0; k < RING_MAX_ARRAYS; ++k) arrays[k] = nullptr;
  }
  __device__ char* slot(int s) const { return smem + s * sh.slot_bytes(); }
  __device__ int* slice() const {
    return reinterpret_cast<int*>(smem + sh.nslots * sh.slot_bytes());
  }
  __device__ char* extra() const { return smem + sh.bytes(); }
  __device__ int first_node(int t) const { return t * sh.TN; }
  __device__ int end_node(int t) const { return min(t * sh.TN + sh.TN, sh.N); }
  // row_ptr[n] for a node n of the run (or the run's end)
  __device__ int rp(int n) const { return slice()[n - nb0]; }

  // issue the copies of tile t into slot s; no commit
  template <int CPW>
  __device__ void issue(int t, int s) const {
    const int n0 = first_node(t), n1 = end_node(t);
    const int r0 = rp(n0);
    copy_block<CPW>(slot(s),
                    rows + static_cast<int64_t>(r0) * sh.rowbytes,
                    min(rp(n1) - r0, sh.slot_rows) * sh.rowbytes);
#pragma unroll
    for (int k = 0; k < RING_MAX_ARRAYS; ++k)   // constant indices: registers
      if (k < sh.narrays)
        copy_block<CPW>(slot(s) + sh.rows_bytes() + k * sh.array_bytes(),
                        arrays[k] + static_cast<int64_t>(n0) * sh.rowbytes,
                        (n1 - n0) * sh.rowbytes);
  }

  // The walk: work(t, s) reduces tile t from slot s.  Every thread of the
  // block calls it for every tile of the run.
  template <int CPW, typename Work>
  __device__ void walk(Work&& work) const {
    if (t0 >= t1) return;
    const int nb1 = end_node(t1 - 1);
    int* sl = slice();
    for (int i = threadIdx.x; i <= nb1 - nb0; i += blockDim.x)
      sl[i] = row_ptr[nb0 + i];
    __syncthreads();
    const int ntiles = t1 - t0, ahead = sh.nslots - 1;
    for (int j = 0; j < ahead; ++j) {
      if (j < ntiles) issue<CPW>(t0 + j, j);
      copy_commit();
    }
    for (int i = 0; i < ntiles; ++i) {
      if (i + ahead < ntiles)
        issue<CPW>(t0 + i + ahead, (i + ahead) % sh.nslots);
      copy_commit();               // empty near the end: still counts
      copy_wait(ahead);            // tile i's group has landed
      __syncthreads();
      work(t0 + i, i % sh.nslots);
      __syncthreads();             // slot i % nslots is free again
    }
  }

  // edge row `row` of tile t (staged in slot s) at element c: from the slot
  // when it was copied, else from device memory
  template <typename T>
  __device__ const T* row_at(int t, int s, int row, int c) const {
    const int local = row - rp(first_node(t));
    const char* base = local < sh.slot_rows
                           ? slot(s) + local * sh.rowbytes
                           : rows + static_cast<int64_t>(row) * sh.rowbytes;
    return reinterpret_cast<const T*>(base) + c;
  }
  // node array k's row of local node nl of the tile in slot s, at element c
  template <typename T>
  __device__ const T* array_at(int s, int k, int nl, int c) const {
    return reinterpret_cast<const T*>(slot(s) + sh.rows_bytes() +
                                      k * sh.array_bytes() +
                                      nl * sh.rowbytes) + c;
  }
};

// The launch of a tile walk: `shape.run` and the grid (runs of tiles, at
// most SMs x resident blocks at this block size and the shape's shared
// memory plus `extra` bytes).  Raises the kernel's dynamic shared-memory
// limit to what it needs when that is more than 48 KB (the limit counts
// the kernel's static shared memory too).  Returns the shared memory per
// block in *smem.
template <typename Kernel>
__host__ inline cudaError_t tile_launch(Kernel kernel, int threads, int extra,
                                        TileShape* shape, int* grid,
                                        int* smem) {
  const int tiles = shape->tiles();
  // the dynamic shared memory a launch needs, above the default 48 KB
  auto allow = [kernel](int bytes) {
    return bytes <= 48 * 1024
               ? cudaSuccess
               : cudaFuncSetAttribute(
                     kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                     bytes);
  };
  // size the occupancy query with a run slice of up to 256 nodes; a longer
  // run (a batch of more than ~250 nodes per resident block) only adds
  // shared memory
  shape->run = (255 + shape->TN) / shape->TN;
  const int probe = shape->bytes() + extra;
  cudaError_t err = allow(probe);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, probe)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int resident = sms * per_sm;
  shape->run = tiles < 1 ? 1 : (tiles + resident - 1) / resident;
  *grid = tiles < 1 ? 1 : (tiles + shape->run - 1) / shape->run;
  *smem = shape->bytes() + extra;
  return *smem > probe ? allow(*smem) : cudaSuccess;
}

// True when every pointer is 4-byte aligned (4-byte copies of bf16 pairs).
__host__ inline bool aligned4(const void* const* ptrs, int n) {
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 4 != 0) return false;
  return true;
}

// The slots of a ring: as many tiles ahead as fit `budget` bytes, 2 to 4.
__host__ inline int ring_slots(int slot_bytes, int budget) {
  const int n = budget / (slot_bytes > 0 ? slot_bytes : 1);
  return n < 2 ? 2 : (n > 4 ? 4 : n);
}

// Sum, in the order j = j0, j0 + 1, ..., j1 - 1 and starting from 0, of
// p[j * stride]: float32 partials written by other blocks (read past L1),
// sixteen loads in flight at a time.
__device__ __forceinline__ float ordered_sum(const float* p, int64_t stride,
                                             int j0, int j1) {
  constexpr int B = 16;
  float v = 0.f;
  for (int j = j0; j < j1; j += B) {
    float t[B];
#pragma unroll
    for (int k = 0; k < B; ++k)
      t[k] = j + k < j1 ? __ldcg(p + (j + k) * stride) : 0.f;
#pragma unroll
    for (int k = 0; k < B; ++k)
      if (j + k < j1) v = __fadd_rn(v, t[k]);
  }
  return v;
}
