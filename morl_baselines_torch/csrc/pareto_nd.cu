// Pareto non-dominated mask for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel morl_baselines_tpu/ops/pareto_kernel.py::_nd_kernel
// (called by non_dominated_mask_pallas).  Same function, another design:
//
//   out[i] = valid[i] && !dominated[i]
//   dominated[i] = exists valid j with  points[j] >= points[i] in every objective
//                                   and points[j] >  points[i] in at least one,
//                  or (dedup) exists valid j < i with points[j] == points[i].
//
// What bounds it: operations.  Every pair (row, column) the data needs costs
// about 3d + 2 compare and logic operations against n * (4d + 2) bytes of
// traffic for the whole call.  On a front (no row dominated) that is every
// pair, so n = 131072, d = 3 is 1.9e11 operations: 2.8 ms at the f32 rate.
// A block per row tile walking every column tile would keep at most one block
// per non-dominated row tile busy, with a few warps to hide the latency of a
// compare chain and a block-wide barrier per tile; hence the design below.
//
// The design, one work item per warp:
//
// - A warp owns a row tile of 32 * R rows (R rows per lane, in registers) and
//   one chunk of the column tiles (32 columns each).  Items are (row tile,
//   column chunk) pairs, chunk-major, numbered by the warp's global index; the
//   launch plan (ops/pareto_kernel.py::nd_launch_plan) picks the number of
//   chunks from n and the SM count, so that the card is full even when only a
//   few row tiles hold a non-dominated row.  Blocks run in no order and carry
//   nothing between them.
// - Each warp streams its column tiles through a private pair of
//   shared-memory buffers with cp.async: the copy of tile t + 1 is in flight
//   while tile t is compared.  No __syncthreads anywhere: only __syncwarp, so
//   warps of a block never wait on each other.
// - A lane reads each staged column once (float4 loads that every lane of the
//   warp shares: a broadcast) and tests it against its R rows, branch-free.
//   When the tile's rows and valid columns are finite (always, on real
//   fronts), the test is arithmetic (scan_tile_fast): d subtractions, one OR
//   of their bits and one max per pair, about 5 instructions, most of them on
//   the FP32 pipe.  Otherwise it is the exact predicate chain
//   (scan_tile_cmp), the column's valid bit the first term of the >= chain
//   and, with dedup, j < i a term of the > chain.  On the fast path with
//   dedup, a tile wholly before the row tile needs only >= (an exact
//   duplicate there dominates too) and a tile wholly after needs >= and >;
//   the tiles that overlap the row tile take the exact path.
// - Exit by warp: before each tile the warp votes (__any_sync) whether any of
//   its rows is still undecided, and leaves when none is.  A row found
//   dominated is written to a per-row int32 scratch (a plain store of 1), and
//   between tiles each warp re-reads the scratch (volatile) to drop rows that
//   another chunk has already decided.  That changes the work, never the output.
// - Completion: with more than one chunk, each warp fences its stores and
//   counts itself in a per-row-tile counter (atomicAdd); the warp that arrives
//   last writes the row tile's output bytes, once: one launch per call.  With
//   one chunk (small n: one block) the warp writes its rows directly and no
//   scratch exists.
//
// NaN inputs are out of scope (comparisons with NaN are false here, as in the
// plain version, but the JAX pair already disagree on them).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS = 32;      // columns per tile: one per lane when staging
constexpr int STAGES = 2;     // cp.async ring depth per warp: double buffering
constexpr int MAX_WARPS = 4;  // warps per block
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int rows_per_thread(int d) { return d <= 8 ? 4 : 2; }
__host__ __device__ constexpr int padded(int d) { return (d + 3) / 4 * 4; }

__device__ __forceinline__ bool is_finite(float x) {  // neither inf nor NaN: the exponent is not all ones
  return (__float_as_uint(x) & 0x7f800000u) != 0x7f800000u;
}

template <int D>
struct alignas(16) WarpStages {
  float pts[STAGES][COLS * padded(D)];  // pts[s][c * padded(D) + k]: objective k of column c
  uint32_t valid[STAGES][COLS / 4];     // the columns' valid bytes
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  // copies src_bytes (0..4) and zero-fills the rest of the 4 bytes
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copy of the column tile at column `base` into stage `s`.  Columns
// past n arrive as invalid (their valid bytes are zero-filled).
template <int D>
__device__ __forceinline__ void start_tile_copy(WarpStages<D>& st, int s, const float* pts, const uint8_t* valid,
                                           int n, long long base, int lane) {
  const long long floats = (long long)n * D;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const int e = lane + j * COLS;  // element of the (COLS, D) tile, coalesced across lanes
    const int c = e / D;
    const long long g = base * D + e;
    const bool in = g < floats;
    cp_async4(&st.pts[s][c * padded(D) + (e - c * D)], in ? pts + g : pts, in ? 4 : 0);
  }
  if (lane < COLS / 4) {
    const long long g = base + 4 * lane;
    const long long left = (long long)n - g;
    const int bytes = left >= 4 ? 4 : (left > 0 ? (int)left : 0);
    cp_async4(&st.valid[s][lane], bytes > 0 ? valid + g : valid, bytes);
  }
}

// The exact path, for any input: predicates on the compares, the column's
// valid bit the first term of the >= chain; hit = ge && (gt || (dedup && j < i)).
template <int D, int R>
__device__ __forceinline__ void scan_tile_cmp(const float* tile, unsigned vmask, const float (&r)[R][D],
                                              bool (&hit)[R], int col0, const int (&row)[R], bool dedup) {
  constexpr int DP = padded(D);
#pragma unroll 4
  for (int c = 0; c < COLS; ++c) {
    const float* v = tile + c * DP;
    const bool cv = (vmask >> c) & 1u;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      bool ge = cv, gt = dedup && col0 + c < row[i];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        ge = ge & (v[k] >= r[i][k]);
        gt = gt | (v[k] > r[i][k]);
      }
      hit[i] = hit[i] | (ge & gt);
    }
  }
}

// The fast path, exact when every row and every valid column of the tile is
// finite and -0 has been read as +0.  Then d_k = v_k - r_k rounds to zero only
// when v_k == r_k (to +0) and never changes sign, so with x = OR_k bits(d_k)
// as an int32:  ge <=> no sign bit <=> x >= 0,  and  ge && gt <=> x > 0.
// Per pair that is d subtractions (FP32 pipe) and about d/2 + 1 integer
// operations (3-input ORs, one max), against 2d predicated compares and a
// combine for the exact path, which ran 1.8x slower on a front of 131072
// points (PERF.md).  An invalid column is staged with -inf in
// objective 0, so its x is negative.  m[i] = max over the tile's columns.
template <int D, int R>
__device__ __forceinline__ void scan_tile_fast(const float* tile, const float (&r)[R][D], int (&m)[R]) {
  constexpr int DP = padded(D);
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    float v[DP];
#pragma unroll
    for (int g = 0; g < DP / 4; ++g) {
      const float4 q = reinterpret_cast<const float4*>(tile + c * DP)[g];  // a broadcast: every lane reads it
      v[4 * g] = q.x;
      v[4 * g + 1] = q.y;
      v[4 * g + 2] = q.z;
      v[4 * g + 3] = q.w;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      int x = 0;
#pragma unroll
      for (int k = 0; k < D; ++k) x |= __float_as_int(v[k] - r[i][k]);
      m[i] = max(m[i], x);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(MAX_WARPS * 32, D <= 4 ? 8 : 4)
nd_mask_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ valid, uint8_t* __restrict__ out,
               int* dominated, int* arrived, int n, int dedup, int row_tiles, int col_tiles, int n_chunks,
               int chunk_tiles) {
  constexpr int R = rows_per_thread(D);
  constexpr int ROW_TILE = 32 * R;
  __shared__ WarpStages<D> stages[MAX_WARPS];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long item = (long long)blockIdx.x * (blockDim.x / 32) + warp;
  if (item >= (long long)row_tiles * n_chunks) return;
  const int chunk = (int)(item / row_tiles);
  const int rt = (int)(item - (long long)chunk * row_tiles);
  const int row0 = rt * ROW_TILE;
  WarpStages<D>& st = stages[warp];
  const bool split = n_chunks > 1;  // other warps share these rows: scratch and counter

  float r[R][D];
  int row[R];
  bool rvalid[R], dom[R], pub[R];
  bool finite = true;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    row[i] = row0 + i * 32 + lane;
    rvalid[i] = row[i] < n && valid[row[i]] != 0;
    dom[i] = pub[i] = false;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      r[i][k] = rvalid[i] ? pts[(long long)row[i] * D + k] + 0.0f : 0.0f;  // + 0.0f reads -0 as +0
      finite = finite && is_finite(r[i][k]);
    }
  }
  const bool rows_finite = __all_sync(FULL, finite);

  const int t_begin = chunk * chunk_tiles;
  const int t_end = min(t_begin + chunk_tiles, col_tiles);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (t_begin + s < t_end) start_tile_copy<D>(st, s, pts, valid, n, (long long)(t_begin + s) * COLS, lane);
    cp_async_commit();
  }
  for (int t = t_begin; t < t_end; ++t) {
    bool busy = false;
#pragma unroll
    for (int i = 0; i < R; ++i) busy = busy | (rvalid[i] && !dom[i]);
    if (!__any_sync(FULL, busy)) break;

    const int tn = t + STAGES - 1;
    if (tn < t_end) start_tile_copy<D>(st, (tn - t_begin) % STAGES, pts, valid, n, (long long)tn * COLS, lane);
    cp_async_commit();
    // rows another warp has decided (read now, applied after the tile, so the
    // load's latency hides behind the compares)
    bool seen[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      seen[i] = split && rvalid[i] && !dom[i] && reinterpret_cast<volatile int*>(dominated)[row[i]] != 0;

    cp_async_wait<STAGES - 1>();  // this lane's copies of tile t have landed
    __syncwarp();                 // ... and every other lane's
    const int s = (t - t_begin) % STAGES;
    // lane c prepares column c: -0 read as +0, an invalid column gets -inf in
    // objective 0 (the fast path's mask; the exact path masks with vmask)
    float* col = st.pts[s] + lane * padded(D);
    const bool cvalid = reinterpret_cast<const uint8_t*>(st.valid[s])[lane] != 0;
    bool cfinite = true;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float x = col[k] + 0.0f;
      cfinite = cfinite && is_finite(x);
      col[k] = (k == 0 && !cvalid) ? __uint_as_float(0xff800000u) : x;  // -inf
    }
    const unsigned vmask = __ballot_sync(FULL, cvalid);
    const bool fast = rows_finite && __all_sync(FULL, cfinite || !cvalid);
    __syncwarp();

    const int col0 = t * COLS;
    const bool diag = dedup && col0 < row0 + ROW_TILE && col0 + COLS > row0;
    const bool before = dedup && col0 < row0;  // with dedup, >= alone dominates here
    bool hit[R];
#pragma unroll
    for (int i = 0; i < R; ++i) hit[i] = false;
    if (fast && !diag) {
      int m[R];
#pragma unroll
      for (int i = 0; i < R; ++i) m[i] = -2147483647 - 1;
      scan_tile_fast<D, R>(st.pts[s], r, m);
#pragma unroll
      for (int i = 0; i < R; ++i) hit[i] = before ? m[i] >= 0 : m[i] > 0;
    } else {
      scan_tile_cmp<D, R>(st.pts[s], vmask, r, hit, col0, row, dedup);
    }
    __syncwarp();  // every lane is done with stage s before it is refilled
#pragma unroll
    for (int i = 0; i < R; ++i) dom[i] = dom[i] || (rvalid[i] && hit[i]);

    if (split) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (dom[i] && !pub[i]) dominated[row[i]] = 1;
        pub[i] = pub[i] || dom[i] || seen[i];
        dom[i] = dom[i] || seen[i];
      }
    }
  }
  cp_async_wait<0>();  // no copy in flight when the warp leaves

  if (!split) {  // this warp saw every column: its rows are decided
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (row[i] < n) out[row[i]] = (rvalid[i] && !dom[i]) ? 1 : 0;
    return;
  }
  __threadfence();  // this lane's scratch stores are visible before the warp counts itself
  __syncwarp();
  int last = 0;
  if (lane == 0) last = atomicAdd(arrived + rt, 1) == n_chunks - 1;
  last = __shfl_sync(FULL, last, 0);
  if (!last) return;
  __threadfence();  // the last warp sees every other chunk's stores
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (row[i] < n)
      out[row[i]] = (rvalid[i] && !dom[i] && reinterpret_cast<volatile int*>(dominated)[row[i]] == 0) ? 1 : 0;
}

template <int D>
cudaError_t launch(const float* pts, const uint8_t* valid, uint8_t* out, int* scratch, int n, int dedup,
                   int row_tile, int row_tiles, int col_tiles, int n_chunks, int chunk_tiles, int warps, int blocks,
                   cudaStream_t stream) {
  const long long items = (long long)row_tiles * n_chunks;
  if (row_tile != 32 * rows_per_thread(D) || (long long)row_tiles * row_tile < n || (long long)col_tiles * COLS < n ||
      (long long)n_chunks * chunk_tiles < col_tiles || warps < 1 || warps > MAX_WARPS ||
      (long long)blocks * warps < items || (n_chunks > 1 && scratch == nullptr))
    return cudaErrorInvalidValue;
  int* dominated = scratch;                                                  // (row_tiles * row_tile,) int32
  int* arrived = scratch ? scratch + (long long)row_tiles * row_tile : nullptr;  // (row_tiles,) int32
  nd_mask_kernel<D><<<blocks, warps * 32, 0, stream>>>(pts, valid, out, dominated, arrived, n, dedup, row_tiles,
                                                       col_tiles, n_chunks, chunk_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// points (n, d) float32 row-major, valid (n,) bytes 0/1 at a 4-byte-aligned
// address, out (n,) bytes 0/1.  scratch: (row_tiles * row_tile + row_tiles)
// int32 zeros when n_chunks > 1, else null.  The plan's numbers come from
// ops/pareto_kernel.py::nd_launch_plan; a plan the kernel cannot take returns
// cudaErrorInvalidValue.  One launch on `stream` of device `device`; returns
// the launch's cudaError.
//
// The launch runs under a device guard: the calling thread's current device
// is read first and restored before returning, so PyTorch's current device
// never moves under it.
int nd_mask_launch(const void* points, const void* valid, void* out, void* scratch, int n, int d, int dedup,
                   int row_tile, int row_tiles, int col_tiles, int n_chunks, int chunk_tiles, int warps, int blocks,
                   int device, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  const float* p = static_cast<const float*>(points);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  uint8_t* o = static_cast<uint8_t*>(out);
  int* sc = static_cast<int*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ND_CASE(D)                                                                                              \
  case D:                                                                                                       \
    err = launch<D>(p, v, o, sc, n, dedup, row_tile, row_tiles, col_tiles, n_chunks, chunk_tiles, warps, blocks, \
                    s);                                                                                         \
    break;
  switch (d) {
    ND_CASE(1) ND_CASE(2) ND_CASE(3) ND_CASE(4) ND_CASE(5) ND_CASE(6) ND_CASE(7) ND_CASE(8)
    ND_CASE(9) ND_CASE(10) ND_CASE(11) ND_CASE(12) ND_CASE(13) ND_CASE(14) ND_CASE(15) ND_CASE(16)
    default: err = cudaErrorInvalidValue;
  }
#undef ND_CASE
  if (prev != device) {
    const cudaError_t restore = cudaSetDevice(prev);
    if (err == cudaSuccess) err = restore;
  }
  return (int)err;
}

}  // extern "C"
