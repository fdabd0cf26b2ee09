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
// One thread owns one row and keeps its d values in registers; a block of TILE
// threads is a row tile.  The block walks every column tile: it stages the
// (TILE, d) column points and their valid flags in shared memory (transposed,
// so that all threads of a warp read the same word: a broadcast), then each
// thread tests its row against all staged columns.  Nothing is carried between
// blocks and one byte per row is written, so unlike the TPU kernel there is no
// sequential OR-accumulation over a grid axis.  Columns past n are masked at
// load (treated as invalid): no padded copy of the input.  A block stops early
// once every one of its rows is decided dominated (or is invalid); that changes
// the work, never the output.
//
// Bound: about n^2 * (3d + 2) compare/logic operations against n * (4d + 2)
// bytes of traffic, so it is bound by operations, not bytes.  Simple and right
// first; wgmma/TMA-style tuning is later work.
//
// NaN inputs are out of scope (comparisons with NaN are false here, as in the
// plain version, but the JAX pair already disagree on them).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;

template <int D>
__global__ void __launch_bounds__(TILE)
nd_mask_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ valid,
               uint8_t* __restrict__ out, int n, int dedup) {
  __shared__ float cols[D * TILE];  // cols[k * TILE + c]: objective k of column c
  __shared__ uint8_t vcols[TILE];

  const int tid = threadIdx.x;
  const long long i = (long long)blockIdx.x * TILE + tid;
  const bool row_in = i < n;

  float r[D];
  bool row_valid = false;
  if (row_in) {
    row_valid = valid[i] != 0;
#pragma unroll
    for (int k = 0; k < D; ++k) r[k] = pts[i * D + k];
  }
  bool dominated = false;
  bool done = !row_valid;  // invalid rows are never reported, skip their work

  const int n_tiles = (n + TILE - 1) / TILE;
  for (int t = 0; t < n_tiles; ++t) {
    const long long base = (long long)t * TILE;
    // coalesced load of the (TILE, D) column tile, transposed into shared memory
    for (int e = tid; e < TILE * D; e += TILE) {
      const int c = e / D;
      const int k = e - c * D;
      cols[k * TILE + c] = (base + c < n) ? pts[base * D + e] : 0.0f;
    }
    vcols[tid] = (base + tid < n) ? valid[base + tid] : 0;
    __syncthreads();

    if (!done) {
      for (int c = 0; c < TILE; ++c) {
        if (!vcols[c]) continue;
        bool ge = true, gt = false;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          const float v = cols[k * TILE + c];
          ge = ge && (v >= r[k]);
          gt = gt || (v > r[k]);
        }
        // ge && !gt means every component is equal: a duplicate
        if (ge && (gt || (dedup && base + c < i))) {
          dominated = true;
          break;
        }
      }
      done = dominated;
    }
    // also the barrier before the next tile overwrites shared memory
    if (!__syncthreads_or(!done)) break;
  }
  if (row_in) out[i] = (row_valid && !dominated) ? 1 : 0;
}

template <int D>
void launch(const float* pts, const uint8_t* valid, uint8_t* out, int n, int dedup,
            cudaStream_t stream) {
  const int blocks = (n + TILE - 1) / TILE;
  nd_mask_kernel<D><<<blocks, TILE, 0, stream>>>(pts, valid, out, n, dedup);
}

}  // namespace

extern "C" {

// points (n, d) float32 row-major, valid (n,) bytes 0/1, out (n,) bytes 0/1.
// Launches on `stream` of device `device`; returns cudaGetLastError().
int nd_mask_launch(const void* points, const void* valid, void* out, int n, int d, int dedup,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaSuccess;
  const float* p = static_cast<const float*>(points);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  uint8_t* o = static_cast<uint8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: launch<1>(p, v, o, n, dedup, s); break;
    case 2: launch<2>(p, v, o, n, dedup, s); break;
    case 3: launch<3>(p, v, o, n, dedup, s); break;
    case 4: launch<4>(p, v, o, n, dedup, s); break;
    case 5: launch<5>(p, v, o, n, dedup, s); break;
    case 6: launch<6>(p, v, o, n, dedup, s); break;
    case 7: launch<7>(p, v, o, n, dedup, s); break;
    case 8: launch<8>(p, v, o, n, dedup, s); break;
    case 9: launch<9>(p, v, o, n, dedup, s); break;
    case 10: launch<10>(p, v, o, n, dedup, s); break;
    case 11: launch<11>(p, v, o, n, dedup, s); break;
    case 12: launch<12>(p, v, o, n, dedup, s); break;
    case 13: launch<13>(p, v, o, n, dedup, s); break;
    case 14: launch<14>(p, v, o, n, dedup, s); break;
    case 15: launch<15>(p, v, o, n, dedup, s); break;
    case 16: launch<16>(p, v, o, n, dedup, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
