// Per-row top-k of fp32 class probabilities (the fused ingest megastep's
// top-K) on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/topk_mask.py (topk /
// _kernel): for x (B, C) fp32, the k largest values of each row,
// descending, with ties to the LOWEST column, and their columns. The
// values are the input bits, untouched.
//
// What bounds it on this card: bytes, in principle. One megastep's batch
// is B = 512 rows of C = 1000 classes (2 MB in) and, at the path's
// k = min(K, C) = 1000, (B, k) f32 values plus i32 indices out (4 MB):
// under 2 us at 3.35 TB/s. The design below does C^2 compares per row
// instead of a sort's C log C, so it is paced by its instructions (~5e8
// compares per batch, tens of microseconds), not by the bytes; beside the
// batch's CNN forward and clustering that is small, so exactness came
// first.
//
// Design (simple and exact first):
//  * one block per row, the row copied once into shared memory (C = 1000
//    is 4 KB; C above kRankMaxC, 48 KB of fp32, is refused by the wrapper
//    rather than served another way);
//  * the TPU kernel makes k passes of max-extract-and-mask over a VMEM
//    tile, masking taken entries with a -3e38 sentinel. At k = C = 1000
//    that is 1000 sequential block reductions per row, and the sentinel
//    ties with inputs at or below it. Instead the block ranks by counting
//    (rank_topk.cuh, shared with dequant_topk.cu): each column's rank is
//    #{j : v_j > v_c or (v_j == v_c and j < c)}, a permutation whatever
//    the ties, and the column writes slot rank when rank < k. Exact,
//    deterministic, no sentinel, one pass.
#include <cuda_runtime.h>

#include <cstddef>

#include "rank_topk.cuh"

namespace {

using hopper::kRankMaxC;
using hopper::kRankThreads;

__global__ void __launch_bounds__(kRankThreads)
topk_kernel(const float* __restrict__ x, int C, int k,
            float* __restrict__ vals, int* __restrict__ idx) {
  extern __shared__ float v[];               // C
  const int row = blockIdx.x;
  const float* xr = x + (size_t)row * C;
  for (int c = threadIdx.x; c < C; c += kRankThreads) v[c] = xr[c];
  __syncthreads();
  hopper::rank_topk_row(v, C, k, vals + (size_t)row * k,
                        idx + (size_t)row * k);
}

}  // namespace

extern "C" int topk_launch(const float* x, float* vals, int* idx, int B,
                           int C, int k, void* stream) {
  if (C > kRankMaxC) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  topk_kernel<<<B, kRankThreads, (size_t)C * sizeof(float), st>>>(
      x, C, k, vals, idx);
  return (int)cudaGetLastError();
}
