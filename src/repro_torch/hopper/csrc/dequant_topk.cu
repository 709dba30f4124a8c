// Fused int8/uint8 dequant + per-row top-k (the archive's lazy rank path
// over v4 shards) on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/dequant_topk.py
// (dequant_topk / _kernel): for quantized rows q (M, C) with per-row
// scales s (M,) and a format-level multiplier sg, the k largest values of
// q * (sg * s_row), descending, with ties to the LOWEST column, and their
// columns.
//
// What bounds it on this card: bytes. The work is one sealed shard's
// quantized mean-prob matrix, a few hundred rows of C = 1000 uint8 (well
// under 1 MB in), and (M, k) f32 values plus i32 indices out, 8 bytes per
// ranked entry: at k = C the outputs are 8x the inputs, a few MB, about a
// microsecond at 3.35 TB/s. The design below does C^2 compares per row
// instead of a sort's C log C, so it is paced by its instructions (tens of
// microseconds per shard), not by the bytes; it runs once per shard
// residency, so exactness came first.
//
// Design (simple and exact first):
//  * one block per row; the row is dequantized once into shared memory as
//    fp32 (C = 1000 is 4 KB; C above kRankMaxC, 48 KB of fp32, is refused
//    by the wrapper rather than served another way). The TPU kernel's k
//    passes of max-extract-and-mask are not carried over: they are k
//    sequential block reductions;
//  * rank by counting (rank_topk.cuh, shared with topk.cu): quantization
//    makes many ties, and the rank count sends them to the lowest column
//    exactly, with no sentinel and no second pass;
//  * the scale is sg * s_row and the value q * scale, each one fp32
//    multiply in that order (__fmul_rn, and the library is built without
//    --use_fast_math), which is the op order of the TPU kernel and of the
//    eager v4 loader, so the values equal theirs bit for bit.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "rank_topk.cuh"

namespace {

using hopper::kRankMaxC;
using hopper::kRankThreads;

template <typename T>
__global__ void __launch_bounds__(kRankThreads)
dequant_topk_kernel(const T* __restrict__ q, const float* __restrict__ scales,
                    float sg, int C, int k, float* __restrict__ vals,
                    int* __restrict__ idx) {
  extern __shared__ float v[];               // C
  const int row = blockIdx.x;
  const T* qr = q + (size_t)row * C;
  const float s = __fmul_rn(sg, scales[row]);
  for (int c = threadIdx.x; c < C; c += kRankThreads)
    v[c] = __fmul_rn((float)qr[c], s);
  __syncthreads();
  hopper::rank_topk_row(v, C, k, vals + (size_t)row * k,
                        idx + (size_t)row * k);
}

}  // namespace

extern "C" int dequant_topk_launch(const void* q, int is_signed,
                                   const float* scales, float sg, float* vals,
                                   int* idx, int M, int C, int k,
                                   void* stream) {
  if (C > kRankMaxC) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)C * sizeof(float);
  if (is_signed) {
    dequant_topk_kernel<int8_t><<<M, kRankThreads, smem, st>>>(
        static_cast<const int8_t*>(q), scales, sg, C, k, vals, idx);
  } else {
    dequant_topk_kernel<uint8_t><<<M, kRankThreads, smem, st>>>(
        static_cast<const uint8_t*>(q), scales, sg, C, k, vals, idx);
  }
  return (int)cudaGetLastError();
}
