// Per-row top-k of fp32 class probabilities (the fused ingest megastep's
// top-K) on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/topk_mask.py (topk /
// _kernel): for x (B, C) fp32, the k largest values of each row,
// descending, with ties to the LOWEST column, and their columns. The
// values are the input bits, untouched.
//
// What bounds it on this card: bytes. One megastep's batch is B = 512 rows
// of C = 1000 classes (2 MB in) and, at the path's k = min(K, C) = 1000,
// (B, k) f32 values plus i32 indices out (4 MB): under 2 us at 3.35 TB/s.
// A sort of the row does C log^2 C compare-exchanges (~55 rounds of 1024
// at C = 1000), all in registers and shared memory, so the instructions
// stay near the bytes; the counting rank it replaces did C^2 compares
// per row (~5e8 per batch) and was paced by them.
//
// Design: a bitonic sort of one row per block.
//  * each column becomes one 64-bit key (~ordered(v) << 32) | col, where
//    ordered() maps fp32 bits to an unsigned order (sign bit flipped for
//    positives, all bits for negatives) and -0.0 is first made +0.0: the
//    JAX kernel compares with ==, so the two zeros tie. Ascending keys are
//    then descending values with ties to the lowest column, and no two
//    keys are equal, so the order is total and the result exact. The
//    value written is read back from x at the key's column, so its bits
//    (a -0.0 too) are the input's;
//  * the row is padded to N, the next power of two (at least 32), with
//    keys of all ones, which sort last (a real key has col < 2^31);
//  * T = clamp(N / 4, 32, 1024) threads hold E = N / T keys each in
//    registers, key i at thread i % T, register i / T. A compare-exchange
//    at stride j then runs inside a thread for j >= T, through shared
//    memory (N keys, 8 KB at C = 1000, 128 KB at C = 12288, so the launch
//    raises the block's limit above 48 KB and returns the error if that is
//    refused) for 32 <= j < T, and between the lanes of a warp with
//    __shfl_xor_sync for j < 32;
//  * one block per row: 512 blocks of 256 threads at the path's shape, one
//    wave on 132 SMs; the first k keys are written coalesced.
// NaN has no place in the order: the callers' rows hold none.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxC = 12288;             // ops.TOPK_MAX_C: N <= 16384
constexpr uint64_t kPadKey = ~0ull;

__device__ __forceinline__ uint64_t make_key(float v, int col) {
  uint32_t u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;          // -0.0 ties with +0.0
  const uint32_t ordered = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((uint64_t)(~ordered) << 32) | (uint32_t)col;
}

// the lower index of a pair keeps the smaller key where the run ascends
__device__ __forceinline__ uint64_t pick(uint64_t mine, uint64_t other,
                                         bool keep_min) {
  return keep_min ? min(mine, other) : max(mine, other);
}

template <int E>
__global__ void __launch_bounds__(1024)
topk_sort_kernel(const float* __restrict__ x, int C, int k,
                 float* __restrict__ vals, int* __restrict__ idx) {
  extern __shared__ uint64_t skey[];     // N = E * T keys
  const int T = blockDim.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const int N = E * T;
  const float* xr = x + (size_t)blockIdx.x * C;

  uint64_t r[E];
#pragma unroll
  for (int t = 0; t < E; ++t) {
    const int i = t * T + tid;
    r[t] = i < C ? make_key(xr[i], i) : kPadKey;
  }

  for (int size = 2; size <= N; size <<= 1) {
    // strides j = jt * T >= T: both keys of a pair in this thread
#pragma unroll
    for (int jt = E / 2; jt >= 1; jt >>= 1) {
      if (jt * T < size) {
#pragma unroll
        for (int t = 0; t < E; ++t) {
          if ((t & jt) == 0) {
            const bool asc = ((t * T + tid) & size) == 0;
            const uint64_t a = r[t], b = r[t | jt];
            r[t] = asc ? min(a, b) : max(a, b);
            r[t | jt] = asc ? max(a, b) : min(a, b);
          }
        }
      }
    }
    // strides 32 <= j < T: through shared memory
    for (int j = min(size, T) >> 1; j >= 32; j >>= 1) {
#pragma unroll
      for (int t = 0; t < E; ++t) skey[t * T + tid] = r[t];
      __syncthreads();
#pragma unroll
      for (int t = 0; t < E; ++t) {
        const int i = t * T + tid;
        const uint64_t other = skey[t * T + (tid ^ j)];
        r[t] = pick(r[t], other, ((i & j) == 0) == ((i & size) == 0));
      }
      __syncthreads();                   // read before the next write
    }
    // strides j < 32: between the lanes of a warp
    for (int j = min(size >> 1, 16); j >= 1; j >>= 1) {
      const bool lower = (lane & j) == 0;
#pragma unroll
      for (int t = 0; t < E; ++t) {
        const uint64_t other = __shfl_xor_sync(0xffffffffu, r[t], j);
        r[t] = pick(r[t], other, lower == (((t * T + tid) & size) == 0));
      }
    }
  }

  float* vr = vals + (size_t)blockIdx.x * k;
  int* ir = idx + (size_t)blockIdx.x * k;
#pragma unroll
  for (int t = 0; t < E; ++t) {
    const int s = t * T + tid;
    if (s < k) {
      const int col = (int)(uint32_t)r[t];
      vr[s] = xr[col];
      ir[s] = col;
    }
  }
}

template <int E>
int launch(const float* x, float* vals, int* idx, int B, int C, int k,
           int T, cudaStream_t st) {
  const size_t smem = sizeof(uint64_t) * (size_t)E * T;
  auto kern = topk_sort_kernel<E>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<B, T, smem, st>>>(x, C, k, vals, idx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int topk_launch(const float* x, float* vals, int* idx, int B,
                           int C, int k, void* stream) {
  if (B < 1 || C < 1 || C > kMaxC || k < 1 || k > C)
    return (int)cudaErrorInvalidValue;
  int N = 32;
  while (N < C) N <<= 1;
  const int T = min(1024, max(32, N / 4));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N / T) {
    case 1: return launch<1>(x, vals, idx, B, C, k, T, st);
    case 2: return launch<2>(x, vals, idx, B, C, k, T, st);
    case 4: return launch<4>(x, vals, idx, B, C, k, T, st);
    case 8: return launch<8>(x, vals, idx, B, C, k, T, st);
    case 16: return launch<16>(x, vals, idx, B, C, k, T, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
