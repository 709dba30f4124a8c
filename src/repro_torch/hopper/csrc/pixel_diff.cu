// Blocked pairwise crop pixel differencing (paper §4.2) on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/pixel_diff.py
// (pixel_match / _kernel): for crops a (Na, D) against references
// b (Nb, D), the lowest index j minimizing mean |a_i - b_j|, kept only when
// that minimum is STRICTLY below the threshold (else -1), and the minimum.
//
// What bounds it on this card: bytes, and at the tracker's shapes the
// launch itself. The redundancy gate matches a few crops against up to
// 512 ring entries of D = 3072 floats: 6.3 MB of b read once for ~3 ops per
// element. The tracker matches ~1-10 crops against ~1-10: a few hundred
// KB, well under a launch's latency.
//
// Design (simple first):
//  * one warp scores one (a_i, b_j) pair at a time: each lane reads 16 bytes
//    of b per step, so a warp reads 512 contiguous bytes; a_i is staged once
//    per block in shared memory;
//  * b's rows are split into contiguous ranges over blockIdx.y so that a
//    handful of crops still spread the 6.3 MB over the whole card; a second
//    tiny kernel merges the per-range (min, argmin) in range order when
//    there is more than one range;
//  * the |a - b| differences are formed in fp32, as everywhere else, but
//    summed in fp64 and rounded to fp32 once (sum / D). The stream's
//    duplicate crops differ by a mean of ~0.02, right at the threshold, and
//    an fp32 sum of 3072 terms moves by ~1e-7 relative with its order; an
//    fp64 sum makes the fp32 mean independent of the order, so this kernel
//    and the CPU version make the same match decisions bit for bit;
//  * rows are walked in increasing order with a strict '<' and the
//    cross-warp / cross-range merges break equal means to the lower index,
//    so ties go to the lowest index like np.argmin.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void keep_lower(float& v, int& i, float ov,
                                           int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// grid (Na, n_split). With n_split == 1 the block writes the final
// (match, min_d); otherwise it writes its range's (min, argmin) partial.
__global__ void __launch_bounds__(kThreads)
pixel_match_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   int* __restrict__ match, float* __restrict__ min_d,
                   float* __restrict__ part_v, int* __restrict__ part_i,
                   int Nb, int D, int rows_per_split, float thr) {
  extern __shared__ float4 a_s4[];           // D / 4
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];

  const int i = blockIdx.x;
  const int D4 = D / 4;
  const float4* a4 = reinterpret_cast<const float4*>(a) + (size_t)i * D4;
  for (int k = threadIdx.x; k < D4; k += kThreads) a_s4[k] = a4[k];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j_lo = blockIdx.y * rows_per_split;
  const int j_hi = min(Nb, j_lo + rows_per_split);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float best = INFINITY;
  int bidx = INT_MAX;
  for (int j = j_lo + warp; j < j_hi; j += kWarps) {
    const float4* row = b4 + (size_t)j * D4;
    double s = 0.0;
    for (int k = lane; k < D4; k += 32) {
      const float4 x = __ldg(row + k);
      const float4 y = a_s4[k];
      s += (double)fabsf(y.x - x.x);
      s += (double)fabsf(y.y - x.y);
      s += (double)fabsf(y.z - x.z);
      s += (double)fabsf(y.w - x.w);
    }
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    const float mean = (float)(s / (double)D);
    if (mean < best) {                       // strict: earlier j keeps ties
      best = mean;
      bidx = j;
    }
  }
  if (lane == 0) {
    red_v[warp] = best;
    red_i[warp] = bidx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = red_v[0];
    int idx = red_i[0];
    for (int w = 1; w < kWarps; ++w) keep_lower(v, idx, red_v[w], red_i[w]);
    if (gridDim.y == 1) {
      min_d[i] = v;
      match[i] = (v < thr) ? idx : -1;
    } else {
      part_v[(size_t)i * gridDim.y + blockIdx.y] = v;
      part_i[(size_t)i * gridDim.y + blockIdx.y] = idx;
    }
  }
}

// One thread per crop: merge the ranges in order (lower ranges hold lower
// indices, so a strict '<' keeps the lowest index), then threshold.
__global__ void pixel_match_merge(const float* __restrict__ part_v,
                                  const int* __restrict__ part_i,
                                  int* __restrict__ match,
                                  float* __restrict__ min_d, int Na,
                                  int n_split, float thr) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Na) return;
  float v = INFINITY;
  int idx = INT_MAX;
  for (int s = 0; s < n_split; ++s) {
    const float pv = part_v[(size_t)i * n_split + s];
    if (pv < v) {
      v = pv;
      idx = part_i[(size_t)i * n_split + s];
    }
  }
  min_d[i] = v;
  match[i] = (v < thr) ? idx : -1;
}

}  // namespace

extern "C" int pixel_match_launch(const float* a, const float* b, int* match,
                                  float* min_d, float* part_v, int* part_i,
                                  int Na, int Nb, int D, int n_split,
                                  float thr, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)D * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(pixel_match_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  const int rows_per_split = (Nb + n_split - 1) / n_split;
  pixel_match_kernel<<<dim3(Na, n_split), kThreads, smem, st>>>(
      a, b, match, min_d, part_v, part_i, Nb, D, rows_per_split, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  pixel_match_merge<<<(Na + 127) / 128, 128, 0, st>>>(
      part_v, part_i, match, min_d, Na, n_split, thr);
  return (int)cudaGetLastError();
}
