// Blocked pairwise crop pixel differencing (paper §4.2) on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/pixel_diff.py
// (pixel_match / _kernel): for crops a (Na, D) against references
// b (Nb, D), the lowest index j minimizing mean |a_i - b_j|, kept only when
// that minimum is STRICTLY below the threshold (else -1), and the minimum.
// Generalised to row ranges: row i searches only b's rows [lo[i], hi[i])
// (clamped to [0, Nb); null lo/hi mean [0, Nb) for every row), and its
// match is the absolute index of the lowest minimiser there. An empty
// range gives -1 and inf. a may be a view into b's buffer.
//
// What bounds it on this card: bytes, and the launch. The pixel tracker
// matches a window of up to 8192 crops, each against the few crops of its
// previous frame: ~90 MB of crops read once, ~0.03 ms at 3.35 TB/s. The
// redundancy gate matches a few crops against up to 512 ring entries of
// D = 3072 floats: 6.3 MB of b read once for ~3 ops per element.
//
// Design:
//  * one launch per call: the tracker batches a window of frames into one
//    call (one range per crop: the rows of its previous frame), so the
//    launch and the host's sync are paid per window, not per frame;
//  * one warp scores one (a_i, b_j) pair at a time: each lane reads 16 bytes
//    of b per step, so a warp reads 512 contiguous bytes; a_i is staged once
//    per block in shared memory;
//  * a long range is split into contiguous chunks over blockIdx.y so that a
//    handful of crops still spread the gate's 6.3 MB over the whole card.
//    The chunks merge inside the same launch: each block folds its
//    (mean, j) into one 64-bit key per row with atomicMin (means are
//    >= +0.0, so their bits order as unsigned, and the lower j wins equal
//    means), and the last block of the row to arrive (a counter, after
//    __threadfence) applies the threshold. The launcher sets keys and
//    counters with one cudaMemsetAsync;
//  * the |a - b| differences are formed in fp32, as everywhere else, but
//    summed in fp64 and rounded to fp32 once (sum / D). The stream's
//    duplicate crops differ by a mean of ~0.02, right at the threshold, and
//    an fp32 sum of 3072 terms moves by ~1e-7 relative with its order; an
//    fp64 sum makes the fp32 mean independent of the order, so this kernel
//    and the CPU version make the same match decisions bit for bit;
//  * rows are walked in increasing order with a strict '<' and every merge
//    breaks equal means to the lower index, so ties go to the lowest index
//    like np.argmin.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned long long kNoKey = ~0ull;   // memset 0xFF: no candidate

__device__ __forceinline__ void keep_lower(float& v, int& i, float ov,
                                           int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void finish(int* match, float* min_d, int i,
                                       float v, int idx, float thr) {
  min_d[i] = v;
  match[i] = (v < thr) ? idx : -1;
}

// grid (Na, n_split). keys/counts are used only when n_split > 1: keys
// start at kNoKey and counts at -1 (both all bits set).
__global__ void __launch_bounds__(kThreads)
pixel_match_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const int* __restrict__ lo, const int* __restrict__ hi,
                   int* __restrict__ match, float* __restrict__ min_d,
                   unsigned long long* keys, int* counts, int Nb, int D,
                   float thr) {
  extern __shared__ float4 a_s4[];           // D / 4
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];

  const int i = blockIdx.x;
  const int r_lo = lo ? max(lo[i], 0) : 0;
  const int r_hi = hi ? min(hi[i], Nb) : Nb;
  const int len = max(r_hi - r_lo, 0);
  const int chunk = (len + gridDim.y - 1) / gridDim.y;
  const int j_lo = r_lo + blockIdx.y * chunk;
  const int j_hi = min(r_hi, j_lo + chunk);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int D4 = D / 4;
  float best = INFINITY;
  int bidx = INT_MAX;
  if (j_lo < j_hi) {                         // uniform over the block
    const float4* a4 = reinterpret_cast<const float4*>(a) + (size_t)i * D4;
    for (int k = threadIdx.x; k < D4; k += kThreads) a_s4[k] = a4[k];
    __syncthreads();
    const float4* b4 = reinterpret_cast<const float4*>(b);
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
      if (mean < best) {                     // strict: earlier j keeps ties
        best = mean;
        bidx = j;
      }
    }
  }
  if (lane == 0) {
    red_v[warp] = best;
    red_i[warp] = bidx;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float v = red_v[0];
  int idx = red_i[0];
  for (int w = 1; w < kWarps; ++w) keep_lower(v, idx, red_v[w], red_i[w]);
  if (gridDim.y == 1) {
    finish(match, min_d, i, v, idx, thr);
    return;
  }
  if (idx != INT_MAX)
    atomicMin(keys + i, ((unsigned long long)__float_as_uint(v) << 32) |
                            (unsigned)idx);
  __threadfence();                           // the key before the count
  if (atomicAdd(counts + i, 1) != (int)gridDim.y - 2) return;
  __threadfence();                           // every chunk has folded in
  const unsigned long long key =
      *reinterpret_cast<volatile unsigned long long*>(keys + i);
  if (key == kNoKey)
    finish(match, min_d, i, INFINITY, -1, thr);
  else
    finish(match, min_d, i, __uint_as_float((unsigned)(key >> 32)),
           (int)(key & 0xffffffffu), thr);
}

}  // namespace

// scratch: Na 64-bit keys followed by Na int counts, set here when
// n_split > 1 (may be null otherwise); lo/hi may be null together.
extern "C" int pixel_match_launch(const float* a, const float* b,
                                  const int* lo, const int* hi, int* match,
                                  float* min_d, void* scratch, int Na, int Nb,
                                  int D, int n_split, float thr,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)D * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pixel_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  unsigned long long* keys = nullptr;
  int* counts = nullptr;
  if (n_split > 1) {
    keys = static_cast<unsigned long long*>(scratch);
    counts = reinterpret_cast<int*>(keys + Na);
    cudaError_t err = cudaMemsetAsync(
        scratch, 0xFF, (size_t)Na * (sizeof(*keys) + sizeof(*counts)), st);
    if (err != cudaSuccess) return (int)err;
  }
  pixel_match_kernel<<<dim3(Na, n_split), kThreads, smem, st>>>(
      a, b, lo, hi, match, min_d, keys, counts, Nb, D, thr);
  return (int)cudaGetLastError();
}
