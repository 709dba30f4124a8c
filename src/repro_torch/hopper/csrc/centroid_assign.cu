// Nearest-centroid assignment for Focus clustering (paper §4.2) on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/centroid_assign.py
// (_kernel / _assign_impl): for feats (B, D) and centroids (M, D), the
// squared L2 distance to the nearest centroid, its lowest index, and the
// fused ``matched = d2 <= T^2`` mask.
//
// What bounds it on this card: operations. On the ingest path B = 512,
// M = 4096, D = 128: 2*B*M*D = 0.54 GFLOP against 2 MiB of centroids and
// 256 KiB of features, about 200 FLOP per byte, far above the H100's
// fp32 ridge. The cross term f.c stays in fp32 FMA on the CUDA cores and
// never goes to the TF32 tensor cores: the argmin and the matched mask
// are an exact contract (the clustering decisions, and through them the
// saved index bytes, depend on them), and TF32 keeps only ~3 digits.
//
// Design (simple first; a wgmma/TMA version is later work):
//  * one block owns kRows feature rows, staged once in shared memory, and
//    walks all M centroids in tiles of kThreads: thread t scores centroid
//    m0 + t against every row of the block, reading its centroid row with
//    16-byte loads and the feature rows as shared-memory broadcasts;
//  * the online argmin runs on the partial score |c|^2 - 2 f.c (|f|^2 is
//    constant per row, so the argmin is unchanged) and |f|^2 is added back
//    once at the end, as the TPU kernel does;
//  * each thread sees its centroids in increasing order and keeps a strict
//    '<', and the cross-thread reduction breaks equal scores to the lower
//    index, so ties go to the lowest index like jnp.argmin;
//  * the ragged M edge is masked in the kernel. The TPU kernel padded with
//    3e18 rows, whose |c|^2 overflows fp32 to inf at D = 128.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>

namespace {

constexpr int kRows = 8;        // feature rows per block
constexpr int kThreads = 256;   // centroids scored per tile (one per thread)
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void keep_lower(float& v, int& i, float ov,
                                           int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kThreads)
centroid_assign_kernel(const float* __restrict__ feats,
                       const float* __restrict__ cents,
                       float* __restrict__ min_d2, int* __restrict__ argmin,
                       bool* __restrict__ matched, int B, int M, int D,
                       float t2) {
  extern __shared__ float4 f_s4[];          // kRows * D / 4
  __shared__ float red_v[kRows][kWarps];
  __shared__ int red_i[kRows][kWarps];

  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, B - row0);
  const int D4 = D / 4;
  const float4* feats4 = reinterpret_cast<const float4*>(feats);
  for (int k = threadIdx.x; k < kRows * D4; k += kThreads) {
    const int r = k / D4;
    f_s4[k] = (r < nrows) ? feats4[(size_t)(row0 + r) * D4 + (k % D4)]
                          : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  float best[kRows];
  int bidx[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    best[r] = INFINITY;
    bidx[r] = INT_MAX;
  }

  const float4* cents4 = reinterpret_cast<const float4*>(cents);
  for (int m0 = 0; m0 < M; m0 += kThreads) {
    const int m = m0 + threadIdx.x;
    if (m >= M) break;                     // ragged edge: masked, not padded
    const float4* c4 = cents4 + (size_t)m * D4;
    float dot[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) dot[r] = 0.f;
    float cn = 0.f;
    for (int d = 0; d < D4; ++d) {
      const float4 c = __ldg(c4 + d);
      cn = fmaf(c.x, c.x, cn);
      cn = fmaf(c.y, c.y, cn);
      cn = fmaf(c.z, c.z, cn);
      cn = fmaf(c.w, c.w, cn);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 f = f_s4[r * D4 + d];
        dot[r] = fmaf(f.x, c.x, dot[r]);
        dot[r] = fmaf(f.y, c.y, dot[r]);
        dot[r] = fmaf(f.z, c.z, dot[r]);
        dot[r] = fmaf(f.w, c.w, dot[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float part = cn - 2.f * dot[r];
      if (part < best[r]) {                // strict: earlier m keeps ties
        best[r] = part;
        bidx[r] = m;
      }
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float v = best[r];
    int i = bidx[r];
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, i, off);
      keep_lower(v, i, ov, oi);
    }
    if (lane == 0) {
      red_v[r][warp] = v;
      red_i[r][warp] = i;
    }
  }
  __syncthreads();

  if (threadIdx.x < nrows) {
    const int r = threadIdx.x;
    float v = red_v[r][0];
    int i = red_i[r][0];
    for (int w = 1; w < kWarps; ++w) keep_lower(v, i, red_v[r][w], red_i[r][w]);
    if (i == INT_MAX) i = 0;               // no finite score: index 0, as on TPU
    const float* f = reinterpret_cast<const float*>(f_s4) + r * D;
    float fn = 0.f;
    for (int d = 0; d < D; ++d) fn = fmaf(f[d], f[d], fn);
    const float d2 = v + fn;
    min_d2[row0 + r] = d2;
    argmin[row0 + r] = i;
    matched[row0 + r] = d2 <= t2;
  }
}

}  // namespace

extern "C" int centroid_assign_launch(const float* feats, const float* cents,
                                      float* min_d2, int* argmin,
                                      bool* matched, int B, int M, int D,
                                      float t2, void* stream) {
  const size_t smem = (size_t)kRows * D * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(centroid_assign_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  const int grid = (B + kRows - 1) / kRows;
  centroid_assign_kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      feats, cents, min_d2, argmin, matched, B, M, D, t2);
  return (int)cudaGetLastError();
}
