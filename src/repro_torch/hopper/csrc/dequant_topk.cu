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
// microsecond at 3.35 TB/s. At the archive path's shard sizes (tens of
// rows) the launch and one block's latency are what remain.
//
// Design: a row holds at most 256 distinct keys, so it is ranked by one
// stable counting pass over its 8-bit key, O(C) work and no compares
// between columns (the earlier design counted C^2 compares per row). A
// block per row, a thread per key:
//  1. every key's value v_b = q_b * (sg * s_row) (q_b = b for uint8,
//     b - 128 for int8), each product one fp32 multiply in that order
//     (__fmul_rn, and the library is built without --use_fast_math), the
//     op order of the TPU kernel and of the eager v4 loader, so the values
//     equal theirs bit for bit;
//  2. keys in descending value order (by q for s >= 0, reversed for
//     s < 0: fl(q * s) is monotone in q) are merged into groups of EQUAL
//     value: the group of a key is the number of value changes before it.
//     Two keys collide when the products round alike (s = 0 after an
//     underflow of sg * s_row, every q; a product that overflows to inf;
//     -0.0 and +0.0), and the reference then ranks them by column, so the
//     pass is keyed on the group, not on q;
//  3. each warp counts the groups of its contiguous range of columns
//     (32 columns a step: __match_any_sync finds the lanes of one group,
//     the lowest of them adds __popc of the set);
//  4. a block scan over the 256 groups gives each group's first rank, and
//     each warp's offset within a group is the counts of the warps before
//     it (they hold earlier columns);
//  5. each warp walks its range again in column order: a column's rank is
//     its warp's running offset for its group plus the lanes of its group
//     below it, so ties go to the lowest column;
//  6. only ranks below k are written, with the column's own value (its
//     key's v_b, so -0.0 stays -0.0).
// NaN compares unequal to itself and would split groups: the callers'
// rows hold no NaN (finite, positive scales). The row's keys are staged
// in shared memory by one block-wide pass first, so the row's loads share
// one memory latency instead of one per warp step.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;              // a thread per key
constexpr int kWarps = kThreads / 32;
constexpr int kMaxC = 12288;               // DEQUANT_MAX_C in hopper/ops.py
constexpr int kNoGroup = 256;              // lanes past the range

template <bool kSigned>
__global__ void __launch_bounds__(kThreads)
dequant_topk_kernel(const uint8_t* __restrict__ q,
                    const float* __restrict__ scales, float sg, int C, int k,
                    float* __restrict__ vals, int* __restrict__ idx) {
  __shared__ float value[256];             // v_b by key
  __shared__ int group[256];               // group by key
  __shared__ int count[kWarps][256];       // per warp and group
  __shared__ int warp_sum[kWarps];
  __shared__ unsigned fresh_bits[kWarps];
  __shared__ uint8_t keys[kMaxC];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint8_t* qr = q + (size_t)blockIdx.x * C;
  const float s = __fmul_rn(sg, scales[blockIdx.x]);

  // the row's keys (uint8 as is, int8 + 128); counts cleared
  for (int c = tid; c < C; c += kThreads)
    keys[c] = kSigned ? (uint8_t)(qr[c] ^ 0x80u) : qr[c];
  for (int e = tid; e < kWarps * 256; e += kThreads) (&count[0][0])[e] = 0;
  // 1. every key's value
  value[tid] = __fmul_rn(kSigned ? (float)(tid - 128) : (float)tid, s);
  __syncthreads();

  // 2. groups of equal value, in descending value order (position p)
  const bool up = !(s < 0.0f);             // value non-decreasing in key
  const int p = tid;
  const int key = up ? 255 - p : p;
  const bool fresh = p > 0 && value[key] != value[up ? key + 1 : key - 1];
  const unsigned bits = __ballot_sync(0xffffffffu, fresh);
  if (lane == 0) fresh_bits[warp] = bits;
  __syncthreads();
  int gk = __popc(bits & (0xffffffffu >> (31 - lane)));
  for (int w = 0; w < warp; ++w) gk += __popc(fresh_bits[w]);
  group[key] = gk;
  __syncthreads();

  // 3. each warp's group counts over its contiguous range of columns
  const int per = (C + kThreads - 1) / kThreads * 32;
  const int c0 = warp * per;
  const int c1 = c0 + per < C ? c0 + per : C;
  for (int base = c0; base < c1; base += 32) {     // uniform over the warp
    const int c = base + lane;
    const int g = c < c1 ? group[keys[c]] : kNoGroup;
    const unsigned peers = __match_any_sync(0xffffffffu, g);
    if (g != kNoGroup && lane == __ffs(peers) - 1)
      count[warp][g] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // 4. first rank of each group (thread tid owns group tid), then each
  //    warp's running offset within the group
  int total = 0;
  for (int w = 0; w < kWarps; ++w) total += count[w][tid];
  int incl = total;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int run = incl - total;
  for (int w = 0; w < warp; ++w) run += warp_sum[w];
  for (int w = 0; w < kWarps; ++w) {
    const int cw = count[w][tid];
    count[w][tid] = run;
    run += cw;
  }
  __syncthreads();

  // 5-6. the stable scatter, column order within each warp's range
  float* vr = vals + (size_t)blockIdx.x * k;
  int* ir = idx + (size_t)blockIdx.x * k;
  const unsigned below = (1u << lane) - 1u;
  for (int base = c0; base < c1; base += 32) {
    const int c = base + lane;
    const int kc = c < c1 ? keys[c] : 0;
    const int g = c < c1 ? group[kc] : kNoGroup;
    const unsigned peers = __match_any_sync(0xffffffffu, g);
    int r = 0;
    if (g != kNoGroup) r = count[warp][g] + __popc(peers & below);
    __syncwarp();
    if (g != kNoGroup) {
      if (r < k) {
        vr[r] = value[kc];
        ir[r] = c;
      }
      if (lane == __ffs(peers) - 1) count[warp][g] += __popc(peers);
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int dequant_topk_launch(const void* q, int is_signed,
                                   const float* scales, float sg, float* vals,
                                   int* idx, int M, int C, int k,
                                   void* stream) {
  if (C < 1 || C > kMaxC || k < 1 || k > C) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* qb = static_cast<const uint8_t*>(q);
  if (is_signed) {
    dequant_topk_kernel<true><<<M, kThreads, 0, st>>>(qb, scales, sg, C, k,
                                                       vals, idx);
  } else {
    dequant_topk_kernel<false><<<M, kThreads, 0, st>>>(qb, scales, sg, C, k,
                                                        vals, idx);
  }
  return (int)cudaGetLastError();
}
