// Rank by counting: the per-row top-k body shared by topk.cu and
// dequant_topk.cu.
//
// A block holds one row of C fp32 values in shared memory. Each thread
// takes up to kPer columns c and counts
//   rank(c) = #{j : v_j > v_c or (v_j == v_c and j < c)},
// which is a permutation of 0..C-1 whatever the ties, so each output slot
// r < k is written exactly once, by the column of rank r: descending
// values, ties to the LOWEST column, exact and deterministic, with no
// sentinel and no second pass. Every thread reads the same v_j at the same
// step, a shared-memory broadcast. The cost is C^2 compares per row (~1e6
// at C = 1000), so the body is paced by its instructions, not its bytes.
// NaN compares false both ways and would break the permutation: the
// callers' rows hold no NaN (probabilities, dequantized ranks).
#pragma once

#include <cstddef>

namespace hopper {

constexpr int kRankThreads = 256;
constexpr int kRankPer = 4;                  // columns per thread per pass
constexpr int kRankMaxC = 48 * 1024 / 4;     // fp32 row in 48 KB of smem

// v: the row in shared memory (C values, written and synchronised by the
// caller); vr, ir: the row's k output slots in device memory.
__device__ __forceinline__ void rank_topk_row(const float* v, int C, int k,
                                              float* __restrict__ vr,
                                              int* __restrict__ ir) {
  for (int base = 0; base < C; base += kRankThreads * kRankPer) {
    int cc[kRankPer];
    float vc[kRankPer];
    int rank[kRankPer];
#pragma unroll
    for (int t = 0; t < kRankPer; ++t) {
      cc[t] = base + t * kRankThreads + threadIdx.x;
      vc[t] = cc[t] < C ? v[cc[t]] : 0.0f;
      rank[t] = 0;
    }
#pragma unroll 4
    for (int j = 0; j < C; ++j) {
      const float vj = v[j];
#pragma unroll
      for (int t = 0; t < kRankPer; ++t)
        rank[t] += (vj > vc[t]) | ((vj == vc[t]) & (j < cc[t]));
    }
#pragma unroll
    for (int t = 0; t < kRankPer; ++t) {
      if (cc[t] < C && rank[t] < k) {
        vr[rank[t]] = vc[t];
        ir[rank[t]] = cc[t];
      }
    }
  }
}

}  // namespace hopper
