// Fused frame-difference motion gate (paper §6.1 background subtraction)
// on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/frame_gate.py
// (motion_gate / _kernel): for one frame f and the background model bg,
// both (H, W, 3) fp32,
//   * new_bg = (1 - alpha) * bg + alpha * f over EVERY pixel, remainder
//     rows and columns included;
//   * tiles (H/t, W/t): the mean of |f - bg| over each complete t x t tile
//     and its 3 channels (remainder rows and columns belong to no tile);
//   * hot = tiles > thr, strict.
//
// What bounds it on this card: bytes. It reads f and bg once and writes
// new_bg once, 12 bytes of traffic per value for ~5 operations: a 128 x 128
// frame moves 0.59 MB (0.18 us at 3.35 TB/s), a 720p frame 33 MB (~10 us).
// At the stream's 128 x 128 the launch itself costs more than the bytes.
//
// Design (simple and exact first):
//  * one launch per frame does both jobs. Every thread walks the H*W*3
//    values grid-stride for the EMA (coalesced), and thread g < ty*tx also
//    sums tile g in a fixed order (row by row, each row's 3t contiguous
//    values left to right). The TPU kernel walks row blocks in order on
//    one core; here the tiles are independent, so no carry between blocks
//    is needed;
//  * the EMA rounds each product and the sum separately (__fmul_rn,
//    __fadd_rn, and 1 - alpha with __fsub_rn): nvcc would otherwise
//    contract it into one FMA, and new_bg would no longer equal the plain
//    PyTorch version bit for bit;
//  * |f - bg| is formed in fp32 and summed in fp64, then divided by 3t^2
//    and rounded to fp32 once, the rule pixel_diff.cu follows. For frame
//    data (values in [0, 1], each 0 or at least 2^-20, tiles up to 16 x 16)
//    every difference is a multiple of 2^-43 below 1 and the sum stays
//    below 2^10, so the fp64 sum is exact in any order: the tile mean, and
//    a hot decision next to the threshold, do not depend on the order of
//    the sum, and the card and the CPU decide alike. (The TPU kernel rounds
//    the channel mean to fp32 first and sums the tile in fp32; the two
//    agree to 1e-6.)
//  * alpha and thr arrive by value as fp32, so a per-stream gate tuning
//    neither rebuilds nor synchronises.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 2048;           // grid-stride cap for the EMA

__global__ void __launch_bounds__(kThreads)
motion_gate_kernel(const float* __restrict__ f, const float* __restrict__ bg,
                   float* __restrict__ new_bg, float* __restrict__ tiles,
                   bool* __restrict__ hot, size_t n, int W, int t, int ty,
                   int tx, float alpha, float thr) {
  const size_t gid = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * kThreads;
  const float keep = __fsub_rn(1.0f, alpha);
  for (size_t e = gid; e < n; e += stride) {
    new_bg[e] = __fadd_rn(__fmul_rn(keep, __ldg(bg + e)),
                          __fmul_rn(alpha, __ldg(f + e)));
  }
  if (gid < (size_t)ty * tx) {
    const int i = (int)(gid / tx);
    const int j = (int)(gid % tx);
    const int row_len = 3 * t;
    double s = 0.0;
    for (int y = i * t; y < (i + 1) * t; ++y) {
      const size_t base = ((size_t)y * W + (size_t)j * t) * 3;
      for (int k = 0; k < row_len; ++k) {
        s += (double)fabsf(__fsub_rn(__ldg(f + base + k),
                                     __ldg(bg + base + k)));
      }
    }
    const float m = __double2float_rn(s / (double)(3 * t * t));
    tiles[gid] = m;
    hot[gid] = m > thr;
  }
}

}  // namespace

extern "C" int motion_gate_launch(const float* frame, const float* bg,
                                  float* new_bg, float* tiles, bool* hot,
                                  int H, int W, int t, float alpha, float thr,
                                  void* stream) {
  if (H < 1 || W < 1 || t < 1) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)H * W * 3;
  const int ty = H / t, tx = W / t;
  const size_t n_tiles = (size_t)ty * tx;
  size_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const size_t tile_blocks = (n_tiles + kThreads - 1) / kThreads;
  if (tile_blocks > blocks) blocks = tile_blocks;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  motion_gate_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      frame, bg, new_bg, tiles, hot, n, W, t, ty, tx, alpha, thr);
  return (int)cudaGetLastError();
}
