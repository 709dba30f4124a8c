// Fused frame-difference motion gate (paper §6.1 background subtraction)
// on Hopper, over a window of N frames in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/frame_gate.py
// (motion_gate / _kernel), which takes one frame per call. For frames
// f_0 .. f_{N-1} and the background model bg_0, all (H, W, 3) fp32, frame
// n gives
//   * tiles[n] (H/t, W/t): the mean of |f_n - bg_n| over each complete
//     t x t tile and its 3 channels (remainder rows and columns belong to
//     no tile);
//   * hot[n] = tiles[n] > thr, strict;
//   * bg_{n+1} = (1 - alpha) * bg_n + alpha * f_n over EVERY pixel,
//     remainder rows and columns included;
// and new_bg is bg_N: the N single-frame steps, in order, bit for bit.
//
// What bounds it on this card: bytes. A window reads its frames once, bg
// once, and writes new_bg once plus 5 bytes per tile and frame: a
// 128 x 128 frame is 0.2 MB (0.06 us at 3.35 TB/s), a 720p frame 11 MB
// (3.3 us). One launch per frame (the earlier design) cost more than the
// bytes at 128 x 128, and one thread per tile summed its 3t^2 values
// serially.
//
// Design:
//  * the EMA is a recursion per value, so frames serialise within a value;
//    the kernel parallelises over tiles and values instead. A group of G
//    threads (a power of two, G <= 256) owns one tile, each thread up to
//    kMaxV of its values (k = lane + m*G in the tile's row-major order).
//    A thread keeps its values' background in registers across the
//    window, reads each frame once, and writes new_bg once at the end;
//  * at the stream's 128 x 128 there are only 256 tiles (8192 threads), so
//    one frame's loads cannot cover the memory latency: each thread keeps
//    the next A = kDeepAhead frames' values in registers, and the load of
//    frame n + A is issued as soon as frame n is consumed. Where the
//    tiles alone fill the card (720p: 14,400 tiles, 460,800 threads) the
//    registers buy more resident threads instead: A = kShallowAhead;
//  * each tile's |f - bg| is summed in fp64: a thread's values in order,
//    then a shuffle tree over the group's lanes and, for G > 32, the
//    group's warps in order through shared memory;
//  * tiles of more than kMaxV * 256 values (t > 26) take a block each
//    (kBigThreads threads) and keep the background in new_bg instead of
//    registers: each value is owned by one thread, which reads and writes
//    only its own values, so no barrier guards them;
//  * values outside every tile (remainder rows and columns) take the
//    blocks after the tile blocks: one value per thread, walked across
//    the window;
//  * the EMA rounds each product and the sum separately (__fmul_rn,
//    __fadd_rn, and 1 - alpha with __fsub_rn): nvcc would otherwise
//    contract it into one FMA, and new_bg would no longer equal the plain
//    PyTorch version bit for bit;
//  * |f - bg| is formed in fp32 and summed in fp64, then divided by 3t^2
//    and rounded to fp32 once, the rule pixel_diff.cu follows. For frame
//    data (values in [0, 1], each 0 or at least 2^-20, tiles up to 16 x 16)
//    every difference is a multiple of 2^-43 below 1 and the sum stays
//    below 2^10, so the fp64 sum is exact in any order: the tree above
//    gives the plain version's tile mean, and a hot decision next to the
//    threshold does not depend on the order of the sum, so the card and
//    the CPU decide alike. (The TPU kernel rounds the channel mean to fp32
//    first and sums the tile in fp32; the two agree to 1e-6.)
//  * alpha and thr arrive by value as fp32, so a per-stream gate tuning
//    neither rebuilds nor synchronises.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxV = 8;          // values of its tile a thread keeps
constexpr int kDeepAhead = 8;     // frames in flight, few tiles
constexpr int kShallowAhead = 2;  // frames in flight, tiles fill the card
constexpr long long kFillThreads = 65536;  // tile threads that fill it
constexpr int kMaxGroup = 256;    // threads per tile on the register path
constexpr int kBigThreads = 256;  // threads per tile on the big-tile path
constexpr int kMinThreads = 64;   // block size floor on the register path
constexpr int kMaxRemBlocks = 1024;

struct Geometry {
  int N, W, t, ty, tx, G, tile_blocks;
  unsigned plane;                 // H * W * 3 values per frame
  unsigned rem_right;             // values right of the tiles, rows < ty*t
  unsigned rem;                   // all values outside every tile
};

__device__ __forceinline__ float ema(float keep, float alpha, float b,
                                     float x) {
  return __fadd_rn(__fmul_rn(keep, b), __fmul_rn(alpha, x));
}

// Offset in a frame of value k (row-major over t rows of 3t values) of
// tile (i, j).
__device__ __forceinline__ unsigned tile_offset(const Geometry& g, int i,
                                                int j, int k) {
  const int row_len = 3 * g.t;
  return ((unsigned)(i * g.t + k / row_len) * g.W + (unsigned)(j * g.t)) * 3
         + k % row_len;
}

// The sum over a group of G threads (G a power of two, aligned in the
// block), returned to the group's first thread. Every thread of the block
// calls it the same number of times; for G > 32 it holds one barrier,
// and ``parity`` alternates the shared slots between consecutive calls.
__device__ __forceinline__ double group_sum(double s, int G, double* part,
                                           int parity) {
  for (int o = (G < 32 ? G : 32) / 2; o > 0; o >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, o);
  if (G <= 32) return s;
  double* pp = part + parity * (kMaxGroup / 32);
  if ((threadIdx.x & 31) == 0) pp[threadIdx.x >> 5] = s;
  __syncthreads();
  const int first = (threadIdx.x / G) * (G / 32);
  double t = 0.0;
  for (int w = 0; w < G / 32; ++w) t += pp[first + w];
  return t;
}

__device__ __forceinline__ void emit_tile(const Geometry& g, int n,
                                          int tile, double s,
                                          float* __restrict__ tiles,
                                          bool* __restrict__ hot,
                                          float thr) {
  const float m = __double2float_rn(s / (double)(3 * g.t * g.t));
  const size_t o = (size_t)n * g.ty * g.tx + tile;
  tiles[o] = m;
  hot[o] = m > thr;
}

// The register path: a group of G threads per tile, V values a thread,
// A frames' loads in flight.
template <int V, int A>
__device__ void tile_role(const float* __restrict__ f,
                          const float* __restrict__ bg,
                          float* __restrict__ nb, float* __restrict__ tiles,
                          bool* __restrict__ hot, const Geometry& g,
                          float keep, float alpha, float thr) {
  __shared__ double part[2 * kMaxGroup / 32];
  const int G = g.G;
  const int lane = threadIdx.x & (G - 1);
  const int tile = blockIdx.x * (blockDim.x / G) + threadIdx.x / G;
  const bool live = tile < g.ty * g.tx;
  const int i = live ? tile / g.tx : 0, j = live ? tile % g.tx : 0;
  const int P = 3 * g.t * g.t;
  unsigned off[V];
  bool has[V];
  float b[V];
#pragma unroll
  for (int m = 0; m < V; ++m) {
    const int k = lane + m * G;
    has[m] = live && k < P;
    off[m] = has[m] ? tile_offset(g, i, j, k) : 0u;
    b[m] = has[m] ? __ldg(bg + off[m]) : 0.0f;
  }
  float x[A][V];
#pragma unroll
  for (int u = 0; u < A; ++u) {
    const float* fn = f + (size_t)u * g.plane;
#pragma unroll
    for (int m = 0; m < V; ++m)
      x[u][m] = (u < g.N && has[m]) ? __ldg(fn + off[m]) : 0.0f;
  }
  for (int n0 = 0; n0 < g.N; n0 += A) {
#pragma unroll
    for (int u = 0; u < A; ++u) {
      const int n = n0 + u;
      if (n >= g.N) break;                     // uniform over the block
      double s = 0.0;
#pragma unroll
      for (int m = 0; m < V; ++m) {
        if (has[m]) {
          s += (double)fabsf(__fsub_rn(x[u][m], b[m]));
          b[m] = ema(keep, alpha, b[m], x[u][m]);
        }
      }
      if (n + A < g.N) {                       // refill: frame n + A
        const float* fn = f + (size_t)(n + A) * g.plane;
#pragma unroll
        for (int m = 0; m < V; ++m)
          if (has[m]) x[u][m] = __ldg(fn + off[m]);
      }
      s = group_sum(s, G, part, n & 1);
      if (live && lane == 0) emit_tile(g, n, tile, s, tiles, hot, thr);
    }
  }
#pragma unroll
  for (int m = 0; m < V; ++m)
    if (has[m]) nb[off[m]] = b[m];
}

// Tiles too large for registers: a block per tile; the background lives in
// new_bg, each value read and written only by its own thread.
__device__ void big_tile_role(const float* __restrict__ f,
                              const float* __restrict__ bg,
                              float* __restrict__ nb,
                              float* __restrict__ tiles,
                              bool* __restrict__ hot, const Geometry& g,
                              float keep, float alpha, float thr) {
  __shared__ double part[2 * kMaxGroup / 32];
  const int tile = blockIdx.x;
  const int i = tile / g.tx, j = tile % g.tx;
  const int P = 3 * g.t * g.t;
  for (int n = 0; n < g.N; ++n) {
    const float* src = n == 0 ? bg : nb;
    const float* fn = f + (size_t)n * g.plane;
    double s = 0.0;
    for (int k = threadIdx.x; k < P; k += blockDim.x) {
      const unsigned o = tile_offset(g, i, j, k);
      const float x = __ldg(fn + o);
      const float b = src[o];
      s += (double)fabsf(__fsub_rn(x, b));
      nb[o] = ema(keep, alpha, b, x);
    }
    s = group_sum(s, blockDim.x, part, n & 1);
    if (threadIdx.x == 0) emit_tile(g, n, tile, s, tiles, hot, thr);
  }
}

// Values outside every tile: the EMA only, one value per thread across
// the window.
__device__ void remainder_role(const float* __restrict__ f,
                               const float* __restrict__ bg,
                               float* __restrict__ nb, const Geometry& g,
                               float keep, float alpha) {
  const unsigned right_w = (unsigned)(g.W - g.tx * g.t) * 3;
  const unsigned block = blockIdx.x - g.tile_blocks;
  const unsigned n_blocks = gridDim.x - g.tile_blocks;
  for (unsigned r = block * blockDim.x + threadIdx.x; r < g.rem;
       r += n_blocks * blockDim.x) {
    const unsigned e =
        r < g.rem_right
            ? (r / right_w) * g.W * 3 + (unsigned)(g.tx * g.t) * 3
                  + r % right_w
            : (unsigned)(g.ty * g.t) * g.W * 3 + (r - g.rem_right);
    float b = __ldg(bg + e);
#pragma unroll 8
    for (int n = 0; n < g.N; ++n)
      b = ema(keep, alpha, b, __ldg(f + (size_t)n * g.plane + e));
    nb[e] = b;
  }
}

// V values a thread and A frames ahead on the register path; V = 0 is
// the big-tile path.
template <int V, int A>
__global__ void __launch_bounds__(kMaxGroup)
motion_gate_kernel(const float* __restrict__ f, const float* __restrict__ bg,
                   float* __restrict__ nb, float* __restrict__ tiles,
                   bool* __restrict__ hot, Geometry g, float alpha,
                   float thr) {
  const float keep = __fsub_rn(1.0f, alpha);
  if ((int)blockIdx.x >= g.tile_blocks) {      // uniform over the block
    remainder_role(f, bg, nb, g, keep, alpha);
    return;
  }
  if constexpr (V == 0)
    big_tile_role(f, bg, nb, tiles, hot, g, keep, alpha, thr);
  else
    tile_role<V, A>(f, bg, nb, tiles, hot, g, keep, alpha, thr);
}

}  // namespace

extern "C" int motion_gate_launch(const float* frames, const float* bg,
                                  float* new_bg, float* tiles, bool* hot,
                                  int N, int H, int W, int t, float alpha,
                                  float thr, void* stream) {
  if (N < 1 || H < 1 || W < 1 || t < 1) return (int)cudaErrorInvalidValue;
  const size_t plane = (size_t)H * W * 3;
  if (plane >= (1u << 31)) return (int)cudaErrorInvalidValue;
  Geometry g;
  g.N = N;
  g.W = W;
  g.t = t;
  g.ty = H / t;
  g.tx = W / t;
  g.plane = (unsigned)plane;
  g.rem_right = (unsigned)((size_t)g.ty * t * (W - g.tx * t) * 3);
  g.rem = (unsigned)(plane - (size_t)g.ty * g.tx * t * t * 3);
  const long long P = 3LL * t * t;
  const int n_tiles = g.ty * g.tx;
  int V = 0, threads = kBigThreads, per_block = 1;
  bool deep = true;
  if (P <= (long long)kMaxV * kMaxGroup) {
    int G = 1;
    while ((long long)G * kMaxV < P) G *= 2;
    V = (int)((P + G - 1) / G);
    g.G = G;
    threads = G > kMinThreads ? G : kMinThreads;
    per_block = threads / G;
    deep = (long long)n_tiles * G < kFillThreads;
  } else {
    g.G = kBigThreads;
  }
  g.tile_blocks = (n_tiles + per_block - 1) / per_block;
  size_t rem_blocks = (g.rem + threads - 1) / threads;
  if (rem_blocks > kMaxRemBlocks) rem_blocks = kMaxRemBlocks;
  const unsigned grid = (unsigned)(g.tile_blocks + rem_blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MOTION_GATE_CASE(v)                                              \
  case v:                                                                \
    if (deep)                                                            \
      motion_gate_kernel<v, kDeepAhead><<<grid, threads, 0, st>>>(       \
          frames, bg, new_bg, tiles, hot, g, alpha, thr);                \
    else                                                                 \
      motion_gate_kernel<v, kShallowAhead><<<grid, threads, 0, st>>>(    \
          frames, bg, new_bg, tiles, hot, g, alpha, thr);                \
    break;
  switch (V) {
    case 0:
      motion_gate_kernel<0, 1><<<grid, threads, 0, st>>>(
          frames, bg, new_bg, tiles, hot, g, alpha, thr);
      break;
    MOTION_GATE_CASE(1)
    MOTION_GATE_CASE(2)
    MOTION_GATE_CASE(3)
    MOTION_GATE_CASE(4)
    MOTION_GATE_CASE(5)
    MOTION_GATE_CASE(6)
    MOTION_GATE_CASE(7)
    MOTION_GATE_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MOTION_GATE_CASE
  return (int)cudaGetLastError();
}
