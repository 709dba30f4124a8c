// Nearest-centroid assignment for Focus clustering (paper §4.2) on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/centroid_assign.py
// (_kernel / _assign_impl): for feats (B, D) and centroids (M, D), the
// squared L2 distance to the nearest centroid, its lowest index, and the
// fused ``matched = d2 <= T^2`` mask.
//
// What bounds it on this card: operations. On the ingest path B = 512,
// M = 4096 (2048 on the default serve), D = 128: 2*B*M*D = 0.54 GFLOP
// against 2 MiB of centroids and 256 KiB of features, about 200 FLOP per
// byte, far above the H100's fp32 ridge. The cross term f.c stays in fp32
// FMA on the CUDA cores and never goes to the TF32 tensor cores: the
// argmin and the matched mask are an exact contract (the clustering
// decisions, and through them the saved index bytes, depend on them), and
// TF32 keeps only ~3 digits.
//
// Design (a SIMT register-tiled product with an argmin epilogue):
//  * a block owns a tile of kBM = 64 feature rows x kBN = 128 centroids, so
//    (512, 4096) runs 8 x 32 = 256 blocks, two per SM; each of its 256
//    threads keeps an 8 x 4 outer-product tile of accumulators (8 rows,
//    centroids tx + 32j) fed from registers: per k two broadcast float4
//    loads of features and four conflict-free loads of centroids for 32
//    FMAs;
//  * the k-loop walks D in steps of kBK = 16, double-buffered: the next
//    step's 16-byte global loads are in flight in registers while this
//    step computes, then stored transposed (k-major, rows padded) into the
//    other shared buffer, one barrier per step. The transpose is why the
//    copy goes through registers and not cp.async;
//  * every dot product, |c|^2 and |f|^2 is one fmaf chain over d = 0..D-1
//    in order, whatever the tile, so duplicated centroids score bit for
//    bit alike and ties are real ties;
//  * the argmin runs on the partial score |c|^2 - 2 f.c (|f|^2 is constant
//    per row, so the argmin is unchanged) and |f|^2 is added back once at
//    the end, as the TPU kernel does;
//  * rows merge across the centroid tiles inside the launch: a thread keeps
//    its best (score, index) per row with a strict '<' over increasing
//    indices, a warp takes the min of 64-bit keys (order-preserving score
//    bits, -0.0 made +0.0 first, then the index, so equal scores go to the
//    lower index), and one atomicMin per row folds the key into device
//    memory. The last block of a row tile to arrive (a counter, after
//    __threadfence) adds |f|^2 and applies the threshold. The launcher sets
//    keys and counters with one cudaMemsetAsync; no second kernel;
//  * a row whose scores are all inf or NaN gets index 0 and inf, as on the
//    TPU;
//  * blockIdx.z is a stream slot: the stacked entry point runs S problems
//    of one (B, M, D) in one launch (the multi-stream pipeline's phase 1,
//    one table per stream), each slot with its own keys and row-tile
//    counters in the scratch. A slot runs the same body on the same tiles
//    in the same k order as a launch of its own, and the atomicMin merge
//    does not depend on order, so every slot's outputs are bitwise those
//    of a solo launch; the solo entry point is the S = 1 case;
//  * the ragged B and M edges (and a D that is not a multiple of kBK) are
//    masked in the kernel: the tile loads read zeros past them and the
//    epilogue skips them. The TPU kernel padded with 3e18 rows, whose
//    |c|^2 overflows fp32 to inf at D = 128.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kBM = 64;           // feature rows per block
constexpr int kBN = 128;          // centroids per block
constexpr int kBK = 16;           // k per pipeline step
constexpr int kThreads = 256;
constexpr int kTM = 8;            // rows per thread
constexpr int kTN = 4;            // centroids per thread (stride 32)
constexpr int kPadM = kBM + 4;    // row pitch of the k-major tiles; keeps
constexpr int kPadN = kBN + 4;    // float4 alignment
constexpr unsigned long long kNoKey = ~0ull;

static_assert(kThreads == (kBM / kTM) * 32, "a warp per 8 rows");
static_assert(kBN == kTN * 32, "4 centroids per lane");

__device__ __forceinline__ unsigned order_bits(float v) {
  unsigned u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;              // -0.0 ties with +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unorder_bits(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ float4 load4(const float* base, int row, int rows,
                                        int k, int D) {
  if (row < rows && k < D)
    return __ldg(reinterpret_cast<const float4*>(base + (size_t)row * D + k));
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__global__ void __launch_bounds__(kThreads, 2)
centroid_assign_kernel(const float* __restrict__ feats,
                       const float* __restrict__ cents,
                       float* __restrict__ min_d2, int* __restrict__ argmin,
                       bool* __restrict__ matched,
                       unsigned long long* keys, int* counts, int B, int M,
                       int D, float t2) {
  __shared__ __align__(16) float a_s[2][kBK][kPadM];
  __shared__ __align__(16) float b_s[2][kBK][kPadN];
  __shared__ float cn_s[kBN];
  __shared__ float fn_s[kBM];
  __shared__ int last_s;

  const int t = threadIdx.x;
  const int tx = t & 31;
  const int ty = t >> 5;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  // this block's stream slot
  const size_t z = blockIdx.z;
  feats += z * B * D;
  cents += z * M * D;
  min_d2 += z * B;
  argmin += z * B;
  matched += z * B;
  keys += z * B;
  counts += z * gridDim.y;

  // loader roles: a float4 of one feature row, two of centroid rows
  const int ld_r = t >> 2;                   // 0..63
  const int ld_k = (t & 3) * 4;              // 0, 4, 8, 12
  float4 ra, rb0, rb1;
  auto load = [&](int k0) {
    ra = load4(feats, row0 + ld_r, B, k0 + ld_k, D);
    rb0 = load4(cents, col0 + ld_r, M, k0 + ld_k, D);
    rb1 = load4(cents, col0 + ld_r + 64, M, k0 + ld_k, D);
  };
  auto store = [&](int buf) {
    a_s[buf][ld_k + 0][ld_r] = ra.x;
    a_s[buf][ld_k + 1][ld_r] = ra.y;
    a_s[buf][ld_k + 2][ld_r] = ra.z;
    a_s[buf][ld_k + 3][ld_r] = ra.w;
    b_s[buf][ld_k + 0][ld_r] = rb0.x;
    b_s[buf][ld_k + 1][ld_r] = rb0.y;
    b_s[buf][ld_k + 2][ld_r] = rb0.z;
    b_s[buf][ld_k + 3][ld_r] = rb0.w;
    b_s[buf][ld_k + 0][ld_r + 64] = rb1.x;
    b_s[buf][ld_k + 1][ld_r + 64] = rb1.y;
    b_s[buf][ld_k + 2][ld_r + 64] = rb1.z;
    b_s[buf][ld_k + 3][ld_r + 64] = rb1.w;
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  float nrm = 0.f;       // warps 0-3: |c|^2 of centroid t; 4-5: |f|^2 of row

  const int n_steps = (D + kBK - 1) / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < n_steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < n_steps) load((s + 1) * kBK);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&a_s[buf][k][ty * 8]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&a_s[buf][k][ty * 8 + 4]);
      const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[kTN];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = b_s[buf][k][tx + 32 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      if (ty < 4) {                          // warp-uniform
        const float c = b_s[buf][k][t];
        nrm = fmaf(c, c, nrm);
      } else if (ty < 6) {
        const float f = a_s[buf][k][t - 128];
        nrm = fmaf(f, f, nrm);
      }
    }
    if (s + 1 < n_steps) store(buf ^ 1);
    __syncthreads();
  }
  if (ty < 4)
    cn_s[t] = nrm;
  else if (ty < 6)
    fn_s[t - 128] = nrm;
  __syncthreads();

  // each row's best (score, index) over this block's centroids
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    float best = INFINITY;
    int bidx = INT_MAX;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = col0 + tx + 32 * j;
      const float part = cn_s[tx + 32 * j] - 2.f * acc[i][j];
      if (col < M && part < best) {          // strict: earlier index keeps ties
        best = part;
        bidx = col;
      }
    }
    unsigned long long key =
        bidx == INT_MAX ? kNoKey
                        : ((unsigned long long)order_bits(best) << 32) |
                              (unsigned)bidx;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, key, off);
      key = o < key ? o : key;
    }
    const int row = row0 + ty * 8 + i;
    if (tx == i && row < B && key != kNoKey) atomicMin(keys + row, key);
  }
  __threadfence();                           // the keys before the count
  __syncthreads();
  if (t == 0)
    last_s = atomicAdd(counts + blockIdx.y, 1) == (int)gridDim.x - 2;
  __syncthreads();
  if (!last_s) return;
  __threadfence();                           // every centroid tile is in

  const int row = row0 + t;
  if (t < kBM && row < B) {
    const unsigned long long key =
        *reinterpret_cast<volatile unsigned long long*>(keys + row);
    float best = INFINITY;
    int idx = 0;                             // no finite score: index 0
    if (key != kNoKey) {
      best = unorder_bits((unsigned)(key >> 32));
      idx = (int)(key & 0xffffffffu);
    }
    const float d2 = best + fn_s[t];
    min_d2[row] = d2;
    argmin[row] = idx;
    matched[row] = d2 <= t2;
  }
}

}  // namespace

// S stream slots of one (B, M, D) problem each, slot-major: feats (S, B, D),
// cents (S, M, D), outputs (S, B). scratch: S * B 64-bit keys followed by
// S * ceil(B / 64) int counters, all set here (keys to "none", counters to
// -1).
extern "C" int centroid_assign_stacked_launch(
    const float* feats, const float* cents, float* min_d2, int* argmin,
    bool* matched, void* scratch, int S, int B, int M, int D, float t2,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int row_tiles = (B + kBM - 1) / kBM;
  auto* keys = static_cast<unsigned long long*>(scratch);
  int* counts = reinterpret_cast<int*>(keys + (size_t)S * B);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0xFF,
      (size_t)S * B * sizeof(*keys) + (size_t)S * row_tiles * sizeof(int),
      st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + kBN - 1) / kBN, row_tiles, S);
  centroid_assign_kernel<<<grid, kThreads, 0, st>>>(
      feats, cents, min_d2, argmin, matched, keys, counts, B, M, D, t2);
  return (int)cudaGetLastError();
}

// One slot: scratch holds B keys and ceil(B / 64) counters.
extern "C" int centroid_assign_launch(const float* feats, const float* cents,
                                      float* min_d2, int* argmin,
                                      bool* matched, void* scratch, int B,
                                      int M, int D, float t2, void* stream) {
  return centroid_assign_stacked_launch(feats, cents, min_d2, argmin,
                                        matched, scratch, 1, B, M, D, t2,
                                        stream);
}

// The grid of one slot, for a caller's check that it fills the card.
extern "C" int centroid_assign_blocks(int B, int M) {
  return ((M + kBN - 1) / kBN) * ((B + kBM - 1) / kBM);
}
