// Fused causal or full attention with an online softmax on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _kernel). For each batch b and head h of q, k, v
// (B, S, H, dh), fp32 or bf16:
//   s   = (q . k^T) * scale                       in fp32, scale = 1/sqrt(dh)
//   s   = -1e30 where col >= S, or (causal) where col > row
//   m   = running row max over the KV tiles; p = exp(s - m)
//   l   = l * alpha + rowsum(p);  acc = acc * alpha + p . v, alpha = exp(m_old - m)
//   out = acc / (l == 0 ? 1 : l), cast to q's dtype.
// The (S, S) score matrix never exists in device memory. Two bodies:
// bf16 (the LM's type, the main path) on the tensor cores, and fp32 in
// SIMT FMAs, the one that meets the JAX package's fp32 tolerance
// (atol = rtol = 2e-5), which bf16 operands cannot; the C entry point
// picks by type.
//
// What bounds it on this card: operations. At the LM prefill's shape
// (B=4, S=2048, H=16, dh=128, bf16, causal) it reads q, k, v once and
// writes the output once, 134 MB (0.040 ms at 3.35 TB/s). The causal half
// of q . k^T is 34.4 GFLOP with bf16 operands. p . v has fp32 p, but
// p = p_hi + p_lo with p_hi = bf16(p), p_lo = bf16(p - p_hi) is exact to
// about 2^-17 of p, so p . v is two bf16 products (v is bf16) into one
// fp32 accumulator: 68.7 GFLOP. All 103 GFLOP on the bf16 tensor cores
// (989 TFLOP/s): 0.104 ms. (With p . v at fp32's 67 TFLOP/s it would be
// 0.548 ms.)
//
// bf16 design (mma.sync, FlashAttention-2's register layout):
//  * a block of 4 warps owns 64 query rows of one (b, h), 16 rows a warp;
//    Q is copied to shared memory once and held in registers as
//    m16n8k16 A fragments (ldmatrix);
//  * KV tiles of 64 rows, double-buffered: cp.async.cg 16-byte copies of
//    tile t+1 are in flight while tile t's products run, one
//    __syncthreads per tile. Rows are padded by 16 bytes, so the 8 row
//    addresses of every ldmatrix fall in 8 different bank groups. At
//    dh = 128 two buffers of K and V take 68 KB of dynamic shared memory
//    (Q is staged in the second buffer before the loop), so the launch
//    raises the block's limit above 48 KB first and returns the error if
//    that is refused;
//  * s = q . k^T: mma.sync m16n8k16 bf16 -> fp32, K's B fragments by
//    ldmatrix; the score accumulators are then, unmoved, the A fragments
//    of p . v (split hi/lo in registers), V's B fragments by
//    ldmatrix.trans; row max and sum across the quad that shares a row
//    with __shfl_xor_sync; exp is exp2f with log2(e) folded into the
//    scale; l is summed over fp32 p, unrounded; every sum is fp32;
//  * causal: tiles above the diagonal are never loaded, only the diagonal
//    tile and a ragged last tile are masked, and the query tiles with the
//    most KV tiles start first (grid y runs the query tiles from the
//    last, grid x the (b, h) pairs);
//  * kept from the fp32 body: the loop starts at tile 0, whose column 0 is
//    valid for every row, so the running max is finite after the first
//    tile and a masked score's exp2(-1e30 - m) is 0; query rows past S
//    are read as zeros and never written; K and V rows past S are
//    zero-filled and masked.
//
// fp32 design (simple and right, the body of PR 15, unchanged):
//  * one block of 256 threads per (b*h, tile of 64 query rows); the block
//    reads the (B, S, H, dh) layout through the row stride H*dh, so the
//    wrapper needs no transpose;
//  * the Q tile (64 x dh) stays in shared memory; a loop over KV tiles of
//    32 rows from column 0 upward stages K and V and the tile's
//    probabilities in dynamic shared memory: 72.6 KB at dh = 128, so the
//    launch raises the block's limit above 48 KB first;
//  * thread (ty, tx) of a 16 x 16 grid owns query rows ty + 16i (i < 4),
//    score columns tx + 16j (j < 2) and output columns tx + 16j
//    (j < dh/16); the 16 lanes sharing a row reduce its max and sum with
//    warp shuffles, and each keeps the row's running max and denominator
//    in registers, the accumulator too;
//  * causal KV tiles strictly above the diagonal are skipped; tile 0
//    first, as above; exp is expf, every sum fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;

namespace simt {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 32;          // KV rows per tile
constexpr int kThreads = 256;    // a 16 x 16 grid of threads
static_assert(kBK == 32 && kBQ == 4 * 16 && kThreads == 16 * 16,
              "each of the 16 x 16 threads owns 4 query rows and 2 keys");

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * (DH + 1) + (size_t)kBK * (DH + 1) +
                          (size_t)kBK * DH + (size_t)kBQ * (kBK + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int H, float scale, int causal) {
  constexpr int QS = DH + 1;     // padded row stride of the Q and K tiles
  constexpr int PS = kBK + 1;    // padded row stride of the P tile
  constexpr int NJ = DH / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* sq = smem;              // kBQ x QS
  float* sk = sq + kBQ * QS;     // kBK x QS
  float* sv = sk + kBK * QS;     // kBK x DH
  float* sp = sv + kBK * DH;     // kBQ x PS

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * kBQ;
  const size_t stride = (size_t)H * DH;
  const size_t base = (size_t)b * S * stride + (size_t)h * DH;

  for (int e = tid; e < kBQ * DH; e += kThreads) {
    const int r = e / DH, d = e % DH;
    const int s = q0 + r;
    sq[r * QS + d] = s < S ? load_f(q + base + (size_t)s * stride + d) : 0.f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  int n_kv = (S + kBK - 1) / kBK;
  if (causal) {
    const int last_row = min(q0 + kBQ - 1, S - 1);
    n_kv = min(n_kv, last_row / kBK + 1);
  }

  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * kBK;
    __syncthreads();             // the last tile's K, V and P are consumed
    for (int e = tid; e < kBK * DH; e += kThreads) {
      const int r = e / DH, d = e % DH;
      const int s = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (s < S) {
        const size_t off = base + (size_t)s * stride + d;
        kx = load_f(k + off);
        vx = load_f(v + off);
      }
      sk[r * QS + d] = kx;
      sv[r * DH + d] = vx;
    }
    __syncthreads();

    float sc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float k_a = sk[tx * QS + d];
      const float k_b = sk[(tx + 16) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qd = sq[(ty + 16 * i) * QS + d];
        sc[i][0] = fmaf(qd, k_a, sc[i][0]);
        sc[i][1] = fmaf(qd, k_b, sc[i][1]);
      }
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < S && (!causal || col <= row);
        sc[i][j] = ok ? sc[i][j] * scale : kNeg;
      }
      const float m_new = fmaxf(m[i], row_max16(fmaxf(sc[i][0], sc[i][1])));
      const float p0 = expf(sc[i][0] - m_new);
      const float p1 = expf(sc[i][1] - m_new);
      alpha[i] = expf(m[i] - m_new);
      l[i] = l[i] * alpha[i] + row_sum16(p0 + p1);
      m[i] = m_new;
      sp[(ty + 16 * i) * PS + tx] = p0;
      sp[(ty + 16 * i) * PS + tx + 16] = p1;
    }
    __syncthreads();

    float pv[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) pv[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float vc[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vc[j] = sv[c * DH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sp[(ty + 16 * i) * PS + c];
#pragma unroll
        for (int j = 0; j < NJ; ++j) pv[i][j] = fmaf(p, vc[j], pv[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = acc[i][j] * alpha[i] + pv[i][j];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    T* out = o + base + (size_t)row * stride;
#pragma unroll
    for (int j = 0; j < NJ; ++j) store_f(out + tx + 16 * j, acc[i][j] / denom);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, float scale, int causal, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<DH>();
  auto kern = flash_attention_kernel<T, DH>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((S + kBQ - 1) / kBQ), (unsigned)(B * H));
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace simt

namespace tc {

constexpr int kBQ = 64;          // query rows per block, 16 per warp
constexpr int kBK = 64;          // KV rows per tile
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBQ == kBK, "the causal tile count and the Q staging "
                          "assume square tiles");

using bf16 = __nv_bfloat16;

// shared-memory rows are dh + kPad bf16 long: 16 bytes more than a row,
// so the 8 rows an ldmatrix reads start in 8 different 16-byte bank groups
constexpr int kPad = 8;

template <int DH>
constexpr size_t smem_bytes() {        // K and V, two buffers each
  return sizeof(bf16) * 4 * (size_t)kBK * (DH + kPad);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a . b: one 16 x 8 tile, depth 16, bf16 operands, fp32 accumulator
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
               "{%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) as two bf16 pairs whose sum is (x0, x1) to about 2^-17 each:
// hi = bf16(x), lo = bf16(x - hi); the lower column in the low half
__device__ __forceinline__ void split_hi_lo(float x0, float x1, uint32_t& hi,
                                            uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows r0 .. r0 + 63 of one head (row stride `stride`) into a padded
// shared tile; rows past S become zeros
template <int DH>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t stride, int r0, int S) {
  constexpr int kChunks = DH / 8;        // 16-byte chunks per row
  static_assert(kBK * kChunks % kThreads == 0, "whole rounds of copies");
#pragma unroll
  for (int it = 0; it < kBK * kChunks / kThreads; ++it) {
    const int c = it * kThreads + threadIdx.x;
    const int r = c / kChunks, ch = c % kChunks;
    const bool ok = r0 + r < S;
    cp_async16(smem_u32(dst + r * (DH + kPad) + ch * 8),
               src + (size_t)(ok ? r0 + r : 0) * stride + ch * 8, ok);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       int S, int H, float scale, int causal) {
  constexpr int LD = DH + kPad;
  constexpr int KT = DH / 16;            // depth steps of q . k^T
  constexpr int NT = kBK / 8;            // 8-key tiles of the scores
  constexpr int OT = DH / 8;             // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char tc_smem[];
  // buffer i: K at (2i) * kBK * LD, V at (2i + 1) * kBK * LD
  bf16* const sbase = reinterpret_cast<bf16*>(tc_smem);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;       // fragment row, column pair
  const int mi = lane >> 3, mr = lane & 7;       // ldmatrix matrix, row
  const int qt = gridDim.y - 1 - blockIdx.y;     // most KV tiles first
  const int q0 = qt * kBQ;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const size_t stride = (size_t)H * DH;
  const size_t base = (size_t)b * S * stride + (size_t)h * DH;
  const bf16* const qb = q + base;
  const bf16* const kb = k + base;
  const bf16* const vb = v + base;
  const int n_kv = causal ? qt + 1 : (S + kBK - 1) / kBK;
  const float scale2 = scale * kLog2e;

  load_tile<DH>(sbase + 2 * kBK * LD, qb, stride, q0, S);  // Q, in buffer 1
  load_tile<DH>(sbase, kb, stride, 0, S);
  load_tile<DH>(sbase + kBK * LD, vb, stride, 0, S);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[KT][4];
  {
    // matrix mi: rows (mi & 1) * 8, columns (mi >> 1) * 8 of the A tile
    const bf16* row = sbase + 2 * kBK * LD +
                      (warp * 16 + (mi & 1) * 8 + mr) * LD + (mi >> 1) * 8;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
      ldmatrix_x4(qf[kt], smem_u32(row + kt * 16));
  }
  __syncthreads();                               // Q read before refills

  float acc[OT][4];
#pragma unroll
  for (int ot = 0; ot < OT; ++ot)
    acc[ot][0] = acc[ot][1] = acc[ot][2] = acc[ot][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // rows g and g + 8
  const int row0 = q0 + warp * 16 + g;

  for (int t = 0; t < n_kv; ++t) {
    const bf16* const st_k = sbase + (t & 1) * 2 * kBK * LD;
    const bf16* const st_v = st_k + kBK * LD;
    if (t + 1 < n_kv) {
      bf16* const nx_k = sbase + ((t + 1) & 1) * 2 * kBK * LD;
      load_tile<DH>(nx_k, kb, stride, (t + 1) * kBK, S);
      load_tile<DH>(nx_k + kBK * LD, vb, stride, (t + 1) * kBK, S);
      cp_async_commit();
    }

    // s = q . k^T; matrix mi of an ldmatrix: keys (mi >> 1) * 8, depth
    // (mi & 1) * 8, i.e. b0 and b1 of two 8-key tiles
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const bf16* krow = st_k + ((mi >> 1) * 8 + mr) * LD + (mi & 1) * 8;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, smem_u32(krow + np * 16 * LD + kt * 16));
        mma(s[2 * np], qf[kt], kf[0], kf[1]);
        mma(s[2 * np + 1], qf[kt], kf[2], kf[3]);
      }
    }

    // scale (log2 domain), mask the diagonal and a ragged last tile
    const int k0 = t * kBK;
    const bool edge = k0 + kBK > S || (causal && t == n_kv - 1);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale2;
        if (edge) {
          const int col = k0 + nt * 8 + tig * 2 + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (col >= S || (causal && col > row)) x = kNeg;
        }
        s[nt][e] = x;
      }
    }

    // online softmax over the two rows this thread holds
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      alpha[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - mx[e >> 1]);
        rs[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];  // per lane
#pragma unroll
    for (int ot = 0; ot < OT; ++ot) {
      acc[ot][0] *= alpha[0];
      acc[ot][1] *= alpha[0];
      acc[ot][2] *= alpha[1];
      acc[ot][3] *= alpha[1];
    }

    // acc += p . v with p = p_hi + p_lo; the score tiles 2kk and 2kk + 1
    // are the A fragment of keys 16kk .. 16kk + 15; matrix mi of an
    // ldmatrix.trans: keys (mi & 1) * 8, columns (mi >> 1) * 8, i.e. b0
    // and b1 of two 8-column tiles
    const bf16* vrow = st_v + ((mi & 1) * 8 + mr) * LD + (mi >> 1) * 8;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_hi_lo(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split_hi_lo(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split_hi_lo(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split_hi_lo(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, smem_u32(vrow + kk * 16 * LD + dp * 16));
        mma(acc[2 * dp], hi, vf[0], vf[1]);
        mma(acc[2 * dp], lo, vf[0], vf[1]);
        mma(acc[2 * dp + 1], hi, vf[2], vf[3]);
        mma(acc[2 * dp + 1], lo, vf[2], vf[3]);
      }
    }

    if (t + 1 < n_kv) cp_async_wait_all();
    __syncthreads();          // tile t consumed; tile t + 1 landed for all
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    const float li = quad_sum(l[i]);
    if (row >= S) continue;
    const float denom = li == 0.f ? 1.f : li;
    bf16* out = o + base + (size_t)row * stride + tig * 2;
#pragma unroll
    for (int ot = 0; ot < OT; ++ot)
      *reinterpret_cast<__nv_bfloat162*>(out + ot * 8) =
          __floats2bfloat162_rn(acc[ot][2 * i] / denom,
                                acc[ot][2 * i + 1] / denom);
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, float scale, int causal, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<DH>();
  auto kern = flash_attention_kernel<DH>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)(B * H), (unsigned)((S + kBQ - 1) / kBQ));
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), S, H, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace tc

int launch_dh(const void* q, const void* k, const void* v, void* o, int B,
              int S, int H, int dh, int is_bf16, float scale, int causal,
              cudaStream_t st) {
#define FA_CASE(D)                                                         \
  case D:                                                                  \
    return is_bf16 ? tc::launch<D>(q, k, v, o, B, S, H, scale, causal, st)  \
                   : simt::launch<float, D>(q, k, v, o, B, S, H, scale,     \
                                            causal, st);
  switch (dh) {
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FA_CASE
}

}  // namespace

// q, k, v, o: (B, S, H, dh) contiguous, fp32 (is_bf16 = 0) or bf16, bf16
// rows 16-byte aligned.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int dh, int is_bf16, int causal,
                                      float scale, void* stream) {
  if (B < 1 || S < 1 || H < 1 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  return launch_dh(q, k, v, o, B, S, H, dh, is_bf16, scale, causal,
                   static_cast<cudaStream_t>(stream));
}
