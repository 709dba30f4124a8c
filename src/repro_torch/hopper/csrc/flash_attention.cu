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
// The (S, S) score matrix never exists in device memory.
//
// What bounds it on this card: operations. At the LM prefill's shape
// (B=4, S=2048, H=16, dh=128, causal) it reads q, k, v once and writes the
// output once, 134 MB (0.04 ms at 3.35 TB/s), but does 68.7 GFLOP of the
// two products (half of 4*B*H*S^2*dh, for the causal half). In bf16, q . k^T
// has bf16 operands (989 TFLOP/s on the tensor cores) and p . v has fp32
// p (67 TFLOP/s outside them): 0.55 ms; 1.03 ms all at fp32's rate, 0.07
// ms all on the tensor cores.
//
// Design (simple and right first; wgmma, TMA and bf16 tensor cores for
// the two products are later work):
//  * one block of 256 threads per (b*h, tile of 64 query rows); the block
//    reads the (B, S, H, dh) layout through the row stride H*dh, so the
//    wrapper needs no transpose;
//  * the Q tile (64 x dh, widened to fp32) stays in shared memory; a loop
//    over KV tiles of 32 rows from column 0 upward stages K and V (fp32)
//    and the tile's probabilities in dynamic shared memory: 72.6 KB at
//    dh = 128, so the launch raises the block's limit above 48 KB first
//    (a launch refused for its shared memory never runs) and three blocks
//    fit on one SM;
//  * thread (ty, tx) of a 16 x 16 grid owns query rows ty + 16i (i < 4),
//    score columns tx + 16j (j < 2) and output columns tx + 16j
//    (j < dh/16); the 16 lanes sharing a row reduce its max and sum with
//    warp shuffles, and each keeps the row's running max and denominator
//    in registers, the accumulator too;
//  * causal KV tiles strictly above the diagonal are skipped. The loop
//    starts at tile 0, whose column 0 is valid for every row, so the
//    running max is finite after the first tile and a masked score's
//    exp(-1e30 - m) is 0 (a split-KV order would have to guard a row whose
//    first tile is fully masked);
//  * query rows past S are computed on zero-padded Q and never written;
//    K and V rows past S are zero and masked;
//  * exp is expf (accurate, not __expf), every sum fp32; bf16 inputs are
//    widened on load, and a product of two bf16 values is exact in fp32,
//    so only the order of the sums separates the kernel from the plain
//    version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 32;          // KV rows per tile
constexpr int kThreads = 256;    // a 16 x 16 grid of threads
constexpr float kNeg = -1e30f;
static_assert(kBK == 32 && kBQ == 4 * 16 && kThreads == 16 * 16,
              "each of the 16 x 16 threads owns 4 query rows and 2 keys");

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* o, int B,
              int S, int H, int dh, float scale, int causal, cudaStream_t st) {
  switch (dh) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, scale, causal, st);
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, scale, causal, st);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, scale, causal, st);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, scale, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: (B, S, H, dh) contiguous, fp32 (is_bf16 = 0) or bf16.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int dh, int is_bf16, int causal,
                                      float scale, void* stream) {
  if (B < 1 || S < 1 || H < 1 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_dh<__nv_bfloat16>(q, k, v, o, B, S, H, dh, scale,
                                            causal, st)
                 : launch_dh<float>(q, k, v, o, B, S, H, dh, scale, causal,
                                    st);
}
