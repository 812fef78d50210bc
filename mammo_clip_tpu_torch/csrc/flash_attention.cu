// Hand-written CUDA flash attention for Hopper (sm_90a), forward and backward.
//
// Replaces the stock Pallas TPU kernel that benchmarks/probe_flash_attention.py::
// flash_attention_bnsd calls (jax.experimental.pallas.ops.tpu.flash_attention):
// non-causal softmax attention of (B, N, S, D) q, k, v with no mask and no bias,
//   o = softmax(q k^T * scale) v,
// statistics and accumulation in fp32, o in the input dtype; the backward gives
// dq, dk, dv in the input dtype. ops/flash_attention.py wraps it in a
// torch.autograd.Function beside its plain PyTorch version.
//
// Which kernels serve which dtype (FA_DISPATCH, at the end of the file):
//   bf16  tensor-core kernels, fwd_tc_kernel / dot_v8_kernel (or dot_kernel) /
//         dkdv_tc_kernel / dq_tc_kernel;
//   fp32  fp32-FMA kernels, fwd_kernel / dot_kernel / dkdv_kernel / dq_kernel,
//         kept for fp32 because TF32 tensor cores would not hold 1e-4.
// Both paths have the same structure: a block owns a 64-row tile and walks the
// other side's 64-row tiles, so the (S, S) scores never reach device memory:
//   forward   block per (b, n, query tile): online softmax over the key tiles
//             (running max m and sum l in fp32, O accumulated in fp32), then
//             o = O / l and lse = m + log l (fp32, (B, N, S), natural log);
//   backward  three launches and no float atomics, each output element has one
//             writer, so every run gives the same bits: Dvec = rowsum(dO * o);
//             a block per key tile that loops over the query tiles, recomputes
//             P = exp(S * scale - lse) and sums dV += P^T dO,
//             dK += (scale * dS)^T Q with dS = P * (dO V^T - Dvec); a block per
//             query tile that loops over the key tiles for dQ += (scale * dS) K.
//
// bf16 design (FlashAttention-2's shape, on mma.sync, ldmatrix and cp.async).
// A block is 4 warps; each warp owns 16 rows of the block's 64-row tile. Every
// product is mma.sync.m16n8k16 (bf16 in, fp32 sums). Tiles are copied into
// shared memory as bf16 by 16-byte cp.async.cg (rows past S and columns past D
// zero-filled with a source size of 0), row-major with a row stride of Dmax + 8
// elements, so the 8 row addresses of each ldmatrix fall on 8 distinct 16-byte
// bank groups. The streamed side's tiles sit in a 2-stage ring: the copy of
// tile i+1 is issued before tile i's products and waited for after them.
//   forward   Q lives in registers as A fragments (ldmatrix once); S = Q K^T
//             with K's rows as the "col" B operand; the online softmax runs in
//             registers (exp2 with scale * log2 e folded in, row max and sum
//             reduced over the 4 threads of a quad); the fp32 C fragments of P
//             are packed to bf16 as the A fragments of P V (the TPU kernel's
//             rounding point, p.astype(v.dtype)), V read by ldmatrix.trans; the
//             epilogue writes o through shared memory as 16-byte stores.
//   dK, dV    K and V resident in shared memory; Q, dO and their lse and Dvec
//             slices streamed: S^T = K Q^T, dP^T = V dO^T, then
//             dV += bf16(P^T) dO and dK += bf16(scale * dS^T) Q (the TPU
//             kernel's p.T.astype and ds.T.astype), dO and Q by ldmatrix.trans.
//   dQ        Q and dO resident; K and V streamed; S, P, dP, dS as above, then
//             dQ += bf16(scale * dS) K with K by ldmatrix.trans.
// Keys past S get a score of -inf (forward) or P = 0 (backward); rows past S
// are never stored. D up to 128 is compiled for Dmax 32, 64 and 128 (zero-padded
// columns); a D that is not a multiple of 8 (or a pointer that is not 16-byte
// aligned) makes the same kernels copy their tiles one element at a time.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16): at the probe's shape
// (16, 12, 256, 64) bf16 the forward must move ~26 MB (q, k, v, o, lse) for
// 3.2 GFLOP and the backward ~51 MB for 8.1 GFLOP, so both are bound by bytes
// (~8 and ~15 us); the work at mma.sync's rate is a few microseconds. Each
// streamed tile is read once per block of the other side (4 x the minimal bytes
// at S = 256, mostly from L2), and the softmax's exponentials run on the SFU.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <initializer_list>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "common.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kTile = 64;         // rows of a query or key tile
constexpr int kThreads = 256;     // 16 x 16 threads, 4 x 4 scores each
constexpr int kTs = kTile + 1;    // stride of a transposed tile
constexpr int kMaxD = 128;
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const bf16* p, size_t i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(bf16* p, size_t i, float v) { p[i] = __float2bfloat16(v); }

// Sum or max over the 16 threads of a half-warp (the threads that share rows).
__device__ __forceinline__ float row_sum(float v) {
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Rows [row0, row0 + 64) of a (S, D) matrix into shared memory as fp32, zero
// beyond S and D: row-major with stride Dmax + 1, or transposed with stride 65.
template <int Dmax, typename T>
__device__ void load_rows(const T* src, float* dst, int row0, int S, int D) {
  for (int idx = threadIdx.x; idx < kTile * Dmax; idx += kThreads) {
    const int r = idx / Dmax, d = idx % Dmax;
    const float v = (row0 + r < S && d < D) ? ld(src, (size_t)(row0 + r) * D + d) : 0.f;
    dst[r * (Dmax + 1) + d] = v;
  }
}
template <int Dmax, typename T>
__device__ void load_cols(const T* src, float* dst, int row0, int S, int D) {
  for (int idx = threadIdx.x; idx < kTile * Dmax; idx += kThreads) {
    const int r = idx / Dmax, d = idx % Dmax;
    const float v = (row0 + r < S && d < D) ? ld(src, (size_t)(row0 + r) * D + d) : 0.f;
    dst[d * kTs + r] = v;
  }
}

template <int Dmax>
constexpr size_t fwd_smem() {  // Q rows, K^T, V^T, P
  return sizeof(float) * (kTile * (Dmax + 1) + 2 * Dmax * kTs + kTile * kTs);
}
template <int Dmax>
constexpr size_t dkdv_smem() {  // K rows, V rows, Q^T, dO^T, P^T, dS^T, lse, Dvec
  return sizeof(float) * (2 * kTile * (Dmax + 1) + 2 * Dmax * kTs + 2 * kTile * kTs + 2 * kTile);
}
template <int Dmax>
constexpr size_t dq_smem() {  // Q rows, dO rows, K^T, V^T, dS
  return sizeof(float) * (2 * kTile * (Dmax + 1) + 2 * Dmax * kTs + kTile * kTs);
}

// grid (query tiles, B * N); o (B, N, S, D) in T, lse (B, N, S) fp32.
template <typename T, int Dmax>
__global__ void __launch_bounds__(kThreads) fwd_kernel(const T* q, const T* k, const T* v, T* o,
                                                       float* lse, int S, int D, float scale) {
  constexpr int kJ = Dmax / 16;
  extern __shared__ float smem[];
  float* qs = smem;                          // [64][Dmax+1]
  float* kt = qs + kTile * (Dmax + 1);       // [Dmax][65]
  float* vt = kt + Dmax * kTs;               // [Dmax][65]
  float* ps = vt + Dmax * kTs;               // [64][65]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t head = (size_t)blockIdx.y * S * D;
  const int q0 = blockIdx.x * kTile;
  load_rows<Dmax>(q + head, qs, q0, S, D);

  float m[4], l[4], acc[4][kJ];
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    for (int j = 0; j < kJ; ++j) acc[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < S; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_cols<Dmax>(k + head, kt, k0, S, D);
    load_cols<Dmax>(v + head, vt, k0, S, D);
    __syncthreads();
    float s[4][4] = {};
    for (int d = 0; d < Dmax; ++d) {
      float a[4], b[4];
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * (Dmax + 1) + d];
      for (int j = 0; j < 4; ++j) b[j] = kt[d * kTs + tx + 16 * j];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (k0 + tx + 16 * j < S) ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));  // finite: key k0 is in range
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty * 4 + i) * kTs + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
      for (int j = 0; j < kJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    for (int c = 0; c < kTile; ++c) {
      float p[4], b[kJ];
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * kTs + c];
      for (int j = 0; j < kJ; ++j) b[j] = vt[(tx + 16 * j) * kTs + c];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < kJ; ++j) acc[i][j] = fmaf(p[i], b[j], acc[i][j]);
    }
  }
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
    const float inv = 1.f / l[i];
    for (int j = 0; j < kJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) st(o, head + (size_t)r * D + d, acc[i][j] * inv);
    }
    if (tx == 0) lse[(size_t)blockIdx.y * S + r] = m[i] + logf(l[i]);
  }
}

// Dvec = rowsum(dO * o) in fp32: one warp per row of the (B * N * S, D) matrices.
template <typename T>
__global__ void __launch_bounds__(kThreads) dot_kernel(const T* o, const T* g, float* dvec,
                                                       int rows, int D) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  float sum = 0.f;
  for (int d = lane; d < D; d += 32) sum += ld(o, (size_t)row * D + d) * ld(g, (size_t)row * D + d);
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) dvec[row] = sum;
}

// grid (key tiles, B * N): dK and dV of one key tile over all query tiles.
// Thread rows are keys (ty*4+i), columns queries (tx+16j).
template <typename T, int Dmax>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const T* q, const T* k, const T* v,
                                                        const T* g, const float* lse,
                                                        const float* dvec, T* dk, T* dv, int S,
                                                        int D, float scale) {
  constexpr int kJ = Dmax / 16;
  extern __shared__ float smem[];
  float* ks = smem;                          // [64][Dmax+1]
  float* vs = ks + kTile * (Dmax + 1);       // [64][Dmax+1]
  float* qt = vs + kTile * (Dmax + 1);       // [Dmax][65]
  float* gt = qt + Dmax * kTs;               // [Dmax][65]
  float* pt = gt + Dmax * kTs;               // [64][65]
  float* dst = pt + kTile * kTs;             // [64][65]
  float* lse_s = dst + kTile * kTs;          // [64]
  float* dvec_s = lse_s + kTile;             // [64]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t head = (size_t)blockIdx.y * S * D;
  const int k0 = blockIdx.x * kTile;
  load_rows<Dmax>(k + head, ks, k0, S, D);
  load_rows<Dmax>(v + head, vs, k0, S, D);

  float acc_k[4][kJ] = {}, acc_v[4][kJ] = {};
  for (int q0 = 0; q0 < S; q0 += kTile) {
    __syncthreads();
    load_cols<Dmax>(q + head, qt, q0, S, D);
    load_cols<Dmax>(g + head, gt, q0, S, D);
    if (threadIdx.x < kTile) {
      const bool in = q0 + (int)threadIdx.x < S;
      lse_s[threadIdx.x] = in ? lse[(size_t)blockIdx.y * S + q0 + threadIdx.x] : 0.f;
      dvec_s[threadIdx.x] = in ? dvec[(size_t)blockIdx.y * S + q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    for (int d = 0; d < Dmax; ++d) {
      float a[4], b[4], c[4], e[4];
      for (int i = 0; i < 4; ++i) {
        a[i] = ks[(ty * 4 + i) * (Dmax + 1) + d];
        c[i] = vs[(ty * 4 + i) * (Dmax + 1) + d];
      }
      for (int j = 0; j < 4; ++j) {
        b[j] = qt[d * kTs + tx + 16 * j];
        e[j] = gt[d * kTs + tx + 16 * j];
      }
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(c[i], e[j], dp[i][j]);
        }
    }
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = (q0 + c < S) ? expf(s[i][j] * scale - lse_s[c]) : 0.f;
        pt[(ty * 4 + i) * kTs + c] = p;
        dst[(ty * 4 + i) * kTs + c] = p * (dp[i][j] - dvec_s[c]);
      }
    __syncthreads();
    for (int c = 0; c < kTile; ++c) {
      float p[4], ds[4], bq[kJ], bg[kJ];
      for (int i = 0; i < 4; ++i) {
        p[i] = pt[(ty * 4 + i) * kTs + c];
        ds[i] = dst[(ty * 4 + i) * kTs + c];
      }
      for (int j = 0; j < kJ; ++j) {
        bq[j] = qt[(tx + 16 * j) * kTs + c];
        bg[j] = gt[(tx + 16 * j) * kTs + c];
      }
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < kJ; ++j) {
          acc_v[i][j] = fmaf(p[i], bg[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(ds[i], bq[j], acc_k[i][j]);
        }
    }
  }
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty * 4 + i;
    if (r >= S) continue;
    for (int j = 0; j < kJ; ++j) {
      const int d = tx + 16 * j;
      if (d >= D) continue;
      st(dk, head + (size_t)r * D + d, acc_k[i][j] * scale);
      st(dv, head + (size_t)r * D + d, acc_v[i][j]);
    }
  }
}

// grid (query tiles, B * N): dQ of one query tile over all key tiles.
// Thread rows are queries (ty*4+i), columns keys (tx+16j).
template <typename T, int Dmax>
__global__ void __launch_bounds__(kThreads) dq_kernel(const T* q, const T* k, const T* v,
                                                      const T* g, const float* lse,
                                                      const float* dvec, T* dq, int S, int D,
                                                      float scale) {
  constexpr int kJ = Dmax / 16;
  extern __shared__ float smem[];
  float* qs = smem;                          // [64][Dmax+1]
  float* gs = qs + kTile * (Dmax + 1);       // [64][Dmax+1]
  float* kt = gs + kTile * (Dmax + 1);       // [Dmax][65]
  float* vt = kt + Dmax * kTs;               // [Dmax][65]
  float* dss = vt + Dmax * kTs;              // [64][65]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t head = (size_t)blockIdx.y * S * D;
  const int q0 = blockIdx.x * kTile;
  load_rows<Dmax>(q + head, qs, q0, S, D);
  load_rows<Dmax>(g + head, gs, q0, S, D);
  float row_lse[4], row_dvec[4];
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    row_lse[i] = r < S ? lse[(size_t)blockIdx.y * S + r] : 0.f;
    row_dvec[i] = r < S ? dvec[(size_t)blockIdx.y * S + r] : 0.f;
  }

  float acc[4][kJ] = {};
  for (int k0 = 0; k0 < S; k0 += kTile) {
    __syncthreads();
    load_cols<Dmax>(k + head, kt, k0, S, D);
    load_cols<Dmax>(v + head, vt, k0, S, D);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    for (int d = 0; d < Dmax; ++d) {
      float a[4], b[4], c[4], e[4];
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[(ty * 4 + i) * (Dmax + 1) + d];
        c[i] = gs[(ty * 4 + i) * (Dmax + 1) + d];
      }
      for (int j = 0; j < 4; ++j) {
        b[j] = kt[d * kTs + tx + 16 * j];
        e[j] = vt[d * kTs + tx + 16 * j];
      }
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(c[i], e[j], dp[i][j]);
        }
    }
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = (k0 + c < S) ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        dss[(ty * 4 + i) * kTs + c] = p * (dp[i][j] - row_dvec[i]);
      }
    __syncthreads();
    for (int c = 0; c < kTile; ++c) {
      float ds[4], b[kJ];
      for (int i = 0; i < 4; ++i) ds[i] = dss[(ty * 4 + i) * kTs + c];
      for (int j = 0; j < kJ; ++j) b[j] = kt[(tx + 16 * j) * kTs + c];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < kJ; ++j) acc[i][j] = fmaf(ds[i], b[j], acc[i][j]);
    }
  }
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
    for (int j = 0; j < kJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) st(dq, head + (size_t)r * D + d, acc[i][j] * scale);
    }
  }
}

template <typename K>
int prepare(K kernel, size_t smem) {
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int Dmax>
int forward(const void* q, const void* k, const void* v, void* o, float* lse, int BN, int S,
            int D, float scale, cudaStream_t s) {
  const size_t smem = fwd_smem<Dmax>();
  int rc;
  if ((rc = prepare(fwd_kernel<T, Dmax>, smem))) return rc;
  const dim3 grid((S + kTile - 1) / kTile, BN);
  fwd_kernel<T, Dmax><<<grid, kThreads, smem, s>>>((const T*)q, (const T*)k, (const T*)v,
                                                   (T*)o, lse, S, D, scale);
  return (int)cudaGetLastError();
}

template <typename T, int Dmax>
int backward(const void* q, const void* k, const void* v, const void* o, const void* g,
             const float* lse, float* dvec, void* dq, void* dk, void* dv, int BN, int S, int D,
             float scale, cudaStream_t s) {
  const int rows = BN * S, per_block = kThreads / 32;
  dot_kernel<T><<<(rows + per_block - 1) / per_block, kThreads, 0, s>>>((const T*)o, (const T*)g,
                                                                         dvec, rows, D);
  int rc;
  if ((rc = (int)cudaGetLastError())) return rc;
  const dim3 grid((S + kTile - 1) / kTile, BN);
  if ((rc = prepare(dkdv_kernel<T, Dmax>, dkdv_smem<Dmax>()))) return rc;
  dkdv_kernel<T, Dmax><<<grid, kThreads, dkdv_smem<Dmax>(), s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)g, lse, dvec, (T*)dk, (T*)dv, S, D, scale);
  if ((rc = (int)cudaGetLastError())) return rc;
  if ((rc = prepare(dq_kernel<T, Dmax>, dq_smem<Dmax>()))) return rc;
  dq_kernel<T, Dmax><<<grid, kThreads, dq_smem<Dmax>(), s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)g, lse, dvec, (T*)dq, S, D, scale);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16: tensor-core kernels
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;   // 4 warps, 16 rows of a 64-row tile each
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

// ldmatrix addresses in a [rows][kS] tile. A fragment: rows r0..r0+15, columns
// c0..c0+15. B fragments, two n8 tiles: from n-major rows (n0..n0+15, k c0..+15;
// r[0..1] for n0, r[2..3] for n0 + 8), or with .trans from k-major rows
// (k r0..r0+15, n c0..c0+15).
template <int kS>
__device__ __forceinline__ const bf16* a_addr(const bf16* t, int r0, int c0, int lane) {
  return t + (r0 + (lane & 15)) * kS + c0 + (lane >> 4) * 8;
}
template <int kS>
__device__ __forceinline__ const bf16* b_addr(const bf16* t, int n0, int c0, int lane) {
  return t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * kS + c0 + ((lane >> 3) & 1) * 8;
}
template <int kS>
__device__ __forceinline__ const bf16* bt_addr(const bf16* t, int r0, int c0, int lane) {
  return t + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kS + c0 + (lane >> 4) * 8;
}

// The A fragments of a 16 x 64 product operand from the C fragments of eight
// n8 tiles, rounded to bf16: k step kk takes tiles 2 kk and 2 kk + 1.
__device__ __forceinline__ void c_to_a(unsigned (&a)[4], const float (&c)[8][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Rows [row0, row0 + 64) of a (S, D) bf16 matrix into a [64][Dmax + 8] tile,
// zero past S and D. With `vec` (D % 8 == 0, 16-byte aligned) by cp.async in
// 16-byte pieces, which the caller commits and waits for; otherwise element by
// element, synchronously.
template <int Dmax>
__device__ __forceinline__ void tile_load(bf16* dst, const bf16* src, int row0, int S, int D,
                                          bool vec) {
  constexpr int kS = Dmax + 8, kC = Dmax / 8;
  if (vec) {
#pragma unroll
    for (int n = 0; n < kTile * kC / kTcThreads; ++n) {
      const int i = threadIdx.x + n * kTcThreads, r = i / kC, c = i % kC;
      const bool in = row0 + r < S && c * 8 < D;
      cp_async16(dst + r * kS + c * 8, in ? src + (size_t)(row0 + r) * D + c * 8 : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kTile * Dmax; i += kTcThreads) {
      const int r = i / Dmax, d = i % Dmax;
      dst[r * kS + d] = (row0 + r < S && d < D) ? src[(size_t)(row0 + r) * D + d]
                                                : __float2bfloat16(0.f);
    }
  }
}

// Entries [row0, row0 + 64) of a length-S fp32 vector, zero past S.
__device__ __forceinline__ void stat_load(float* dst, const float* src, int row0, int S) {
  if (threadIdx.x < kTile) {
    const bool in = row0 + (int)threadIdx.x < S;
    cp_async4(dst + threadIdx.x, in ? src + row0 + threadIdx.x : src, in ? 4 : 0);
  }
}

// A warp's 16 x Dmax fp32 C fragments, times s0 (row g) and s1 (row g + 8),
// into 16 rows of a [..][Dmax + 8] bf16 tile.
template <int Dmax>
__device__ __forceinline__ void frag_store(bf16* dst, const float (&c)[Dmax / 8][4], float s0,
                                           float s1, int lane) {
  constexpr int kS = Dmax + 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < Dmax / 8; ++n) {
    *reinterpret_cast<unsigned*>(dst + g * kS + 8 * n + 2 * t) =
        pack_bf16(c[n][0] * s0, c[n][1] * s0);
    *reinterpret_cast<unsigned*>(dst + (g + 8) * kS + 8 * n + 2 * t) =
        pack_bf16(c[n][2] * s1, c[n][3] * s1);
  }
}

// 16 rows of a [..][Dmax + 8] tile to rows [row0, row0 + 16) of a (S, D)
// matrix, by one warp: coalesced 16-byte stores with `vec`, else element-wise.
template <int Dmax>
__device__ __forceinline__ void warp_store(bf16* dst, const bf16* src, int row0, int S, int D,
                                           bool vec, int lane) {
  constexpr int kS = Dmax + 8, kC = Dmax / 8;
  if (vec) {
#pragma unroll
    for (int n = 0; n < 16 * kC / 32; ++n) {
      const int i = lane + 32 * n, r = i / kC, c = i % kC;
      if (row0 + r < S && c * 8 < D)
        *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * D + c * 8) =
            *reinterpret_cast<const uint4*>(src + r * kS + c * 8);
    }
  } else {
    for (int i = lane; i < 16 * Dmax; i += 32) {
      const int r = i / Dmax, d = i % Dmax;
      if (row0 + r < S && d < D) dst[(size_t)(row0 + r) * D + d] = src[r * kS + d];
    }
  }
}

template <int Dmax>
constexpr size_t fwd_tc_smem() {  // Q, 2 stages of K and V
  return sizeof(bf16) * 5 * kTile * (Dmax + 8);
}
template <int Dmax>
constexpr size_t bwd_tc_smem() {  // 2 resident tiles, 2 stages of 2 streamed tiles, their stats
  return sizeof(bf16) * 6 * kTile * (Dmax + 8) + sizeof(float) * 4 * kTile;
}

// grid (query tiles, B * N); o (B, N, S, D) bf16, lse (B, N, S) fp32.
template <int Dmax>
__global__ void __launch_bounds__(kTcThreads) fwd_tc_kernel(const bf16* q, const bf16* k,
                                                            const bf16* v, bf16* o, float* lse,
                                                            int S, int D, float scale, int vec) {
  constexpr int kS = Dmax + 8, kKd = Dmax / 16, kNd = Dmax / 8, kT = kTile * kS;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);  // [64][kS]
  bf16* ks = qs + kT;                            // [2][64][kS]
  bf16* vs = ks + 2 * kT;                        // [2][64][kS]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane & 3;
  const size_t head = (size_t)blockIdx.y * S * D;
  const int q0 = blockIdx.x * kTile, nk = (S + kTile - 1) / kTile;
  const float sl2 = scale * kLog2e;
  tile_load<Dmax>(qs, q + head, q0, S, D, vec);
  tile_load<Dmax>(ks, k + head, 0, S, D, vec);
  tile_load<Dmax>(vs, v + head, 0, S, D, vec);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  unsigned qf[kKd][4];
#pragma unroll
  for (int kk = 0; kk < kKd; ++kk) ldsm(qf[kk], a_addr<kS>(qs, warp * 16, kk * 16, lane));

  float acc[kNd][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's partial sums
  for (int it = 0; it < nk; ++it) {
    const bf16* kt = ks + (it & 1) * kT;
    const bf16* vt = vs + (it & 1) * kT;
    if (it + 1 < nk) {  // the other stage was released by the last iteration's barrier
      tile_load<Dmax>(ks + ((it + 1) & 1) * kT, k + head, (it + 1) * kTile, S, D, vec);
      tile_load<Dmax>(vs + ((it + 1) & 1) * kT, v + head, (it + 1) * kTile, S, D, vec);
    }
    cp_async_commit();
    float s[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < kKd; ++kk)
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2) {
        unsigned b[4];
        ldsm(b, b_addr<kS>(kt, 16 * j2, 16 * kk, lane));
        mma(s[2 * j2], qf[kk], b[0], b[1]);
        mma(s[2 * j2 + 1], qf[kk], b[2], b[3]);
      }
    // online softmax in log2 units; this thread holds rows g (e < 2) and g + 8
    const int key = it * kTile + 2 * t;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = key + 8 * j + (e & 1) < S ? s[j][e] * sl2 : -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));  // finite: key it*64 < S
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < kNd; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned a[4];
      c_to_a(a, s, kk);
#pragma unroll
      for (int n2 = 0; n2 < kNd / 2; ++n2) {
        unsigned b[4];
        ldsm_t(b, bt_addr<kS>(vt, 16 * kk, 16 * n2, lane));
        mma(acc[2 * n2], a, b[0], b[1]);
        mma(acc[2 * n2 + 1], a, b[2], b[3]);
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  bf16* os = qs + warp * 16 * kS;  // this warp's Q rows, read by no other warp
  frag_store<Dmax>(os, acc, 1.f / l[0], 1.f / l[1], lane);
  __syncwarp();
  warp_store<Dmax>(o + head, os, q0 + warp * 16, S, D, vec, lane);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + (lane >> 2) + 8 * r;
      if (row < S) lse[(size_t)blockIdx.y * S + row] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

// Dvec = rowsum(dO * o) of bf16 rows with D % 8 == 0 and 16-byte aligned rows:
// `lanes` threads per row (a power of two >= D / 8), 16-byte loads, shuffles
// within each group of lanes.
__global__ void __launch_bounds__(kThreads) dot_v8_kernel(const bf16* o, const bf16* g,
                                                          float* dvec, int rows, int D,
                                                          int lanes) {
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int row = tid / lanes, c = tid % lanes, chunks = D / 8;
  float sum = 0.f;
  if (row < rows)
    for (int i = c; i < chunks; i += lanes) {
      const uint4 a = reinterpret_cast<const uint4*>(o + (size_t)row * D)[i];
      const uint4 b = reinterpret_cast<const uint4*>(g + (size_t)row * D)[i];
      const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 fa = __bfloat1622float2(pa[j]), fb = __bfloat1622float2(pb[j]);
        sum = fmaf(fa.x, fb.x, sum);
        sum = fmaf(fa.y, fb.y, sum);
      }
    }
  for (int off = lanes / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (row < rows && c == 0) dvec[row] = sum;
}

// grid (key tiles, B * N): dK and dV of one key tile over all query tiles.
// Each warp owns 16 keys; C fragments have keys as rows and queries as columns.
template <int Dmax>
__global__ void __launch_bounds__(kTcThreads) dkdv_tc_kernel(const bf16* q, const bf16* k,
                                                             const bf16* v, const bf16* g,
                                                             const float* lse, const float* dvec,
                                                             bf16* dk, bf16* dv, int S, int D,
                                                             float scale, int vec) {
  constexpr int kS = Dmax + 8, kKd = Dmax / 16, kNd = Dmax / 8, kT = kTile * kS;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* ks = reinterpret_cast<bf16*>(smem_tc);   // [64][kS]
  bf16* vs = ks + kT;                            // [64][kS]
  bf16* qs = vs + kT;                            // [2][64][kS]
  bf16* gs = qs + 2 * kT;                        // [2][64][kS]
  float* ls = reinterpret_cast<float*>(gs + 2 * kT);  // [2][64]
  float* dvs = ls + 2 * kTile;                        // [2][64]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane & 3;
  const size_t head = (size_t)blockIdx.y * S * D, stats = (size_t)blockIdx.y * S;
  const int k0 = blockIdx.x * kTile, nq = (S + kTile - 1) / kTile;
  const float sl2 = scale * kLog2e;
  tile_load<Dmax>(ks, k + head, k0, S, D, vec);
  tile_load<Dmax>(vs, v + head, k0, S, D, vec);
  tile_load<Dmax>(qs, q + head, 0, S, D, vec);
  tile_load<Dmax>(gs, g + head, 0, S, D, vec);
  stat_load(ls, lse + stats, 0, S);
  stat_load(dvs, dvec + stats, 0, S);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  float dka[kNd][4] = {}, dva[kNd][4] = {};
  for (int it = 0; it < nq; ++it) {
    const int st = it & 1, nx = (it + 1) & 1;
    const bf16* qt = qs + st * kT;
    const bf16* gt = gs + st * kT;
    const float* lt = ls + st * kTile;
    const float* dt = dvs + st * kTile;
    if (it + 1 < nq) {
      tile_load<Dmax>(qs + nx * kT, q + head, (it + 1) * kTile, S, D, vec);
      tile_load<Dmax>(gs + nx * kT, g + head, (it + 1) * kTile, S, D, vec);
      stat_load(ls + nx * kTile, lse + stats, (it + 1) * kTile, S);
      stat_load(dvs + nx * kTile, dvec + stats, (it + 1) * kTile, S);
    }
    cp_async_commit();
    float s[8][4] = {}, dp[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < kKd; ++kk) {
      unsigned ka[4], va[4];
      ldsm(ka, a_addr<kS>(ks, warp * 16, 16 * kk, lane));
      ldsm(va, a_addr<kS>(vs, warp * 16, 16 * kk, lane));
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2) {
        unsigned bq[4], bg[4];
        ldsm(bq, b_addr<kS>(qt, 16 * j2, 16 * kk, lane));
        ldsm(bg, b_addr<kS>(gt, 16 * j2, 16 * kk, lane));
        mma(s[2 * j2], ka, bq[0], bq[1]);
        mma(s[2 * j2 + 1], ka, bq[2], bq[3]);
        mma(dp[2 * j2], va, bg[0], bg[1]);
        mma(dp[2 * j2 + 1], va, bg[2], bg[3]);
      }
    }
    // P^T and scale * dS^T; columns are queries it*64 + c
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        const float p = it * kTile + c < S ? exp2f(s[j][e] * sl2 - lt[c] * kLog2e) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dt[c]) * scale;
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned ap[4], ad[4];
      c_to_a(ap, s, kk);
      c_to_a(ad, dp, kk);
#pragma unroll
      for (int n2 = 0; n2 < kNd / 2; ++n2) {
        unsigned b[4];
        ldsm_t(b, bt_addr<kS>(gt, 16 * kk, 16 * n2, lane));
        mma(dva[2 * n2], ap, b[0], b[1]);
        mma(dva[2 * n2 + 1], ap, b[2], b[3]);
        ldsm_t(b, bt_addr<kS>(qt, 16 * kk, 16 * n2, lane));
        mma(dka[2 * n2], ad, b[0], b[1]);
        mma(dka[2 * n2 + 1], ad, b[2], b[3]);
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }
  bf16* kw = ks + warp * 16 * kS;  // this warp's K and V rows, read by no other warp
  bf16* vw = vs + warp * 16 * kS;
  frag_store<Dmax>(kw, dka, 1.f, 1.f, lane);
  frag_store<Dmax>(vw, dva, 1.f, 1.f, lane);
  __syncwarp();
  warp_store<Dmax>(dk + head, kw, k0 + warp * 16, S, D, vec, lane);
  warp_store<Dmax>(dv + head, vw, k0 + warp * 16, S, D, vec, lane);
}

// grid (query tiles, B * N): dQ of one query tile over all key tiles.
// Each warp owns 16 queries; C fragments have queries as rows and keys as columns.
template <int Dmax>
__global__ void __launch_bounds__(kTcThreads) dq_tc_kernel(const bf16* q, const bf16* k,
                                                           const bf16* v, const bf16* g,
                                                           const float* lse, const float* dvec,
                                                           bf16* dq, int S, int D, float scale,
                                                           int vec) {
  constexpr int kS = Dmax + 8, kKd = Dmax / 16, kNd = Dmax / 8, kT = kTile * kS;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);  // [64][kS]
  bf16* gs = qs + kT;                            // [64][kS]
  bf16* ks = gs + kT;                            // [2][64][kS]
  bf16* vs = ks + 2 * kT;                        // [2][64][kS]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane & 3;
  const size_t head = (size_t)blockIdx.y * S * D;
  const int q0 = blockIdx.x * kTile, nk = (S + kTile - 1) / kTile;
  const float sl2 = scale * kLog2e;
  float lse2[2], dvr[2];  // rows g and g + 8 of this warp
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + (lane >> 2) + 8 * r;
    lse2[r] = row < S ? lse[(size_t)blockIdx.y * S + row] * kLog2e : 0.f;
    dvr[r] = row < S ? dvec[(size_t)blockIdx.y * S + row] : 0.f;
  }
  tile_load<Dmax>(qs, q + head, q0, S, D, vec);
  tile_load<Dmax>(gs, g + head, q0, S, D, vec);
  tile_load<Dmax>(ks, k + head, 0, S, D, vec);
  tile_load<Dmax>(vs, v + head, 0, S, D, vec);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  float dqa[kNd][4] = {};
  for (int it = 0; it < nk; ++it) {
    const bf16* kt = ks + (it & 1) * kT;
    const bf16* vt = vs + (it & 1) * kT;
    if (it + 1 < nk) {
      tile_load<Dmax>(ks + ((it + 1) & 1) * kT, k + head, (it + 1) * kTile, S, D, vec);
      tile_load<Dmax>(vs + ((it + 1) & 1) * kT, v + head, (it + 1) * kTile, S, D, vec);
    }
    cp_async_commit();
    float s[8][4] = {}, dp[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < kKd; ++kk) {
      unsigned qa[4], ga[4];
      ldsm(qa, a_addr<kS>(qs, warp * 16, 16 * kk, lane));
      ldsm(ga, a_addr<kS>(gs, warp * 16, 16 * kk, lane));
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2) {
        unsigned bk[4], bv[4];
        ldsm(bk, b_addr<kS>(kt, 16 * j2, 16 * kk, lane));
        ldsm(bv, b_addr<kS>(vt, 16 * j2, 16 * kk, lane));
        mma(s[2 * j2], qa, bk[0], bk[1]);
        mma(s[2 * j2 + 1], qa, bk[2], bk[3]);
        mma(dp[2 * j2], ga, bv[0], bv[1]);
        mma(dp[2 * j2 + 1], ga, bv[2], bv[3]);
      }
    }
    const int key = it * kTile + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = key + 8 * j + (e & 1) < S ? exp2f(s[j][e] * sl2 - lse2[r]) : 0.f;
        s[j][e] = p * (dp[j][e] - dvr[r]) * scale;
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned a[4];
      c_to_a(a, s, kk);
#pragma unroll
      for (int n2 = 0; n2 < kNd / 2; ++n2) {
        unsigned b[4];
        ldsm_t(b, bt_addr<kS>(kt, 16 * kk, 16 * n2, lane));
        mma(dqa[2 * n2], a, b[0], b[1]);
        mma(dqa[2 * n2 + 1], a, b[2], b[3]);
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }
  bf16* qw = qs + warp * 16 * kS;  // this warp's Q rows, read by no other warp
  frag_store<Dmax>(qw, dqa, 1.f, 1.f, lane);
  __syncwarp();
  warp_store<Dmax>(dq + head, qw, q0 + warp * 16, S, D, vec, lane);
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if ((uintptr_t)p % 16) return false;
  return true;
}

template <int Dmax>
int forward_tc(const void* q, const void* k, const void* v, void* o, float* lse, int BN, int S,
               int D, float scale, cudaStream_t s) {
  const int vec = D % 8 == 0 && aligned16({q, k, v, o});
  const size_t smem = fwd_tc_smem<Dmax>();
  int rc;
  if ((rc = prepare(fwd_tc_kernel<Dmax>, smem))) return rc;
  const dim3 grid((S + kTile - 1) / kTile, BN);
  fwd_tc_kernel<Dmax><<<grid, kTcThreads, smem, s>>>((const bf16*)q, (const bf16*)k,
                                                     (const bf16*)v, (bf16*)o, lse, S, D, scale,
                                                     vec);
  return (int)cudaGetLastError();
}

template <int Dmax>
int backward_tc(const void* q, const void* k, const void* v, const void* o, const void* g,
                const float* lse, float* dvec, void* dq, void* dk, void* dv, int BN, int S, int D,
                float scale, cudaStream_t s) {
  const int vec = D % 8 == 0 && aligned16({q, k, v, o, g, dq, dk, dv});
  const int rows = BN * S;
  if (vec) {
    int lanes = 1;
    while (lanes < D / 8) lanes *= 2;
    const long long threads = (long long)rows * lanes;
    dot_v8_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        (const bf16*)o, (const bf16*)g, dvec, rows, D, lanes);
  } else {
    const int per_block = kThreads / 32;
    dot_kernel<bf16><<<(rows + per_block - 1) / per_block, kThreads, 0, s>>>(
        (const bf16*)o, (const bf16*)g, dvec, rows, D);
  }
  int rc;
  if ((rc = (int)cudaGetLastError())) return rc;
  const size_t smem = bwd_tc_smem<Dmax>();
  const dim3 grid((S + kTile - 1) / kTile, BN);
  if ((rc = prepare(dkdv_tc_kernel<Dmax>, smem))) return rc;
  dkdv_tc_kernel<Dmax><<<grid, kTcThreads, smem, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g, lse, dvec, (bf16*)dk,
      (bf16*)dv, S, D, scale, vec);
  if ((rc = (int)cudaGetLastError())) return rc;
  if ((rc = prepare(dq_tc_kernel<Dmax>, smem))) return rc;
  dq_tc_kernel<Dmax><<<grid, kTcThreads, smem, s>>>((const bf16*)q, (const bf16*)k,
                                                    (const bf16*)v, (const bf16*)g, lse, dvec,
                                                    (bf16*)dq, S, D, scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface, loaded with ctypes. (B, N, S, D) tensors are contiguous; BN = B * N.
// Every launcher runs its kernels on CUDA device `device` (made current only if it
// is not), enqueues them on `stream`, does not synchronise, and returns a CUDA
// error code (0 on success; cudaErrorInvalidValue for a D the kernels do not take).
// bf16 runs the tensor-core kernels, fp32 the fp32-FMA kernels.
// ---------------------------------------------------------------------------

#define FA_DISPATCH(fp32_fn, bf16_fn, ...)                                    \
  if (S < 1 || D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;         \
  DeviceGuard guard(device);                                                  \
  if (guard.err) return guard.err;                                            \
  cudaStream_t s = (cudaStream_t)stream;                                      \
  if (bf16_io) {                                                              \
    if (D <= 32) return bf16_fn<32>(__VA_ARGS__, s);                          \
    if (D <= 64) return bf16_fn<64>(__VA_ARGS__, s);                          \
    return bf16_fn<128>(__VA_ARGS__, s);                                      \
  }                                                                           \
  if (D <= 32) return fp32_fn<float, 32>(__VA_ARGS__, s);                     \
  if (D <= 64) return fp32_fn<float, 64>(__VA_ARGS__, s);                     \
  return fp32_fn<float, 128>(__VA_ARGS__, s);

extern "C" {

// o (BN, S, D) in the input dtype, lse (BN, S) fp32.
int fa_forward(const void* q, const void* k, const void* v, int bf16_io, void* o, float* lse,
               int BN, int S, int D, float scale, int device, void* stream) {
  FA_DISPATCH(forward, forward_tc, q, k, v, o, lse, BN, S, D, scale)
}

// g = dL/do; dvec (BN, S) fp32 scratch; dq, dk, dv in the input dtype.
int fa_backward(const void* q, const void* k, const void* v, const void* o, const void* g,
                const float* lse, int bf16_io, float* dvec, void* dq, void* dk, void* dv, int BN,
                int S, int D, float scale, int device, void* stream) {
  FA_DISPATCH(backward, backward_tc, q, k, v, o, g, lse, dvec, dq, dk, dv, BN, S, D, scale)
}

}  // extern "C"
