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
// Design. One thread block of 256 threads (16 x 16) owns a 64-row tile and walks
// the other side's 64-row tiles, so the (S, S) scores never reach device memory:
//   forward   block per (b, n, query tile): online softmax over the key tiles
//             (running max m and sum l in fp32, O accumulated in fp32), then
//             o = O / l and lse = m + log l (fp32, (B, N, S)) for the backward;
//   backward  three launches and no float atomics, so every run gives the same
//             bits: Dvec = rowsum(dO * o); a block per key tile that loops over
//             the query tiles, recomputes P = exp(S * scale - lse) and sums
//             dV += P^T dO, dK += scale * dS^T Q with dS = P * (dO V^T - Dvec);
//             a block per query tile that loops over the key tiles for
//             dQ += scale * dS K.
// Each thread holds a 4 x 4 patch of the 64 x 64 score tile (rows ty*4+i,
// columns tx+16j) and the matching 4 x (D/16) patch of its accumulators; rows
// of a tile are reduced over the 16 threads that share them with warp shuffles.
// Tiles sit in shared memory as fp32, row-major with a row stride of Dmax+1 or
// transposed with a stride of 65, so every inner-loop read is a broadcast or
// hits 32 distinct banks. Head sizes up to 128 are compiled for Dmax 32, 64 and
// 128 (a D below Dmax is zero-padded); any S is taken, the ragged last tile is
// masked inside the kernels.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16): at the probe's shape
// (16, 12, 256, 64) bf16 the forward must move ~26 MB (q, k, v, o, lse) for
// 3.2 GFLOP and the backward ~51 MB for 8.1 GFLOP, so both are bound by bytes
// (~8 and ~15 us). These kernels multiply in fp32 FMA from shared memory, one
// block at a time per SM for Dmax 128, so they are far from that; bf16 tensor
// cores (mma.sync or wgmma) with TMA-fed tiles are the redesign's work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <math.h>
#include <stddef.h>

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

}  // namespace

// ---------------------------------------------------------------------------
// C interface, loaded with ctypes. (B, N, S, D) tensors are contiguous; BN = B * N.
// Every launcher enqueues on `stream`, does not synchronise, and returns a CUDA
// error code (0 on success; cudaErrorInvalidValue for a D the kernels do not take).
// ---------------------------------------------------------------------------

#define FA_DISPATCH(fn, ...)                                                  \
  if (S < 1 || D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;         \
  cudaStream_t s = (cudaStream_t)stream;                                      \
  if (bf16_io) {                                                              \
    if (D <= 32) return fn<bf16, 32>(__VA_ARGS__, s);                         \
    if (D <= 64) return fn<bf16, 64>(__VA_ARGS__, s);                         \
    return fn<bf16, 128>(__VA_ARGS__, s);                                     \
  }                                                                           \
  if (D <= 32) return fn<float, 32>(__VA_ARGS__, s);                          \
  if (D <= 64) return fn<float, 64>(__VA_ARGS__, s);                          \
  return fn<float, 128>(__VA_ARGS__, s);

extern "C" {

// o (BN, S, D) in the input dtype, lse (BN, S) fp32.
int fa_forward(const void* q, const void* k, const void* v, int bf16_io, void* o, float* lse,
               int BN, int S, int D, float scale, void* stream) {
  FA_DISPATCH(forward, q, k, v, o, lse, BN, S, D, scale)
}

// g = dL/do; dvec (BN, S) fp32 scratch; dq, dk, dv in the input dtype.
int fa_backward(const void* q, const void* k, const void* v, const void* o, const void* g,
                const float* lse, int bf16_io, float* dvec, void* dq, void* dk, void* dv, int BN,
                int S, int D, float scale, void* stream) {
  FA_DISPATCH(backward, q, k, v, o, g, lse, dvec, dq, dk, dv, BN, S, D, scale)
}

}  // extern "C"
