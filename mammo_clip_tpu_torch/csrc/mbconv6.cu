// Hand-written CUDA for the e=1 form of the fused train-mode MBConv block on
// Hopper (sm_90a): the stage kernels.
//
// Replaces the Pallas kernels of mammo_clip_tpu/ops/mbconv6_pallas.py::
// fused_mbconv_e6 in its e=1 form (params of type MBConvParams: the depthwise
// runs on x itself, no expand conv and no bn0): the forward phases _p2_kernel
// .. _p5_kernel and the backward phases _b1_kernel, _b2_kernel and _b4_kernel.
// The expanding form has its own recompute kernels (csrc/mbconv6_e6.cu). The
// Python side (ops/mbconv6.py::_forward_kernels, _backward_kernels) sequences
// these kernels; only the analytic per-channel combinations (mean/var from
// sums, rsqrt, the SE MLP on (N, C) vectors) stay torch ops, as they stayed
// host-side jnp in the Pallas version.
//
// Design. The TPU kernel recomputes the chain in its passes because VMEM
// cannot hold it; here the intermediates (d, v, y and their cotangents) are
// stored in device memory in fp32, one simple kernel per stage:
//   mix          1x1 channel product out[n,co,p] = sum_ci w[ci,co] in[n,ci,p]
//                (project Wp, and its transpose in backward), shared-memory
//                tiled, fp32 FMA accumulation
//   pgemm        per-image product reduced over positions, split over position
//                chunks (T = v dy^T, which gives dWp and dgate)
//   dw_fwd       3x3 depthwise with SAME edges on the valid image
//   dw_bwd_x     transposed stencil (correlation with the flipped taps)
//   dw_bwd_k     the 9 tap-correlation sums for dK
//   reduce_*     per-(image, channel) sums over the valid region in two
//                deterministic levels (block tree, then a fixed-order loop);
//                no float atomics, so every run gives the same bits
//   elementwise  bn+silu, x delta + residual, and the bn/silu backward terms
// Every output is written with its pad region zero, so fused blocks chain.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16, 67 TFLOP/s fp32
// without tensor cores): the function must read x (and dout) and write out
// (and dx), N*(C+C2)*P elements each way; its channel product is 2*N*P*C*C2
// FLOPs (two in backward). At B5 block 0 (N=2, 48->24, 760x456, bf16) that is
// ~100 MB against ~1.7 GFLOP, so the bound is bytes (~0.03 ms forward). These
// kernels move every fp32 intermediate through device memory and run the
// product on fp32 FMA, so they are far from that bound; a recompute design
// with the product on the tensor cores, as the expanding form has, is later
// work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <stddef.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kMixBM = 64, kMixBN = 64, kMixBK = 16;
constexpr int kPgBM = 64, kPgBK = 64, kPgBP = 16;
constexpr int kPgChunk = 2048;
constexpr int kRedChunk = 4096;
constexpr int kDwRows = 8;
constexpr int kEwBlocks = 4224;  // 32 blocks per SM, grid-stride

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const bf16* p, size_t i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(bf16* p, size_t i, float v) { p[i] = __float2bfloat16(v); }

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }
__device__ __forceinline__ float dsilu(float x) {
  float s = 1.f / (1.f + expf(-x));
  return s * (1.f + x * (1.f - s));
}

// Tree reduction of one value per thread over a block of kThreads; result in red[0].
__device__ __forceinline__ void block_sum(float* red, float v) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
}

// out[n,co,p] = sum_ci w[ci*Co+co] * in[n,ci,p] * (scale ? scale[n*Ci+ci] : 1)
template <typename T>
__global__ void __launch_bounds__(kThreads)
mix_kernel(const T* __restrict__ in, const float* __restrict__ w,
           const float* __restrict__ scale, float* __restrict__ out,
           int Ci, int Co, int P) {
  __shared__ float Ws[kMixBK][kMixBM];
  __shared__ float Xs[kMixBK][kMixBN];
  const int n = blockIdx.z;
  const int co0 = blockIdx.y * kMixBM;
  const int p0 = blockIdx.x * kMixBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* inn = in + (size_t)n * Ci * P;
  float acc[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < Ci; k0 += kMixBK) {
    for (int i = tid; i < kMixBK * kMixBM; i += kThreads) {
      const int kk = i / kMixBM, mm = i % kMixBM;
      const int ci = k0 + kk, co = co0 + mm;
      Ws[kk][mm] = (ci < Ci && co < Co) ? w[(size_t)ci * Co + co] : 0.f;
    }
    for (int i = tid; i < kMixBK * kMixBN; i += kThreads) {
      const int kk = i / kMixBN, pp = i % kMixBN;
      const int ci = k0 + kk, p = p0 + pp;
      float v = 0.f;
      if (ci < Ci && p < P) {
        v = ld(inn, (size_t)ci * P + p);
        if (scale) v *= scale[(size_t)n * Ci + ci];
      }
      Xs[kk][pp] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kMixBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Ws[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Xs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i) {
    const int co = co0 + ty + 16 * i;
    if (co >= Co) continue;
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + tx + 16 * j;
      if (p < P) out[((size_t)n * Co + co) * P + p] = acc[i][j];
    }
  }
}

// partial[((n*M + m)*K + k)*nchunk + chunk] = sum over the chunk's positions p
// of A[n,m,p] * B[n,k,p]. Callers pass a B that is zero outside the valid
// region, so no mask is needed here.
template <typename T>
__global__ void __launch_bounds__(kThreads)
pgemm_kernel(const T* __restrict__ A, const float* __restrict__ B,
             float* __restrict__ partial, int M, int K, int P, int nchunk) {
  __shared__ float As[kPgBP][kPgBM + 1];
  __shared__ float Bs[kPgBP][kPgBK + 1];
  const int n = blockIdx.z;
  const int chunk = blockIdx.x;
  const int tiles_k = (K + kPgBK - 1) / kPgBK;
  const int m0 = (blockIdx.y / tiles_k) * kPgBM;
  const int k0 = (blockIdx.y % tiles_k) * kPgBK;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int pstart = chunk * kPgChunk;
  const int pend = min(P, pstart + kPgChunk);
  const T* An = A + (size_t)n * M * P;
  const float* Bn = B + (size_t)n * K * P;
  float acc[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int q0 = pstart; q0 < pend; q0 += kPgBP) {
    for (int i = tid; i < kPgBP * kPgBM; i += kThreads) {
      const int mm = i / kPgBP, q = i % kPgBP;
      const int m = m0 + mm, p = q0 + q;
      As[q][mm] = (m < M && p < pend) ? ld(An, (size_t)m * P + p) : 0.f;
    }
    for (int i = tid; i < kPgBP * kPgBK; i += kThreads) {
      const int kk = i / kPgBP, q = i % kPgBP;
      const int k = k0 + kk, p = q0 + q;
      Bs[q][kk] = (k < K && p < pend) ? Bn[(size_t)k * P + p] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPgBP; ++q) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[q][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[q][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx + 16 * j;
      if (k < K) partial[(((size_t)n * M + m) * K + k) * nchunk + chunk] = acc[i][j];
    }
  }
}

// Loads rows [r0-1, r0+kDwRows] x cols [-1, W] of the depthwise input plane (x)
// into the tile, zero outside the valid image.
template <typename T>
__device__ __forceinline__ void load_w_tile(float* tile, const T* __restrict__ src, int r0,
                                            int W, int vh, int vw) {
  const int tw = W + 2;
  for (int i = threadIdx.x; i < (kDwRows + 2) * tw; i += kThreads) {
    const int r = r0 + i / tw - 1, c = i % tw - 1;
    tile[i] = (r >= 0 && r < vh && c >= 0 && c < vw) ? ld(src, (size_t)r * W + c) : 0.f;
  }
}

// d[n,e,r,c] = sum_ab k9[e,3a+b] * w[r+a-1, c+b-1] on the valid image, 0 elsewhere.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dw_fwd_kernel(const T* __restrict__ src, const float* __restrict__ k9,
              float* __restrict__ d, int E, int H, int W, int vh, int vw) {
  extern __shared__ float tile[];
  const int r0 = blockIdx.x * kDwRows, e = blockIdx.y, n = blockIdx.z;
  const size_t plane = ((size_t)n * E + e) * H * W;
  load_w_tile(tile, src + plane, r0, W, vh, vw);
  __syncthreads();
  float kk[9];
  for (int t = 0; t < 9; ++t) kk[t] = k9[e * 9 + t];
  const int tw = W + 2;
  for (int i = threadIdx.x; i < kDwRows * W; i += kThreads) {
    const int tr = i / W, c = i % W, r = r0 + tr;
    if (r >= H) break;
    float acc = 0.f;
    if (r < vh && c < vw) {
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) acc = fmaf(kk[a * 3 + b], tile[(tr + a) * tw + c + b], acc);
    }
    d[plane + (size_t)r * W + c] = acc;
  }
}

// out[q] = sum_ab k9[3a+b] * dd[q - (a-1, b-1)] on the valid image, 0 elsewhere.
__global__ void __launch_bounds__(kThreads)
dw_bwd_x_kernel(const float* __restrict__ dd, const float* __restrict__ k9,
                float* __restrict__ out, int E, int H, int W, int vh, int vw) {
  extern __shared__ float tile[];
  const int r0 = blockIdx.x * kDwRows, e = blockIdx.y, n = blockIdx.z;
  const size_t plane = ((size_t)n * E + e) * H * W;
  const int tw = W + 2;
  for (int i = threadIdx.x; i < (kDwRows + 2) * tw; i += kThreads) {
    const int r = r0 + i / tw - 1, c = i % tw - 1;
    tile[i] = (r >= 0 && r < vh && c >= 0 && c < vw) ? dd[plane + (size_t)r * W + c] : 0.f;
  }
  __syncthreads();
  float kk[9];
  for (int t = 0; t < 9; ++t) kk[t] = k9[e * 9 + t];
  for (int i = threadIdx.x; i < kDwRows * W; i += kThreads) {
    const int tr = i / W, c = i % W, r = r0 + tr;
    if (r >= H) break;
    float acc = 0.f;
    if (r < vh && c < vw) {
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b)
          acc = fmaf(kk[a * 3 + b], tile[(tr + 2 - a) * tw + c + 2 - b], acc);
    }
    out[plane + (size_t)r * W + c] = acc;
  }
}

// partial[((n*E + e)*nchunk + chunk)*9 + 3a+b] = sum over the block's valid rows
// of dd[r,c] * w[r+a-1, c+b-1].
template <typename T>
__global__ void __launch_bounds__(kThreads)
dw_bwd_k_kernel(const float* __restrict__ dd, const T* __restrict__ src,
                float* __restrict__ partial, int E, int H, int W, int vh, int vw) {
  extern __shared__ float tile[];
  __shared__ float red[kThreads];
  const int chunk = blockIdx.x, e = blockIdx.y, n = blockIdx.z;
  const int nchunk = gridDim.x;
  const int r0 = chunk * kDwRows;
  const size_t plane = ((size_t)n * E + e) * H * W;
  load_w_tile(tile, src + plane, r0, W, vh, vw);
  __syncthreads();
  const int tw = W + 2;
  float acc[9];
  for (int t = 0; t < 9; ++t) acc[t] = 0.f;
  for (int i = threadIdx.x; i < kDwRows * W; i += kThreads) {
    const int tr = i / W, c = i % W, r = r0 + tr;
    if (r >= vh) break;
    if (c >= vw) continue;
    const float g = dd[plane + (size_t)r * W + c];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) acc[a * 3 + b] = fmaf(g, tile[(tr + a) * tw + c + b], acc[a * 3 + b]);
  }
  float* dst = partial + (((size_t)n * E + e) * nchunk + chunk) * 9;
  for (int t = 0; t < 9; ++t) {
    block_sum(red, acc[t]);
    if (threadIdx.x == 0) dst[t] = red[0];
    __syncthreads();
  }
}

// partial[((n*Ch + ch)*nchunk + chunk)*2 + {0,1}] = sums over the chunk's valid
// positions of a and of a*b', with b' = (b - mb[ch]) * ib[ch] when mb is given,
// b' = b when only b is given, and b' = a when b is null.
__global__ void __launch_bounds__(kThreads)
reduce_partial_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      const float* mb, const float* ib, float* __restrict__ partial,
                      int Ch, int H, int W, int vh, int vw) {
  __shared__ float red[kThreads];
  const int chunk = blockIdx.x, ch = blockIdx.y, n = blockIdx.z;
  const int nchunk = gridDim.x;
  const int P = H * W;
  const size_t base = ((size_t)n * Ch + ch) * P;
  const float m = mb ? mb[ch] : 0.f, iv = mb ? ib[ch] : 1.f;
  float s1 = 0.f, s2 = 0.f;
  const int pend = min(P, (chunk + 1) * kRedChunk);
  for (int p = chunk * kRedChunk + threadIdx.x; p < pend; p += kThreads) {
    const int r = p / W, c = p - r * W;
    if (r < vh && c < vw) {
      const float x = a[base + p];
      const float y = b ? (b[base + p] - m) * iv : x;
      s1 += x;
      s2 = fmaf(x, y, s2);
    }
  }
  float* dst = partial + (((size_t)n * Ch + ch) * nchunk + chunk) * 2;
  block_sum(red, s1);
  if (threadIdx.x == 0) dst[0] = red[0];
  __syncthreads();
  block_sum(red, s2);
  if (threadIdx.x == 0) dst[1] = red[0];
}

// Second level: out_n[(n*Ch + ch)*K + k] = sum over chunks, out[ch*K + k] = sum
// over n of out_n, both in a fixed order.
__global__ void reduce_final_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out_n, float* __restrict__ out,
                                    int N, int Ch, int nchunk, int K) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= Ch * K) return;
  const int ch = idx / K, k = idx % K;
  float tot = 0.f;
  for (int n = 0; n < N; ++n) {
    const float* src = partial + ((size_t)n * Ch + ch) * nchunk * K + k;
    float s = 0.f;
    for (int c = 0; c < nchunk; ++c) s += src[(size_t)c * K];
    if (out_n) out_n[((size_t)n * Ch + ch) * K + k] = s;
    tot += s;
  }
  if (out) out[idx] = tot;
}

struct Pos {
  int n, ch;
  bool valid;
};

__device__ __forceinline__ Pos pos_of(size_t i, int Ch, int H, int W, int vh, int vw) {
  const size_t P = (size_t)H * W;
  const int p = (int)(i % P);
  const size_t nc = i / P;
  const int r = p / W, c = p - r * W;
  return Pos{(int)(nc / Ch), (int)(nc % Ch), r < vh && c < vw};
}

#define EW_LOOP(total) \
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < (total); \
       i += (size_t)gridDim.x * kThreads)

// v = silu((d - m) * a + be) on the valid image, 0 elsewhere.
__global__ void __launch_bounds__(kThreads)
bn_act_kernel(const float* __restrict__ d, const float* __restrict__ m,
              const float* __restrict__ a, const float* __restrict__ be,
              float* __restrict__ v, int N, int Ch, int H, int W, int vh, int vw) {
  const size_t total = (size_t)N * Ch * H * W;
  EW_LOOP(total) {
    const Pos q = pos_of(i, Ch, H, W, vh, vw);
    v[i] = q.valid ? silu((d[i] - m[q.ch]) * a[q.ch] + be[q.ch]) : 0.f;
  }
}

// out = g * delta[n] on the valid image, 0 elsewhere.
template <typename T>
__global__ void __launch_bounds__(kThreads)
scale_rows_kernel(const T* __restrict__ g, const float* __restrict__ delta,
                  float* __restrict__ out, int N, int Ch, int H, int W, int vh, int vw) {
  const size_t total = (size_t)N * Ch * H * W;
  EW_LOOP(total) {
    const Pos q = pos_of(i, Ch, H, W, vh, vw);
    out[i] = q.valid ? ld(g, i) * delta[q.n] : 0.f;
  }
}

// Batch-norm backward apply: out = a*k1 - k2 - (x - m)*inv*k3 on the valid
// image, 0 elsewhere. out may alias a.
__global__ void __launch_bounds__(kThreads)
bn_bwd_kernel(const float* a, const float* __restrict__ x, const float* __restrict__ m,
              const float* __restrict__ inv, const float* __restrict__ k1,
              const float* __restrict__ k2, const float* __restrict__ k3, float* out,
              int N, int Ch, int H, int W, int vh, int vw) {
  const size_t total = (size_t)N * Ch * H * W;
  EW_LOOP(total) {
    const Pos q = pos_of(i, Ch, H, W, vh, vw);
    const int c = q.ch;
    out[i] = q.valid ? a[i] * k1[c] - k2[c] - (x[i] - m[c]) * inv[c] * k3[c] : 0.f;
  }
}

// SE/bn1-silu backward: out = (du*gate[n,e] + ds[n,e]) * dsilu((d - m)*a + be)
// on the valid image, 0 elsewhere. ds is dL/ds_mean already divided by H*W.
// out may alias du.
__global__ void __launch_bounds__(kThreads)
dv_bwd_kernel(const float* du, const float* __restrict__ d, const float* __restrict__ m,
              const float* __restrict__ a, const float* __restrict__ be,
              const float* __restrict__ gate, const float* __restrict__ ds, float* out,
              int N, int Ch, int H, int W, int vh, int vw) {
  const size_t total = (size_t)N * Ch * H * W;
  EW_LOOP(total) {
    const Pos q = pos_of(i, Ch, H, W, vh, vw);
    const int c = q.ch;
    const size_t nc = (size_t)q.n * Ch + c;
    out[i] = q.valid ? (du[i] * gate[nc] + ds[nc]) * dsilu((d[i] - m[c]) * a[c] + be[c]) : 0.f;
  }
}

// out = ([x +] delta[n] * ((y - m)*a + be)) on the valid image, 0 elsewhere.
template <typename T>
__global__ void __launch_bounds__(kThreads)
out_fwd_kernel(const T* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ m, const float* __restrict__ a,
               const float* __restrict__ be, const float* __restrict__ delta,
               int residual, T* __restrict__ out, int N, int Ch, int H, int W, int vh,
               int vw) {
  const size_t total = (size_t)N * Ch * H * W;
  EW_LOOP(total) {
    const Pos q = pos_of(i, Ch, H, W, vh, vw);
    float v = 0.f;
    if (q.valid) {
      v = delta[q.n] * ((y[i] - m[q.ch]) * a[q.ch] + be[q.ch]);
      if (residual) v += ld(x, i);
    }
    st(out, i, v);
  }
}

// out = a [+ g] on the valid image, 0 elsewhere, in the I/O type.
template <typename T>
__global__ void __launch_bounds__(kThreads)
finish_kernel(const float* __restrict__ a, const T* __restrict__ g, T* __restrict__ out,
              int N, int Ch, int H, int W, int vh, int vw) {
  const size_t total = (size_t)N * Ch * H * W;
  EW_LOOP(total) {
    const Pos q = pos_of(i, Ch, H, W, vh, vw);
    float v = 0.f;
    if (q.valid) {
      v = a[i];
      if (g) v += ld(g, i);
    }
    st(out, i, v);
  }
}

int ew_blocks(size_t total) {
  const size_t b = (total + kThreads - 1) / kThreads;
  return (int)(b < (size_t)kEwBlocks ? b : (size_t)kEwBlocks);
}

size_t dw_smem(int W) { return (size_t)(kDwRows + 2) * (W + 2) * sizeof(float); }

constexpr size_t kMaxDynSmem = 48 * 1024;

}  // namespace

// ---------------------------------------------------------------------------
// C interface, loaded with ctypes. Every launcher enqueues on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).
// ---------------------------------------------------------------------------

extern "C" {

int mbc_dw_max_width() { return (int)(kMaxDynSmem / ((kDwRows + 2) * sizeof(float))) - 2; }
int mbc_red_chunk() { return kRedChunk; }
int mbc_pg_chunk() { return kPgChunk; }
int mbc_dw_rows() { return kDwRows; }

int mbc_mix(const void* in, int in_bf16, const float* w, const float* scale, float* out,
            int N, int Ci, int Co, int P, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((P + kMixBN - 1) / kMixBN, (Co + kMixBM - 1) / kMixBM, N);
  if (in_bf16)
    mix_kernel<bf16><<<grid, kThreads, 0, s>>>((const bf16*)in, w, scale, out, Ci, Co, P);
  else
    mix_kernel<float><<<grid, kThreads, 0, s>>>((const float*)in, w, scale, out, Ci, Co, P);
  return (int)cudaGetLastError();
}

int mbc_pgemm(const void* a, int a_bf16, const float* b, float* partial, int N, int M,
              int K, int P, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nchunk = (P + kPgChunk - 1) / kPgChunk;
  const int tiles = ((M + kPgBM - 1) / kPgBM) * ((K + kPgBK - 1) / kPgBK);
  dim3 grid(nchunk, tiles, N);
  if (a_bf16)
    pgemm_kernel<bf16><<<grid, kThreads, 0, s>>>((const bf16*)a, b, partial, M, K, P, nchunk);
  else
    pgemm_kernel<float><<<grid, kThreads, 0, s>>>((const float*)a, b, partial, M, K, P, nchunk);
  return (int)cudaGetLastError();
}

int mbc_dw_fwd(const void* src, int src_bf16, const float* k9, float* d, int N, int E, int H,
               int W, int vh, int vw, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = dw_smem(W);
  if (smem > kMaxDynSmem) return (int)cudaErrorInvalidValue;
  dim3 grid((H + kDwRows - 1) / kDwRows, E, N);
  if (src_bf16)
    dw_fwd_kernel<bf16><<<grid, kThreads, smem, s>>>((const bf16*)src, k9, d, E, H, W, vh, vw);
  else
    dw_fwd_kernel<float><<<grid, kThreads, smem, s>>>((const float*)src, k9, d, E, H, W, vh, vw);
  return (int)cudaGetLastError();
}

int mbc_dw_bwd_x(const float* dd, const float* k9, float* out, int N, int E, int H, int W,
                 int vh, int vw, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = dw_smem(W);
  if (smem > kMaxDynSmem) return (int)cudaErrorInvalidValue;
  dim3 grid((H + kDwRows - 1) / kDwRows, E, N);
  dw_bwd_x_kernel<<<grid, kThreads, smem, s>>>(dd, k9, out, E, H, W, vh, vw);
  return (int)cudaGetLastError();
}

int mbc_dw_bwd_k(const float* dd, const void* src, int src_bf16, float* partial, int N, int E,
                 int H, int W, int vh, int vw, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = dw_smem(W);
  if (smem > kMaxDynSmem) return (int)cudaErrorInvalidValue;
  dim3 grid((H + kDwRows - 1) / kDwRows, E, N);
  if (src_bf16)
    dw_bwd_k_kernel<bf16><<<grid, kThreads, smem, s>>>(dd, (const bf16*)src, partial, E, H, W, vh, vw);
  else
    dw_bwd_k_kernel<float><<<grid, kThreads, smem, s>>>(dd, (const float*)src, partial, E, H, W, vh, vw);
  return (int)cudaGetLastError();
}

int mbc_reduce_partial(const float* a, const float* b, const float* mb, const float* ib,
                       float* partial, int N, int Ch, int H, int W, int vh, int vw,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nchunk = (H * W + kRedChunk - 1) / kRedChunk;
  dim3 grid(nchunk, Ch, N);
  reduce_partial_kernel<<<grid, kThreads, 0, s>>>(a, b, mb, ib, partial, Ch, H, W, vh, vw);
  return (int)cudaGetLastError();
}

int mbc_reduce_final(const float* partial, float* out_n, float* out, int N, int Ch,
                     int nchunk, int K, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int total = Ch * K;
  reduce_final_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0, s>>>(partial, out_n, out, N, Ch, nchunk, K);
  return (int)cudaGetLastError();
}

int mbc_bn_act(const float* d, const float* m, const float* a, const float* be, float* v,
               int N, int Ch, int H, int W, int vh, int vw, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  bn_act_kernel<<<ew_blocks((size_t)N * Ch * H * W), kThreads, 0, s>>>(d, m, a, be, v, N, Ch, H, W, vh, vw);
  return (int)cudaGetLastError();
}

int mbc_scale_rows(const void* g, int g_bf16, const float* delta, float* out, int N,
                   int Ch, int H, int W, int vh, int vw, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = ew_blocks((size_t)N * Ch * H * W);
  if (g_bf16)
    scale_rows_kernel<bf16><<<blocks, kThreads, 0, s>>>((const bf16*)g, delta, out, N, Ch, H, W, vh, vw);
  else
    scale_rows_kernel<float><<<blocks, kThreads, 0, s>>>((const float*)g, delta, out, N, Ch, H, W, vh, vw);
  return (int)cudaGetLastError();
}

int mbc_bn_bwd(const float* a, const float* x, const float* m, const float* inv,
               const float* k1, const float* k2, const float* k3, float* out, int N,
               int Ch, int H, int W, int vh, int vw, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  bn_bwd_kernel<<<ew_blocks((size_t)N * Ch * H * W), kThreads, 0, s>>>(a, x, m, inv, k1, k2, k3, out, N, Ch, H, W, vh, vw);
  return (int)cudaGetLastError();
}

int mbc_dv_bwd(const float* du, const float* d, const float* m, const float* a,
               const float* be, const float* gate, const float* ds, float* out, int N,
               int Ch, int H, int W, int vh, int vw, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dv_bwd_kernel<<<ew_blocks((size_t)N * Ch * H * W), kThreads, 0, s>>>(du, d, m, a, be, gate, ds, out, N, Ch, H, W, vh, vw);
  return (int)cudaGetLastError();
}

int mbc_out_fwd(const void* x, int bf16_io, const float* y, const float* m, const float* a,
                const float* be, const float* delta, int residual, void* out, int N,
                int Ch, int H, int W, int vh, int vw, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = ew_blocks((size_t)N * Ch * H * W);
  if (bf16_io)
    out_fwd_kernel<bf16><<<blocks, kThreads, 0, s>>>((const bf16*)x, y, m, a, be, delta, residual, (bf16*)out, N, Ch, H, W, vh, vw);
  else
    out_fwd_kernel<float><<<blocks, kThreads, 0, s>>>((const float*)x, y, m, a, be, delta, residual, (float*)out, N, Ch, H, W, vh, vw);
  return (int)cudaGetLastError();
}

int mbc_finish(const float* a, const void* g, int bf16_io, void* out, int N, int Ch,
               int H, int W, int vh, int vw, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = ew_blocks((size_t)N * Ch * H * W);
  if (bf16_io)
    finish_kernel<bf16><<<blocks, kThreads, 0, s>>>(a, (const bf16*)g, (bf16*)out, N, Ch, H, W, vh, vw);
  else
    finish_kernel<float><<<blocks, kThreads, 0, s>>>(a, (const float*)g, (float*)out, N, Ch, H, W, vh, vw);
  return (int)cudaGetLastError();
}

}  // extern "C"
