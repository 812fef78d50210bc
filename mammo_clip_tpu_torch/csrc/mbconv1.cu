// Hand-written CUDA for the standalone e=1 MBConv block on Hopper (sm_90a).
//
// Replaces the Pallas kernels of mammo_clip_tpu/ops/mbconv_pallas.py::
// fused_mbconv_e1: the forward phases _p1_kernel, _p2_kernel, _p3_kernel and
// the backward phases _b1_kernel, _b2_kernel, _b3_kernel. The Python side
// (ops/mbconv.py) sequences them; the per-channel and per-image combinations
// between passes (BN stats from sums, the SE MLP and its backward, the BN2
// stats from the per-image second moments, dK from the tap sums) stay small
// torch ops there, as they stayed host-side jnp in the Pallas version.
//
// Design. The TPU kernel keeps nothing but x and a few per-channel and
// per-image vectors from forward to backward and recomputes the block from x
// in every pass; this port keeps that design, with serial per-pixel channel
// loops on the CUDA cores (csrc/mbconv6_e6.cu's e=1 form computes the same
// block with its channel products on the tensor cores):
//   P1  stencil -> per-channel [sum d, sum d^2]
//   P2  recompute d -> bn1 -> silu v; per image sum v and M = sum v v^T (C x C)
//   P3  recompute v; u = v*gate; y = u Wp; bn2; out = delta*yhat [+ x]
//   B1  recompute to ybar; [sum dyhat, sum dyhat*ybar]; per image T1 = sum v dyhat^T,
//       T2 = sum v ybar^T
//   B2  recompute to dy, du, ddhat; [sum ddhat, sum ddhat*dbar], dWp = sum u dy^T,
//       and the 27 tap sums [x_tap, x_tap*dbar, x_tap*ddhat] for dK
//   B3  dd on the tile plus a 1-pixel ring (x with a 2-pixel halo), then
//       dx = corr(K, dd) [+ dout]
// One thread block per (image, row tile of kRows rows) walks the row tile in
// chunks of kCols columns; each chunk's x halo tile (all channels, fp32) sits
// in shared memory with one thread per pixel. The per-pixel channel products
// (u Wp, Wp dy) are the kernel's own loops over shared memory. Every reduction
// is deterministic: a thread owns each output entry and sums its chunk's
// pixels in a fixed order, each block writes one partial per entry, and a
// second kernel adds the partials of the row tiles in a fixed order (no float
// atomics), so every run gives the same bits.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16): the function must
// read x (and dout) and write out (and dx); its channel product is 2*P*C*C2
// FLOPs and its stencil 18*P*C. At B5 blocks 1-2 (N=2, C=C2=24, 760x456, bf16)
// that is ~67 MB forward against ~1.1 GFLOP, so the bound is bytes (~0.02 ms). These
// loops run fp32 FMA from shared memory at low occupancy and re-read x once
// per pass, so they are far from that bound; wgmma for the products and
// more blocks in flight are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <stddef.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 4;                 // rows of a block's row tile
constexpr int kCols = 32;                // columns of one chunk
constexpr int kPix = kRows * kCols;      // pixels of a chunk: one per thread
constexpr int kLd = kPix + 1;            // row stride of per-pixel smem arrays (no bank conflicts)
constexpr int kTw1 = kCols + 2;          // x tile width with a 1-pixel halo
constexpr int kTs1 = (kRows + 2) * kTw1; // x tile size per channel, 1-pixel halo
constexpr int kTw2 = kCols + 4;          // x tile width with a 2-pixel halo (B3)
constexpr int kTs2 = (kRows + 4) * kTw2;
constexpr int kExt = (kRows + 2) * kTw1; // B3: chunk plus a 1-pixel ring
constexpr int kLdE = kExt + 1;
constexpr int kMaxC = 64;                // widest C and C2 the kernels take
constexpr int kVecSlots = (2 * kMaxC + kThreads - 1) / kThreads;
constexpr int kOuterSlots = (kMaxC * kMaxC + kThreads - 1) / kThreads;
constexpr int kTapSlots = (27 * kMaxC + kThreads - 1) / kThreads;
constexpr size_t kMaxSmem = 232448;      // per-block opt-in limit on sm_90

static_assert(kPix == kThreads, "one pixel per thread");

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const bf16* p, size_t i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(bf16* p, size_t i, float v) { p[i] = __float2bfloat16(v); }

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }
__device__ __forceinline__ float silu(float x) { return x * sigm(x); }
__device__ __forceinline__ float dsilu(float x) {
  const float s = sigm(x);
  return s * (1.f + x * (1.f - s));
}

// tile[c][i][j] = x[n, c, r0 - halo + i, c0 - halo + j], 0 outside the image.
template <typename T>
__device__ void load_tile(float* tile, const T* __restrict__ x, int n, int C, int H, int W,
                          int r0, int c0, int halo) {
  const int tw = kCols + 2 * halo, ts = (kRows + 2 * halo) * tw;
  for (int i = threadIdx.x; i < C * ts; i += kThreads) {
    const int c = i / ts, rem = i - c * ts;
    const int r = r0 - halo + rem / tw, col = c0 - halo + rem % tw;
    float v = 0.f;
    if (r >= 0 && r < H && col >= 0 && col < W) v = ld(x, (((size_t)n * C + c) * H + r) * W + col);
    tile[i] = v;
  }
}

// 3x3 depthwise of one channel's tile whose window's top-left corner is (tr, tc).
__device__ __forceinline__ float stencil(const float* t, const float* __restrict__ k9, int tw,
                                         int tr, int tc) {
  float acc = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) acc = fmaf(k9[3 * a + b], t[(tr + a) * tw + tc + b], acc);
  return acc;
}

// acc[j] += sum over the chunk's pixels of A[a][q] * B[b][q], for the entries
// e = tid + j*kThreads < na*nb, (a, b) = (e / nb, e % nb).
template <int S>
__device__ __forceinline__ void acc_outer(float (&acc)[S], const float* A, int na,
                                          const float* B, int nb) {
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int e = threadIdx.x + j * kThreads;
    if (e < na * nb) {
      const float* pa = A + (e / nb) * kLd;
      const float* pb = B + (e % nb) * kLd;
      float s = 0.f;
      for (int q = 0; q < kPix; ++q) s = fmaf(pa[q], pb[q], s);
      acc[j] += s;
    }
  }
}

// Entries e < 2n: acc += sum_q A[e][q] (e < n) or sum_q A[e-n][q] * B[e-n][q] (e >= n).
template <int S>
__device__ __forceinline__ void acc_moments(float (&acc)[S], const float* A, const float* B,
                                            int n) {
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int e = threadIdx.x + j * kThreads;
    if (e < 2 * n) {
      const int c = e < n ? e : e - n;
      const float* pa = A + c * kLd;
      const float* pb = B + c * kLd;
      float s = 0.f;
      if (e < n)
        for (int q = 0; q < kPix; ++q) s += pa[q];
      else
        for (int q = 0; q < kPix; ++q) s = fmaf(pa[q], pb[q], s);
      acc[j] += s;
    }
  }
}

// part[blk * K + off + e] = acc[j] for e = tid + j*kThreads < count.
template <int S>
__device__ __forceinline__ void write_slots(float* part, int K, int off, const float (&acc)[S],
                                            int count) {
  const size_t base = (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * K + off;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int e = threadIdx.x + j * kThreads;
    if (e < count) part[base + e] = acc[j];
  }
}

template <int S>
__device__ __forceinline__ void zero(float (&acc)[S]) {
#pragma unroll
  for (int j = 0; j < S; ++j) acc[j] = 0.f;
}

// Grid: (row tiles H / kRows, images N). Pixel of this thread in a chunk.
struct Px {
  int pr, pc, col;
  bool valid;
};

__device__ __forceinline__ Px pixel(int c0, int W) {
  Px p;
  p.pr = threadIdx.x / kCols;
  p.pc = threadIdx.x % kCols;
  p.col = c0 + p.pc;
  p.valid = p.col < W;
  return p;
}

// ---------------------------------------------------------------- forward

// P1: part[blk][c] = sum d, part[blk][C + c] = sum d^2.
template <typename T>
__global__ void __launch_bounds__(kThreads)
p1_kernel(const T* __restrict__ x, const float* __restrict__ k9, float* __restrict__ part,
          int C, int H, int W) {
  extern __shared__ float sm[];
  float* tile = sm;
  float* D = tile + C * kTs1;
  const int n = blockIdx.y, r0 = blockIdx.x * kRows;
  float acc[kVecSlots];
  zero(acc);
  for (int c0 = 0; c0 < W; c0 += kCols) {
    load_tile(tile, x, n, C, H, W, r0, c0, 1);
    __syncthreads();
    const Px p = pixel(c0, W);
    for (int c = 0; c < C; ++c)
      D[c * kLd + threadIdx.x] = p.valid ? stencil(tile + c * kTs1, k9 + 9 * c, kTw1, p.pr, p.pc) : 0.f;
    __syncthreads();
    acc_moments(acc, D, D, C);
    __syncthreads();
  }
  write_slots(part, 2 * C, 0, acc, 2 * C);
}

// Recompute v = silu(bn1(d)) of every channel at this thread's pixel into V[c][tid].
__device__ __forceinline__ void recompute_v(float* V, const float* tile, const float* __restrict__ k9,
                                            const float* __restrict__ m1, const float* __restrict__ a1,
                                            const float* __restrict__ b1, int C, const Px& p) {
  for (int c = 0; c < C; ++c) {
    float v = 0.f;
    if (p.valid) {
      const float d = stencil(tile + c * kTs1, k9 + 9 * c, kTw1, p.pr, p.pc);
      v = silu((d - m1[c]) * a1[c] + b1[c]);
    }
    V[c * kLd + threadIdx.x] = v;
  }
}

// P2: part[blk][c] = sum v, part[blk][C + c1*C + c2] = sum v[c1] v[c2].
template <typename T>
__global__ void __launch_bounds__(kThreads)
p2_kernel(const T* __restrict__ x, const float* __restrict__ k9, const float* __restrict__ m1,
          const float* __restrict__ a1, const float* __restrict__ b1, float* __restrict__ part,
          int C, int H, int W) {
  extern __shared__ float sm[];
  float* tile = sm;
  float* V = tile + C * kTs1;
  const int n = blockIdx.y, r0 = blockIdx.x * kRows;
  float s[kVecSlots], m[kOuterSlots];
  zero(s);
  zero(m);
  for (int c0 = 0; c0 < W; c0 += kCols) {
    load_tile(tile, x, n, C, H, W, r0, c0, 1);
    __syncthreads();
    recompute_v(V, tile, k9, m1, a1, b1, C, pixel(c0, W));
    __syncthreads();
    acc_moments(s, V, V, C);  // entries < C: sum v (the sum v^2 entries are not written)
    acc_outer(m, V, C, V, C);
    __syncthreads();
  }
  const int K = C + C * C;
  write_slots(part, K, 0, s, C);
  write_slots(part, K, C, m, C * C);
}

// P3: out = delta[n] * ((y - m2) * a2 + b2) [+ x], y = sum_c v[c] gate[n,c] Wp[c,:].
template <typename T>
__global__ void __launch_bounds__(kThreads)
p3_kernel(const T* __restrict__ x, const float* __restrict__ k9, const float* __restrict__ m1,
          const float* __restrict__ a1, const float* __restrict__ b1,
          const float* __restrict__ gate, const float* __restrict__ wp,
          const float* __restrict__ m2, const float* __restrict__ a2,
          const float* __restrict__ b2, const float* __restrict__ delta, int residual,
          T* __restrict__ out, int C, int C2, int H, int W) {
  extern __shared__ float sm[];
  float* tile = sm;
  float* U = tile + C * kTs1;
  const int n = blockIdx.y, r0 = blockIdx.x * kRows;
  const float* g = gate + (size_t)n * C;
  const float dn = delta[n];
  for (int c0 = 0; c0 < W; c0 += kCols) {
    load_tile(tile, x, n, C, H, W, r0, c0, 1);
    __syncthreads();
    const Px p = pixel(c0, W);
    recompute_v(U, tile, k9, m1, a1, b1, C, p);
    if (p.valid) {
      for (int c = 0; c < C; ++c) U[c * kLd + threadIdx.x] *= g[c];
      for (int c2 = 0; c2 < C2; ++c2) {
        float y = 0.f;
        for (int c = 0; c < C; ++c) y = fmaf(U[c * kLd + threadIdx.x], wp[c * C2 + c2], y);
        float o = dn * ((y - m2[c2]) * a2[c2] + b2[c2]);
        if (residual) o += tile[c2 * kTs1 + (p.pr + 1) * kTw1 + p.pc + 1];
        st(out, (((size_t)n * C2 + c2) * H + r0 + p.pr) * W + p.col, o);
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- backward

// B1: part[blk] = [sum dyhat (C2), sum dyhat*ybar (C2), T1 = sum v dyhat^T (C*C2),
// T2 = sum v ybar^T (C*C2)], with ybar = (y - m2) * inv2 and dyhat = dout * delta[n].
template <typename T>
__global__ void __launch_bounds__(kThreads)
b1_kernel(const T* __restrict__ x, const T* __restrict__ gout, const float* __restrict__ k9,
          const float* __restrict__ m1, const float* __restrict__ a1,
          const float* __restrict__ b1, const float* __restrict__ gate,
          const float* __restrict__ wp, const float* __restrict__ m2,
          const float* __restrict__ inv2, const float* __restrict__ delta,
          float* __restrict__ part, int C, int C2, int H, int W) {
  extern __shared__ float sm[];
  float* tile = sm;
  float* V = tile + C * kTs1;
  float* YB = V + C * kLd;
  float* DYH = YB + C2 * kLd;
  const int n = blockIdx.y, r0 = blockIdx.x * kRows;
  const float* g = gate + (size_t)n * C;
  const float dn = delta[n];
  float r2[kVecSlots], t1[kOuterSlots], t2[kOuterSlots];
  zero(r2);
  zero(t1);
  zero(t2);
  for (int c0 = 0; c0 < W; c0 += kCols) {
    load_tile(tile, x, n, C, H, W, r0, c0, 1);
    __syncthreads();
    const Px p = pixel(c0, W);
    recompute_v(V, tile, k9, m1, a1, b1, C, p);
    for (int c2 = 0; c2 < C2; ++c2) {
      float yb = 0.f, dyh = 0.f;
      if (p.valid) {
        float y = 0.f;
        for (int c = 0; c < C; ++c) y = fmaf(V[c * kLd + threadIdx.x] * g[c], wp[c * C2 + c2], y);
        yb = (y - m2[c2]) * inv2[c2];
        dyh = ld(gout, (((size_t)n * C2 + c2) * H + r0 + p.pr) * W + p.col) * dn;
      }
      YB[c2 * kLd + threadIdx.x] = yb;
      DYH[c2 * kLd + threadIdx.x] = dyh;
    }
    __syncthreads();
    acc_moments(r2, DYH, YB, C2);
    acc_outer(t1, V, C, DYH, C2);
    acc_outer(t2, V, C, YB, C2);
    __syncthreads();
  }
  const int K = 2 * C2 + 2 * C * C2;
  write_slots(part, K, 0, r2, 2 * C2);
  write_slots(part, K, 2 * C2, t1, C * C2);
  write_slots(part, K, 2 * C2 + C * C2, t2, C * C2);
}

// dy at one pixel: k2 * dyhat - alpha - ybar * beta_r, from u (in U[.][col]) and dout.
struct Bn2Bwd {
  const float *wp, *m2, *inv2, *k2, *alpha, *beta_r;
};

// B2: part[blk] = [sum ddhat (C), sum ddhat*dbar (C), dWp = sum u dy^T (C*C2),
// taps (C*27: for tap (a, b) and channel c, [sum x_tap, sum x_tap*dbar, sum x_tap*ddhat])].
template <typename T>
__global__ void __launch_bounds__(kThreads)
b2_kernel(const T* __restrict__ x, const T* __restrict__ gout, const float* __restrict__ k9,
          const float* __restrict__ m1, const float* __restrict__ inv1,
          const float* __restrict__ a1, const float* __restrict__ b1,
          const float* __restrict__ gate, Bn2Bwd bn2, const float* __restrict__ ds_hw,
          const float* __restrict__ delta, float* __restrict__ part, int C, int C2, int H,
          int W) {
  extern __shared__ float sm[];
  float* tile = sm;
  float* A = tile + C * kTs1;  // u, then dbar
  float* DY = A + C * kLd;
  float* DDH = DY + C2 * kLd;
  const int n = blockIdx.y, r0 = blockIdx.x * kRows;
  const float* g = gate + (size_t)n * C;
  const float* ds = ds_hw + (size_t)n * C;
  const float dn = delta[n];
  float r1[kVecSlots], dwp[kOuterSlots], taps[kTapSlots];
  zero(r1);
  zero(dwp);
  zero(taps);
  const int me = threadIdx.x;
  for (int c0 = 0; c0 < W; c0 += kCols) {
    load_tile(tile, x, n, C, H, W, r0, c0, 1);
    __syncthreads();
    const Px p = pixel(c0, W);
    recompute_v(A, tile, k9, m1, a1, b1, C, p);
    for (int c = 0; c < C; ++c) A[c * kLd + me] *= g[c];
    for (int c2 = 0; c2 < C2; ++c2) {
      float dy = 0.f;
      if (p.valid) {
        float y = 0.f;
        for (int c = 0; c < C; ++c) y = fmaf(A[c * kLd + me], bn2.wp[c * C2 + c2], y);
        const float yb = (y - bn2.m2[c2]) * bn2.inv2[c2];
        const float dyh = ld(gout, (((size_t)n * C2 + c2) * H + r0 + p.pr) * W + p.col) * dn;
        dy = bn2.k2[c2] * dyh - bn2.alpha[c2] - yb * bn2.beta_r[c2];
      }
      DY[c2 * kLd + me] = dy;
    }
    __syncthreads();
    acc_outer(dwp, A, C, DY, C2);
    __syncthreads();
    for (int c = 0; c < C; ++c) {
      float dbar = 0.f, ddh = 0.f;
      if (p.valid) {
        float du = 0.f;
        for (int c2 = 0; c2 < C2; ++c2) du = fmaf(bn2.wp[c * C2 + c2], DY[c2 * kLd + me], du);
        const float d = stencil(tile + c * kTs1, k9 + 9 * c, kTw1, p.pr, p.pc);
        const float dhat = (d - m1[c]) * a1[c] + b1[c];
        dbar = (d - m1[c]) * inv1[c];
        ddh = (du * g[c] + ds[c]) * dsilu(dhat);
      }
      A[c * kLd + me] = dbar;
      DDH[c * kLd + me] = ddh;
    }
    __syncthreads();
    acc_moments(r1, DDH, A, C);
    const int ncols = min(kCols, W - c0);  // the chunk's columns inside the image
#pragma unroll
    for (int j = 0; j < kTapSlots; ++j) {
      const int e = me + j * kThreads;
      if (e < 27 * C) {
        const int c = e / 27, t = e % 27, tap = t / 3, kind = t % 3;
        const float* xt = tile + c * kTs1 + (tap / 3) * kTw1 + tap % 3;
        const float* w = kind == 1 ? A + c * kLd : DDH + c * kLd;
        float s = 0.f;
        for (int pr = 0; pr < kRows; ++pr) {
          const float* xr = xt + pr * kTw1;
          const float* wr = w + pr * kCols;
          if (kind == 0)
            for (int pc = 0; pc < ncols; ++pc) s += xr[pc];
          else
            for (int pc = 0; pc < ncols; ++pc) s = fmaf(xr[pc], wr[pc], s);
        }
        taps[j] += s;
      }
    }
    __syncthreads();
  }
  const int K = 2 * C + C * C2 + 27 * C;
  write_slots(part, K, 0, r1, 2 * C);
  write_slots(part, K, 2 * C, dwp, C * C2);
  write_slots(part, K, 2 * C + C * C2, taps, 27 * C);
}

// B3: dd on the chunk and a 1-pixel ring (0 outside the image), then
// dx = sum_ab K[a,b] dd[r+1-a, w+1-b] [+ dout].
template <typename T>
__global__ void __launch_bounds__(kThreads)
b3_kernel(const T* __restrict__ x, const T* __restrict__ gout, const float* __restrict__ k9,
          const float* __restrict__ m1, const float* __restrict__ inv1,
          const float* __restrict__ a1, const float* __restrict__ b1,
          const float* __restrict__ gate, Bn2Bwd bn2, const float* __restrict__ ds_hw,
          const float* __restrict__ r1a, const float* __restrict__ r1b,
          const float* __restrict__ delta, int residual, T* __restrict__ dx, int C, int C2,
          int H, int W) {
  extern __shared__ float sm[];
  float* tile = sm;              // x, 2-pixel halo
  float* UD = tile + C * kTs2;   // u, then dd, on the extended pixels
  float* DY = UD + C * kLdE;
  const int n = blockIdx.y, r0 = blockIdx.x * kRows;
  const float* g = gate + (size_t)n * C;
  const float* ds = ds_hw + (size_t)n * C;
  const float dn = delta[n];
  for (int c0 = 0; c0 < W; c0 += kCols) {
    load_tile(tile, x, n, C, H, W, r0, c0, 2);
    __syncthreads();
    // extended pixel q: (er, ec) in [0, kRows+2) x [0, kCols+2), image (r0-1+er, c0-1+ec);
    // its 3x3 window's top-left in the 2-halo tile is (er, ec)
    for (int q = threadIdx.x; q < kExt; q += kThreads) {
      const int er = q / kTw1, ec = q % kTw1;
      const int r = r0 - 1 + er, col = c0 - 1 + ec;
      const bool in = r >= 0 && r < H && col >= 0 && col < W;
      for (int c = 0; c < C; ++c) {
        float u = 0.f;
        if (in) {
          const float d = stencil(tile + c * kTs2, k9 + 9 * c, kTw2, er, ec);
          u = silu((d - m1[c]) * a1[c] + b1[c]) * g[c];
        }
        UD[c * kLdE + q] = u;
      }
      for (int c2 = 0; c2 < C2; ++c2) {
        float dy = 0.f;
        if (in) {
          float y = 0.f;
          for (int c = 0; c < C; ++c) y = fmaf(UD[c * kLdE + q], bn2.wp[c * C2 + c2], y);
          const float yb = (y - bn2.m2[c2]) * bn2.inv2[c2];
          const float dyh = ld(gout, (((size_t)n * C2 + c2) * H + r) * W + col) * dn;
          dy = bn2.k2[c2] * dyh - bn2.alpha[c2] - yb * bn2.beta_r[c2];
        }
        DY[c2 * kLdE + q] = dy;
      }
      for (int c = 0; c < C; ++c) {
        float dd = 0.f;
        if (in) {
          float du = 0.f;
          for (int c2 = 0; c2 < C2; ++c2) du = fmaf(bn2.wp[c * C2 + c2], DY[c2 * kLdE + q], du);
          const float d = stencil(tile + c * kTs2, k9 + 9 * c, kTw2, er, ec);
          const float dhat = (d - m1[c]) * a1[c] + b1[c];
          const float ddh = (du * g[c] + ds[c]) * dsilu(dhat);
          dd = a1[c] * ddh - r1a[c] - (d - m1[c]) * inv1[c] * r1b[c];
        }
        UD[c * kLdE + q] = dd;  // only this thread reads column q of UD and DY
      }
    }
    __syncthreads();
    const Px p = pixel(c0, W);
    if (p.valid) {
      for (int c = 0; c < C; ++c) {
        const float* dd = UD + c * kLdE;
        const float* kk = k9 + 9 * c;
        float acc = 0.f;
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = 0; b < 3; ++b)
            acc = fmaf(kk[3 * a + b], dd[(p.pr + 2 - a) * kTw1 + p.pc + 2 - b], acc);
        const size_t i = (((size_t)n * C + c) * H + r0 + p.pr) * W + p.col;
        if (residual) acc += ld(gout, i);
        st(dx, i, acc);
      }
    }
    __syncthreads();
  }
}

// out_n[n*K + k] = sum over the row tiles t of part[(n*nt + t)*K + k], out[k] =
// sum over n of out_n, both in a fixed order.
__global__ void reduce_tiles_kernel(const float* __restrict__ part, float* __restrict__ out_n,
                                    float* __restrict__ out, int N, int nt, int K) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  float tot = 0.f;
  for (int n = 0; n < N; ++n) {
    float s = 0.f;
    for (int t = 0; t < nt; ++t) s += part[((size_t)n * nt + t) * K + k];
    if (out_n) out_n[(size_t)n * K + k] = s;
    tot += s;
  }
  if (out) out[k] = tot;
}

size_t smem_bytes(int pass, int C, int C2) {
  size_t f = 0;
  switch (pass) {
    case 1: case 2: case 3: f = (size_t)C * (kTs1 + kLd); break;
    case 4: f = (size_t)C * (kTs1 + kLd) + 2 * (size_t)C2 * kLd; break;
    case 5: f = (size_t)C * (kTs1 + 2 * kLd) + (size_t)C2 * kLd; break;
    case 6: f = (size_t)C * (kTs2 + kLdE) + (size_t)C2 * kLdE; break;
  }
  return f * sizeof(float);
}

// Opt in to the dynamic shared memory a launch needs; cudaErrorInvalidValue when
// the shapes are outside what the kernels take.
template <typename K>
int prepare(K kernel, size_t smem, int C, int C2, int H) {
  if (C < 1 || C > kMaxC || C2 < 1 || C2 > kMaxC || H % kRows || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

#define MB1_GRID dim3 grid(H / kRows, N)

}  // namespace

// ---------------------------------------------------------------------------
// C interface, loaded with ctypes. Every launcher enqueues on `stream`, does not
// synchronise, and returns a CUDA error code (0 on success). `part` buffers are
// (N * H / kRows, K) floats, one row per block.
// ---------------------------------------------------------------------------

extern "C" {

int mb1_rows() { return kRows; }
int mb1_max_channels() { return kMaxC; }

int mb1_p1(const void* x, int bf16_io, const float* k9, float* part, int N, int C, int H,
           int W, void* stream) {
  MB1_GRID;
  const size_t smem = smem_bytes(1, C, C);
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (bf16_io) {
    if ((rc = prepare(p1_kernel<bf16>, smem, C, C, H))) return rc;
    p1_kernel<bf16><<<grid, kThreads, smem, s>>>((const bf16*)x, k9, part, C, H, W);
  } else {
    if ((rc = prepare(p1_kernel<float>, smem, C, C, H))) return rc;
    p1_kernel<float><<<grid, kThreads, smem, s>>>((const float*)x, k9, part, C, H, W);
  }
  return (int)cudaGetLastError();
}

int mb1_p2(const void* x, int bf16_io, const float* k9, const float* m1, const float* a1,
           const float* b1, float* part, int N, int C, int H, int W, void* stream) {
  MB1_GRID;
  const size_t smem = smem_bytes(2, C, C);
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (bf16_io) {
    if ((rc = prepare(p2_kernel<bf16>, smem, C, C, H))) return rc;
    p2_kernel<bf16><<<grid, kThreads, smem, s>>>((const bf16*)x, k9, m1, a1, b1, part, C, H, W);
  } else {
    if ((rc = prepare(p2_kernel<float>, smem, C, C, H))) return rc;
    p2_kernel<float><<<grid, kThreads, smem, s>>>((const float*)x, k9, m1, a1, b1, part, C, H, W);
  }
  return (int)cudaGetLastError();
}

int mb1_p3(const void* x, int bf16_io, const float* k9, const float* m1, const float* a1,
           const float* b1, const float* gate, const float* wp, const float* m2,
           const float* a2, const float* b2, const float* delta, int residual, void* out,
           int N, int C, int C2, int H, int W, void* stream) {
  MB1_GRID;
  const size_t smem = smem_bytes(3, C, C2);
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (bf16_io) {
    if ((rc = prepare(p3_kernel<bf16>, smem, C, C2, H))) return rc;
    p3_kernel<bf16><<<grid, kThreads, smem, s>>>((const bf16*)x, k9, m1, a1, b1, gate, wp, m2,
                                                 a2, b2, delta, residual, (bf16*)out, C, C2, H, W);
  } else {
    if ((rc = prepare(p3_kernel<float>, smem, C, C2, H))) return rc;
    p3_kernel<float><<<grid, kThreads, smem, s>>>((const float*)x, k9, m1, a1, b1, gate, wp, m2,
                                                  a2, b2, delta, residual, (float*)out, C, C2, H, W);
  }
  return (int)cudaGetLastError();
}

int mb1_b1(const void* x, const void* gout, int bf16_io, const float* k9, const float* m1,
           const float* a1, const float* b1, const float* gate, const float* wp,
           const float* m2, const float* inv2, const float* delta, float* part, int N, int C,
           int C2, int H, int W, void* stream) {
  MB1_GRID;
  const size_t smem = smem_bytes(4, C, C2);
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (bf16_io) {
    if ((rc = prepare(b1_kernel<bf16>, smem, C, C2, H))) return rc;
    b1_kernel<bf16><<<grid, kThreads, smem, s>>>((const bf16*)x, (const bf16*)gout, k9, m1, a1,
                                                 b1, gate, wp, m2, inv2, delta, part, C, C2, H, W);
  } else {
    if ((rc = prepare(b1_kernel<float>, smem, C, C2, H))) return rc;
    b1_kernel<float><<<grid, kThreads, smem, s>>>((const float*)x, (const float*)gout, k9, m1,
                                                  a1, b1, gate, wp, m2, inv2, delta, part, C,
                                                  C2, H, W);
  }
  return (int)cudaGetLastError();
}

int mb1_b2(const void* x, const void* gout, int bf16_io, const float* k9, const float* m1,
           const float* inv1, const float* a1, const float* b1, const float* gate,
           const float* wp, const float* m2, const float* inv2, const float* k2,
           const float* alpha, const float* beta_r, const float* ds_hw, const float* delta,
           float* part, int N, int C, int C2, int H, int W, void* stream) {
  MB1_GRID;
  const size_t smem = smem_bytes(5, C, C2);
  cudaStream_t s = (cudaStream_t)stream;
  const Bn2Bwd bn2{wp, m2, inv2, k2, alpha, beta_r};
  int rc;
  if (bf16_io) {
    if ((rc = prepare(b2_kernel<bf16>, smem, C, C2, H))) return rc;
    b2_kernel<bf16><<<grid, kThreads, smem, s>>>((const bf16*)x, (const bf16*)gout, k9, m1, inv1,
                                                 a1, b1, gate, bn2, ds_hw, delta, part, C, C2, H, W);
  } else {
    if ((rc = prepare(b2_kernel<float>, smem, C, C2, H))) return rc;
    b2_kernel<float><<<grid, kThreads, smem, s>>>((const float*)x, (const float*)gout, k9, m1,
                                                  inv1, a1, b1, gate, bn2, ds_hw, delta, part, C,
                                                  C2, H, W);
  }
  return (int)cudaGetLastError();
}

int mb1_b3(const void* x, const void* gout, int bf16_io, const float* k9, const float* m1,
           const float* inv1, const float* a1, const float* b1, const float* gate,
           const float* wp, const float* m2, const float* inv2, const float* k2,
           const float* alpha, const float* beta_r, const float* ds_hw, const float* r1a,
           const float* r1b, const float* delta, int residual, void* dx, int N, int C, int C2,
           int H, int W, void* stream) {
  MB1_GRID;
  const size_t smem = smem_bytes(6, C, C2);
  cudaStream_t s = (cudaStream_t)stream;
  const Bn2Bwd bn2{wp, m2, inv2, k2, alpha, beta_r};
  int rc;
  if (bf16_io) {
    if ((rc = prepare(b3_kernel<bf16>, smem, C, C2, H))) return rc;
    b3_kernel<bf16><<<grid, kThreads, smem, s>>>((const bf16*)x, (const bf16*)gout, k9, m1, inv1,
                                                 a1, b1, gate, bn2, ds_hw, r1a, r1b, delta,
                                                 residual, (bf16*)dx, C, C2, H, W);
  } else {
    if ((rc = prepare(b3_kernel<float>, smem, C, C2, H))) return rc;
    b3_kernel<float><<<grid, kThreads, smem, s>>>((const float*)x, (const float*)gout, k9, m1,
                                                  inv1, a1, b1, gate, bn2, ds_hw, r1a, r1b, delta,
                                                  residual, (float*)dx, C, C2, H, W);
  }
  return (int)cudaGetLastError();
}

int mb1_reduce_tiles(const float* part, float* out_n, float* out, int N, int nt, int K,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  reduce_tiles_kernel<<<(K + kThreads - 1) / kThreads, kThreads, 0, s>>>(part, out_n, out, N, nt, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
