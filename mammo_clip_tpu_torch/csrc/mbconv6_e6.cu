// Hand-written CUDA for the fused train-mode MBConv block on Hopper (sm_90a),
// forward and backward, in its expanding (e6) form and its e=1 form.
//
// Replaces the Pallas kernels of mammo_clip_tpu/ops/mbconv6_pallas.py::
// fused_mbconv_e6 in both forms: the forward passes _p1_kernel .. _p5_kernel
// and the backward passes _b1_kernel .. _b4_kernel. The block is
//
//   x --We--> z --bn0,silu--> w --dw3x3--> d --bn1,silu--> v --SE--> u --Wp--> y
//     --bn2--> yhat ;  out = [x +] delta * yhat
//
// with exact batch-statistics BatchNorm. ops/mbconv6.py sequences the passes
// (one ctypes call each, m6_pass); the SE MLP and its backward on (N, E)
// vectors stay torch ops there, as they stayed host-side jnp in the Pallas
// version.
//
// Design. As in the TPU kernel, the forward keeps only x, the statistics and
// (N, E) vectors for the backward (~17 KB at B5's block 4, against the ~541 MB
// of the stage design it replaces). A thread block owns one tile of TR x 32
// positions of one image (TR = 8 for bf16 I/O, 4 for fp32) and walks E in
// chunks of 16 channels; x's tile with its halo stays in shared memory as bf16,
// position-major, for the whole walk. Within one call, d (E channels, fp32) is
// written once by the pass that recomputes it from x and read back by the
// passes after it, instead of recomputing z -> w -> d from x in each of them:
// measured faster on the card (PERF.md), and freed before the call returns.
//   moments   x's sums and Gram sum x x^T                                  [P1]
//   bn0       bn0_kernel: bn0's statistics from them in fp64 (z = x We is
//             linear in x)                                                 [P1]
//   sweep F2  x -> z -> w -> d, written; per tile [sum d, sum d^2]         [P2]
//   sweep F3  d -> v; per tile sum v (the SE squeeze)                      [P3]
//   sweep F4  d -> v, u = v gate, y = u Wp; writes y (C2 channels, fp32)
//             and per tile [sum y, sum y^2]                                [P4]
//   out       out = [x +] delta * bn2(y), zero outside the valid image     [P5]
//   sweep B1  F2's and F4's recompute, d and y written again; per tile
//             [sum dyh, sum dyh ybar] for the bn2 backward                 [B1]
//   bwd_v     d -> v, s' = silu'(bn1(d)), dbar; du = dy Wp^T (dy from y and
//             dout, the bn2 backward, on load); per image sums of v du (the
//             SE cotangent), du s', s', du s' dbar and s' dbar, from which
//             bn1's backward sums follow once the SE backward has given ds;
//             dWp = sum u (x) dy                                           [B1, B2]
//   bwd_x     on the tile and a 1-wide ring: w from x (for the dK taps), d
//             read back, du, then the exact dd; on the tile: the stencil's
//             transpose -> dL/dw -> dz0hat; per tile bn0's backward sums, T3
//             = sum x (x) g0 inv0 dz0hat and the 9 dK tap sums; writes dxa =
//             (g0 inv0 dz0hat) We^T (C channels)                          [B2, B3]
//   bn0_bwd   bn0_bwd_kernel: dWe from T3 and x's moments, and dx's terms
//             affine in x (M, k), in fp64                                  [B3]
//   dx        dx = [G +] dxa - x M + k on the valid image, 0 elsewhere     [B4]
// Where the TPU kernel recomputed the whole chain for out (P5) and dx (B4),
// this port keeps y (C2 channels) and dxa (C channels) in fp32 between two
// passes of the same call.
//
// Data parallelism. Where a batch spans `ranks` processes (N images each),
// every sum over the batch that a later pass consumes is summed across the
// ranks between the passes by the caller (ops/mbconv6.py): x's moments before
// bn0, [sum d | sum d^2] after F2, [sum y | sum y^2] after F4, bn2's backward
// sums after B1, bn1's backward sums before bwd_x (p.sb1; bwd_x still writes
// this rank's, the gamma1 / beta1 gradients) and bn0's backward sums before
// bn0_bwd; the statistics then divide by ranks * N * vh * vw. Per-image sums
// (the SE squeeze, q) and the parameter gradients stay this rank's.
//
// The e=1 form (the TPU kernel's expand=False branch: no We, no bn0, d is the
// depthwise of x itself, E = C) runs the same sweeps with a compile-time
// EXPAND = false (m6_pass's `expand` argument): the tile of x with its halo
// stays in shared memory channel-major in its own type (exact in fp32 too),
// and every pass recomputes d from it by the stencil, which is the whole
// recompute; nothing but the statistics, s_mean and the gate (a few KB) is
// kept from forward to backward, and y (C2 channels, fp32) within a call.
// F2, F3, F4, out, B1 and bwd_v are the passes above with d from the stencil;
// there is no moments, bn0, dx or DX pass. bwd_x (bwd_x1) loads x with a
// 2-wide halo and dy on the tile's ring, forms d then dd on the ring, and on
// the tile dx = [dout +] the stencil's transpose of dd, written straight to
// dx, and the 9 dK tap sums. C and C2 go up to 64 (b7's 64 -> 32), so its
// products take 4 k16 steps and 8 n8 tiles (Fr<false>, prep1_kernel).
//
// Every channel product runs on the tensor cores as mma.sync.m16n8k16 (bf16
// in, fp32 sums) with ldmatrix operands: z = x We, y = u Wp, du = dy Wp^T, dxa
// and x M with positions as M; the Gram, dWp and T3 with positions as K. An
// operand that is not exactly bf16 is split, a = hi + lo, and the product sums
// hi*hi + hi*lo + lo*hi (x is exactly bf16 in the bf16 case: two products),
// ~2^-17 relative, so that the statistics hold 1e-4 of the fp32 version; the
// weights' split fragments are laid out once per call (prep_kernel). The
// depthwise stencil, BatchNorm and SiLU (accurate expf) run in fp32 on the CUDA
// cores. Reductions are deterministic: a warp sums its lanes by a shuffle tree,
// warps are added in a fixed order, each block writes one partial per entry,
// and sum_blocks_kernel adds the blocks' partials in a fixed order. No float
// atomics, so every call gives the same bits.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense): the function
// must read x (and dout) and write out (and dx), ~28 MB of bf16 at block 4 (N=2,
// C=C2=40, E=240, 380x228 valid in 384x232), and its channel products are
// ~7 GFLOP forward, so the bound is bytes (~8 us); the e=1 form at B5's block 0
// (48 -> 24, 760x456) moves ~100 MB (~30 us). This design is bound on chip
// instead, by instruction issue and latency in the recompute phases: the z
// epilogue (SiLU on the halo region), the stencil and the chain's BatchNorm
// and SiLU terms, with the sweeps at 16 warps per SM (two 8-warp blocks, or one
// 16-warp block for bwd_v and bwd_x, whose tiles fill the shared memory); the
// e=1 form's tiles walk only 2-4 chunks, so a tile's fixed costs (its loads,
// the coefficients, the partial sums) weigh more. PERF.md has each pass's time
// on the card; warp specialisation and wgmma, a cheaper SiLU, and tiles that
// prefetch the next tile while they compute are the later levers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;        // 8 warps: the forward sweeps, two blocks per SM
constexpr int kWarps = kThreads / 32;
constexpr int kBig = 512;            // 16 warps: the backward sweeps, one block per SM
constexpr int kBigWarps = kBig / 32;
constexpr int kTC = 32;              // tile columns
constexpr int kEC = 16;              // expanded channels per chunk: 2 per warp
constexpr int kMaxC = 48;            // C and C2 at most: 3 k16 steps, 6 n8 tiles
constexpr int kMaxE = 256;
constexpr int kXs = kMaxC + 8;       // row stride (bf16) of position-major x / dy tiles: 112 B
constexpr int kUs = kEC + 8;         // row stride (bf16) of position-major chunk tiles: 48 B
constexpr int kSl = 64;              // positions of a moments / dx slab
constexpr int kSs = kSl + 8;         // row stride (bf16) of a channel-major slab: 144 B
constexpr size_t kMaxSmem = 232448;
constexpr int kMaxC1 = 64;           // the e=1 form: C (= E) and C2 at most: 4 k16 steps, 8 n8 tiles
constexpr int kXs1 = kMaxC1 + 8;     // row stride (bf16) of its position-major dy tiles: 144 B

enum Pass { kMoments = 0, kF2, kF3, kF4, kB1, kOut, kBwdV, kBwdX, kDx, kBn0, kBn0Bwd, kPasses };
constexpr int kFrags = 24;   // B fragments of the weights per chunk, see prep_kernel
constexpr int kFrags1 = 16;  // the same for the e=1 form (Wp's only)

// Where a form's passes find the weights' B fragments of a chunk (prep_kernel's
// layout), and its widest C2 in k16 steps (du) and n8 tiles (y).
template <bool EXPAND>
struct Fr {
  static constexpr int n = kFrags, kk = 3, nt = 6, xs = kXs;
  __device__ static constexpr int y(int t) { return 6 + t; }
  __device__ static constexpr int du(int k, int t) { return 12 + 2 * k + t; }
};
template <>
struct Fr<false> {
  static constexpr int n = kFrags1, kk = 4, nt = 8, xs = kXs1;
  __device__ static constexpr int y(int t) { return t; }
  __device__ static constexpr int du(int k, int t) { return 8 + 2 * k + t; }
};

struct P6 {
  const void* x;       // (N, C, H, W) T
  const void* g;       // (N, C2, H, W) T: dout
  void* out;           // (N, C2, H, W) T: out (kOut) or (N, C, H, W) T: dx (kDx)
  const float *we, *wp, *k9;        // (C, E), (E, C2), (E, 9)
  const float *m0, *v0, *g0, *b0;   // bn0 mean, var, gamma, beta (E)
  const float *s1, *g1, *b1;        // bn1: [sum d | sum d^2] (2 x Ep), gamma, beta
  const float *s2, *g2, *b2;        // bn2: [sum y | sum y^2] (2 x C2p), gamma, beta
  const float* s3;                  // [sum dyh | sum dyh ybar] (2 x C2p)
  const float *gate, *ds, *q;       // (N, E), (N, E) dL/ds_mean / (vh vw), (N, 5, Ep)
  const float* sb1;                 // bn1's backward sums over every rank (2 x E), or null
  const float *delta, *mom;         // (N,), x's moments [sum x | sum x x^T] (Cp + Cp^2)
  float *xm, *kv;                   // (C, C), (C,): dx's terms affine in x (bn0_bwd_kernel)
  const void* wf;                   // the weights' split B fragments (prep_kernel)
  float *y, *d, *dxa, *dwe, *part, *red, *red_n, *stats;  // d: (N, Ep, H, W) fp32
  float eps;
  int io_bf16, N, C, E, C2, H, W, vh, vw;
  int ranks;  // data-parallel ranks whose sums the batch statistics hold (N images each)
};

__host__ __device__ constexpr int up(int a, int m) { return (a + m - 1) / m * m; }

// The positions a batch statistic counts: the valid image of N images on each rank.
__device__ __forceinline__ float count(const P6& p) {
  return (float)(p.N * p.ranks) * p.vh * p.vw;
}
__device__ __forceinline__ double count64(const P6& p) {
  return (double)(p.N * p.ranks) * p.vh * p.vw;
}

template <int TR, int HALO>
struct Geo {                                 // a tile with its halo, positions row-major
  static constexpr int RR = TR + 2 * HALO;
  static constexpr int RC = kTC + 2 * HALO;
  static constexpr int RQ = RR * RC;
  static constexpr int RQP = up(RQ, 16);     // padded to whole m16 tiles
  static constexpr int MT = RQP / 16;
  static constexpr int SW = RQP + 4;         // fp32 row stride of a [16][SW] chunk array
};

// ---------------------------------------------------------------------------
// small helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const bf16* p, size_t i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(bf16* p, size_t i, float v) { p[i] = __float2bfloat16(v); }
template <typename T>
__device__ __forceinline__ T zero() {
  if constexpr (sizeof(T) == 2) return __float2bfloat16(0.f); else return 0.f;
}

// Accurate expf; the division by 1 + exp(-x) as a reciprocal (2 ulp).
__device__ __forceinline__ float sigm(float x) { return __fdividef(1.f, 1.f + expf(-x)); }
__device__ __forceinline__ float silu(float x) { return __fdividef(x, 1.f + expf(-x)); }
__device__ __forceinline__ float dsilu(float x) {
  const float s = sigm(x);
  return s * (1.f + x * (1.f - s));
}

// Sum over the 8 lanes that share lane % 4 (the rows of an mma C fragment).
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// ldmatrix row addresses (lane's row, its column offset) for the four operand
// shapes: A from [m][k] rows; A^T from [k][m] rows (.trans); B from [n][k] rows;
// B from [k][n] rows (.trans). The B forms load two n8 tiles (n0 and n0 + 8).
__device__ __forceinline__ int a_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) * 8; }
__device__ __forceinline__ int at_row(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int at_col(int lane) { return ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int b_row(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int b_col(int lane) { return ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int bt_row(int lane) { return (lane & 7) + ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int bt_col(int lane) { return (lane >> 4) * 8; }

__device__ __forceinline__ unsigned bits(__nv_bfloat162 h) {
  return *reinterpret_cast<unsigned*>(&h);
}
// Two fp32 values as bf16 pairs hi and lo with a = hi + lo to ~2^-17 relative.
__device__ __forceinline__ void split2(float a, float b, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - f.x, b - f.y));
}
__device__ __forceinline__ void split1(float a, bf16& hi, bf16& lo) {
  hi = __float2bfloat16(a);
  lo = __float2bfloat16(a - __bfloat162float(hi));
}

// A B fragment (one n8 tile, one k16 step) of an fp32 matrix B[k][n] at
// B[k * ldk + n * ldn], zero at k >= K or n >= N, split into hi and lo.
struct Frag {
  unsigned h0, h1, l0, l1;
};
__device__ __forceinline__ Frag bfrag(const float* __restrict__ B, int ldk, int ldn, int k0,
                                      int n0, int K, int N) {
  const int lane = threadIdx.x & 31, n = n0 + (lane >> 2), k = k0 + 2 * (lane & 3);
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = k + (i & 1) + (i >> 1) * 8;
    v[i] = (kk < K && n < N) ? __ldg(B + (size_t)kk * ldk + (size_t)n * ldn) : 0.f;
  }
  Frag f;
  split2(v[0], v[1], f.h0, f.l0);
  split2(v[2], v[3], f.h1, f.l1);
  return f;
}
// d += a b with b split: a exact in bf16 (two products), or split too (three).
__device__ __forceinline__ void mma2(float (&d)[4], const unsigned (&a)[4], const Frag& b) {
  mma(d, a, b.h0, b.h1);
  mma(d, a, b.l0, b.l1);
}
__device__ __forceinline__ void mma3(float (&d)[4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4], const Frag& b) {
  mma(d, ah, b.h0, b.h1);
  mma(d, ah, b.l0, b.l1);
  mma(d, al, b.h0, b.h1);
}
// d += a b for a, b both as (hi, lo) register pairs from ldmatrix.
__device__ __forceinline__ void mma3r(float (&d)[4], const unsigned (&ah)[4],
                                      const unsigned (&al)[4], unsigned bh0, unsigned bh1,
                                      unsigned bl0, unsigned bl1) {
  mma(d, ah, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, al, bh0, bh1);
}

// The weights' B fragments for chunk e0 / 16, as prep_kernel lays them out: one
// 16-byte load per lane instead of four loads and a split in every warp.
//   f = 2 kk + nt        z = x We       B[c][e] = We[c][e], k16 step kk, n8 tile nt
//   f = 6 + nt           y = u Wp       B[e][c2] = Wp[e][c2]
//   f = 12 + 2 kk + nt   du = dy Wp^T   B[c2][e] = Wp[e][c2]
//   f = 18 + nt          dxa = t We^T   B[e][c] = We[c][e]
// and for the e=1 form (Fr<false>): y's at f = nt (8 n8 tiles), du's at 8 + 2 kk + nt.
template <bool EXPAND = true>
__device__ __forceinline__ Frag wfrag(const P6& p, int e0, int f) {
  const uint4 v = __ldg(static_cast<const uint4*>(p.wf) + ((e0 / kEC) * Fr<EXPAND>::n + f) * 32 +
                        (threadIdx.x & 31));
  return Frag{v.x, v.y, v.z, v.w};
}

// ---------------------------------------------------------------------------
// per-channel coefficients, recomputed by every block from the sums
// ---------------------------------------------------------------------------

// ME entries per expanded channel, MC per output channel: the e6 form's (Coef)
// or the e=1 form's (Coef1, whose bn0 entries stay zero).
template <int ME, int MC>
struct CoefT {
  static constexpr int kE = ME, kC = MC;
  float m0[ME], a0[ME], b0[ME], i0[ME], g0[ME];  // bn0 (a = gamma inv)
  float m1[ME], a1[ME], b1[ME], i1[ME];          // bn1
  float gate[ME], dsh[ME], r1a[ME], r1b[ME];     // this image's SE terms
  float cm2[MC], ci2[MC], ca2[MC], cb2[MC], cc2[MC];  // bn2
  float red[kBigWarps * 2 * MC];                 // cross-warp sums
};
using Coef = CoefT<kMaxE, kMaxC>;
using Coef1 = CoefT<kMaxC1, kMaxC1>;

// (mean, inv) of a batch norm from [sum | sum of squares], the plain version's
// formula: var = max(E[t^2] - E[t]^2, 0).
__device__ __forceinline__ float2 moments(const float* s, int half, int c, float cnt, float eps) {
  const float m = s[c] / cnt;
  const float var = fmaxf(s[half + c] / cnt - m * m, 0.f);
  return make_float2(m, 1.f / sqrtf(var + eps));
}

template <typename CF>
__device__ void fill_coef(CF& cf, const P6& p, int n) {
  const int E = p.E, Ep = up(E, 16), C2p = up(p.C2, 8);
  const float cnt = count(p);
  for (int e = threadIdx.x; e < CF::kE; e += blockDim.x) {
    const bool in = e < E;
    float m0 = 0.f, i0 = 0.f, g0 = 0.f, b0 = 0.f;
    if (in && p.m0) {
      m0 = p.m0[e];
      i0 = 1.f / sqrtf(p.v0[e] + p.eps);
      g0 = p.g0[e];
      b0 = p.b0[e];
    }
    cf.m0[e] = m0, cf.i0[e] = i0, cf.g0[e] = g0, cf.a0[e] = g0 * i0, cf.b0[e] = b0;
    float m1 = 0.f, i1 = 0.f, g1 = 0.f, b1 = 0.f;
    if (in && p.s1) {
      const float2 mi = moments(p.s1, Ep, e, cnt, p.eps);
      m1 = mi.x, i1 = mi.y, g1 = p.g1[e], b1 = p.b1[e];
    }
    cf.m1[e] = m1, cf.i1[e] = i1, cf.a1[e] = g1 * i1, cf.b1[e] = b1;
    cf.gate[e] = in && p.gate ? p.gate[(size_t)n * E + e] : 0.f;
    cf.dsh[e] = in && p.ds ? p.ds[(size_t)n * E + e] : 0.f;
    float r1a = 0.f, r1b = 0.f;
    if (in && p.q) {  // bn1's backward sums from the sweep's per-image sums (bn1_backward_sums)
      float sdb = 0.f, sdbd = 0.f;
      for (int m = 0; m < p.N; ++m) {
        const float* qm = p.q + (size_t)m * 5 * Ep;
        const float gm = p.gate[(size_t)m * E + e], dm = p.ds[(size_t)m * E + e];
        sdb += gm * qm[Ep + e] + dm * qm[2 * Ep + e];
        sdbd += gm * qm[3 * Ep + e] + dm * qm[4 * Ep + e];
      }
      // this rank's sums are its gamma1 / beta1 gradients; the coefficients take
      // every rank's (p.sb1) where the batch spans ranks
      const float ga = p.sb1 ? p.sb1[e] : sdb, gb = p.sb1 ? p.sb1[E + e] : sdbd;
      r1a = g1 * i1 * ga / cnt, r1b = g1 * i1 * gb / cnt;
      if (blockIdx.x == 0 && blockIdx.y == 0) p.stats[e] = sdb, p.stats[E + e] = sdbd;
    }
    cf.r1a[e] = r1a, cf.r1b[e] = r1b;
  }
  for (int c = threadIdx.x; c < CF::kC; c += blockDim.x) {
    float m2 = 0.f, i2 = 0.f, a2 = 0.f, b2 = 0.f, c2 = 0.f;
    if (c < p.C2 && p.s2) {
      const float2 mi = moments(p.s2, C2p, c, cnt, p.eps);
      m2 = mi.x, i2 = mi.y, a2 = p.g2[c] * i2, b2 = p.b2[c];
      if (p.s3) {  // bn2 backward: dy = a2 dyh - alpha2 - (y - m2) inv2 beta2r
        b2 = a2 * p.s3[c] / cnt;
        c2 = i2 * a2 * p.s3[C2p + c] / cnt;
      }
    }
    cf.cm2[c] = m2, cf.ci2[c] = i2, cf.ca2[c] = a2, cf.cb2[c] = b2, cf.cc2[c] = c2;
  }
}

// ---------------------------------------------------------------------------
// tile loads
// ---------------------------------------------------------------------------

// x on a tile with its halo, position-major bf16 [q][kXs] (hi, and lo for fp32
// input), zero outside the valid image, past C and on the padding positions.
// Each thread issues kLoads loads before it stores any.
constexpr int kLoads = 8;

template <typename T, int TR, int HALO>
__device__ void load_x(bf16* xh, bf16* xl, const P6& p, int n, int r0, int c0) {
  using G = Geo<TR, HALO>;
  const T* x = static_cast<const T*>(p.x);
  const int total = up(p.C, 16) * G::RQP;
  for (int base = threadIdx.x; base < total; base += kLoads * blockDim.x) {
    T v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = base + u * blockDim.x, c = i / G::RQP, q = i - c * G::RQP;
      const int r = q / G::RC, cc = q - r * G::RC;
      const int gr = r0 - HALO + r, gc = c0 - HALO + cc;
      const bool in = i < total && q < G::RQ && c < p.C && gr >= 0 && gr < p.vh && gc >= 0 &&
                      gc < p.vw;
      if constexpr (sizeof(T) == 2)
        v[u] = in ? x[(((size_t)n * p.C + c) * p.H + gr) * p.W + gc] : __float2bfloat16(0.f);
      else
        v[u] = in ? x[(((size_t)n * p.C + c) * p.H + gr) * p.W + gc] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = base + u * blockDim.x, c = i / G::RQP, q = i - c * G::RQP;
      if (i >= total) break;
      if constexpr (sizeof(T) == 2) {
        xh[q * kXs + c] = v[u];
      } else {
        bf16 h, l;
        split1(v[u], h, l);
        xh[q * kXs + c] = h;
        xl[q * kXs + c] = l;
      }
    }
  }
}

// A tile's region row by row: slot s of a row reads the tile's own columns c0 +
// s V .. + V (s < NV, one 16-byte load where the row is 16-byte aligned and the
// V values lie in the valid image, else value by value) or one halo column
// (s >= NV). Returns the slot's first column in the image and in the region.
template <int HALO, int V>
__device__ __forceinline__ int2 slot_cols(int s, int c0) {
  constexpr int NV = kTC / V;
  const int h = s - NV;  // halo column: 0 .. HALO - 1 left, then right
  const int rc = s < NV ? HALO + s * V : (h < HALO ? h : kTC + h);
  return make_int2(c0 - HALO + rc, rc);
}

// x on a tile with its halo for the e=1 form's stencil, channel-major in its own
// type [c][RQP] (exact), zero outside the valid image and past C (up to the
// chunks' 16 channels). Each thread has kLoads loads in flight before it stores.
template <typename T, int TR, int HALO>
__device__ void load_xc(T* xs, const P6& p, int n, int r0, int c0) {
  using G = Geo<TR, HALO>;
  constexpr int V = 16 / sizeof(T), NV = kTC / V, S = NV + 2 * HALO;
  union Vec {
    uint4 u;
    T t[V];
  };
  const T* x = static_cast<const T*>(p.x);
  const bool aligned = p.W % V == 0 && (reinterpret_cast<size_t>(x) & 15) == 0;
  const int total = up(p.C, 16) * G::RR * S;
  for (int base = threadIdx.x; base < total; base += kLoads * blockDim.x) {
    Vec v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = base + u * blockDim.x, c = i / (G::RR * S), rs = i - c * (G::RR * S);
      const int r = rs / S, s = rs - r * S, gr = r0 - HALO + r, col = slot_cols<HALO, V>(s, c0).x;
      v[u].u = make_uint4(0u, 0u, 0u, 0u);
      if (!(i < total && c < p.C && gr >= 0 && gr < p.vh)) continue;
      const T* src = x + (((size_t)n * p.C + c) * p.H + gr) * p.W;
      if (s >= NV) {
        if (col >= 0 && col < p.vw) v[u].t[0] = src[col];
      } else if (aligned && col + V <= p.vw) {
        v[u].u = __ldg(reinterpret_cast<const uint4*>(src + col));
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k)
          if (col + k < p.vw) v[u].t[k] = src[col + k];
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = base + u * blockDim.x, c = i / (G::RR * S), rs = i - c * (G::RR * S);
      if (i >= total) break;
      const int r = rs / S, s = rs - r * S;
      T* dst = xs + c * G::RQP + r * G::RC + slot_cols<HALO, V>(s, c0).y;
      if (s >= NV) {
        dst[0] = v[u].t[0];
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) dst[k] = v[u].t[k];
      }
    }
  }
}

// dy = a2 (dout delta) - alpha2 - (y - m2) inv2 beta2r (the bn2 backward) on a
// tile with its halo, position-major [q][XS] as hi and lo, zero outside the
// valid image and past C2 (up to the 16-channel steps of the du product).
// dout and y are read 4 positions at a time where the rows allow it.
template <typename T, int TR, int HALO, int XS, typename CF>
__device__ void load_dy(bf16* dh, bf16* dl, const P6& p, const CF& cf, int n, int r0,
                        int c0) {
  using G = Geo<TR, HALO>;
  constexpr int V = 4, NV = kTC / V, S = NV + 2 * HALO;
  union Vg {
    typename std::conditional<sizeof(T) == 2, uint2, uint4>::type u;
    T t[V];
  };
  union Vy {
    float4 u;
    float t[V];
  };
  const T* gp = static_cast<const T*>(p.g);
  const bool aligned = p.W % V == 0 && (reinterpret_cast<size_t>(gp) & (V * sizeof(T) - 1)) == 0 &&
                       (reinterpret_cast<size_t>(p.y) & 15) == 0;
  const int total = up(p.C2, 16) * G::RR * S;
  const float dn = p.delta[n];
  constexpr int kL = kLoads / 2;  // two loads a slot
  for (int base = threadIdx.x; base < total; base += kL * blockDim.x) {
    Vg gv[kL];
    Vy yv[kL];
#pragma unroll
    for (int u = 0; u < kL; ++u) {
      const int i = base + u * blockDim.x, c = i / (G::RR * S), rs = i - c * (G::RR * S);
      const int r = rs / S, s = rs - r * S, gr = r0 - HALO + r, col = slot_cols<HALO, V>(s, c0).x;
#pragma unroll
      for (int k = 0; k < V; ++k) gv[u].t[k] = zero<T>(), yv[u].t[k] = 0.f;
      if (!(i < total && c < p.C2 && gr >= 0 && gr < p.vh)) continue;
      const size_t row = (((size_t)n * p.C2 + c) * p.H + gr) * p.W;
      if (s >= NV) {
        if (col >= 0 && col < p.vw) gv[u].t[0] = gp[row + col], yv[u].t[0] = p.y[row + col];
      } else if (aligned && col + V <= p.vw) {
        gv[u].u = *reinterpret_cast<const decltype(gv[u].u)*>(gp + row + col);
        yv[u].u = *reinterpret_cast<const float4*>(p.y + row + col);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k)
          if (col + k < p.vw) gv[u].t[k] = gp[row + col + k], yv[u].t[k] = p.y[row + col + k];
      }
    }
#pragma unroll
    for (int u = 0; u < kL; ++u) {
      const int i = base + u * blockDim.x, c = i / (G::RR * S), rs = i - c * (G::RR * S);
      if (i >= total) break;
      const int r = rs / S, s = rs - r * S, gr = r0 - HALO + r;
      const int2 cols = slot_cols<HALO, V>(s, c0);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (s >= NV && k > 0) break;
        const int gc = cols.x + k, q = r * G::RC + cols.y + k;
        const bool in = c < p.C2 && gr >= 0 && gr < p.vh && gc >= 0 && gc < p.vw;
        const float v = in ? cf.ca2[c] * (ld(gv[u].t, k) * dn) - cf.cb2[c] -
                                 (yv[u].t[k] - cf.cm2[c]) * cf.cc2[c]
                           : 0.f;
        bf16 h, l;
        split1(v, h, l);
        dh[q * XS + c] = h;
        dl[q * XS + c] = l;
      }
    }
  }
}

// d (written by F2 or B1) for the chunk's 16 channels at the positions of a
// tile with its halo into dst[el][SW]: asynchronous 4-byte copies, zero outside
// the valid image; the caller commits and waits.
template <int TR, int HALO>
__device__ __forceinline__ void fetch_d(float* dst, const P6& p, int n, int e0, int r0, int c0) {
  using G = Geo<TR, HALO>;
  for (int i = threadIdx.x; i < kEC * G::RQP; i += blockDim.x) {
    const int el = i / G::RQP, q = i - el * G::RQP;
    const int r = q / G::RC, cc = q - r * G::RC;
    const int gr = r0 - HALO + r, gc = c0 - HALO + cc;
    const bool in = q < G::RQ && gr >= 0 && gr < p.vh && gc >= 0 && gc < p.vw;
    const float* src = in ? p.d + (((size_t)n * up(p.E, 16) + e0 + el) * p.H + gr) * p.W + gc
                          : p.d;
    cp_async4(dst + el * G::SW + q, src, in ? 4 : 0);
  }
}

// ---------------------------------------------------------------------------
// the recompute phases
// ---------------------------------------------------------------------------

// w = silu(bn0(x We)) for the chunk's 16 channels at every position of the
// tile's halo region into ws[el][q], zero outside the valid image (SAME
// padding: silu(bn0(0)) != 0); with zt, also zbar0 = (z - m0) inv0 at the tile's
// own positions into zt[el][p]. The NW warps take the region's m16 tiles in turn,
// MTW at a time.
template <bool F32, int TR, int HALO, int NW, int MTW>
__device__ __forceinline__ void z_phase(const P6& p, const Coef& cf, const bf16* xh,
                                        const bf16* xl, float* ws, float* zt, int e0, int r0,
                                        int c0) {
  using G = Geo<TR, HALO>;
  constexpr int ST = TR * kTC + 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kc = (p.C + 15) / 16;
  Frag wz[3][2];
#pragma unroll
  for (int kk = 0; kk < 3; ++kk)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      if (kk < kc) wz[kk][nt] = wfrag(p, e0, 2 * kk + nt);
  float ca[2][2], cm[2][2], cb[2][2];  // this thread's 4 channels' bn0 terms
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int e = e0 + nt * 8 + 2 * t + j;
      ca[nt][j] = cf.a0[e], cm[nt][j] = cf.m0[e], cb[nt][j] = cf.b0[e];
    }
  // The products of MTW of this warp's m16 tiles first, then their epilogues
  // (more tiles in flight where the kernel has the registers to spare).
  for (int mt0 = warp; mt0 < G::MT; mt0 += MTW * NW) {
    float acc[MTW][2][4] = {};
#pragma unroll
    for (int i = 0; i < MTW; ++i) {
      const int mt = mt0 + i * NW;
      if (mt >= G::MT) break;
#pragma unroll
      for (int kk = 0; kk < 3; ++kk) {
        if (kk < kc) {
          unsigned a[4];
          const int off = (mt * 16 + a_row(lane)) * kXs + kk * 16 + a_col(lane);
          ldsm(a, xh + off);
          if constexpr (F32) {
            unsigned al[4];
            ldsm(al, xl + off);
            mma3(acc[i][0], a, al, wz[kk][0]);
            mma3(acc[i][1], a, al, wz[kk][1]);
          } else {
            mma2(acc[i][0], a, wz[kk][0]);
            mma2(acc[i][1], a, wz[kk][1]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MTW; ++i) {
      const int mt = mt0 + i * NW;
      if (mt >= G::MT) break;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int q = mt * 16 + g + (v >> 1) * 8, el = nt * 8 + 2 * t + (v & 1), j = v & 1;
          const int r = q / G::RC, cc = q - r * G::RC;
          const int gr = r0 - HALO + r, gc = c0 - HALO + cc;
          const bool valid = q < G::RQ && gr >= 0 && gr < p.vh && gc >= 0 && gc < p.vw;
          const float z = acc[i][nt][v];
          ws[el * G::SW + q] = valid ? silu(ca[nt][j] * (z - cm[nt][j]) + cb[nt][j]) : 0.f;
          if (zt) {
            const int tr = r - HALO, tc = cc - HALO;
            if (q < G::RQ && tr >= 0 && tr < TR && tc >= 0 && tc < kTC)
              zt[el * ST + tr * kTC + tc] = (z - cm[nt][j]) * cf.i0[e0 + el];
          }
        }
    }
  }
}

__device__ __forceinline__ void taps(const P6& p, int e, float (&k)[9]) {
#pragma unroll
  for (int i = 0; i < 9; ++i) k[i] = e < p.E ? __ldg(p.k9 + e * 9 + i) : 0.f;
}

// The 3x3 depthwise of one channel's w (or x, for the e=1 form; region of width
// RC, row stride RC) on `rows` output rows at column `col`: out[r] = sum_ab k[ab]
// src[(r + a) RC + col + b].
template <int RC, int ROWS, typename S>
__device__ __forceinline__ void stencil_col(const S* src, const float (&k)[9], int col,
                                            float (&out)[ROWS]) {
  float w0[3], w1[3];
#pragma unroll
  for (int b = 0; b < 3; ++b) w0[b] = ld(src, col + b), w1[b] = ld(src, RC + col + b);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float w2[3];
#pragma unroll
    for (int b = 0; b < 3; ++b) w2[b] = ld(src, (r + 2) * RC + col + b);
    float acc = 0.f;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      acc = fmaf(k[b], w0[b], acc);
      acc = fmaf(k[3 + b], w1[b], acc);
      acc = fmaf(k[6 + b], w2[b], acc);
    }
    out[r] = acc;
#pragma unroll
    for (int b = 0; b < 3; ++b) w0[b] = w1[b], w1[b] = w2[b];
  }
}

// ---------------------------------------------------------------------------
// forward sweeps F2, F3, F4 and the backward's recompute of y (kB1)
// ---------------------------------------------------------------------------

// The e6 form: F2 and B1 recompute d from x (and write it for the passes after
// them); F3 and F4 read it back, so that they keep neither x nor w on chip. The
// e=1 form recomputes d from x, a stencil and nothing else, in every pass.
__host__ __device__ constexpr bool recomputes(int mode) { return mode == kF2 || mode == kB1; }

template <bool F32, int TR, bool RECOMPUTE>
struct SweepSmem {
  using G = Geo<TR, 1>;
  static constexpr size_t x = sizeof(Coef);
  static constexpr size_t xlo = x + (RECOMPUTE ? (size_t)G::RQP * kXs * 2 : 0);
  static constexpr size_t w = xlo + (RECOMPUTE && F32 ? (size_t)G::RQP * kXs * 2 : 0);
  // recompute: w on the halo region; read back: two stages of d on the tile
  static constexpr size_t u = w + (RECOMPUTE ? (size_t)kEC * G::SW * 4
                                             : 2 * (size_t)kEC * Geo<TR, 0>::SW * 4);
  static constexpr size_t ulo = u + (size_t)TR * kTC * kUs * 2;
  static constexpr size_t total = ulo + (size_t)TR * kTC * kUs * 2;
};

__host__ __device__ constexpr size_t up16(size_t a) { return (a + 15) / 16 * 16; }

// The e=1 form's sweep: x on the tile with its halo, channel-major, C's chunks
// only (so that F2 and F3, which need no u, fit 3 blocks on an SM), then u (hi,
// lo) for F4 and B1. sweep1_u is u's offset.
template <typename T, int TR>
__host__ __device__ constexpr size_t sweep1_u(int C) {
  return sizeof(Coef1) + up16((size_t)up(C, 16) * Geo<TR, 1>::RQP * sizeof(T));
}

template <typename T, int TR, int MODE, bool EXPAND>
constexpr size_t sweep_smem(int C) {
  if constexpr (EXPAND)
    return SweepSmem<sizeof(T) == 4, TR, recomputes(MODE)>::total;
  else
    return sweep1_u<T, TR>(C) + (MODE == kF4 || MODE == kB1 ? 4 * (size_t)TR * kTC * kUs : 0);
}

__host__ __device__ int part_floats(int pass, int C, int E, int C2, bool expand) {
  const int Cp = up(C, 16), Ep = up(E, 16), C2p = up(C2, 8);
  switch (pass) {
    case kMoments: return Cp + Cp * Cp;
    case kF2: return 2 * Ep;
    case kF3: return Ep;
    case kF4:
    case kB1: return 2 * C2p;
    case kBwdV: return 5 * Ep + Ep * C2p;
    case kBwdX: return expand ? 11 * Ep + Cp * Ep : 9 * Ep;
    default: return 0;
  }
}

__device__ __forceinline__ size_t d_index(const P6& p, int n, int e, int gr, int gc) {
  return (((size_t)n * up(p.E, 16) + e) * p.H + gr) * p.W + gc;
}

template <typename T, int TR, int MODE, bool EXPAND>
__global__ void __launch_bounds__(kThreads, EXPAND || MODE == kF4 || MODE == kB1 ? 2 : 3)
    sweep_kernel(P6 p) {
  constexpr bool F32 = sizeof(T) == 4, RECOMPUTE = EXPAND && recomputes(MODE);
  constexpr bool PRODUCT = MODE == kF4 || MODE == kB1;
  using G = Geo<TR, 1>;
  using L = SweepSmem<F32, TR, RECOMPUTE>;
  using CF = std::conditional_t<EXPAND, Coef, Coef1>;
  using F = Fr<EXPAND>;
  constexpr int MW = TR / 4;  // m16 tiles of the tile per warp
  extern __shared__ __align__(16) unsigned char smem[];
  CF& cf = *reinterpret_cast<CF*>(smem);
  bf16* xh = reinterpret_cast<bf16*>(smem + L::x);
  bf16* xl = reinterpret_cast<bf16*>(smem + L::xlo);
  float* ws = reinterpret_cast<float*>(smem + L::w);
  T* xc = reinterpret_cast<T*>(smem + sizeof(Coef1));  // the e=1 form's x tile
  bf16* uh = reinterpret_cast<bf16*>(smem + (EXPAND ? L::u : sweep1_u<T, TR>(p.C)));
  bf16* ul = uh + TR * kTC * kUs;
  const int n = blockIdx.y, tiles_c = (p.vw + kTC - 1) / kTC;
  const int r0 = blockIdx.x / tiles_c * TR, c0 = blockIdx.x % tiles_c * kTC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int Ep = up(p.E, 16), C2p = up(p.C2, 8), nt2 = C2p / 8;
  float* part = p.part + (size_t)(n * gridDim.x + blockIdx.x) *
                             part_floats(MODE, p.C, p.E, p.C2, EXPAND);
  constexpr int SD = Geo<TR, 0>::SW;  // row stride of a stage of d
  fill_coef(cf, p, n);
  if constexpr (!EXPAND) {
    load_xc<T, TR, 1>(xc, p, n, r0, c0);
  } else if (RECOMPUTE) {
    load_x<T, TR, 1>(xh, xl, p, n, r0, c0);
  } else {
    fetch_d<TR, 0>(ws, p, n, 0, r0, c0);
    cp_async_commit();
  }
  __syncthreads();

  float y[MW][F::nt][4] = {};
  for (int e0 = 0; e0 < Ep; e0 += kEC) {
    // d for channels e0 + 2 warp + j at the tile's rows, column `lane`
    float d[2][TR];
    if constexpr (!EXPAND) {  // the stencil on x's own channel
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int el = 2 * warp + j;
        float k[9];
        taps(p, e0 + el, k);
        stencil_col<G::RC, TR>(xc + (size_t)(e0 + el) * G::RQP, k, lane, d[j]);
      }
      if (PRODUCT && e0 > 0) __syncthreads();  // the last chunk's product has read u
    } else {
      if (!RECOMPUTE) {  // this chunk's d has landed; the next chunk's starts
        cp_async_wait_all();
        __syncthreads();
        if (e0 + kEC < Ep) {
          fetch_d<TR, 0>(ws + ((e0 / kEC + 1) & 1) * kEC * SD, p, n, e0 + kEC, r0, c0);
          cp_async_commit();
        }
      }
      if (RECOMPUTE) {
        z_phase<F32, TR, 1, kWarps, PRODUCT ? 1 : (G::MT + kWarps - 1) / kWarps>(
            p, cf, xh, xl, ws, nullptr, e0, r0, c0);
        __syncthreads();
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = e0 + 2 * warp + j;
          float k[9];
          taps(p, e, k);
          stencil_col<G::RC, TR>(ws + (2 * warp + j) * G::SW, k, lane, d[j]);
#pragma unroll
          for (int tr = 0; tr < TR; ++tr)
            if (r0 + tr < p.H && c0 + lane < p.W) p.d[d_index(p, n, e, r0 + tr, c0 + lane)] = d[j][tr];
        }
      } else {
        const float* src = ws + ((e0 / kEC) & 1) * kEC * SD;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int tr = 0; tr < TR; ++tr) d[j][tr] = src[(2 * warp + j) * SD + tr * kTC + lane];
      }
    }
    if (MODE == kF2 || MODE == kF3) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = e0 + 2 * warp + j;
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int tr = 0; tr < TR; ++tr) {
          const bool valid = r0 + tr < p.vh && c0 + lane < p.vw;
          if (MODE == kF2) {
            const float v = valid ? d[j][tr] : 0.f;
            s0 += v;
            s1 = fmaf(v, v, s1);
          } else {
            s0 += valid ? silu(cf.a1[e] * (d[j][tr] - cf.m1[e]) + cf.b1[e]) : 0.f;
          }
        }
        s0 = warp_sum(s0);
        if (MODE == kF2) s1 = warp_sum(s1);
        if (lane == 0) {
          part[e] = s0;
          if (MODE == kF2) part[Ep + e] = s1;
        }
      }
    } else {
      // u = silu(bn1(d)) gate as bf16 hi and lo, [p][el], two channels per word
#pragma unroll
      for (int tr = 0; tr < TR; ++tr) {
        const bool valid = r0 + tr < p.vh && c0 + lane < p.vw;
        float u[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = e0 + 2 * warp + j;
          u[j] = valid ? silu(cf.a1[e] * (d[j][tr] - cf.m1[e]) + cf.b1[e]) * cf.gate[e] : 0.f;
        }
        unsigned hi, lo;
        split2(u[0], u[1], hi, lo);
        const int q = (tr * kTC + lane) * kUs + 2 * warp;
        *reinterpret_cast<unsigned*>(uh + q) = hi;
        *reinterpret_cast<unsigned*>(ul + q) = lo;
      }
    }
    if (RECOMPUTE || PRODUCT) __syncthreads();  // w is free; u is ready
    // (e6 read back: the next chunk's first barrier frees u and this stage of d)
    if (PRODUCT) {
      if constexpr (EXPAND) {
        Frag wy[6];
#pragma unroll
        for (int nt = 0; nt < 6; ++nt)
          if (nt < nt2) wy[nt] = wfrag(p, e0, F::y(nt));
#pragma unroll
        for (int i = 0; i < MW; ++i) {
          const int mt = warp * MW + i;
          unsigned ah[4], al[4];
          const int off = (mt * 16 + a_row(lane)) * kUs + a_col(lane);
          ldsm(ah, uh + off);
          ldsm(al, ul + off);
#pragma unroll
          for (int nt = 0; nt < 6; ++nt)
            if (nt < nt2) mma3(y[i][nt], ah, al, wy[nt]);
        }
      } else {  // the A fragments first, then one B fragment at a time (8 n8 tiles)
        unsigned ah[MW][4], al[MW][4];
#pragma unroll
        for (int i = 0; i < MW; ++i) {
          const int off = ((warp * MW + i) * 16 + a_row(lane)) * kUs + a_col(lane);
          ldsm(ah[i], uh + off);
          ldsm(al[i], ul + off);
        }
#pragma unroll
        for (int nt = 0; nt < F::nt; ++nt) {
          if (nt >= nt2) break;
          const Frag w = wfrag<false>(p, e0, F::y(nt));
#pragma unroll
          for (int i = 0; i < MW; ++i) mma3(y[i][nt], ah[i], al[i], w);
        }
      }
    }
  }
  if (!PRODUCT) return;

  // y to device memory; [sum y, sum y^2] (F4) or [sum dyh, sum dyh ybar] (B1)
  const T* gp = static_cast<const T*>(p.g);
#pragma unroll
  for (int nt = 0; nt < F::nt; ++nt) {
    if (nt >= nt2) break;
    float s[2][2] = {};
#pragma unroll
    for (int i = 0; i < MW; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int pos = (warp * MW + i) * 16 + g + (q >> 1) * 8;
        const int gr = r0 + pos / kTC, gc = c0 + pos % kTC, c2 = nt * 8 + 2 * t + (q & 1);
        if (c2 >= p.C2) continue;
        const float v = y[i][nt][q];
        const size_t idx = (((size_t)n * p.C2 + c2) * p.H + gr) * p.W + gc;
        if (gr < p.H && gc < p.W) p.y[idx] = v;
        if (!(gr < p.vh && gc < p.vw)) continue;
        if (MODE == kF4) {
          s[q & 1][0] += v;
          s[q & 1][1] = fmaf(v, v, s[q & 1][1]);
        } else {
          const float dyh = ld(gp, idx) * p.delta[n];
          s[q & 1][0] += dyh;
          s[q & 1][1] = fmaf(dyh, (v - cf.cm2[c2]) * cf.ci2[c2], s[q & 1][1]);
        }
      }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float v = group_sum(s[j][k]);
        if (g == 0) cf.red[(warp * 2 + k) * CF::kC + nt * 8 + 2 * t + j] = v;
      }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * C2p; i += kThreads) {
    const int k = i / C2p, c2 = i - k * C2p;
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += cf.red[(w * 2 + k) * CF::kC + c2];
    part[i] = v;
  }
}

// ---------------------------------------------------------------------------
// backward sweep over v: SE cotangent, bn1 backward sums, dWp
// ---------------------------------------------------------------------------

template <bool F32, int TR>
struct BwdVSmem {
  static constexpr int TP = TR * kTC;
  static constexpr size_t d = sizeof(Coef);  // two stages of d on the tile
  static constexpr size_t dy = d + 2 * (size_t)kEC * (TP + 4) * 4;
  static constexpr size_t dylo = dy + (size_t)TP * kXs * 2;
  static constexpr size_t u = dylo + (size_t)TP * kXs * 2;
  static constexpr size_t ulo = u + (size_t)TP * kUs * 2;
  static constexpr size_t total = ulo + (size_t)TP * kUs * 2;
};

// The e=1 form's: x on the tile with its halo (channel-major), one stage of d.
template <typename T, int TR>
struct BwdV1Smem {
  static constexpr int TP = TR * kTC;
  static constexpr size_t x = sizeof(Coef1);
  static constexpr size_t d = x + up16((size_t)kMaxC1 * Geo<TR, 1>::RQP * sizeof(T));
  static constexpr size_t dy = d + (size_t)kEC * (TP + 4) * 4;
  static constexpr size_t dylo = dy + (size_t)TP * kXs1 * 2;
  static constexpr size_t u = dylo + (size_t)TP * kXs1 * 2;
  static constexpr size_t ulo = u + (size_t)TP * kUs * 2;
  static constexpr size_t total = ulo + (size_t)TP * kUs * 2;
};

// One tile per block, 16 warps, each on one m16 tile of positions (TR = 8):
// du = dy Wp^T (dy from y and dout, the bn2 backward, loaded once), then
// v, s' and dbar from d (read back, or for the e=1 form the stencil on x, one
// channel per warp), the per-image sums, and dWp = sum u (x) dy.
template <typename T, int TR, bool EXPAND>
__global__ void __launch_bounds__(kBig, 1) bwd_v_kernel(P6 p) {
  constexpr bool F32 = sizeof(T) == 4;
  using L = std::conditional_t<EXPAND, BwdVSmem<F32, TR>, BwdV1Smem<T, TR>>;
  using CF = std::conditional_t<EXPAND, Coef, Coef1>;
  using F = Fr<EXPAND>;
  constexpr int TP = L::TP;
  extern __shared__ __align__(16) unsigned char smem[];
  CF& cf = *reinterpret_cast<CF*>(smem);
  T* xc = reinterpret_cast<T*>(smem + BwdV1Smem<T, TR>::x);  // the e=1 form's x tile
  float* db = reinterpret_cast<float*>(smem + L::d);
  bf16* dyh = reinterpret_cast<bf16*>(smem + L::dy);
  bf16* dyl = reinterpret_cast<bf16*>(smem + L::dylo);
  bf16* uh = reinterpret_cast<bf16*>(smem + L::u);
  bf16* ul = reinterpret_cast<bf16*>(smem + L::ulo);
  constexpr int SD = TP + 4;
  const int n = blockIdx.y, tiles_c = (p.vw + kTC - 1) / kTC;
  const int r0 = blockIdx.x / tiles_c * TR, c0 = blockIdx.x % tiles_c * kTC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int Ep = up(p.E, 16), C2p = up(p.C2, 8), kc2 = (p.C2 + 15) / 16;
  const bool chain = warp < TP / 16;  // this warp's m16 tile of positions
  const int mt = warp;
  float* part = p.part + (size_t)(n * gridDim.x + blockIdx.x) *
                             part_floats(kBwdV, p.C, p.E, p.C2, EXPAND);
  fill_coef(cf, p, n);
  if constexpr (EXPAND) {
    fetch_d<TR, 0>(db, p, n, 0, r0, c0);
    cp_async_commit();
  } else {
    load_xc<T, TR, 1>(xc, p, n, r0, c0);
  }
  __syncthreads();
  load_dy<T, TR, 0, F::xs>(dyh, dyl, p, cf, n, r0, c0);

  for (int e0 = 0; e0 < Ep; e0 += kEC) {
    const float* dsrc = db;
    if constexpr (EXPAND) {
      // this chunk's d has landed (and the last chunk's u and sums are read);
      // the next chunk's starts
      cp_async_wait_all();
      __syncthreads();
      if (e0 + kEC < Ep) {
        fetch_d<TR, 0>(db + ((e0 / kEC + 1) & 1) * kEC * SD, p, n, e0 + kEC, r0, c0);
        cp_async_commit();
      }
      dsrc = db + ((e0 / kEC) & 1) * kEC * SD;
    } else {
      // the last chunk's d, u and sums are read; this chunk's d, one channel per warp
      __syncthreads();
      using G = Geo<TR, 1>;
      float k[9], dv[TR];
      taps(p, e0 + warp, k);
      stencil_col<G::RC, TR>(xc + (size_t)(e0 + warp) * G::RQP, k, lane, dv);
#pragma unroll
      for (int tr = 0; tr < TR; ++tr) db[warp * SD + tr * kTC + lane] = dv[tr];
      __syncthreads();
    }
    float acc[2][2][5] = {};  // [nt][column parity][v du, du s', s', du s' dbar, s' dbar]
    if (chain) {
      Frag wd[F::kk][2];
#pragma unroll
      for (int kk = 0; kk < F::kk; ++kk)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          if (kk < kc2) wd[kk][nt] = wfrag<EXPAND>(p, e0, F::du(kk, nt));
      float du[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < F::kk; ++kk)
        if (kk < kc2) {
          unsigned ah[4], al[4];
          const int off = (mt * 16 + a_row(lane)) * F::xs + kk * 16 + a_col(lane);
          ldsm(ah, dyh + off);
          ldsm(al, dyl + off);
          mma3(du[0], ah, al, wd[kk][0]);
          mma3(du[1], ah, al, wd[kk][1]);
        }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float u[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int pos = mt * 16 + g + (q >> 1) * 8, el = nt * 8 + 2 * t + (q & 1), e = e0 + el;
          const bool valid = r0 + pos / kTC < p.vh && c0 + pos % kTC < p.vw;
          const float dd = dsrc[el * SD + pos];
          const float dh = cf.a1[e] * (dd - cf.m1[e]) + cf.b1[e];
          const float sg = sigm(dh);
          const float v = valid ? dh * sg : 0.f;
          const float sp = valid ? sg * (1.f + dh * (1.f - sg)) : 0.f;
          const float dbar = valid ? (dd - cf.m1[e]) * cf.i1[e] : 0.f;
          const float gu = valid ? du[nt][q] : 0.f;
          float* a = acc[nt][q & 1];
          a[0] = fmaf(v, gu, a[0]);
          a[1] = fmaf(gu, sp, a[1]);
          a[2] += sp;
          a[3] = fmaf(gu * sp, dbar, a[3]);
          a[4] = fmaf(sp, dbar, a[4]);
          u[q] = v * cf.gate[e];
        }
        unsigned hi, lo;
        const int off = (mt * 16 + g) * kUs + nt * 8 + 2 * t;
        split2(u[0], u[1], hi, lo);
        *reinterpret_cast<unsigned*>(uh + off) = hi;
        *reinterpret_cast<unsigned*>(ul + off) = lo;
        split2(u[2], u[3], hi, lo);
        *reinterpret_cast<unsigned*>(uh + off + 8 * kUs) = hi;
        *reinterpret_cast<unsigned*>(ul + off + 8 * kUs) = lo;
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int k = 0; k < 5; ++k) {
          const float v = group_sum(acc[nt][j][k]);
          if (g == 0) cf.red[(warp * 5 + k) * kEC + nt * 8 + 2 * t + j] = v;
        }
    __syncthreads();
    for (int i = threadIdx.x; i < 5 * kEC; i += kBig) {
      const int k = i / kEC, el = i - k * kEC;
      float v = 0.f;
      for (int w = 0; w < kBigWarps; ++w) v += cf.red[(w * 5 + k) * kEC + el];
      part[k * Ep + e0 + el] = v;
    }
    // dWp[e][c2] = sum over the tile of u[p][e] dy[p][c2]: M = e, K = positions,
    // one warp per pair of n8 tiles of C2.
    if (warp * 16 < C2p) {
      float a2[2][2][4] = {};  // by k step parity, added at the end
      unsigned ah[2][4], al[2][4], bh[2][4], bl[2][4];  // two k steps in flight
      auto load = [&](int ks, int b) {
        const int ao = (ks * 16 + at_row(lane)) * kUs + at_col(lane);
        const int bo = (ks * 16 + bt_row(lane)) * F::xs + warp * 16 + bt_col(lane);
        ldsm_t(ah[b], uh + ao);
        ldsm_t(al[b], ul + ao);
        ldsm_t(bh[b], dyh + bo);
        ldsm_t(bl[b], dyl + bo);
      };
      load(0, 0);
#pragma unroll
      for (int ks = 0; ks < TP / 16; ++ks) {
        const int b = ks & 1;
        if (ks + 1 < TP / 16) load(ks + 1, b ^ 1);
        mma3r(a2[b][0], ah[b], al[b], bh[b][0], bh[b][1], bl[b][0], bl[b][1]);
        mma3r(a2[b][1], ah[b], al[b], bh[b][2], bh[b][3], bl[b][2], bl[b][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int el = g + (q >> 1) * 8, c2 = warp * 16 + nt * 8 + 2 * t + (q & 1);
          if (c2 < C2p) part[5 * Ep + (size_t)(e0 + el) * C2p + c2] = a2[0][nt][q] + a2[1][nt][q];
        }
    }
  }
}

// ---------------------------------------------------------------------------
// backward sweep to dx: exact dd on the tile and a ring, dz0hat, T3, taps, dxa
// ---------------------------------------------------------------------------

template <bool F32, int TR>
struct BwdXSmem {
  using G1 = Geo<TR, 1>;
  static constexpr int TP = TR * kTC;
  static constexpr size_t x = sizeof(Coef);
  static constexpr size_t xlo = x + (size_t)G1::RQP * kXs * 2;
  static constexpr size_t w = xlo + (F32 ? (size_t)G1::RQP * kXs * 2 : 0);
  static constexpr size_t zt = w + (size_t)kEC * G1::SW * 4;
  static constexpr size_t dy = zt + (size_t)kEC * (TP + 4) * 4;
  static constexpr size_t dylo = dy + (size_t)G1::RQP * kXs * 2;
  static constexpr size_t d = dylo + (size_t)G1::RQP * kXs * 2;
  static constexpr size_t dz = d + (size_t)kEC * G1::SW * 4;
  static constexpr size_t dzlo = dz + (size_t)TP * kUs * 2;
  static constexpr size_t total = dzlo + (size_t)TP * kUs * 2;
};

// du = dy Wp^T on a tile's 1-wide ring region (dy at [q][XS] as hi and lo),
// then the exact dd in place of d at ds[el][SW], zero outside the valid image;
// the warps take the region's m16 tiles in turn, from the last.
template <bool EXPAND, int TR, typename CF>
__device__ __forceinline__ void ring_dd(const P6& p, const CF& cf, const bf16* dyh,
                                        const bf16* dyl, float* ds, int e0, int r0, int c0) {
  using G1 = Geo<TR, 1>;
  using F = Fr<EXPAND>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kc2 = (p.C2 + 15) / 16;
  Frag wd[F::kk][2];
#pragma unroll
  for (int kk = 0; kk < F::kk; ++kk)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      if (kk < kc2) wd[kk][nt] = wfrag<EXPAND>(p, e0, F::du(kk, nt));
  for (int mt = kBigWarps - 1 - warp; mt < G1::MT; mt += kBigWarps) {
    float du[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < F::kk; ++kk)
      if (kk < kc2) {
        unsigned ah[4], al[4];
        const int off = (mt * 16 + a_row(lane)) * F::xs + kk * 16 + a_col(lane);
        ldsm(ah, dyh + off);
        ldsm(al, dyl + off);
        mma3(du[0], ah, al, wd[kk][0]);
        mma3(du[1], ah, al, wd[kk][1]);
      }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int qq = mt * 16 + g + (q >> 1) * 8, el = nt * 8 + 2 * t + (q & 1);
        const int e = e0 + el, r = qq / G1::RC, cc = qq - r * G1::RC;
        const int gr = r0 - 1 + r, gc = c0 - 1 + cc;
        const bool valid = qq < G1::RQ && gr >= 0 && gr < p.vh && gc >= 0 && gc < p.vw;
        float* dp = ds + el * G1::SW + qq;
        const float d = *dp;
        const float dh = cf.a1[e] * (d - cf.m1[e]) + cf.b1[e];
        const float sp = dsilu(dh);
        const float db1h = (du[nt][q] * cf.gate[e] + cf.dsh[e]) * sp;
        const float dd = cf.a1[e] * db1h - cf.r1a[e] - (d - cf.m1[e]) * cf.i1[e] * cf.r1b[e];
        *dp = valid ? dd : 0.f;
      }
  }
}

// The e=1 form's bwd_x: x on the tile with a 2-wide halo (channel-major), dy on
// the tile's 1-wide ring, d then dd on the ring for the chunk.
template <typename T, int TR>
struct BwdX1Smem {
  using G1 = Geo<TR, 1>;
  static constexpr size_t x = sizeof(Coef1);
  static constexpr size_t dy = x + up16((size_t)kMaxC1 * Geo<TR, 2>::RQP * sizeof(T));
  static constexpr size_t dylo = dy + (size_t)G1::RQP * kXs1 * 2;
  static constexpr size_t d = dylo + (size_t)G1::RQP * kXs1 * 2;
  static constexpr size_t total = d + (size_t)kEC * G1::SW * 4;
};

// bwd_x of the e=1 form: per chunk, one channel per warp, d = the stencil on x
// over the tile's ring region; du = dy Wp^T and dd there (ring_dd); then on the
// tile dx = [dout +] corr(K~, dd), written straight to dx (0 outside the valid
// image), and the 9 dK tap sums dd x(shifted).
template <typename T, int TR>
__device__ __forceinline__ void bwd_x1(const P6& p) {
  using G1 = Geo<TR, 1>;
  using G2 = Geo<TR, 2>;
  using L = BwdX1Smem<T, TR>;
  extern __shared__ __align__(16) unsigned char smem[];
  Coef1& cf = *reinterpret_cast<Coef1*>(smem);
  T* xc = reinterpret_cast<T*>(smem + L::x);
  bf16* dyh = reinterpret_cast<bf16*>(smem + L::dy);
  bf16* dyl = reinterpret_cast<bf16*>(smem + L::dylo);
  float* ds = reinterpret_cast<float*>(smem + L::d);
  const int n = blockIdx.y, tiles_c = (p.vw + kTC - 1) / kTC;
  const int r0 = blockIdx.x / tiles_c * TR, c0 = blockIdx.x % tiles_c * kTC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Ep = up(p.E, 16);
  const bool residual = p.C2 == p.C;
  const T* gp = static_cast<const T*>(p.g);
  T* dx = static_cast<T*>(p.out);
  float* part = p.part + (size_t)(n * gridDim.x + blockIdx.x) *
                             part_floats(kBwdX, p.C, p.E, p.C2, false);
  fill_coef(cf, p, n);
  __syncthreads();
  load_xc<T, TR, 2>(xc, p, n, r0, c0);
  load_dy<T, TR, 1, kXs1>(dyh, dyl, p, cf, n, r0, c0);

  for (int e0 = 0; e0 < Ep; e0 += kEC) {
    const int e = e0 + warp;  // this warp's channel
    const T* xe = xc + (size_t)e * G2::RQP;
    float k[9];
    taps(p, e, k);
    __syncthreads();  // the tiles are in; the last chunk's dd is read
    // d on the ring region: its TR + 2 rows at column `lane`, then its last two
    // columns one value a lane (stencil_col's order of terms)
    {
      float dv[TR + 2];
      stencil_col<G2::RC, TR + 2>(xe, k, lane, dv);
#pragma unroll
      for (int r = 0; r < TR + 2; ++r) ds[warp * G1::SW + r * G1::RC + lane] = dv[r];
      if (lane < 2 * (TR + 2)) {
        const int col = kTC + (lane & 1), r = lane >> 1;
        float acc = 0.f;
#pragma unroll
        for (int b = 0; b < 3; ++b)
#pragma unroll
          for (int a = 0; a < 3; ++a)
            acc = fmaf(k[3 * a + b], ld(xe, (r + a) * G2::RC + col + b), acc);
        ds[warp * G1::SW + r * G1::RC + col] = acc;
      }
    }
    __syncthreads();
    ring_dd<false, TR>(p, cf, dyh, dyl, ds, e0, r0, c0);
    __syncthreads();
    // on the tile: dx (the stencil's transpose of dd) and the dK taps
    float kf[9], dl[TR], tp[9] = {};
#pragma unroll
    for (int i = 0; i < 9; ++i) kf[i] = k[8 - i];  // flipped: correlation
    const float* dd = ds + warp * G1::SW;
    stencil_col<G1::RC, TR>(dd, kf, lane, dl);
    // x at rows tr + 1 .. tr + 3 of the 2-wide region, columns lane + 1 .. + 3: a
    // window that slides down a row per output row
    const T* xw = xe + G2::RC + lane + 1;
    float w0[3], w1[3];
#pragma unroll
    for (int b = 0; b < 3; ++b) w0[b] = ld(xw, b), w1[b] = ld(xw, G2::RC + b);
#pragma unroll
    for (int tr = 0; tr < TR; ++tr) {
      const float ddt = dd[(tr + 1) * G1::RC + lane + 1];
      float w2[3];
#pragma unroll
      for (int b = 0; b < 3; ++b) w2[b] = ld(xw, (tr + 2) * G2::RC + b);
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        tp[b] = fmaf(ddt, w0[b], tp[b]);
        tp[3 + b] = fmaf(ddt, w1[b], tp[3 + b]);
        tp[6 + b] = fmaf(ddt, w2[b], tp[6 + b]);
        w0[b] = w1[b], w1[b] = w2[b];
      }
      const int gr = r0 + tr, gc = c0 + lane;
      if (e < p.C && gr < p.H && gc < p.W) {
        const size_t idx = (((size_t)n * p.C + e) * p.H + gr) * p.W + gc;
        float v = 0.f;
        if (gr < p.vh && gc < p.vw) {
          v = dl[tr];
          if (residual) v += ld(gp, idx);
        }
        st(dx, idx, v);
      }
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) tp[i] = warp_sum(tp[i]);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < 9; ++i) part[i * Ep + e] = tp[i];
    }
  }
}

// One tile per block, 16 warps. On the tile and its 1-wide ring: w from x (for
// the taps), d read back, du = dy Wp^T, then dd; on the tile: dL/dw (the
// stencil's transpose of dd), dz0hat, the bn0 sums and dK taps, T3 and dxa.
template <typename T, int TR>
__device__ __forceinline__ void bwd_x6(const P6& p) {
  constexpr bool F32 = sizeof(T) == 4;
  using G1 = Geo<TR, 1>;
  using L = BwdXSmem<F32, TR>;
  constexpr int TP = L::TP, ST = TP + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  Coef& cf = *reinterpret_cast<Coef*>(smem);
  bf16* xh = reinterpret_cast<bf16*>(smem + L::x);
  bf16* xl = reinterpret_cast<bf16*>(smem + L::xlo);
  float* ws = reinterpret_cast<float*>(smem + L::w);
  float* zt = reinterpret_cast<float*>(smem + L::zt);
  bf16* dyh = reinterpret_cast<bf16*>(smem + L::dy);
  bf16* dyl = reinterpret_cast<bf16*>(smem + L::dylo);
  float* ds = reinterpret_cast<float*>(smem + L::d);
  bf16* zh = reinterpret_cast<bf16*>(smem + L::dz);  // g0 inv0 dz0hat, [p][kUs]
  bf16* zl = reinterpret_cast<bf16*>(smem + L::dzlo);
  const int n = blockIdx.y, tiles_c = (p.vw + kTC - 1) / kTC;
  const int r0 = blockIdx.x / tiles_c * TR, c0 = blockIdx.x % tiles_c * kTC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int Ep = up(p.E, 16), kc = (p.C + 15) / 16;
  const int ntc = (p.C + 7) / 8;
  const bool own = warp < TP / 16;  // this warp's m16 tile of the tile's positions
  float* part = p.part + (size_t)(n * gridDim.x + blockIdx.x) *
                             part_floats(kBwdX, p.C, p.E, p.C2, true);
  fill_coef(cf, p, n);
  __syncthreads();
  load_x<T, TR, 1>(xh, xl, p, n, r0, c0);
  load_dy<T, TR, 1, kXs>(dyh, dyl, p, cf, n, r0, c0);
  __syncthreads();

  float dxa[6][4] = {};
  for (int e0 = 0; e0 < Ep; e0 += kEC) {
    // Each warp fetches d for the m16 tiles of its own du / dd step (their
    // order reversed against z_phase's, so that no warp has two tiles of both),
    // lands it while w is recomputed, and reads only what it fetched: no
    // barrier between the two steps.
    for (int mt = kBigWarps - 1 - warp; mt < G1::MT; mt += kBigWarps) {
#pragma unroll
      for (int k = 0; k < kEC * 16 / 32; ++k) {
        const int i = lane + 32 * k, el = i >> 4, qq = mt * 16 + (i & 15);
        const int r = qq / G1::RC, cc = qq - r * G1::RC;
        const int gr = r0 - 1 + r, gc = c0 - 1 + cc;
        const bool in = qq < G1::RQ && gr >= 0 && gr < p.vh && gc >= 0 && gc < p.vw;
        cp_async4(ds + el * G1::SW + qq, in ? p.d + d_index(p, n, e0 + el, gr, gc) : p.d,
                  in ? 4 : 0);
      }
    }
    cp_async_commit();
    z_phase<F32, TR, 1, kBigWarps, 1>(p, cf, xh, xl, ws, zt, e0, r0, c0);
    cp_async_wait_all();
    __syncwarp();
    ring_dd<true, TR>(p, cf, dyh, dyl, ds, e0, r0, c0);
    __syncthreads();
    // dL/dw on the tile (the stencil's transpose), dz0hat, bn0 sums and dK taps:
    // one channel per warp, one column per lane
    {
      const int el = warp, e = e0 + el;
      float k[9], kf[9];
      taps(p, e, k);
#pragma unroll
      for (int i = 0; i < 9; ++i) kf[i] = k[8 - i];  // flipped: correlation
      float dl[TR];
      stencil_col<G1::RC, TR>(ds + el * G1::SW, kf, lane, dl);
      const float* dd = ds + el * G1::SW;
      const float* w = ws + el * G1::SW;
      float s0 = 0.f, s1 = 0.f, tp[9] = {}, dz[TR];
#pragma unroll
      for (int tr = 0; tr < TR; ++tr) {
        const bool valid = r0 + tr < p.vh && c0 + lane < p.vw;
        const float zb = zt[el * ST + tr * kTC + lane];
        const float dzh = valid ? dl[tr] * dsilu(zb * cf.g0[e] + cf.b0[e]) : 0.f;
        s0 += dzh;
        s1 = fmaf(dzh, zb, s1);
        dz[tr] = dzh * cf.a0[e];
        const float ddt = dd[(tr + 1) * G1::RC + lane + 1];
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = 0; b < 3; ++b)
            tp[3 * a + b] = fmaf(ddt, w[(tr + a) * G1::RC + lane + b], tp[3 * a + b]);
      }
      s0 = warp_sum(s0);
      s1 = warp_sum(s1);
#pragma unroll
      for (int i = 0; i < 9; ++i) tp[i] = warp_sum(tp[i]);
      if (lane == 0) {
        part[e] = s0;
        part[Ep + e] = s1;
#pragma unroll
        for (int i = 0; i < 9; ++i) part[(2 + i) * Ep + e] = tp[i];
      }
      // g0 inv0 dz0hat as bf16 hi and lo, [p][el]
#pragma unroll
      for (int tr = 0; tr < TR; ++tr) {
        bf16 hi, lo;
        split1(dz[tr], hi, lo);
        zh[(tr * kTC + lane) * kUs + el] = hi;
        zl[(tr * kTC + lane) * kUs + el] = lo;
      }
    }
    __syncthreads();
    // T3[c][e] = sum over the tile of x[p][c] g0 inv0 dz0hat[p][e]: M = c, K = positions
    Frag wt[6];  // the dxa product's B fragments, in flight during T3
#pragma unroll
    for (int nt = 0; nt < 6; ++nt)
      if (nt < ntc) wt[nt] = wfrag(p, e0, 18 + nt);
    // T3[c][e] = sum over the tile of x[p][c] g0 inv0 dz0hat[p][e]: M = c, K =
    // positions; warp 2 m + nt (m < kc) owns one 16 x 8 tile (c's m16 tile m,
    // the chunk's n8 tile nt), with two independent sums by k-step parity for
    // each of dz0hat's hi and lo parts, added in a fixed order at the end.
    if (warp < 2 * kc) {
      const int m3 = warp >> 1, nt3 = warp & 1;
      float a3[2][2][4] = {};
      unsigned a[2][4], al[2][4], b[2][4];  // two k steps in flight
      auto load = [&](int ks, int i) {
        const int q1 = ((ks >> 1) + 1) * G1::RC + 1 + (ks & 1) * 16 + at_row(lane);
        const int ao = q1 * kXs + m3 * 16 + at_col(lane);
        const int bo = (ks * 16 + bt_row(lane)) * kUs + nt3 * 8 + (lane >> 4) * TP * kUs;
        ldsm_t(a[i], xh + ao);
        if constexpr (F32) ldsm_t(al[i], xl + ao);
        ldsm_t(b[i], zh + bo);  // lanes 16-31 address zl: r[2], r[3] are the lo part
      };
      load(0, 0);
#pragma unroll
      for (int ks = 0; ks < TP / 16; ++ks) {
        const int i = ks & 1;
        if (ks + 1 < TP / 16) load(ks + 1, i ^ 1);
        mma(a3[i][0], a[i], b[i][0], b[i][1]);
        mma(a3[i][1], a[i], b[i][2], b[i][3]);
        if constexpr (F32) mma(a3[i][0], al[i], b[i][0], b[i][1]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = m3 * 16 + g + (q >> 1) * 8, el = nt3 * 8 + 2 * t + (q & 1);
        part[11 * Ep + (size_t)c * Ep + e0 + el] =
            (a3[0][0][q] + a3[1][0][q]) + (a3[0][1][q] + a3[1][1][q]);
      }
    }
    // dxa[p][c] += sum over the chunk of g0 inv0 dz0hat[p][e] We[c][e]
    if (own) {
      unsigned ah[4], al[4];
      const int off = (warp * 16 + a_row(lane)) * kUs + a_col(lane);
      ldsm(ah, zh + off);
      ldsm(al, zl + off);
#pragma unroll
      for (int nt = 0; nt < 6; ++nt)
        if (nt < ntc) mma3(dxa[nt], ah, al, wt[nt]);
    }
    // No barrier here: the next chunk writes d, dd, w and zbar0, which this
    // chunk read before the barrier above, and dz0hat only after its own.
  }
  if (!own) return;
#pragma unroll
  for (int nt = 0; nt < 6; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int pos = warp * 16 + g + (q >> 1) * 8;
      const int gr = r0 + pos / kTC, gc = c0 + pos % kTC, c = nt * 8 + 2 * t + (q & 1);
      if (nt < ntc && c < p.C && gr < p.H && gc < p.W)
        p.dxa[(((size_t)n * p.C + c) * p.H + gr) * p.W + gc] = dxa[nt][q];
    }
}

// The e6 form's bwd_x (bwd_x6) or the e=1 form's (bwd_x1).
template <typename T, int TR, bool EXPAND>
__global__ void __launch_bounds__(kBig, 1) bwd_x_kernel(P6 p) {
  if constexpr (EXPAND)
    bwd_x6<T, TR>(p);
  else
    bwd_x1<T, TR>(p);
}

// ---------------------------------------------------------------------------
// x's moments, the output, dx, and the second level of every reduction
// ---------------------------------------------------------------------------

// The weights' split B fragments, one warp per fragment (wfrag's list), one
// block per chunk of 16 expanded channels; zero past C, C2 and E.
__global__ void __launch_bounds__(kFrags * 32) prep_kernel(P6 p, uint4* wf) {
  const int f = threadIdx.x >> 5, e0 = blockIdx.x * kEC;
  Frag b;
  if (f < 6)
    b = bfrag(p.we, p.E, 1, (f >> 1) * 16, e0 + (f & 1) * 8, p.C, p.E);
  else if (f < 12)
    b = bfrag(p.wp, p.C2, 1, e0, (f - 6) * 8, p.E, p.C2);
  else if (f < 18)
    b = bfrag(p.wp, 1, p.C2, ((f - 12) >> 1) * 16, e0 + (f & 1) * 8, p.C2, p.E);
  else
    b = bfrag(p.we, 1, p.E, e0, (f - 18) * 8, p.E, p.C);
  wf[(blockIdx.x * kFrags + f) * 32 + (threadIdx.x & 31)] = make_uint4(b.h0, b.h1, b.l0, b.l1);
}

// The e=1 form's (Fr<false>): Wp's fragments for y = u Wp (f < 8) and du =
// dy Wp^T (f = 8 + 2 kk + nt).
__global__ void __launch_bounds__(kFrags1 * 32) prep1_kernel(P6 p, uint4* wf) {
  const int f = threadIdx.x >> 5, e0 = blockIdx.x * kEC;
  const Frag b = f < 8 ? bfrag(p.wp, p.C2, 1, e0, f * 8, p.E, p.C2)
                       : bfrag(p.wp, 1, p.C2, ((f - 8) >> 1) * 16, e0 + (f & 1) * 8, p.C2, p.E);
  wf[(blockIdx.x * kFrags1 + f) * 32 + (threadIdx.x & 31)] = make_uint4(b.h0, b.h1, b.l0, b.l1);
}

// Per block: [sum x (Cp) | sum x x^T (Cp x Cp)] over the slabs it walks.
template <typename T>
__global__ void __launch_bounds__(kThreads) moments_kernel(P6 p) {
  constexpr bool F32 = sizeof(T) == 4;
  __shared__ __align__(16) bf16 sh[kMaxC * kSs];
  __shared__ __align__(16) bf16 sl[F32 ? kMaxC * kSs : 8];
  __shared__ float red[kWarps][kMaxC * kSl / kThreads];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* x = static_cast<const T*>(p.x);
  const int HW = p.H * p.W, spi = (HW + kSl - 1) / kSl, slabs = p.N * spi;
  const int kc = (p.C + 15) / 16, Cp = kc * 16;
  float* part = p.part + (size_t)blockIdx.x * part_floats(kMoments, p.C, p.E, p.C2, true);
  float colsum[kMaxC * kSl / kThreads] = {};
  float acc[2][2][4] = {};
  for (int s = blockIdx.x; s < slabs; s += gridDim.x) {
    const int n = s / spi, p0 = (s - n * spi) * kSl;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMaxC * kSl / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads, c = i / kSl, q = i - c * kSl;
      if (c < Cp) {
        const int pos = p0 + q, r = pos / p.W, col = pos - r * p.W;
        const bool in = c < p.C && pos < HW && r < p.vh && col < p.vw;
        const size_t idx = ((size_t)n * p.C + c) * HW + pos;
        const float v = in ? ld(x, idx) : 0.f;
        colsum[j] += v;
        if constexpr (F32) {
          split1(v, sh[c * kSs + q], sl[c * kSs + q]);
        } else {
          sh[c * kSs + q] = in ? x[idx] : __float2bfloat16(0.f);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int item = warp + it * kWarps, mt = item / 3, np = item % 3;
      if (mt >= kc || np >= kc) continue;
#pragma unroll
      for (int ks = 0; ks < kSl / 16; ++ks) {
        unsigned a[4], b[4];
        ldsm(a, sh + (mt * 16 + a_row(lane)) * kSs + ks * 16 + a_col(lane));
        ldsm(b, sh + (np * 16 + b_row(lane)) * kSs + ks * 16 + b_col(lane));
        mma(acc[it][0], a, b[0], b[1]);
        mma(acc[it][1], a, b[2], b[3]);
        if constexpr (F32) {
          unsigned al[4], bl[4];
          ldsm(al, sl + (mt * 16 + a_row(lane)) * kSs + ks * 16 + a_col(lane));
          ldsm(bl, sl + (np * 16 + b_row(lane)) * kSs + ks * 16 + b_col(lane));
          mma(acc[it][0], a, bl[0], bl[1]);
          mma(acc[it][1], a, bl[2], bl[3]);
          mma(acc[it][0], al, b[0], b[1]);
          mma(acc[it][1], al, b[2], b[3]);
        }
      }
    }
  }
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int item = warp + it * kWarps, mt = item / 3, np = item % 3;
    if (mt >= kc || np >= kc) continue;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = mt * 16 + g + (q >> 1) * 8, c2 = np * 16 + nt * 8 + 2 * t + (q & 1);
        part[Cp + c * Cp + c2] = acc[it][nt][q];
      }
  }
  // sum x: thread i's j-th value is channel i / kSl + j * kThreads / kSl (two warps each)
#pragma unroll
  for (int j = 0; j < kMaxC * kSl / kThreads; ++j) {
    const float v = warp_sum(colsum[j]);
    if (lane == 0) red[warp][j] = v;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < Cp; c += kThreads) {
    const int j = c / (kThreads / kSl), w = (c % (kThreads / kSl)) * 2;
    part[c] = red[w][j] + red[w + 1][j];
  }
}

// bn0's batch statistics from x's moments (p.red = [sum x | sum x x^T], Cp and
// Cp x Cp): z = x We is linear in x, so E[z] = sx We / cnt and E[z^2] =
// diag(We^T sxx We) / cnt; in fp64, var = max(E[z^2] - E[z]^2, 0). Writes
// p.stats = [mean0 | var0]. Its plain version is ops/mbconv6.py::bn0_stats.
__global__ void __launch_bounds__(64) bn0_kernel(P6 p) {
  __shared__ double red[2][64];
  const int e = blockIdx.x, c = threadIdx.x, C = p.C, Cp = up(C, 16);
  const float* sx = p.red;
  const float* sxx = p.red + Cp;
  double m = 0.0, q = 0.0;  // this thread's row c of sx We and of We^T sxx We
  if (c < C) {
    double t = 0.0;
    for (int c2 = 0; c2 < C; ++c2) t += (double)sxx[c * Cp + c2] * p.we[(size_t)c2 * p.E + e];
    const double w = p.we[(size_t)c * p.E + e];
    m = (double)sx[c] * w;
    q = w * t;
  }
  red[0][c] = m, red[1][c] = q;
  __syncthreads();
  for (int s = 32; s > 0; s >>= 1) {
    if (c < s) red[0][c] += red[0][c + s], red[1][c] += red[1][c + s];
    __syncthreads();
  }
  if (c == 0) {
    const double cnt = count64(p), mean = red[0][0] / cnt;
    p.stats[e] = (float)mean;
    p.stats[p.E + e] = (float)fmax(red[1][0] / cnt - mean * mean, 0.0);
  }
}

// bn0's backward from bwd_x's sums (p.red = [sum dz0hat | sum dz0hat zbar0 |
// 9 taps | T3], rows of Ep) and x's moments (p.mom), in fp64: alpha0 and beta0r,
// dWe = T3 - sx (x) alpha0 - (sxx We - sx (x) mean0) diag(inv0 beta0r), and
// dx's terms affine in x, M = We diag(inv0 beta0r) We^T and k = We (mean0 inv0
// beta0r - alpha0). One block per row c of dWe, M and k; each warp sums its
// entries of M and k by a shuffle tree. Plain versions: ops/mbconv6.py::
// dwe_from_moments and dx_terms.
__global__ void __launch_bounds__(kMaxE) bn0_bwd_kernel(P6 p) {
  __shared__ double ib_s[kMaxE], k_s[kMaxE];
  const int c = blockIdx.x, e = threadIdx.x, C = p.C, E = p.E;
  const int Cp = up(C, 16), Ep = up(E, 16);
  if (e < E) {
    const double cnt = count64(p), m0 = p.m0[e];
    const double inv0 = 1.0 / sqrt((double)p.v0[e] + p.eps), k0 = p.g0[e] * inv0 / cnt;
    const double alpha0 = k0 * p.red[e], ib = inv0 * k0 * p.red[Ep + e];
    ib_s[e] = ib, k_s[e] = m0 * ib - alpha0;
    double sxz = -(double)p.mom[c] * m0;
    for (int c2 = 0; c2 < C; ++c2) sxz += (double)p.mom[Cp + c * Cp + c2] * p.we[(size_t)c2 * E + e];
    p.dwe[(size_t)c * E + e] =
        (float)(p.red[11 * Ep + c * Ep + e] - (double)p.mom[c] * alpha0 - sxz * ib);
  }
  __syncthreads();
  const int warp = e >> 5, lane = e & 31;
  for (int c2 = warp; c2 <= C; c2 += kMaxE / 32) {
    double v = 0.0;
    for (int j = lane; j < E; j += 32) {
      const double w = p.we[(size_t)c * E + j];
      v += c2 < C ? w * ib_s[j] * p.we[(size_t)c2 * E + j] : w * k_s[j];
    }
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) {
      if (c2 < C)
        p.xm[c * C + c2] = (float)v;
      else
        p.kv[c] = (float)v;
    }
  }
}

// out = [x +] delta * bn2(y) on the valid image, 0 elsewhere. Block 0 also
// writes the returned statistics [mean1 | var1 | mean2 | var2].
template <typename T>
__global__ void __launch_bounds__(kThreads) out_kernel(P6 p) {
  __shared__ float cm[kMaxC1], ca[kMaxC1], cb[kMaxC1];  // C2 of either form
  const float cnt = count(p);
  const int Ep = up(p.E, 16), C2p = up(p.C2, 8);
  for (int c = threadIdx.x; c < p.C2; c += kThreads) {
    const float2 mi = moments(p.s2, C2p, c, cnt, p.eps);
    cm[c] = mi.x, ca[c] = p.g2[c] * mi.y, cb[c] = p.b2[c];
  }
  if (blockIdx.x == 0 && blockIdx.y == 0) {
    for (int e = threadIdx.x; e < p.E; e += kThreads) {
      const float m = p.s1[e] / cnt;
      p.stats[e] = m;
      p.stats[p.E + e] = fmaxf(p.s1[Ep + e] / cnt - m * m, 0.f);
    }
    for (int c = threadIdx.x; c < p.C2; c += kThreads) {
      const float m = p.s2[c] / cnt;
      p.stats[2 * p.E + c] = m;
      p.stats[2 * p.E + p.C2 + c] = fmaxf(p.s2[C2p + c] / cnt - m * m, 0.f);
    }
  }
  __syncthreads();
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  const bool residual = p.C2 == p.C;
  const int HW = p.H * p.W, c = blockIdx.y % p.C2, n = blockIdx.y / p.C2;
  const size_t plane = (size_t)blockIdx.y * HW;  // (n, c) of out and, with the residual, of x
  const float dn = p.delta[n], a = ca[c], m = cm[c], b = cb[c];
  // 4 positions of one row a thread (16-byte y, 8- or 16-byte x and out), where
  // the rows allow it; else one
  constexpr int V = 4;
  union Vt {
    typename std::conditional<sizeof(T) == 2, uint2, uint4>::type u;
    T t[V];
  };
  const bool aligned = p.W % V == 0 && ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(out)) &
                                        (V * sizeof(T) - 1)) == 0 &&
                       (reinterpret_cast<size_t>(p.y) & 15) == 0;
  if (aligned) {
    for (int pos = (blockIdx.x * kThreads + threadIdx.x) * V; pos < HW;
         pos += gridDim.x * kThreads * V) {
      const int r = pos / p.W, col = pos - r * p.W;
      Vt o, xv;
      float yv[V] = {};
      if (r < p.vh && col < p.vw) {
        *reinterpret_cast<float4*>(yv) = *reinterpret_cast<const float4*>(p.y + plane + pos);
        if (residual) xv.u = *reinterpret_cast<const decltype(xv.u)*>(x + plane + pos);
      }
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float v = 0.f;
        if (r < p.vh && col + k < p.vw) {
          v = dn * (a * (yv[k] - m) + b);
          if (residual) v += ld(xv.t, k);
        }
        st(o.t, k, v);
      }
      *reinterpret_cast<decltype(o.u)*>(out + plane + pos) = o.u;
    }
    return;
  }
  for (int pos = blockIdx.x * kThreads + threadIdx.x; pos < HW; pos += gridDim.x * kThreads) {
    const int r = pos / p.W, col = pos - r * p.W;
    float v = 0.f;
    if (r < p.vh && col < p.vw) {
      v = dn * (a * (p.y[plane + pos] - m) + b);
      if (residual) v += ld(x, plane + pos);
    }
    st(out, plane + pos, v);
  }
}

// dx = [G +] dxa - x M + k on the valid image, 0 elsewhere: a block per slab of
// kSl positions, x M on the tensor cores (M = positions, K = C).
template <typename T>
__global__ void __launch_bounds__(128) dx_kernel(P6 p) {
  constexpr bool F32 = sizeof(T) == 4;
  __shared__ __align__(16) bf16 sh[kMaxC * kSs];
  __shared__ __align__(16) bf16 sl[F32 ? kMaxC * kSs : 8];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int HW = p.H * p.W, spi = (HW + kSl - 1) / kSl, s = blockIdx.x;
  const int n = s / spi, p0 = (s - n * spi) * kSl, kc = (p.C + 15) / 16, ntc = (p.C + 7) / 8;
  {
    const T* x = static_cast<const T*>(p.x);
    for (int i = threadIdx.x; i < kc * 16 * kSl; i += 128) {
      const int c = i / kSl, q = i - c * kSl, pos = p0 + q, r = pos / p.W, col = pos - r * p.W;
      const bool in = c < p.C && pos < HW && r < p.vh && col < p.vw;
      const size_t idx = ((size_t)n * p.C + c) * HW + pos;
      if constexpr (F32) {
        split1(in ? ld(x, idx) : 0.f, sh[c * kSs + q], sl[c * kSs + q]);
      } else {
        sh[c * kSs + q] = in ? x[idx] : __float2bfloat16(0.f);
      }
    }
  }
  __syncthreads();
  float acc[6][4] = {};
#pragma unroll
  for (int kk = 0; kk < 3; ++kk) {
    if (kk >= kc) break;
    unsigned a[4];
    const int off = (kk * 16 + at_row(lane)) * kSs + warp * 16 + at_col(lane);
    ldsm_t(a, sh + off);
    unsigned al[4];
    if constexpr (F32) ldsm_t(al, sl + off);
#pragma unroll
    for (int nt = 0; nt < 6; ++nt) {
      if (nt >= ntc) break;
      const Frag b = bfrag(p.xm, p.C, 1, kk * 16, nt * 8, p.C, p.C);
      if constexpr (F32)
        mma3(acc[nt], a, al, b);
      else
        mma2(acc[nt], a, b);
    }
  }
  const T* gp = static_cast<const T*>(p.g);
  T* dx = static_cast<T*>(p.out);
#pragma unroll
  for (int nt = 0; nt < 6; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int pos = p0 + warp * 16 + g + (q >> 1) * 8, c = nt * 8 + 2 * t + (q & 1);
      if (nt >= ntc || c >= p.C || pos >= HW) continue;
      const int r = pos / p.W, col = pos - r * p.W;
      const size_t idx = ((size_t)n * p.C + c) * HW + pos;
      float v = 0.f;
      if (r < p.vh && col < p.vw) {
        v = p.dxa[idx] - acc[nt][q] + p.kv[c];
        if (gp) v += ld(gp, idx);
      }
      st(dx, idx, v);
    }
}

// The e=1 form's dx outside bwd_x's tiles (rows from rc or columns from cc on): 0.
template <typename T>
__global__ void __launch_bounds__(kThreads) dx_pad_kernel(P6 p, int rc, int cc) {
  T* dx = static_cast<T*>(p.out);
  const size_t HW = (size_t)p.H * p.W, total = (size_t)p.N * p.C * HW;
  for (size_t i = blockIdx.x * (size_t)kThreads + threadIdx.x; i < total;
       i += (size_t)gridDim.x * kThreads) {
    const int pos = (int)(i % HW), r = pos / p.W, c = pos - r * p.W;
    if (r >= rc || c >= cc) st(dx, i, 0.f);
  }
}

// Second level: for each entry k of the blocks' partials part[blk][K], with the
// blocks image-major (bpi per image), red_n[n][k] = sum over image n's blocks
// (k < kimg) and red[k - kimg] = sum over all blocks, image by image (k >=
// kimg), the per-image sums times scale_n. A block takes COLS entries, and
// ROWS threads share an entry, each summing every ROWS-th block in order (8
// sums in flight); a warp holds 32 / COLS rows of its entries and adds them by
// shuffles, then warp 0 adds the warps' sums, all in a fixed order. reduce()
// takes 32 x 32 where K alone gives the card enough blocks, else 8 x 128.
template <int COLS, int ROWS>
__global__ void __launch_bounds__(COLS* ROWS)
sum_blocks_kernel(const float* __restrict__ part, int N, int bpi, int K, int kimg,
                  float scale_n, float* __restrict__ red_n, float* __restrict__ red) {
  constexpr int kW = COLS * ROWS / 32, kG = 32 / COLS;  // warps; rows of a warp
  __shared__ float sm[kW][COLS];
  const int tx = threadIdx.x % COLS, ty = threadIdx.x / COLS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.x * COLS + tx, k0 = blockIdx.x * COLS + lane % COLS;
  float tot = 0.f;
  for (int n = 0; n < N; ++n) {
    float s[8] = {};
    if (k < K) {
      const float* src = part + ((size_t)n * bpi) * K + k;
      int b = ty;
      for (; b + 7 * ROWS < bpi; b += 8 * ROWS) {
#pragma unroll
        for (int u = 0; u < 8; ++u) s[u] += src[(size_t)(b + u * ROWS) * K];
      }
      for (; b < bpi; b += ROWS) s[0] += src[(size_t)b * K];
    }
    float v = ((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7]));
#pragma unroll
    for (int off = COLS; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane < COLS) sm[warp][lane] = v;
    __syncthreads();
    if (warp == 0) {  // lane COLS g + t: warps g, g + kG, ... of entry t
      float w = 0.f;
      for (int r = lane / COLS; r < kW; r += kG) w += sm[r][lane % COLS];
#pragma unroll
      for (int off = COLS; off < 32; off <<= 1) w += __shfl_xor_sync(0xffffffffu, w, off);
      if (lane < COLS && k0 < K) {
        if (k0 < kimg)
          red_n[(size_t)n * kimg + k0] = w * scale_n;
        else
          tot += w;
      }
    }
    __syncthreads();
  }
  if (warp == 0 && lane < COLS && k0 < K && k0 >= kimg) red[k0 - kimg] = tot;
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename K>
int launch_big(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t s, const P6& p) {
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  int rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  if (rc) return rc;
  kernel<<<grid, threads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

int reduce(const P6& p, int nimg, int bpi, int K, int kimg, cudaStream_t s,
           float scale_n = 1.f) {
  if (K >= 32 * 132)
    sum_blocks_kernel<32, 32><<<(K + 31) / 32, 1024, 0, s>>>(p.part, nimg, bpi, K, kimg,
                                                             scale_n, p.red_n, p.red);
  else
    sum_blocks_kernel<8, 128><<<(K + 7) / 8, 1024, 0, s>>>(p.part, nimg, bpi, K, kimg,
                                                           scale_n, p.red_n, p.red);
  return (int)cudaGetLastError();
}

int moments_blocks(const P6& p) {
  const int slabs = p.N * ((p.H * p.W + kSl - 1) / kSl);
  return slabs < 1024 ? slabs : 1024;
}

template <typename T>
int out_pass(const P6& p, cudaStream_t s) {
  const int bx = (p.H * p.W + kThreads - 1) / kThreads;
  out_kernel<T><<<dim3(bx < 32 ? bx : 32, p.N * p.C2), kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int TR>
int run_pass(int pass, const P6& p, cudaStream_t s) {
  constexpr bool F32 = sizeof(T) == 4;
  const int tiles = ((p.vh + TR - 1) / TR) * ((p.vw + kTC - 1) / kTC);
  const dim3 grid(tiles, p.N);
  const int Ep = up(p.E, 16), K = part_floats(pass, p.C, p.E, p.C2, true);
  int rc = 0;
  switch (pass) {
    case kMoments: {  // also lays out the weights' fragments for the forward
      prep_kernel<<<Ep / kEC, kFrags * 32, 0, s>>>(p, (uint4*)p.wf);
      const int blocks = moments_blocks(p);
      moments_kernel<T><<<blocks, kThreads, 0, s>>>(p);
      if ((rc = (int)cudaGetLastError())) return rc;
      return reduce(p, 1, blocks, K, 0, s);
    }
    case kBn0:  // bn0's statistics from the moments in p.red (every rank's, where summed)
      bn0_kernel<<<p.E, 64, 0, s>>>(p);
      return (int)cudaGetLastError();
    case kF2:
      rc = launch_big(sweep_kernel<T, TR, kF2, true>, grid, kThreads, sweep_smem<T, TR, kF2, true>(p.C), s, p);
      return rc ? rc : reduce(p, p.N, tiles, K, 0, s);
    case kF3:
      rc = launch_big(sweep_kernel<T, TR, kF3, true>, grid, kThreads, sweep_smem<T, TR, kF3, true>(p.C), s, p);
      return rc ? rc : reduce(p, p.N, tiles, K, Ep, s, 1.f / ((float)p.vh * p.vw));
    case kF4:
      rc = launch_big(sweep_kernel<T, TR, kF4, true>, grid, kThreads, sweep_smem<T, TR, kF4, true>(p.C), s, p);
      return rc ? rc : reduce(p, p.N, tiles, K, 0, s);
    case kB1:  // also lays out the weights' fragments for the backward
      prep_kernel<<<Ep / kEC, kFrags * 32, 0, s>>>(p, (uint4*)p.wf);
      rc = launch_big(sweep_kernel<T, TR, kB1, true>, grid, kThreads, sweep_smem<T, TR, kB1, true>(p.C), s, p);
      return rc ? rc : reduce(p, p.N, tiles, K, 0, s);
    case kOut:
      return out_pass<T>(p, s);
    case kBwdV:
      rc = launch_big(bwd_v_kernel<T, TR, true>, grid, kBig, BwdVSmem<F32, TR>::total, s, p);
      return rc ? rc : reduce(p, p.N, tiles, K, 5 * Ep, s);
    case kBwdX:
      rc = launch_big(bwd_x_kernel<T, TR, true>, grid, kBig, BwdXSmem<F32, TR>::total, s, p);
      return rc ? rc : reduce(p, p.N, tiles, K, 0, s);
    case kBn0Bwd:  // bn0's backward from bwd_x's sums in p.red: dWe, M and k
      bn0_bwd_kernel<<<p.C, kMaxE, 0, s>>>(p);
      return (int)cudaGetLastError();
    case kDx: {
      const int spi = (p.H * p.W + kSl - 1) / kSl;
      dx_kernel<T><<<p.N * spi, 128, 0, s>>>(p);
      return (int)cudaGetLastError();
    }
  }
  return (int)cudaErrorInvalidValue;
}

// The e=1 form's passes: F2 (and Wp's fragments), F3, F4, out; B1 (and the
// fragments), bwd_v, bwd_x (and dx outside its tiles, where there is such).
template <typename T, int TR>
int run_pass1(int pass, const P6& p, cudaStream_t s) {
  const int tiles_r = (p.vh + TR - 1) / TR, tiles_c = (p.vw + kTC - 1) / kTC;
  const int tiles = tiles_r * tiles_c;
  const dim3 grid(tiles, p.N);
  const int Ep = up(p.E, 16), K = part_floats(pass, p.C, p.E, p.C2, false);
  int rc = 0;
  switch (pass) {
    case kF2:
      prep1_kernel<<<Ep / kEC, kFrags1 * 32, 0, s>>>(p, (uint4*)p.wf);
      rc = launch_big(sweep_kernel<T, TR, kF2, false>, grid, kThreads, sweep_smem<T, TR, kF2, false>(p.C), s, p);
      return rc ? rc : reduce(p, p.N, tiles, K, 0, s);
    case kF3:
      rc = launch_big(sweep_kernel<T, TR, kF3, false>, grid, kThreads, sweep_smem<T, TR, kF3, false>(p.C), s, p);
      return rc ? rc : reduce(p, p.N, tiles, K, Ep, s, 1.f / ((float)p.vh * p.vw));
    case kF4:
      rc = launch_big(sweep_kernel<T, TR, kF4, false>, grid, kThreads, sweep_smem<T, TR, kF4, false>(p.C), s, p);
      return rc ? rc : reduce(p, p.N, tiles, K, 0, s);
    case kB1:
      prep1_kernel<<<Ep / kEC, kFrags1 * 32, 0, s>>>(p, (uint4*)p.wf);
      rc = launch_big(sweep_kernel<T, TR, kB1, false>, grid, kThreads, sweep_smem<T, TR, kB1, false>(p.C), s, p);
      return rc ? rc : reduce(p, p.N, tiles, K, 0, s);
    case kOut:
      return out_pass<T>(p, s);
    case kBwdV:
      rc = launch_big(bwd_v_kernel<T, TR, false>, grid, kBig, BwdV1Smem<T, TR>::total, s, p);
      return rc ? rc : reduce(p, p.N, tiles, K, 5 * Ep, s);
    case kBwdX:
      rc = launch_big(bwd_x_kernel<T, TR, false>, grid, kBig, BwdX1Smem<T, TR>::total, s, p);
      if (rc || (rc = reduce(p, p.N, tiles, K, 0, s))) return rc;
      if (tiles_r * TR < p.H || tiles_c * kTC < p.W) {
        dx_pad_kernel<T><<<1024, kThreads, 0, s>>>(p, tiles_r * TR, tiles_c * kTC);
        rc = (int)cudaGetLastError();
      }
      return rc;
  }
  return (int)cudaErrorInvalidValue;
}

template <typename K>
int occupancy(K kernel, int threads, size_t smem, int* smem_out, int* blocks) {
  *smem_out = (int)smem;
  int rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  return rc ? rc : (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem);
}

template <typename T, int TR, bool EXPAND>
int kernel_info(int pass, int C, int* smem, int* blocks) {
  constexpr bool F32 = sizeof(T) == 4;
  using BV = std::conditional_t<EXPAND, BwdVSmem<F32, TR>, BwdV1Smem<T, TR>>;
  constexpr size_t bx = EXPAND ? BwdXSmem<F32, TR>::total : BwdX1Smem<T, TR>::total;
  *smem = 0, *blocks = 0;
  switch (pass) {
    case kF2:
      return occupancy(sweep_kernel<T, TR, kF2, EXPAND>, kThreads, sweep_smem<T, TR, kF2, EXPAND>(C), smem, blocks);
    case kF3:
      return occupancy(sweep_kernel<T, TR, kF3, EXPAND>, kThreads, sweep_smem<T, TR, kF3, EXPAND>(C), smem, blocks);
    case kF4:
      return occupancy(sweep_kernel<T, TR, kF4, EXPAND>, kThreads, sweep_smem<T, TR, kF4, EXPAND>(C), smem, blocks);
    case kB1:
      return occupancy(sweep_kernel<T, TR, kB1, EXPAND>, kThreads, sweep_smem<T, TR, kB1, EXPAND>(C), smem, blocks);
    case kBwdV: return occupancy(bwd_v_kernel<T, TR, EXPAND>, kBig, BV::total, smem, blocks);
    case kBwdX: return occupancy(bwd_x_kernel<T, TR, EXPAND>, kBig, bx, smem, blocks);
    case kMoments:
      return EXPAND ? occupancy(moments_kernel<T>, kThreads, 0, smem, blocks) : 0;
    default: return 0;
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface, loaded with ctypes (ops/cuda_lib.py). m6_pass runs one pass of
// the e6 form (expand = 1) or of the e=1 form (expand = 0: E = C, no We, no
// bn0; passes F2, F3, F4, out, B1, bwd_v and bwd_x): its kernel, then its
// reduction where it has one, on CUDA device `device` (made current only if it
// is not), enqueued on `stream`; it does not synchronise and returns a CUDA
// error code (0 on success). Which pointers a pass reads and writes is listed
// in ops/mbconv6.py; unused ones are null. Shapes: the e6 form C, C2 <= 48,
// E <= 256; the e=1 form C, C2 <= 64; x and dout bf16 (bf16 = 1) or fp32.
// `ranks` (>= 1) is the number of data-parallel ranks whose sums the batch
// statistics' inputs hold.
// ---------------------------------------------------------------------------

extern "C" {

// The dynamic shared memory (bytes) of pass `pass`'s main kernel in this form
// and I/O type at C input channels, and how many of its blocks one SM holds (0
// for a pass without one).
int m6_kernel_info(int pass, int expand, int io_bf16, int C, int* smem, int* blocks_per_sm) {
  if (expand)
    return io_bf16 ? kernel_info<bf16, 8, true>(pass, C, smem, blocks_per_sm)
                   : kernel_info<float, 4, true>(pass, C, smem, blocks_per_sm);
  return io_bf16 ? kernel_info<bf16, 8, false>(pass, C, smem, blocks_per_sm)
                 : kernel_info<float, 4, false>(pass, C, smem, blocks_per_sm);
}

// Floats of block partials the largest pass needs (the `part` scratch).
int m6_scratch(int expand, int io_bf16, int N, int C, int E, int C2, int H, int W, int vh,
               int vw) {
  const int TR = io_bf16 ? 8 : 4;
  const long tiles = (long)N * ((vh + TR - 1) / TR) * ((vw + kTC - 1) / kTC);
  long best = 0;
  for (int pass = kF2; pass < kPasses; ++pass) {
    const long f = tiles * part_floats(pass, C, E, C2, expand);
    best = f > best ? f : best;
  }
  if (expand) {
    P6 p{};
    p.N = N, p.H = H, p.W = W;
    const long m = (long)moments_blocks(p) * part_floats(kMoments, C, E, C2, true);
    best = m > best ? m : best;
  }
  return best > 0x7fffffff ? -1 : (int)best;
}

int m6_pass(int pass, const void* x, const void* g, void* out, const float* we,
            const float* wp, const float* k9, const float* m0, const float* v0,
            const float* g0, const float* b0, const float* s1, const float* g1,
            const float* b1, const float* s2, const float* g2, const float* b2,
            const float* s3, const float* gate, const float* ds, const float* q,
            const float* sb1, const float* delta, const float* mom, float* xm, float* kv, const void* wf, float* y,
            float* d, float* dxa, float* dwe, float* part, float* red, float* red_n, float* stats,
            float eps, int expand, int io_bf16, int N,
            int C, int E, int C2, int H, int W, int vh, int vw, int ranks, int device,
            void* stream) {
  const bool shapes = expand ? C <= kMaxC && C2 <= kMaxC && E <= kMaxE
                             : E == C && C <= kMaxC1 && C2 <= kMaxC1;
  if (pass < 0 || pass >= kPasses || !shapes || C < 1 || C2 < 1 || E < 1 || vh < 1 || vh > H ||
      vw < 1 || vw > W || ranks < 1)
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err) return guard.err;
  const P6 p{x, g, out, we, wp, k9, m0, v0, g0, b0, s1, g1, b1, s2, g2, b2, s3, gate, ds, q,
             sb1, delta, mom, xm, kv, wf, y, d, dxa, dwe, part, red, red_n, stats, eps, io_bf16,
             N, C, E, C2, H, W, vh, vw, ranks};
  cudaStream_t s = (cudaStream_t)stream;
  if (expand) return io_bf16 ? run_pass<bf16, 8>(pass, p, s) : run_pass<float, 4>(pass, p, s);
  return io_bf16 ? run_pass1<bf16, 8>(pass, p, s) : run_pass1<float, 4>(pass, p, s);
}

}  // extern "C"
