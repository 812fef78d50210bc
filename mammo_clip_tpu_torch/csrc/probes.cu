// Hand-written CUDA for the TPU probes of benchmarks/probe_mosaic.py, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of that script:
//   grid probes (probe_grid_overhead, :184-264), over x (N, C, H, W) bf16 in 8-row
//   tiles, one thread block per (image n, tile i) as the TPU grid (N, H/8) has:
//     base     o[c] = sum_{n,h,w} x[n,c,h,w]                                  (:184)
//     halo     base + each tile's clamped halo rows 8*max(i-1,0)+7 and
//              8*min(i+1,H/8-1), broadcast over its 8 rows                    (:197)
//     const    base + N*(H/8)*8*W*(sum k[:,0,:] + sum vec), the (E, 9, W) tap
//              bank and the (E, 1, W) vector read by every block              (:219)
//     compute  per tile z = We^T x (fp32 sums, stored bf16), w = SiLU(z) (bf16),
//              d[e,h,w] = sum_{a,b<3} bf16(wpad[e,h,w+b] * k[e,3a+b,w]) in fp32
//              (zero padding in w, no vertical halo), o[c] += sum_{h,w} d[c,h,w]
//              for c < C                                                      (:235)
//   layout probes (_run, :25-27, over the probes at :37-140), whose functions are:
//     gram         X X^T (C x C, fp32) of each channel's rows flattened
//                  (concat_aligned with its 380 -> 384 zero padding,
//                  reshape_collapse, reshape_collapse_rows10)
//     copy_scale   a copy into another shape, times a scale (reshape_split,
//                  sublane_stack, reshape_split_rows10)
//     channel_mix  o[h,c',w] = sum_c w[c,c'] x[c,h,w] (what dot_3d_rank3rhs means)
//
// Design. A grid block writes one partial per channel and a second kernel adds
// the partials of all blocks in a fixed order: no float atomics, so every run
// gives the same bits. In the base, halo and const kernels each warp sums whole
// channels of the block's 8-row slab (contiguous in memory) with bf16x2 loads
// and warp shuffles. The compute kernel walks its tile in chunks of 30 columns
// plus a 1-column halo (8 x 32 = 256 positions, one per thread): the chunk of x
// and We sit in shared memory as fp32, each thread computes z and SiLU for its
// position and 8 expanded channels at a time, then each warp owns one expanded
// channel and each lane one column for the 9 taps, keeping the probe's rounding
// points (z, SiLU and each tap product rounded to bf16, sums in fp32).
//
// The Gram kernel takes one block per 2 x 2 tile (ti <= tj) of channel pairs:
// each unordered pair once (inside a diagonal tile only q <= p; 136 at C = 16),
// written to both places. The block reads its (up to) four channels once, by
// 16-byte loads straight into registers when W, ld and the pointer allow, else
// 4-byte ones, each thread walking rows and columns by adds; each thread's four
// sums go through a warp shuffle tree and then the 8 warps in order: one
// launch, no scratch, no atomics, the same bits every call.
// The copy kernel moves 16 bytes a thread when both pointers are 16-byte
// aligned (the n % 4 tail by the threads after the last float4), one unit a
// thread with no loop (a grid-stride loop measured ~9% slower at 61,440 floats),
// the grid sized to the work, 32-bit indices below 2^31 elements.
//
// What bounds them on an H100 (3.35 TB/s, 989 TFLOP/s bf16): x is 114 MB in bf16
// at the probe's (16, 40, 232, 384), so every grid probe is bound by reading it
// (~34 us); the compute probe's z alone is 27.4 GFLOP (~28 us at the bf16 peak).
// The layout probes move well under 1 MB: their device work is 2-3.5 us a call
// (benchmarks/layout_timing.py, NVIDIA H100 80GB HBM3, 700.00 W), below the
// host's cost of a launch, which bounds a call (ops/probes.py launches through
// cuda_lib.launcher for that reason). The grid kernels'
// per-block work and the compute kernel's fp32 FMA loops are the per-block
// costs of the halo tiling csrc/mbconv*.cu use, which is what the probe
// measures.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                 // rows of a grid tile (the probe's h_tile)
constexpr int kChunk = 30;               // output columns of a compute chunk
constexpr int kSpan = kChunk + 2;        // with the 1-column halo: 8 x 32 = 256 positions
constexpr int kGroup = 8;                // expanded channels per compute round (one per warp)
constexpr size_t kMaxSmem = 232448;
constexpr int kGramUnits = 4;            // Gram row units a thread keeps in flight

static_assert(kRows * kSpan == kThreads, "one compute position per thread");
static_assert(kGroup == kWarps, "one expanded channel per warp in the tap stage");

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Sum of n (even) contiguous bf16 values starting at p (4-byte aligned), over a warp.
__device__ float slab_sum(const bf16* p, int n, int lane) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  float s = 0.f;
  for (int i = lane; i < n / 2; i += 32) {
    const float2 f = __bfloat1622float2(p2[i]);
    s += f.x + f.y;
  }
  return warp_sum(s);
}

// Block-wide sum (all threads call it; the result is valid in every thread).
__device__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if ((int)threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

// grid (H / 8, N); part (N * H / 8, C). kind 0: base, 1: halo, 2: const (bank = the
// block's sum of k[:, 0, :] and vec, each (E, ., W) bf16).
__global__ void __launch_bounds__(kThreads) grid_sum_kernel(const bf16* x, const bf16* k,
                                                            const bf16* vec, float* part, int kind,
                                                            int C, int E, int H, int W) {
  __shared__ float red[kThreads];
  const int i = blockIdx.x, n = blockIdx.y, ntl = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float bank = 0.f;
  if (kind == 2) {
    float s = 0.f;
    for (int idx = threadIdx.x; idx < E * W; idx += kThreads) {
      const int e = idx / W, w = idx % W;
      s += __bfloat162float(k[(size_t)e * 9 * W + w]) + __bfloat162float(vec[idx]);
    }
    bank = block_sum(s, red);
  }
  const int top = kRows * max(i - 1, 0) + kRows - 1, bot = kRows * min(i + 1, ntl - 1);
  for (int c = warp; c < C; c += kWarps) {
    const bf16* plane = x + ((size_t)n * C + c) * H * W;
    float s = slab_sum(plane + (size_t)i * kRows * W, kRows * W, lane);
    if (kind == 1) {
      float h = 0.f;
      for (int w = lane; w < W; w += 32)
        h += __bfloat162float(plane[(size_t)top * W + w]) + __bfloat162float(plane[(size_t)bot * W + w]);
      s += kRows * warp_sum(h);
    } else if (kind == 2) {
      s += (float)(kRows * W) * bank;
    }
    if (lane == 0) part[((size_t)n * ntl + i) * C + c] = s;
  }
}

// grid (H / 8, N); part (N * H / 8, E): each block's sum of d over its tile, per
// expanded channel. we (C, E), k (E, 9, W), x bf16.
__global__ void __launch_bounds__(kThreads) grid_compute_kernel(const bf16* x, const bf16* we,
                                                                const bf16* k, float* part,
                                                                int C, int E, int H, int W) {
  extern __shared__ float smem[];
  float* xs = smem;                        // [C][8][32]: the chunk of x with its halo columns
  float* wes = xs + C * kThreads;          // [C][E]
  float* ws = wes + C * E;                 // [8 channels][8][32]: SiLU(z) in bf16 values
  float* esum = ws + kGroup * kThreads;    // [E]
  const int i = blockIdx.x, n = blockIdx.y, ntl = gridDim.x;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int r = t / kSpan, cc = t % kSpan;
  for (int idx = t; idx < C * E; idx += kThreads) wes[idx] = __bfloat162float(we[idx]);
  for (int e = t; e < E; e += kThreads) esum[e] = 0.f;
  const bf16* tile = x + (size_t)n * C * H * W + (size_t)i * kRows * W;

  for (int w0 = 0; w0 < W; w0 += kChunk) {
    __syncthreads();  // the previous chunk's readers are done
    const int col = w0 - 1 + cc;             // this thread's column (halo included)
    const bool in = col >= 0 && col < W;
    for (int c = 0; c < C; ++c)
      xs[c * kThreads + t] = in ? __bfloat162float(tile[((size_t)c * H + r) * W + col]) : 0.f;
    for (int e0 = 0; e0 < E; e0 += kGroup) {
      __syncthreads();  // xs written, or the previous group's taps are done with ws
      float z[kGroup] = {};
      for (int c = 0; c < C; ++c) {
        const float xv = xs[c * kThreads + t];
        for (int g = 0; g < kGroup; ++g)
          if (e0 + g < E) z[g] = fmaf(wes[c * E + e0 + g], xv, z[g]);
      }
      for (int g = 0; g < kGroup; ++g) {
        const float zb = round_bf16(z[g]);
        ws[g * kThreads + t] = in ? round_bf16(zb / (1.f + expf(-zb))) : 0.f;
      }
      __syncthreads();
      // taps: warp g owns expanded channel e0 + g, lane the output column w0 + lane - 1
      const int e = e0 + warp, w = w0 + lane - 1;
      float s = 0.f;
      if (e < E && lane >= 1 && lane <= kChunk && w < W) {
        float tap[9];
        for (int j = 0; j < 9; ++j) tap[j] = __bfloat162float(k[((size_t)e * 9 + j) * W + w]);
        const float* row = ws + warp * kThreads;
        for (int rr = 0; rr < kRows; ++rr) {
          float d = 0.f;
          for (int a = 0; a < 3; ++a)
            for (int b = 0; b < 3; ++b)
              d += round_bf16(row[rr * kSpan + lane - 1 + b] * tap[3 * a + b]);
          s += d;
        }
      }
      s = warp_sum(s);
      if (lane == 0 && e < E) esum[e] += s;
    }
  }
  __syncthreads();
  for (int e = t; e < E; e += kThreads) part[((size_t)n * ntl + i) * E + e] = esum[e];
}

// out[c] = sum_b part[b * stride + c] for c < K, blocks b in order.
__global__ void reduce_kernel(const float* part, float* out, int blocks, int K, int stride) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= K) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += part[(size_t)b * stride + c];
  out[c] = s;
}

// Tile pair number `tile` of the upper triangle (ti <= tj) of a CT x CT grid.
__device__ void tile_pair(int tile, int CT, int& ti, int& tj) {
  ti = 0;
  while (tile >= CT - ti) tile -= CT - ti++;
  tj = ti + tile;
}

__device__ __forceinline__ float dot(float a, float b, float s) { return fmaf(a, b, s); }
__device__ __forceinline__ float dot(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// acc[2q + p] += row(ch[q]) . row(ch[2 + p]) over this thread's units: thread t
// takes units t, t + kThreads, ... of a channel's R x Wu units (a unit is V, one
// float or a float4 of a row of ld floats), stepping its row and column by adds.
// kDiag: ch[2 + p] == ch[p], so the second pair of rows is not read again and
// only q <= p is summed.
template <typename V, bool kDiag>
__device__ __forceinline__ void gram_tile(const float* __restrict__ x, const int* ch, int R, int Wu,
                                          int ld, float* acc) {
  constexpr int u4 = sizeof(V) / sizeof(float);
  const int ldu = ld / u4;
  const V* rows[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) rows[q] = reinterpret_cast<const V*>(x + (size_t)ch[q] * R * ld);
  const int dr = kThreads / Wu, dw = kThreads - dr * Wu;
  int r = (int)threadIdx.x / Wu, w = (int)threadIdx.x - r * Wu;
  while (r < R) {
    V a[kGramUnits][2], b[kGramUnits][2];
    bool in[kGramUnits];
#pragma unroll
    for (int u = 0; u < kGramUnits; ++u) {
      in[u] = r < R;
      if (in[u]) {
        const size_t off = (size_t)r * ldu + w;
        a[u][0] = rows[0][off];
        a[u][1] = rows[1][off];
        if (!kDiag) b[u][0] = rows[2][off], b[u][1] = rows[3][off];
        w += dw, r += dr;
        if (w >= Wu) w -= Wu, ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kGramUnits; ++u) {
      if (!in[u]) continue;
      if (kDiag) b[u][0] = a[u][0], b[u][1] = a[u][1];
      acc[0] = dot(a[u][0], b[u][0], acc[0]);
      acc[1] = dot(a[u][0], b[u][1], acc[1]);
      if (!kDiag) acc[2] = dot(a[u][1], b[u][0], acc[2]);
      acc[3] = dot(a[u][1], b[u][1], acc[3]);
    }
  }
}

// Grid CT (CT + 1) / 2 with CT = ceil(C / 2), one block per 2 x 2 tile (ti <= tj):
// out[i, j] = sum_{r, w < W} x[i, r, w] x[j, r, w] for x (C, R, ld), rows of W values
// at a stride of ld (a row-padded buffer is read in place). vec: W and ld are
// multiples of 4 and x is 16-byte aligned (float4 loads).
__global__ void __launch_bounds__(kThreads) gram_kernel(const float* __restrict__ x,
                                                        float* __restrict__ out, int C, int R,
                                                        int W, int ld, int vec) {
  __shared__ float red[kWarps * 4];
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  int ti, tj;
  tile_pair(blockIdx.x, (C + 1) / 2, ti, tj);
  const bool diag = ti == tj;
  // an odd C's last tile repeats channel C - 1; its sums are not written
  const int ch[4] = {min(2 * ti, C - 1), min(2 * ti + 1, C - 1), min(2 * tj, C - 1),
                     min(2 * tj + 1, C - 1)};
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (vec) {
    if (diag) gram_tile<float4, true>(x, ch, R, W / 4, ld, acc);
    else gram_tile<float4, false>(x, ch, R, W / 4, ld, acc);
  } else {
    if (diag) gram_tile<float, true>(x, ch, R, W, ld, acc);
    else gram_tile<float, false>(x, ch, R, W, ld, acc);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = warp_sum(acc[e]);
  if (lane == 0)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[warp * 4 + e] = acc[e];
  __syncthreads();
  if (t < 4) {
    float v = 0.f;
    for (int k = 0; k < kWarps; ++k) v += red[k * 4 + t];
    const int q = t / 2, p = t % 2, i = 2 * ti + q, j = 2 * tj + p;
    if (i < C && j < C && !(diag && q > p)) {
      out[(size_t)i * C + j] = v;
      out[(size_t)j * C + i] = v;
    }
  }
}

// out[i] = x[i] * scale for i < n, one unit a thread and no loop. kVec (both
// pointers 16-byte aligned): thread i < n / 4 moves float4 i, and the next n % 4
// threads the tail's floats.
template <typename I, bool kVec>
__global__ void __launch_bounds__(kThreads) copy_scale_kernel(const float* __restrict__ x,
                                                              float* __restrict__ out, I n,
                                                              float scale) {
  const I i = (I)blockIdx.x * kThreads + threadIdx.x;
  if (kVec) {
    const I n4 = n / 4;
    if (i < n4) {
      float4 v = reinterpret_cast<const float4*>(x)[i];
      v.x *= scale, v.y *= scale, v.z *= scale, v.w *= scale;
      reinterpret_cast<float4*>(out)[i] = v;
    } else if (i - n4 < n - 4 * n4) {
      const I j = 3 * n4 + i;  // 4 * n4 + (i - n4)
      out[j] = x[j] * scale;
    }
  } else if (i < n) {
    out[i] = x[i] * scale;
  }
}

template <typename I, bool kVec>
void launch_copy_scale(const float* x, float* out, long long n, float scale, cudaStream_t s) {
  const long long units = kVec ? n / 4 + n % 4 : n;
  const long long blocks = units > 0 ? (units + kThreads - 1) / kThreads : 1;
  copy_scale_kernel<I, kVec><<<(unsigned)blocks, kThreads, 0, s>>>(x, out, (I)n, scale);
}

// out (H, C2, W)[h, d, w] = sum_c w[c, d] x (C, H, W)[c, h, w]
__global__ void channel_mix_kernel(const float* x, const float* wm, float* out, int C, int C2,
                                   int H, int W) {
  const size_t total = (size_t)H * C2 * W;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int w = idx % W, d = (idx / W) % C2, h = idx / ((size_t)W * C2);
    float s = 0.f;
    for (int c = 0; c < C; ++c) s = fmaf(wm[c * C2 + d], x[((size_t)c * H + h) * W + w], s);
    out[idx] = s;
  }
}

size_t compute_smem(int C, int E) {
  return sizeof(float) * ((size_t)C * kThreads + (size_t)C * E + kGroup * kThreads + E);
}

// Blocks of the channel-mix kernel's grid-stride loop over n elements: one per
// kThreads, at most 1024.
int flat_blocks(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return b < 1 ? 1 : (b > 1024 ? 1024 : (int)b);
}

// Makes `device` current for the launcher's life when it is not already (the
// kernels run on the device of their tensors), and restores the caller's device.
struct DeviceGuard {
  int prev = -1, want;
  int err;
  explicit DeviceGuard(int device) : want(device) {
    err = (int)cudaGetDevice(&prev);
    if (!err && prev != want) err = (int)cudaSetDevice(want);
  }
  ~DeviceGuard() {
    if (prev >= 0 && prev != want) cudaSetDevice(prev);
  }
};

int finish(const float* part, float* out, int blocks, int K, int stride, cudaStream_t s) {
  int rc;
  if ((rc = (int)cudaGetLastError())) return rc;
  reduce_kernel<<<(K + 127) / 128, 128, 0, s>>>(part, out, blocks, K, stride);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface, loaded with ctypes. Every launcher runs its kernels on CUDA device
// `device` (made current only if it is not) and enqueues them on `stream`, does
// not synchronise, and returns a CUDA error code (0 on success). Grid launchers
// take x (N, C, H, W) bf16 with H % 8 == 0 and W even, a scratch `part` of
// (N * H / 8, C) floats ((N * H / 8, E) for compute) and write out (C,) fp32.
// ---------------------------------------------------------------------------

extern "C" {

int pr_grid_sum(int kind, const void* x, const void* k, const void* vec, float* part, float* out,
                int N, int C, int E, int H, int W, int device, void* stream) {
  if (kind < 0 || kind > 2 || H % kRows || W % 2 || C < 1) return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err) return guard.err;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(H / kRows, N);
  grid_sum_kernel<<<grid, kThreads, 0, s>>>((const bf16*)x, (const bf16*)k, (const bf16*)vec,
                                            part, kind, C, E, H, W);
  return finish(part, out, N * H / kRows, C, C, s);
}

int pr_grid_compute(const void* x, const void* we, const void* k, float* part, float* out, int N,
                    int C, int E, int H, int W, int device, void* stream) {
  const size_t smem = compute_smem(C, E);
  if (H % kRows || C < 1 || E < C || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err) return guard.err;
  int rc;
  if ((rc = (int)cudaFuncSetAttribute(grid_compute_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
    return rc;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(H / kRows, N);
  grid_compute_kernel<<<grid, kThreads, smem, s>>>((const bf16*)x, (const bf16*)we,
                                                   (const bf16*)k, part, C, E, H, W);
  return finish(part, out, N * H / kRows, C, E, s);
}

// x (C, R, ld) fp32 with 1 <= W <= ld; out (C, C).
int pr_gram(const float* x, float* out, int C, int R, int W, int ld, int device, void* stream) {
  if (C < 1 || W < 1 || W > ld || R < 0) return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err) return guard.err;
  const int vec = W % 4 == 0 && ld % 4 == 0 && (uintptr_t)x % 16 == 0;
  const int CT = (C + 1) / 2;
  gram_kernel<<<CT * (CT + 1) / 2, kThreads, 0, (cudaStream_t)stream>>>(x, out, C, R, W, ld, vec);
  return (int)cudaGetLastError();
}

int pr_copy_scale(const float* x, float* out, long long n, float scale, int device,
                  void* stream) {
  DeviceGuard guard(device);
  if (guard.err) return guard.err;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = ((uintptr_t)x | (uintptr_t)out) % 16 == 0;
  if (n < (1ll << 31)) {
    if (vec) launch_copy_scale<int, true>(x, out, n, scale, s);
    else launch_copy_scale<int, false>(x, out, n, scale, s);
  } else {
    if (vec) launch_copy_scale<long long, true>(x, out, n, scale, s);
    else launch_copy_scale<long long, false>(x, out, n, scale, s);
  }
  return (int)cudaGetLastError();
}

int pr_channel_mix(const float* x, const float* w, float* out, int C, int C2, int H, int W,
                   int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err) return guard.err;
  channel_mix_kernel<<<flat_blocks((long long)H * C2 * W), kThreads, 0, (cudaStream_t)stream>>>(
      x, w, out, C, C2, H, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
