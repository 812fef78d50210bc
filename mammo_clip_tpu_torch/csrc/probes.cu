// Hand-written CUDA for the TPU probes of benchmarks/probe_mosaic.py, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of that script:
//   grid probes (probe_grid_overhead, :184-264), over x (N, C, H, W) bf16 in 8-row
//   tiles:
//     base     o[c] = sum_{n,h,w} x[n,c,h,w]                                  (:184)
//     halo     base + each tile's clamped halo rows 8*max(i-1,0)+7 and
//              8*min(i+1,H/8-1), broadcast over its 8 rows                    (:197)
//     const    base + N*(H/8)*8*W*(sum k[:,0,:] + sum vec), the (E, 9, W) tap
//              bank and the (E, 1, W) vector resident in every TPU grid step  (:219)
//     compute  per tile z = We^T x (fp32 sums, stored bf16), w = SiLU(z) (bf16),
//              d[e,h,w] = sum_{a,b<3} bf16(wpad[e,h,w+b] * k[e,3a+b,w]) in fp32
//              (zero padding in w, no vertical halo), o[c] += sum_{h,w} d[c,h,w]
//              for c < C (the kernel sums all E channels; ops/probes.py
//              returns the first C)                                           (:235)
//   layout probes (_run, :25-27, over the probes at :37-140), whose functions are:
//     gram         X X^T (C x C, fp32) of each channel's rows flattened
//                  (concat_aligned with its 380 -> 384 zero padding,
//                  reshape_collapse, reshape_collapse_rows10)
//     copy_scale   a copy into another shape, times a scale (reshape_split,
//                  sublane_stack, reshape_split_rows10)
//     channel_mix  o[h,c',w] = sum_c w[c,c'] x[c,h,w] (what dot_3d_rank3rhs means)
//
// Design. No kernel here uses an atomic: a grid kernel writes partials that a
// second kernel adds in a fixed order, so every run gives the same bits. The
// base and halo kernels take one thread block per (image n, tile i), as the TPU
// grid (N, H/8) has; each warp sums whole channels of the block's 8-row slab
// (contiguous in memory) with bf16x2 loads and warp shuffles. The const kernel
// (grid_const_kernel, whose comment has the details) reads x as one contiguous
// range: two blocks per SM, each a run of whole slabs cut where an (n, c) plane
// ends; one thread streams the run into a ring of four 16 KB shared-memory
// stages by the Tensor Memory Accelerator's bulk copies (an mbarrier per stage
// counts its bytes, another the consumers' release), eight warps sum the
// stages, and a ninth sums the block's 1/G share of the tap bank, so the bank
// is read once a call, not once per block; its finishing kernel is a
// programmatic dependent launch, which overlaps its launch with the stream. An
// x that is not 16-byte aligned takes 4-byte loads into registers in the same
// kernel. (16-byte loads straight into registers, 4 in flight a thread, were
// measured against the ring and lost: PERF.md.) The compute kernel (grid_compute_kernel) keeps the probe's rounding points (z,
// SiLU and each tap product rounded to bf16, sums in fp32) with its products on
// the tensor cores: a block owns 64 columns x 64 expanded channels and walks a
// run of 8-row tiles, so that its slice of the tap bank k is read once, into
// registers, and not once per tile; z = x We is an mma.sync product, each pair
// of tap products one mul.rn.bf16x2, and their sums mma.sync products with a
// 0/1 selector; the next tile of x is loaded by cp.async while the current one
// computes.
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
// The channel-mix kernel reads each x value from global memory once, into a
// shared-memory tile of 16 channels x 32 columns, and w's 16 x 16 tile beside
// it; a thread per (output channel, 4 columns) sums from the tiles by fmaf in c
// order.
//
// What bounds them on an H100 (3.35 TB/s, 989 TFLOP/s bf16, 67 TFLOP/s fp32 off
// the tensor cores): x is 114 MB in bf16 at the probe's (16, 40, 232, 384), so
// the base, halo and const probes are bound by reading it (~34 us). The const
// kernel takes ~45-47 us on an NVIDIA H100 80GB HBM3 at 700 W (one torch.sum of
// x ~46 us; without its finishing kernel ~43 us: PERF.md).
// The compute kernel's work, priced at the units that do it: on the tensor cores
// z (27.4 GFLOP) and the taps' selector mmas (144 flop an output, 49.3 GFLOP),
// ~77 us, which bounds it; off them the 3.08 G packed tap products, two an
// instruction at the fp32 FMA rate (~46 us). On chip it takes ~9x that
// (PERF.md): the z phase (per position and channel a SiLU, two MUFU operations)
// and the taps run between barriers and add up, and x's loads are hardly
// overlapped. The layout probes move well under 1 MB: their device work is
// 2-3 us a call, of which ~1.7-1.9 us is the least any launch takes (an empty
// kernel; benchmarks/layout_timing.py, NVIDIA H100 80GB HBM3, 700.00 W), below
// the host's cost of a launch, which bounds a call (ops/probes.py launches
// through cuda_lib.launcher for that reason). The grid kernels' per-block work
// is the per-tile cost of the halo tiling csrc/mbconv6_e6.cu uses, which is what
// the probe measures.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                 // rows of a grid tile (the probe's h_tile)
constexpr int kGramUnits = 4;            // Gram row units a thread keeps in flight

// The compute kernel (grid_compute_kernel): a block owns 64 columns x 64 expanded
// channels and walks a run of 8-row tiles with 16 warps.
constexpr int kCT = 512;                 // threads: 16 warps
constexpr int kCTW = kCT / 32;
constexpr int kCols = 64;                // columns of a block
constexpr int kHalf = kCols / 2;         // columns of a warp in the taps (one per lane)
constexpr int kGE = 64;                  // expanded channels of a block: 8 octets
constexpr int kMaxCC = 48;               // C at most: 3 k16 steps of the expand product
constexpr int kXS = kRows * kCols + 8;   // channel stride (bf16) of the x tile: 1040 B
constexpr int kHS = 16 + 8;              // channel stride (bf16) of the halo tile: 48 B
constexpr int kPos = kCols + 2;          // positions of a row of w: the columns and their halo
constexpr int kWS = kGE / 8 * kRows * kPos * 4;  // words of the w tile (4 channel pairs a position)
static_assert(kCTW == 2 * kRows && kCTW == 2 * (kGE / 8), "z: a warp per row and channel half; "
              "taps: a warp per octet and column half");
constexpr size_t kMaxSmem = 232448;

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

// grid (H / 8, N); part (N * H / 8, C). kind 0: base, 1: halo.
__global__ void __launch_bounds__(kThreads) grid_sum_kernel(const bf16* x, float* part, int kind,
                                                            int C, int H, int W) {
  const int i = blockIdx.x, n = blockIdx.y, ntl = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int top = kRows * max(i - 1, 0) + kRows - 1, bot = kRows * min(i + 1, ntl - 1);
  for (int c = warp; c < C; c += kWarps) {
    const bf16* plane = x + ((size_t)n * C + c) * H * W;
    float s = slab_sum(plane + (size_t)i * kRows * W, kRows * W, lane);
    if (kind == 1) {
      float h = 0.f;
      for (int w = lane; w < W; w += 32)
        h += __bfloat162float(plane[(size_t)top * W + w]) + __bfloat162float(plane[(size_t)bot * W + w]);
      s += kRows * warp_sum(h);
    }
    if (lane == 0) part[((size_t)n * ntl + i) * C + c] = s;
  }
}

// The const kernel (grid_const_kernel). x, read as one contiguous range, is cut into
// runs of whole 8-row slabs, one run a block; the ring design streams a run through
// shared memory by bulk copies, kStages stages of kStageBytes each.
enum ConstLoads { kRing = 0, kRegs4 = 1 };
constexpr int kConsumers = kThreads;               // threads that sum x (8 warps)
constexpr int kRingThreads = kConsumers + 64;      // and the ring's producer and bank warps
constexpr int kStageBytes = 16384;
constexpr int kStageElems = kStageBytes / 2;
constexpr int kStages = 4;
constexpr int kRingPerSM = 2;                      // blocks per SM of the ring design
constexpr int kRegsPerSM = 4;                      // and of the register-load branch
constexpr int kRegLoads = 4;                       // loads in flight per thread (registers)

__device__ __forceinline__ float sum2(unsigned u) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  return f.x + f.y;
}
__device__ __forceinline__ float sum2(uint4 v) {
  return (sum2(v.x) + sum2(v.y)) + (sum2(v.z) + sum2(v.w));
}

// The consumers' sum of v, valid in thread 0: one barrier among the consumer
// threads (named barrier 1, so the ring's producer warp takes no part); the two
// slots of red alternate, so the next call cannot overwrite what thread 0 still reads.
__device__ float consumer_sum(float v, float (*red)[kConsumers / 32], int& slot) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) red[slot][threadIdx.x / 32] = v;
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  float t = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kConsumers / 32; ++w) t += red[slot][w];
  slot ^= 1;
  return t;
}

// Thread t of T's part of block b of G's bank share: the pairs [E W b / G,
// E W (b + 1) / G) of (e, w) in order, this thread's the w = lo + t, lo + t + T,
// ... of each e, each pair k[e, 0, w] + vec[e, 0, w] added before it is summed
// (so that vec = -k[:, 0:1, :] cancels it exactly).
__device__ float bank_share(const bf16* __restrict__ k, const bf16* __restrict__ vec, int E,
                            int W, int b, int G, int t, int T) {
  const long long q0 = (long long)E * W * b / G, q1 = (long long)E * W * (b + 1) / G;
  float bank = 0.f;
  for (long long e = q0 / W; e * W < q1; ++e) {
    const int lo = (int)(max(q0, e * W) - e * W), hi = (int)(min(q1, (e + 1) * W) - e * W);
    const bf16* kr = k + (size_t)e * 9 * W;
    const bf16* vr = vec + (size_t)e * W;
    for (int w = lo + t; w < hi; w += T) bank += __bfloat162float(kr[w]) + __bfloat162float(vr[w]);
  }
  return bank;
}

// This thread's sum of the n bf16 pairs at v, read straight from global memory,
// kRegLoads independent loads in flight.
__device__ __forceinline__ float stream_sum(const unsigned* __restrict__ v, long long n) {
  float acc = 0.f;
  long long i = threadIdx.x;
  for (; i + (kRegLoads - 1) * kConsumers < n; i += kRegLoads * kConsumers) {
    unsigned a[kRegLoads];
#pragma unroll
    for (int u = 0; u < kRegLoads; ++u) a[u] = __ldg(v + i + u * kConsumers);
#pragma unroll
    for (int u = 0; u < kRegLoads; ++u) acc += sum2(a[u]);
  }
  for (; i < n; i += kConsumers) acc += sum2(__ldg(v + i));
  return acc;
}

// grid G; part (G, C + 1): row b holds block b's sum of x over each channel's
// planes in its run (0 for the others) and, at C, its share of the bank.
// Block b's run is the slabs [S b / G, S (b + 1) / G) of the S = N C H / 8 slabs
// in x's memory order; a slab is 8 W values and no slab straddles a plane (one
// (n, c) image of H W values), so the run is the element range [e0, e1), cut at
// plane boundaries into segments: each segment's sum is reduced over the block
// and added to its channel's partial, in order, by thread 0 alone; the block's
// bank share (bank_share) goes to part[b, C]. kRing: one producer thread keeps
// kStages bulk copies of up to kStageBytes in flight (no copy crosses a
// segment's end; a full barrier per stage counts its bytes, an empty barrier
// the 8 consumer warps' release) and a warp of its own sums the bank share, so
// that the consumers start on the first stage at once; kRegs4 (an x that is not
// 16-byte aligned): every thread loads 4-byte words of the segment straight into
// registers, and all of them sum the bank share first. Each block lets the finishing
// kernel launch at its start (grid_dependents_launch).
template <int kLoads>
__global__ void __launch_bounds__(kLoads == kRing ? kRingThreads : kConsumers)
    grid_const_kernel(const bf16* __restrict__ x, const bf16* __restrict__ k,
                      const bf16* __restrict__ vec, float* __restrict__ part, int C, int E, int H,
                      int W, long long S) {
  extern __shared__ __align__(128) unsigned char ring[];  // kRing: [kStages][kStageBytes]
  __shared__ unsigned long long bars[2 * kStages];         // kRing: full, then empty
  __shared__ float red[2][kConsumers / 32];
  const int tid = threadIdx.x, G = gridDim.x, b = blockIdx.x;
  const long long plane = (long long)H * W, slab = (long long)kRows * W;
  const long long e0 = S * b / G * slab, e1 = S * (b + 1) / G * slab;
  float* row = part + (size_t)b * (C + 1);
  grid_dependents_launch();

  if (kLoads == kRing) {
    if (tid == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(&bars[s], 1);
        mbar_init(&bars[kStages + s], kConsumers / 32);
      }
      mbar_fence_init();
    }
    __syncthreads();
    if (tid >= kConsumers + 32) {  // the bank warp
      const float bank = warp_sum(bank_share(k, vec, E, W, b, G, tid % 32, 32));
      if (tid % 32 == 0) row[C] = bank;
      return;
    }
    if (tid >= kConsumers) {  // the producer warp: one thread issues the copies
      if (tid == kConsumers) {
        int it = 0;
        for (long long pos = e0; pos < e1;) {
          const long long end = min(e1, (pos / plane + 1) * plane);
          for (long long q = pos; q < end; q += kStageElems, ++it) {
            const int n = (int)min((long long)kStageElems, end - q), st = it % kStages;
            if (it >= kStages) mbar_wait(&bars[kStages + st], (it / kStages - 1) & 1);
            mbar_arrive_tx(&bars[st], 2 * n);
            bulk_load(ring + st * kStageBytes, x + q, 2 * n, &bars[st]);
          }
          pos = end;
        }
      }
      return;
    }
  }

  // the first segment's barrier (consumer_sum) orders these zeros before thread 0's adds
  for (int c = tid; c < C; c += kConsumers) row[c] = 0.f;
  int slot = 0;
  if (kLoads != kRing) {
    const float bank = consumer_sum(bank_share(k, vec, E, W, b, G, tid, kConsumers), red, slot);
    if (tid == 0) row[C] = bank;
  }

  int it = 0;
  for (long long pos = e0; pos < e1;) {
    const long long p = pos / plane, end = min(e1, (p + 1) * plane);
    float acc = 0.f;
    if (kLoads == kRing) {
      for (long long q = pos; q < end; q += kStageElems, ++it) {
        const int n = (int)min((long long)kStageElems, end - q), st = it % kStages;
        mbar_wait(&bars[st], (it / kStages) & 1);
        const uint4* v = reinterpret_cast<const uint4*>(ring + st * kStageBytes);
        for (int i = tid; i < n / 8; i += kConsumers) acc += sum2(v[i]);
        __syncwarp();
        if (tid % 32 == 0) mbar_arrive(&bars[kStages + st]);
      }
    } else {
      acc = stream_sum(reinterpret_cast<const unsigned*>(x + pos), (end - pos) / 2);
    }
    acc = consumer_sum(acc, red, slot);
    if (tid == 0) row[p % C] += acc;
    pos = end;
  }
}

// out[c] = sum_b part[b, c] + nhw * sum_b part[b, C] over the G rows of part (C + 1
// floats each), one block per channel: thread t takes rows t, t + kThreads, ...,
// then the warps' sums in order (a fixed order: the same bits every call).
// Launched as a programmatic dependent of grid_const_kernel: it may start while
// that kernel runs and waits for its writes before it reads part.
__global__ void __launch_bounds__(kThreads) const_finish_kernel(const float* __restrict__ part,
                                                                float* __restrict__ out, int G,
                                                                int C, float nhw) {
  __shared__ float red[2][kWarps];
  const int c = blockIdx.x, t = threadIdx.x;
  grid_dependency_wait();
  float xs = 0.f, bank = 0.f;
  for (int b = t; b < G; b += kThreads) {
    xs += part[(size_t)b * (C + 1) + c];
    bank += part[(size_t)b * (C + 1) + C];
  }
  xs = warp_sum(xs);
  bank = warp_sum(bank);
  if (t % 32 == 0) red[0][t / 32] = xs, red[1][t / 32] = bank;
  __syncthreads();
  if (t == 0) {
    float a = 0.f, kb = 0.f;
    for (int w = 0; w < kWarps; ++w) a += red[0][w], kb += red[1][w];
    out[c] = a + nhw * kb;
  }
}

__device__ __forceinline__ unsigned short bf16_bits(const bf16* p, size_t i) {
  return reinterpret_cast<const unsigned short*>(p)[i];
}
__device__ __forceinline__ unsigned pack2(unsigned short lo, unsigned short hi) {
  return (unsigned)lo | ((unsigned)hi << 16);
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Two bf16 products at once, each the exact product rounded to bf16 (to nearest,
// ties to even): the same value as bf16(float(a) * float(b)), since a product of
// two bf16 values is exact in fp32.
__device__ __forceinline__ unsigned bmul2(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// SiLU of z0 and z1 rounded to bf16, in fp32: z / (1 + exp(-z)) by __expf and a
// fast reciprocal (__fdividef; both a few ulp from the exact value, so w's bf16
// rounding is the plain version's but where z's SiLU lies within a few ulp of a
// rounding boundary). For z < -87 the divisor overflows and w is 0, not a
// subnormal of at most 1e-36.
__device__ __forceinline__ float2 silu_of_bf16(float z0, float z1) {
  const float2 z = __bfloat1622float2(__floats2bfloat162_rn(z0, z1));
  return make_float2(__fdividef(z.x, 1.f + __expf(-z.x)), __fdividef(z.y, 1.f + __expf(-z.y)));
}

size_t compute_smem(int Cp) {
  return sizeof(bf16) * 2 * ((size_t)Cp * kXS + (size_t)Cp * kHS) +
         sizeof(unsigned) * (size_t)kWS + sizeof(float) * kCTW * 8;
}

// grid (ceil(W / 64) * ceil(E / 64), segments); part (segments * ceil(W / 64), E):
// block (column range cr, channel group grp, segment seg) walks the 8-row tiles
// [seg * T / S, (seg + 1) * T / S) of the T = N * H / 8 tiles (image-major) and
// writes, for each channel e of its group, the sum over those tiles and its 64
// columns of d[e, h, w] = sum_{a,b<3} bf16(w[e, h, w + b - 1] * k[e, 3a + b, w]),
// w = bf16(SiLU(bf16(sum_c x[c] we[c, e]))). x (N, C, H, W), we (C, E), k (E, 9, W)
// bf16; vec: 16-byte x loads (W % 8 == 0 and x 16-byte aligned).
//
// Per tile (8 rows, 64 columns and their two halo columns, 64 channels):
//   z, w   warp w takes row w / 2 and the 32 channels (w % 2): the expand product
//          z = We^T x on the tensor cores, channels as M (We's A fragments in
//          registers for the whole walk), positions as N (the bf16 x tile in
//          shared memory, B fragments by ldmatrix.trans, each reused by both
//          m16 tiles), C as K; warps 0 and 1 also take the 16 halo positions
//          (spreading them over four warps measured no faster).
//          SiLU of the rounded z, rounded to bf16, goes to the block's w tile
//          ([octet][row][position][channel pair], 16 bytes a position: the
//          pairs' stores and the taps' loads are conflict-free); a shuffle
//          pairs the neighbouring channels of each position.
//   taps   warp w takes the channel octet w / 2 and the 32-column half w % 2,
//          lane = column: its 36 tap pairs k[e, j, w], k[e + 1, j, w] live in
//          registers for the whole walk, a position's 8 channels are one
//          16-byte load, each product pair is one mul.rn.bf16x2, and the sums
//          run on the tensor cores too: the four product pairs of a tap (8
//          channels) are the A operand of an mma whose B is a 0/1 selector,
//          B[k][n] = [k >= 8 == n >= 4 and k % 2 == n % 2], so that column n of
//          the fp32 accumulator collects one channel (exact bf16 values in, fp32
//          sums). The accumulators are emptied into fp32 registers every tile.
// x's next tile is loaded by cp.async (its halo columns into registers) while
// the current one computes; two barriers a tile. One partial per (block,
// channel), no atomics.
__global__ void __launch_bounds__(kCT, 1)
    grid_compute_kernel(const bf16* __restrict__ x, const bf16* __restrict__ we,
                        const bf16* __restrict__ k, float* __restrict__ part, int N, int C,
                        int E, int H, int W, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Cp = (C + 15) / 16 * 16, kc = Cp / 16;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);                          // [2][Cp][kXS]
  bf16* xh = xs + 2 * (size_t)Cp * kXS;                                  // [2][Cp][kHS]
  unsigned* ws = reinterpret_cast<unsigned*>(xh + 2 * (size_t)Cp * kHS);  // [8][kRows][kPos][4]
  float* red = reinterpret_cast<float*>(ws + kWS);                       // [kCTW][8]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int groups = (E + kGE - 1) / kGE;
  const int grp = blockIdx.x % groups, cr = blockIdx.x / groups, c0 = cr * kCols;
  const int e0 = grp * kGE;
  // the z phase's row and channel half; the taps' octet and column half
  const int zr = warp >> 1, zh = warp & 1, oct = warp >> 1, half = warp & 1;
  const bool z_active = e0 + zh * (kGE / 2) < E, active = e0 + oct * 8 < E;
  const int col = c0 + half * kHalf + lane;  // the lane's output column
  const int ntl = H / kRows;
  const long long T = (long long)N * ntl;
  const int tb = (int)(T * blockIdx.y / gridDim.y), te = (int)(T * (blockIdx.y + 1) / gridDim.y);

  // channels C..Cp-1 of both x and both halo buffers stay zero
  for (int i = tid; i < 2 * (Cp - C) * kXS; i += kCT) {
    const int b = i / ((Cp - C) * kXS), r = i % ((Cp - C) * kXS);
    xs[(size_t)b * Cp * kXS + (size_t)C * kXS + r] = __float2bfloat16(0.f);
  }
  for (int i = tid; i < 2 * (Cp - C) * kHS; i += kCT) {
    const int b = i / ((Cp - C) * kHS), r = i % ((Cp - C) * kHS);
    xh[(size_t)b * Cp * kHS + (size_t)C * kHS + r] = __float2bfloat16(0.f);
  }

  // We^T's A fragments for the warp's 32 channels (2 m16 tiles, 3 k16 steps)
  unsigned aw[2][3][4] = {};
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int kk = 0; kk < 3; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = e0 + zh * (kGE / 2) + m * 16 + g + (i & 1) * 8;
        const int c = kk * 16 + 2 * t + (i >> 1) * 8;
        const unsigned short lo = (c < C && e < E) ? bf16_bits(we, (size_t)c * E + e) : 0;
        const unsigned short hi = (c + 1 < C && e < E) ? bf16_bits(we, (size_t)(c + 1) * E + e) : 0;
        if (kk < kc) aw[m][kk][i] = pack2(lo, hi);
      }
  // the lane's taps for its octet's 4 channel pairs
  unsigned kr[4][9];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const int ea = e0 + oct * 8 + 2 * p;
      const bool in = col < W;
      const unsigned short lo = (in && ea < E) ? bf16_bits(k, ((size_t)ea * 9 + j) * W + col) : 0;
      const unsigned short hi =
          (in && ea + 1 < E) ? bf16_bits(k, ((size_t)(ea + 1) * 9 + j) * W + col) : 0;
      kr[p][j] = pack2(lo, hi);
    }
  // the adder's selector: b0 rows k < 8, b1 rows k >= 8, of column n = g
  const unsigned one = (g & 1) ? 0x3F800000u : 0x00003F80u;
  const unsigned sel0 = g < 4 ? one : 0u, sel1 = g < 4 ? 0u : one;

  const unsigned short* xu = reinterpret_cast<const unsigned short*>(x);
  auto tile_src = [&](int tt, int c, int r) {  // x[n, c, row0 + r, 0]
    const int n = tt / ntl, row0 = (tt - n * ntl) * kRows;
    return ((size_t)(n * C + c) * H + row0 + r) * W;
  };
  // x's tile tt (its 64 columns) into buffer b by cp.async, zero past W
  auto load_tile = [&](int tt, int b) {
    bf16* dst = xs + (size_t)b * Cp * kXS;
    if (vec) {
      for (int i = tid; i < C * kRows * (kCols / 8); i += kCT) {
        const int c = i / (kRows * kCols / 8), r = (i / (kCols / 8)) % kRows, q = i % (kCols / 8);
        const int cc = c0 + q * 8;
        const bool in = cc < W;
        cp_async16(dst + c * kXS + r * kCols + q * 8, in ? x + tile_src(tt, c, r) + cc : x,
                   in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < C * kRows * (kCols / 2); i += kCT) {
        const int c = i / (kRows * kCols / 2), r = (i / (kCols / 2)) % kRows, q = i % (kCols / 2);
        const int cc = c0 + q * 2;
        const bool in = cc < W;
        cp_async4(dst + c * kXS + r * kCols + q * 2, in ? x + tile_src(tt, c, r) + cc : x,
                  in ? 4 : 0);
      }
    }
  };
  // tile tt's halo columns: position 2r + s is column c0 - 1 (s = 0) or c0 + 64
  // (s = 1) of row r; up to 2 values a thread (C <= 48)
  constexpr int kHaloPer = (kMaxCC * 16 + kCT - 1) / kCT;
  auto load_halo = [&](int tt, unsigned short (&v)[kHaloPer]) {
#pragma unroll
    for (int u = 0; u < kHaloPer; ++u) {
      const int i = tid + u * kCT, c = i / 16, pos = i % 16;
      const int cc = (pos & 1) ? c0 + kCols : c0 - 1;
      v[u] = (c < C && cc >= 0 && cc < W) ? xu[tile_src(tt, c, pos >> 1) + cc] : 0;
    }
  };
  auto store_halo = [&](int b, const unsigned short (&v)[kHaloPer]) {
    unsigned short* dst = reinterpret_cast<unsigned short*>(xh + (size_t)b * Cp * kHS);
#pragma unroll
    for (int u = 0; u < kHaloPer; ++u) {
      const int i = tid + u * kCT;
      if (i < C * 16) dst[(i / 16) * kHS + i % 16] = v[u];
    }
  };
  // z for 16 positions (two n8 tiles; B from rows kk * 16 + .. of src, stride ld)
  // and the warp's 32 channels; w into the w tile at pos(q) = (row, position).
  auto z_pair = [&](const bf16* src, int ld, auto pos) {
    const int br = (lane & 7) + ((lane >> 3) & 1) * 8, bc = (lane >> 4) * 8;
    float z[2][2][4] = {};
#pragma unroll
    for (int kk = 0; kk < 3; ++kk) {
      if (kk < kc) {
        unsigned b[4];
        ldsm_t(b, src + (kk * 16 + br) * ld + bc);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma(z[m][0], aw[m][kk], b[0], b[1]);
          mma(z[m][1], aw[m][kk], b[2], b[3]);
        }
      }
    }
    // lane 4g + t holds channels g (z[.][.][0..1]) and g + 8 ([2..3]) of each m16
    // tile at positions 2t, 2t + 1 of each n8 tile; the lane with g even keeps
    // position 2t of channels (g, g + 1), its partner (lane ^ 4) position 2t + 1
    const bool odd = g & 1;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 s = silu_of_bf16(z[m][n][2 * h], z[m][n][2 * h + 1]);
          const float other = __shfl_xor_sync(0xffffffffu, odd ? s.x : s.y, 4);
          const int o = zh * 4 + m * 2 + h;  // the octet of channels g (+ 8 h)
          const int2 rp = pos(n * 8 + 2 * t + odd);
          ws[((o * kRows + rp.x) * kPos + rp.y) * 4 + (g >> 1)] =
              odd ? pack_bf16(other, s.y) : pack_bf16(s.x, other);
        }
  };

  float tot[4] = {0.f, 0.f, 0.f, 0.f};
  unsigned short hv[kHaloPer];
  if (tb < te) {
    load_tile(tb, 0);
    cp_async_commit();
    load_halo(tb, hv);
    store_halo(0, hv);
  }
  for (int tt = tb, b = 0; tt < te; ++tt, b ^= 1) {
    const bool more = tt + 1 < te;
    if (more) load_tile(tt + 1, b ^ 1);
    cp_async_commit();
    if (more) load_halo(tt + 1, hv);
    cp_async_wait_prior();
    __syncthreads();  // tile tt's x and halo are in shared memory; the w tile is free
    if (z_active) {
      const bf16* xb = xs + (size_t)b * Cp * kXS + zr * kCols;
#pragma unroll
      for (int j = 0; j < kCols / 16; ++j)
        z_pair(xb + j * 16, kXS, [&](int q) { return make_int2(zr, 1 + j * 16 + q); });
      if (zr == 0)  // the halo: position 2r + s of the halo tile
        z_pair(xh + (size_t)b * Cp * kHS, kHS,
               [](int q) { return make_int2(q >> 1, (q & 1) ? kPos - 1 : 0); });
    }
    __syncthreads();  // the w tile is complete
    if (active) {
      // taps: output (r, col) takes w at positions (r, 32 half + lane + bb), bb < 3
      float acc[3][4] = {};
      const uint4* wt = reinterpret_cast<const uint4*>(ws) + oct * kRows * kPos + half * kHalf + lane;
#pragma unroll 4
      for (int r = 0; r < kRows; ++r) {
        uint4 wv[3];
#pragma unroll
        for (int bb = 0; bb < 3; ++bb) wv[bb] = wt[r * kPos + bb];
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int bb = 0; bb < 3; ++bb) {
            const unsigned pr[4] = {bmul2(wv[bb].x, kr[0][3 * a + bb]),
                                    bmul2(wv[bb].y, kr[1][3 * a + bb]),
                                    bmul2(wv[bb].z, kr[2][3 * a + bb]),
                                    bmul2(wv[bb].w, kr[3][3 * a + bb])};
            mma(acc[a], pr, sel0, sel1);
          }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) tot[j] += (acc[0][j] + acc[1][j]) + acc[2][j];
    }
    if (more) store_halo(b ^ 1, hv);
  }

  // lane 4g + t: tot = channels 0-3 (t < 2) or 4-7 (t >= 2) of the octet, summed over g
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    tot[j] += __shfl_xor_sync(0xffffffffu, tot[j], 4);
    tot[j] += __shfl_xor_sync(0xffffffffu, tot[j], 8);
    tot[j] += __shfl_xor_sync(0xffffffffu, tot[j], 16);
  }
  if (lane == 0 || lane == 2)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp * 8 + (lane == 2 ? 4 : 0) + j] = tot[j];
  __syncthreads();
  if (tid < kGE) {
    const int e = e0 + tid, w0 = 2 * (tid / 8), j = tid % 8;
    if (e < E)
      part[((size_t)blockIdx.y * ((W + kCols - 1) / kCols) + cr) * E + e] =
          red[w0 * 8 + j] + red[(w0 + 1) * 8 + j];
  }
}

// out[i] = bmul2(a[i], b[i]) for n pairs: the tap products of grid_compute_kernel,
// held to fp32-multiply-then-round bit for bit by tests/test_torch_cuda.py.
__global__ void bf16_mul_kernel(const unsigned* a, const unsigned* b, unsigned* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = bmul2(a[i], b[i]);
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

// The channel-mix kernel: a block owns row h and a range of kMixCols columns and
// walks C2 in chunks of kMixD outputs and, for each, C in chunks of kMixC
// channels: its x tile (kMixC x kMixCols, one float4 a thread when vec) and w
// tile (kMixC x kMixD) go to shared memory, each value read from global memory
// by one thread; then thread (d, q) sums output d of the chunk at columns 4q..4q+3
// from the tiles, c in order by fmaf. At C2 <= kMixD every x value is read once.
constexpr int kMixC = 16, kMixD = 16, kMixQ = 8, kMixCols = 4 * kMixQ;
constexpr int kMixThreads = kMixD * kMixQ;
constexpr int kMixW = kMixC * kMixD / kMixThreads;  // w values a thread loads a tile
static_assert(kMixThreads == kMixC * kMixQ && kMixW * kMixThreads == kMixC * kMixD,
              "a tile load takes one float4 of x and kMixW values of w a thread");

// out (H, C2, W)[h, d, w] = sum_c w[c, d] x (C, H, W)[c, h, w]; vec: W % 4 == 0 and
// x, out 16-byte aligned (float4 loads and stores), else value by value.
template <bool kVec>
__global__ void __launch_bounds__(kMixThreads) channel_mix_kernel(const float* __restrict__ x,
                                                                  const float* __restrict__ wm,
                                                                  float* __restrict__ out, int C,
                                                                  int C2, int H, int W) {
  __shared__ float4 xs[kMixC][kMixQ];
  __shared__ float ws[kMixC][kMixD];
  const int tid = threadIdx.x, dq = tid / kMixQ, q = tid % kMixQ;
  const int nb = (W + kMixCols - 1) / kMixCols, h = blockIdx.x / nb;
  const int w0 = (blockIdx.x - h * nb) * kMixCols + 4 * q;
  const int cols = max(0, min(4, W - w0));  // columns of this thread's float4 within W
  for (int d0 = 0; d0 < C2; d0 += kMixD) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    auto step = [&](int j) {
      const float4 v = xs[j][q];
      const float f = ws[j][dq];
      acc.x = fmaf(f, v.x, acc.x);
      acc.y = fmaf(f, v.y, acc.y);
      acc.z = fmaf(f, v.z, acc.z);
      acc.w = fmaf(f, v.w, acc.w);
    };
    for (int c0 = 0; c0 < C; c0 += kMixC) {
      // tile loads: thread (dq, q) takes x[c0 + dq, h, w0..w0+3], and kMixW values of w
      float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c0 + dq < C && cols > 0) {
        const float* src = x + ((size_t)(c0 + dq) * H + h) * W + w0;
        if (kVec) {
          xv = __ldg(reinterpret_cast<const float4*>(src));
        } else {
          xv.x = __ldg(src);
          if (cols > 1) xv.y = __ldg(src + 1);
          if (cols > 2) xv.z = __ldg(src + 2);
          if (cols > 3) xv.w = __ldg(src + 3);
        }
      }
      float wv[kMixW];
#pragma unroll
      for (int u = 0; u < kMixW; ++u) {
        const int i = tid + u * kMixThreads, wc = c0 + i / kMixD, wd = d0 + i % kMixD;
        wv[u] = wc < C && wd < C2 ? __ldg(wm + (size_t)wc * C2 + wd) : 0.f;
      }
      __syncthreads();  // the previous tiles are no longer read
      xs[dq][q] = xv;
#pragma unroll
      for (int u = 0; u < kMixW; ++u) {
        const int i = tid + u * kMixThreads;
        ws[i / kMixD][i % kMixD] = wv[u];
      }
      __syncthreads();
      if (c0 + kMixC <= C) {
#pragma unroll
        for (int j = 0; j < kMixC; ++j) step(j);
      } else {
        for (int j = 0; j < C - c0; ++j) step(j);
      }
    }
    if (d0 + dq < C2 && cols > 0) {
      float* dst = out + ((size_t)h * C2 + d0 + dq) * W + w0;
      if (kVec) {
        *reinterpret_cast<float4*>(dst) = acc;
      } else {
        dst[0] = acc.x;
        if (cols > 1) dst[1] = acc.y;
        if (cols > 2) dst[2] = acc.z;
        if (cols > 3) dst[3] = acc.w;
      }
    }
  }
}

__global__ void empty_kernel() {}

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
// take x (N, C, H, W) bf16 with H % 8 == 0, W even and x 4-byte aligned (else
// cudaErrorInvalidValue, never a misaligned load) and a scratch `part`; pr_grid_sum's is (N * H / 8, C) floats and it writes out (C,)
// fp32.
// ---------------------------------------------------------------------------

extern "C" {

int pr_grid_sum(int kind, const void* x, float* part, float* out, int N, int C, int H, int W,
                int device, void* stream) {
  if (kind < 0 || kind > 1 || H % kRows || W % 2 || C < 1 || (uintptr_t)x % 4)
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err) return guard.err;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(H / kRows, N);
  grid_sum_kernel<<<grid, kThreads, 0, s>>>((const bf16*)x, part, kind, C, H, W);
  return finish(part, out, N * H / kRows, C, C, s);
}

// The const probe: k (E, 9, W) and vec (E, 1, W) bf16; part holds `parts` rows of
// C + 1 floats and bounds the grid (at most kRingPerSM or kRegsPerSM blocks per SM,
// one slab each at least); out (C,). The bulk-copy ring when x is 16-byte aligned,
// else 4-byte loads into registers.
int pr_grid_const(const void* x, const void* k, const void* vec, float* part, int parts,
                  float* out, int N, int C, int E, int H, int W, int device, void* stream) {
  if (N < 1 || C < 1 || E < 0 || H < kRows || H % kRows || W < 2 || W % 2 || parts < 1 ||
      (uintptr_t)x % 4)
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err) return guard.err;
  int sms, rc;
  if ((rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device))) return rc;
  const long long S = (long long)N * C * (H / kRows);
  const int loads = (uintptr_t)x % 16 ? kRegs4 : kRing;
  const int G = (int)std::min<long long>({S, (long long)sms * (loads == kRing ? kRingPerSM
                                                                              : kRegsPerSM),
                                          (long long)parts});
  cudaStream_t s = (cudaStream_t)stream;
  const bf16 *xb = (const bf16*)x, *kb = (const bf16*)k, *vb = (const bf16*)vec;
  if (loads == kRing) {
    constexpr int smem = kStages * kStageBytes;
    if ((rc = (int)cudaFuncSetAttribute(grid_const_kernel<kRing>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
      return rc;
    grid_const_kernel<kRing><<<G, kRingThreads, smem, s>>>(xb, kb, vb, part, C, E, H, W, S);
  } else {
    grid_const_kernel<kRegs4><<<G, kConsumers, 0, s>>>(xb, kb, vb, part, C, E, H, W, S);
  }
  if ((rc = (int)cudaGetLastError())) return rc;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, const_finish_kernel, (const float*)part, out, G, C,
                                 (float)((long long)N * H * W));
}

// The ring design's dynamic shared memory and how many of its blocks an SM holds,
// on the current device.
int pr_grid_const_info(int* smem, int* blocks) {
  *smem = kStages * kStageBytes;
  int rc;
  if ((rc = (int)cudaFuncSetAttribute(grid_const_kernel<kRing>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, *smem)))
    return rc;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, grid_const_kernel<kRing>,
                                                            kRingThreads, *smem);
}

// part holds `parts` rows of E floats (at least pr_grid_compute's segments times
// ceil(W / 64), which N * H / 8 * ceil(W / 64) always is); out (E,): the channel
// sums of d for all E channels. C <= 48.
int pr_grid_compute(const void* x, const void* we, const void* k, float* part, int parts,
                    float* out, int N, int C, int E, int H, int W, int device, void* stream) {
  if (N < 1 || H < kRows || H % kRows || W < 2 || W % 2 || C < 1 || C > kMaxCC || E < C ||
      (uintptr_t)x % 4)
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err) return guard.err;
  int sms, rc;
  if ((rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device))) return rc;
  // about two waves of one block per SM, each block a run of whole tiles
  const int cols = (W + kCols - 1) / kCols, groups = (E + kGE - 1) / kGE;
  const int tiles = N * (H / kRows);
  const int segs = std::max(1, std::min(tiles, (2 * sms + cols * groups - 1) / (cols * groups)));
  if ((long long)segs * cols > parts) return (int)cudaErrorInvalidValue;
  const size_t smem = compute_smem((C + 15) / 16 * 16);
  if ((rc = (int)cudaFuncSetAttribute(grid_compute_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
    return rc;
  cudaStream_t s = (cudaStream_t)stream;
  const int vec = W % 8 == 0 && (uintptr_t)x % 16 == 0;
  grid_compute_kernel<<<dim3(cols * groups, segs), kCT, smem, s>>>(
      (const bf16*)x, (const bf16*)we, (const bf16*)k, part, N, C, E, H, W, vec);
  return finish(part, out, segs * cols, E, E, s);
}

// The compute kernel's dynamic shared memory at C and how many of its blocks an SM
// holds, on the current device.
int pr_grid_compute_info(int C, int* smem, int* blocks) {
  if (C < 1 || C > kMaxCC) return (int)cudaErrorInvalidValue;
  *smem = (int)compute_smem((C + 15) / 16 * 16);
  int rc;
  if ((rc = (int)cudaFuncSetAttribute(grid_compute_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, *smem)))
    return rc;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, grid_compute_kernel, kCT,
                                                            *smem);
}

// out = the compute kernel's packed bf16 products of n pairs of bf16 pairs (for the
// bit check of tests/test_torch_cuda.py; on no probe's path).
int pr_bf16_mul(const void* a, const void* b, void* out, int n, int device, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err) return guard.err;
  bf16_mul_kernel<<<(n + kThreads - 1) / kThreads + (n == 0), kThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned*)a, (const unsigned*)b, (unsigned*)out, n);
  return (int)cudaGetLastError();
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
  if (C < 0 || C2 < 0 || H < 0 || W < 0) return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err) return guard.err;
  if (H == 0 || W == 0 || C2 == 0) return (int)cudaSuccess;  // nothing to write
  const long long blocks = (long long)H * ((W + kMixCols - 1) / kMixCols);
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)blocks;
  cudaStream_t s = (cudaStream_t)stream;
  if (W % 4 == 0 && ((uintptr_t)x | (uintptr_t)out) % 16 == 0)
    channel_mix_kernel<true><<<grid, kMixThreads, 0, s>>>(x, w, out, C, C2, H, W);
  else
    channel_mix_kernel<false><<<grid, kMixThreads, 0, s>>>(x, w, out, C, C2, H, W);
  return (int)cudaGetLastError();
}

// One launch of a one-thread kernel that does nothing: the card's least device
// time per launch, measured beside the layout kernels (on no probe's path).
int pr_empty(int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err) return guard.err;
  empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
