// Depthwise k x k convolution (k = 3, 5 or 7, stride 1 or 2, padding k / 2,
// or at stride 2 k / 2 - 1 rows and columns of zeros before the plane:
// TensorFlow's SAME of EfficientNet's stride-2 convs) of bf16 NCHW planes
// with the folded-BN bias and the activation (none, ReLU6, ReLU or Swish) in
// its epilogue: the eval-time conv + BN (+ activation) of a depthwise layer
// as one pass over the activations (K6).
//
// Replaces no Pallas kernel: the JAX package leaves every convolution to
// lax.conv_general_dilated (litepose_tpu/models/layers.py).  The port sent
// the conv to PyTorch's generic NCHW depthwise kernel
// (at::native::conv_depthwise2d_forward, which specializes 3x3 and 5x5 and
// runs 7x7 through a loop over a run-time kernel size), then added the bias
// by a broadcast and clamped, each its own pass over the activations: those
// three were the largest device ops of a served LitePose forward.
//
// Contract, with the plain twin litepose_tpu_torch.ops.depthwise.
// depthwise_conv_ref (F.conv2d, + bias.to(bf16), clamp / relu):
//   * x (B, C, H, W) bf16, w (C, 1, k, k) bf16, bias (C) fp32, contiguous;
//     out (B, C, Ho, Wo) bf16, Ho = (H - 1) / s + 1, Wo = (W - 1) / s + 1;
//     output (oy, ox)'s window starts at input (oy * s - p, ox * s - p), p
//     the pad: k / 2, or k / 2 - 1 at stride 2 (the twin pads p before and
//     k - 1 - p after, and convolves with no padding of its own);
//   * each output is the fp32 sum of its window's k*k products (cells
//     outside the plane are zero), taken row by row of the window and left
//     to right in a row, rounded to bf16 once, as F.conv2d rounds its fp32
//     accumulator; every product of two bf16 values is exact in fp32, so
//     the sum differs from F.conv2d's only by its order (on an H100 ATen's
//     order is the same, and the two agree bit for bit);
//   * then the bias rounded to bf16 (bias.to(bf16)) is added and the sum
//     rounded to bf16 again, as y + bias.to(y.dtype) does;
//   * then ReLU6 or ReLU (a NaN passes, as torch.clamp and torch.relu pass
//     it), or Swish as the layers round it, x * torch.sigmoid(x): the
//     sigmoid in fp32 rounded to bf16, the product rounded to bf16
//     (conv_common.cuh).
//
// What bounds it on an H100: at stride 1 an output costs 4 bytes (its
// input cell read, itself written) and k*k fp32 multiply-adds.  7x7 is 49
// FMAs against 4 bytes, 24.5 FLOP a byte beside the card's 20 (67 TFLOP/s
// of fp32 outside the tensor cores over 3.35 TB/s): the 34 7x7 convs of a
// LitePose-Auto-S@448 call at b64 read and write 5.63 GB (1.68 ms) and
// need 60.3 G FMAs (1.80 ms), so both the FMA pipes and the bytes must run
// near their peaks at once; 5x5 and 3x3 are bound by bytes.  ATen's kernel
// reads every input cell from global memory once a tap it serves (49 loads
// an output at 7x7, through L1), and its bias add and clamp read and write
// the output twice more.
//
// Design:
//   1. Register blocking: a thread computes 4 output rows x 8 columns.  It
//      reads each of the 3 * s + k staged input rows its rows reach once
//      (two or three shared loads, issued a row ahead), turns the cells it
//      needs into fp32 (a shift or a mask each), and applies each cell to
//      every tap of every output of its block that the row reaches: 4 * 8 *
//      49 = 1568 FMAs at 7x7 stride 1 against 10 row reads, the 49 weights
//      in registers.  The loops are unrolled at compile time (k and s are
//      template arguments), so the accumulators stay in registers.
//   2. Tiles and units: a tile is (plane, band of `groups` x 4 output rows,
//      `strips` x 8 output columns), one thread a (row group, strip); the
//      geometry follows H, W and the stride (plan() below): a band is as
//      tall as 256 threads and 54 KB of staged rows allow, split evenly
//      over the plane, and small planes (56^2, 28^2, 16^2) put several
//      tiles side by side in a CTA.  A unit is up to kRounds such sets of
//      tiles, staged together; each thread computes its tile of every set.
//   3. Persistent CTAs, two slots: at most as many CTAs as the card holds
//      at once each walk their units; unit u + 1 is staged by cp.async into
//      one slot while unit u is computed from the other, with one block
//      barrier a unit (two for bands and narrow tiles).  Staging copies only
//      cells of the plane, 16 bytes at a time (8 where W is no multiple of
//      8), whole planes or a band's rows in order; the columns beside the
//      plane and, for whole planes, the rows above and below it are zeroed
//      once when the CTA starts.  Weights stage as fp32 (rows of 8), loaded
//      into registers before a unit's multiply-adds and stored after them.
//      The pad is a template argument beside k and s: it moves the window's
//      first staged row and column, which the unrolled loops index at
//      compile time.
//   4. Epilogue in registers: the pair of sums rounded to bf16x2, the bias
//      added and rounded in bf16x2 (one rounding of the exact sum, as the
//      fp32 add then the cast: two bf16 values whose exponents lie 16 or
//      more apart sum to the larger either way), max.NaN / min.NaN for the
//      activation (Swish in fp32 a value), and one 16-byte store of 8
//      outputs (8-byte or 2-byte stores where a row is no multiple of 8 or 4
//      outputs).
// Measured (PERF.md, tools/depthwise_clock.py): at the 7x7 stride-1 shapes
// the multiply-adds alone run at 51-58% of the FMA pipes' rate, and staging
// and the unit barriers take it to 34-51%; the shared loads of the input
// rows, which at the register file's limit the compiler issues only some 50
// instructions ahead of use, are what keeps the loop from its peak (the same
// loop with the loads taken out runs at 83%).  Shapes the fast staging does
// not take (a tile narrower than its plane, W no multiple of 4, x off 8
// bytes) stage cell by cell with bounds checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

#include "conv_common.cuh"

namespace {

constexpr int kRows = 4;          // output rows a thread computes
constexpr int kCols = 8;          // output columns a thread computes: 16 bytes of bf16
constexpr int kLead = 8;          // staged cells left of a tile's first window column
constexpr int kMaxThreads = 256;
constexpr int kMaxStrips = 32;    // a tile is at most 256 output columns wide
constexpr int kMaxTiles = 64;     // tiles a unit
constexpr int kRounds = 3;        // sets of tiles a unit: a thread's tiles a unit
constexpr int kWRegs = 8;         // weights a thread loads ahead for the next unit
constexpr int kMaxBuffer = 54 * 1024;  // shared bytes of one unit: two slots, two CTAs an SM
constexpr int kMaxShared = 2 * (kMaxBuffer + 32);

// 16-byte loads a thread makes from a staged row: its windows' columns
// start kLead - p cells into the first
__host__ __device__ constexpr int row_loads(int k, int s, int p) {
  return (kLead - p + (kCols - 1) * s + k + 7) / 8;
}

// fp32 weights a tile stages: k rows of 8 (two 16-byte loads a row)
__host__ __device__ constexpr int weight_pitch(int k) { return 8 * k; }

// How a unit's input reaches shared memory:
//   kPlanes: the unit's tiles are whole planes, one after another in device
//     memory: its copies run through them in order, each row's cells only;
//   kBands: a tile is a band of rows of one plane: its rows in the plane,
//     in order, then zeros in its rows above or below the plane;
//   kCells: a tile is narrower than the plane, or W is no multiple of 4 or x
//     off 8 bytes: every staged cell by bounds-checked copies.
// kPlanes and kBands copy no cell outside the plane: the columns beside it
// are zeroed once, when the CTA starts.  Against kCells on the same
// shapes, at the depthwise convs of LitePose-Auto-S@448 b64 and
// Auto-XS@256 b128 (H100, CUDA events): kPlanes takes 9-31% off the 7x7
// convs from 128^2 at stride 2 down to 16^2 (-6 to +3% at Auto-XS's two
// 64^2 5x5 convs, 0.05 ms each), kBands 8-31% off the 5x5 and 7x7 convs at
// 224^2, 128^2 and 112^2 (1-3% at the 3x3 convs).
constexpr int kPlanes = 0, kBands = 1, kCells = 2;

struct Geometry {
  int Ho, Wo;
  int strips, groups;     // a tile: strips x kCols output columns, groups x kRows output rows
  int tiles_x, tiles_y;   // tiles a plane, across and down
  int tiles_per_round;    // tiles a CTA computes at once (one a thread)
  int tiles_per_unit;     // rounds of them staged together
  int rows_in, pitch;     // a tile's staged rows, and cells a staged row
  int tile_elems;         // rows_in * pitch
  int threads, buffer;    // a CTA, and the shared bytes of one unit (two are staged)
  int staging;            // kPlanes, kBands or kCells
  int chunk, cpr;         // cells a copy moves (8 or 4; 1 cell by cell), copies a row
  int per_tile;           // copies a tile (kPlanes: H rows; kCells: rows_in staged rows)
  int dt, dr, dc;         // a thread's stride through (tile, row, copy): blockDim.x copies
  int tiles, units;       // tiles is 0 when the launch has 2^31 or more
  Divmod by_tiles_x, by_tiles_y, by_c;
};

Geometry plan(long long planes, int C, int H, int W, int k, int s, int p, int chunk) {
  Geometry g;
  g.Ho = (H - 1) / s + 1;
  g.Wo = (W - 1) / s + 1;
  const int col_strips = (g.Wo + kCols - 1) / kCols;
  g.tiles_x = (col_strips + kMaxStrips - 1) / kMaxStrips;
  g.strips = (col_strips + g.tiles_x - 1) / g.tiles_x;
  g.staging = g.tiles_x > 1 || chunk == 1 ? kCells : kPlanes;
  if (g.staging == kCells) {
    g.pitch = 8 * ((g.strips - 1) * s + row_loads(k, s, p));
  } else {
    // the plane's cells and every column a valid output's window reaches; a
    // strip's loads past the row end feed only outputs right of the plane
    const int reach = kLead + (g.Wo - 1) * s - p + k;
    g.pitch = ((reach > kLead + W ? reach : kLead + W) + 7) / 8 * 8;
  }
  const auto tile_bytes = [&](int groups) {
    return 4 * weight_pitch(k) + 2 * ((groups * kRows - 1) * s + k) * g.pitch;
  };
  const int row_groups = (g.Ho + kRows - 1) / kRows;
  int max_groups = kMaxThreads / g.strips;
  while (max_groups > 1 && tile_bytes(max_groups) > kMaxBuffer) --max_groups;
  g.tiles_y = (row_groups + max_groups - 1) / max_groups;
  g.groups = (row_groups + g.tiles_y - 1) / g.tiles_y;
  if (g.staging == kPlanes && g.tiles_y > 1) g.staging = kBands;
  const int tile_threads = g.strips * g.groups;
  int fit = kMaxBuffer / tile_bytes(g.groups);
  if (fit > kMaxTiles) fit = kMaxTiles;
  int per_round = kMaxThreads / tile_threads;
  if (per_round > fit) per_round = fit;
  g.tiles_per_round = per_round < 1 ? 1 : per_round;
  int rounds = fit / g.tiles_per_round;
  if (rounds > kRounds) rounds = kRounds;
  g.tiles_per_unit = g.tiles_per_round * (rounds < 1 ? 1 : rounds);
  g.threads = g.tiles_per_round * tile_threads;
  g.rows_in = (g.groups * kRows - 1) * s + k;
  g.tile_elems = g.rows_in * g.pitch;
  // 32 bytes past the last row: the last strip's loads may run past it
  g.buffer = g.tiles_per_unit * tile_bytes(g.groups) + 32;
  g.chunk = chunk;
  g.cpr = g.staging == kCells ? g.pitch / chunk : W / chunk;
  g.per_tile = (g.staging == kCells ? g.rows_in : H) * g.cpr;
  // kBands walks one tile's rows at a time
  g.dt = g.staging == kBands ? 0 : g.threads / g.per_tile;
  const int rem = g.staging == kBands ? g.threads : g.threads - g.dt * g.per_tile;
  g.dr = rem / g.cpr;
  g.dc = rem - g.dr * g.cpr;
  const long long tiles = planes * g.tiles_y * g.tiles_x;
  g.tiles = tiles < 0x7fffffffLL ? static_cast<int>(tiles) : 0;
  g.units = (g.tiles + g.tiles_per_unit - 1) / g.tiles_per_unit;
  g.by_tiles_x = divmod_of(g.tiles_x);
  g.by_tiles_y = divmod_of(g.tiles_y);
  g.by_c = divmod_of(C);
  return g;
}

__device__ __forceinline__ float bf16_bits(unsigned short h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

// 16 or 8 bytes from global src into shared dst; zeros when `valid` is 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int valid) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" :: "r"(a), "l"(src),
               "r"(valid) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, int valid) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" :: "r"(a), "l"(src), "r"(valid)
               : "memory");
}

// two outputs' fp32 sums -> act(bf16(bf16(sum) + b)) as a bf16 pair (low
// half the first).  The bf16 add rounds the exact sum once, which is the
// fp32 add rounded to bf16 (see the design note); max.NaN / min.NaN keep a
// NaN, as torch.clamp and torch.relu do; Swish as silu_bf16 rounds it.
__device__ __forceinline__ uint32_t epilogue(float s0, float s1, __nv_bfloat162 b, int act) {
  __nv_bfloat162 z = __hadd2(__floats2bfloat162_rn(s0, s1), b);
  if (act == kActSilu) {
    const float2 v = __bfloat1622float2(z);
    z = __floats2bfloat162_rn(silu_bf16(v.x), silu_bf16(v.y));
  } else if (act != kActNone) {
    z = __hmax2_nan(z, __float2bfloat162_rn(0.0f));
    if (act == kActRelu6) z = __hmin2_nan(z, __float2bfloat162_rn(6.0f));
  }
  return *reinterpret_cast<const uint32_t*>(&z);
}

template <int K, int S, int P>
__global__ void __launch_bounds__(kMaxThreads, 2)
    depthwise_conv_kernel(const unsigned short* __restrict__ x,
                          const unsigned short* __restrict__ w,
                          const float* __restrict__ bias, unsigned short* __restrict__ out,
                          const Geometry g, int C, int H, int W, int act, int store_vec) {
  constexpr int KK = K * K;
  constexpr int kLoads = row_loads(K, S, P);
  constexpr int kIn = (kRows - 1) * S + K;  // staged rows a thread's row group reads
  constexpr int kWP = weight_pitch(K);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int tile_plane[2][kMaxTiles], tile_y0[2][kMaxTiles], tile_x0[2][kMaxTiles];
  __shared__ int tile_c[2][kMaxTiles];

  const int tid = threadIdx.x, T = blockDim.x;
  const auto weights_of = [&](int b) { return reinterpret_cast<float*>(smem + b * g.buffer); };
  const auto input_of = [&](int b) {
    return reinterpret_cast<unsigned short*>(smem + b * g.buffer + 4 * kWP * g.tiles_per_unit);
  };
  const auto tiles_in = [&](int u) {
    const int n = g.tiles - u * g.tiles_per_unit;
    return n < g.tiles_per_unit ? n : g.tiles_per_unit;
  };
  // where unit u's tiles lie, into slot b
  const auto locate = [&](int u, int b) {
    for (int i = tid; i < tiles_in(u); i += T) {
      const int t = u * g.tiles_per_unit + i;
      const int rows = fast_div(t, g.by_tiles_x);
      const int plane = fast_div(rows, g.by_tiles_y);
      tile_plane[b][i] = plane;
      tile_y0[b][i] = (rows - plane * g.tiles_y) * g.groups * kRows;
      tile_x0[b][i] = (t - rows * g.tiles_x) * g.strips * kCols;
      tile_c[b][i] = plane - fast_div(plane, g.by_c) * C;
    }
  };
  // this thread's first (tile, row, copy) of a unit's staging
  const int t0 = tid / g.per_tile;
  const int r0 = (tid - t0 * g.per_tile) / g.cpr;
  const int c0 = tid - t0 * g.per_tile - r0 * g.cpr;
  const int rb0 = tid / g.cpr, cb0 = tid - rb0 * g.cpr;  // kBands: within a tile's rows
  // a copy of g.chunk cells, all of them in the plane
  const auto copy = [&](unsigned short* d, const unsigned short* src) {
    if (g.chunk == 8) {
      cp_async16(d, src, 16);
    } else {
      cp_async8(d, src, 8);
    }
  };
  // unit u's input into slot b
  const auto stage = [&](int b, int u, int n) {
    unsigned short* dst = input_of(b);
    if (g.staging == kPlanes) {
      // the planes of tiles u * tiles_per_unit on are contiguous in x
      const unsigned short* src =
          x + static_cast<long long>(u * g.tiles_per_unit) * H * W + tid * g.chunk;
      int t = t0, r = r0, c = c0;
      while (t < n) {
        copy(dst + t * g.tile_elems + (r + P) * g.pitch + kLead + g.chunk * c, src);
        src += T * g.chunk;
        t += g.dt;
        r += g.dr;
        c += g.dc;
        if (c >= g.cpr) {
          c -= g.cpr;
          ++r;
        }
        if (r >= H) {
          r -= H;
          ++t;
        }
      }
    } else if (g.staging == kBands) {
      for (int t = 0; t < n; ++t) {
        const int iy0 = tile_y0[b][t] * S - P;
        const int ra = iy0 < 0 ? 0 : iy0;
        const int rb = iy0 + g.rows_in < H ? iy0 + g.rows_in : H;
        unsigned short* tile = dst + t * g.tile_elems;
        // staged rows above and below the plane
        const int above = (ra - iy0) * g.pitch / 8;
        const int below = (iy0 + g.rows_in - rb) * g.pitch / 8;
        for (int i = tid; i < above + below; i += T) {
          const int at = i < above ? i : (rb - iy0) * g.pitch / 8 + i - above;
          reinterpret_cast<uint4*>(tile)[at] = make_uint4(0, 0, 0, 0);
        }
        const unsigned short* src = x + static_cast<long long>(tile_plane[b][t]) * H * W +
                                    static_cast<long long>(ra) * W + tid * g.chunk;
        int r = rb0, c = cb0;
        while (r < rb - ra) {
          copy(tile + (ra - iy0 + r) * g.pitch + kLead + g.chunk * c, src);
          src += T * g.chunk;
          r += g.dr;
          c += g.dc;
          if (c >= g.cpr) {
            c -= g.cpr;
            ++r;
          }
        }
      }
    } else {
      int t = t0, r = r0, c = c0;
      while (t < n) {
        const int iy = tile_y0[b][t] * S - P + r;
        const int ix = tile_x0[b][t] * S - kLead + g.chunk * c;
        // ix and W are multiples of the copy: a copy lies wholly in or out of the row
        const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
        const unsigned short* src = in ? x + static_cast<long long>(tile_plane[b][t]) * H * W +
                                             static_cast<long long>(iy) * W + ix
                                       : x;
        unsigned short* d = dst + t * g.tile_elems + r * g.pitch + g.chunk * c;
        if (g.chunk == 8) {
          cp_async16(d, src, in ? 16 : 0);
        } else if (g.chunk == 4) {
          cp_async8(d, src, in ? 8 : 0);
        } else {
          *d = in ? __ldg(src) : 0;
        }
        t += g.dt;
        r += g.dr;
        c += g.dc;
        if (c >= g.cpr) {
          c -= g.cpr;
          ++r;
        }
        if (r >= g.rows_in) {
          r -= g.rows_in;
          ++t;
        }
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  // unit u's weights: loaded ahead into registers, stored as fp32 (rows of
  // 8) after the unit before it.  kPlanes: tile t of unit u is plane
  // u * tiles_per_unit + t, its channel counted on from the unit's first
  unsigned short wraw[kWRegs];
  const auto channel = [&](int b, int u, int t) {
    if (g.staging != kPlanes) return tile_c[b][t];
    const int first = u * g.tiles_per_unit;
    int c = first - fast_div(first, g.by_c) * C + t;
    while (c >= C) c -= C;
    return c;
  };
  const auto load_weights = [&](int b, int u, int n) {
#pragma unroll
    for (int j = 0; j < kWRegs; ++j) {
      const int i = tid + j * T;
      if (i < n * KK) wraw[j] = __ldg(w + channel(b, u, i / KK) * KK + i % KK);
    }
  };
  const auto store_weights = [&](int b, int u, int n) {
    float* wd = weights_of(b);
#pragma unroll
    for (int j = 0; j < kWRegs; ++j) {
      const int i = tid + j * T;
      if (i < n * KK) wd[(i / KK) * kWP + (i % KK) / K * 8 + i % K] = bf16_bits(wraw[j]);
    }
    for (int i = tid + kWRegs * T; i < n * KK; i += T)
      wd[(i / KK) * kWP + (i % KK) / K * 8 + i % K] =
          bf16_bits(__ldg(w + channel(b, u, i / KK) * KK + i % KK));
  };

  // this thread's block of outputs in each set of tiles: tile, row group, strip
  const int tile_threads = g.strips * g.groups;
  const int my_t = tid / tile_threads;
  const int grp = (tid - my_t * tile_threads) / g.strips;
  const int q = tid - my_t * tile_threads - grp * g.strips;

  // both slots zero: kPlanes and kBands never write the columns beside the
  // plane, nor kPlanes the rows above and below it
  for (int i = tid; i < 2 * g.buffer / 16; i += T)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  int u = blockIdx.x;
  locate(u, 0);
  __syncthreads();
  stage(0, u, tiles_in(u));
  load_weights(0, u, tiles_in(u));
  store_weights(0, u, tiles_in(u));
  for (int b = 0; u < g.units; u += gridDim.x, b ^= 1) {
    const int n = tiles_in(u);
    const int next = u + gridDim.x;
    const int n_next = next < g.units ? tiles_in(next) : 0;
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    // unit u's input and weights are in slot b for every thread, and every
    // thread is done with slot b ^ 1
    __syncthreads();
    if (n_next) locate(next, b ^ 1);
    if (g.staging != kPlanes) __syncthreads();  // kBands and kCells read the located tiles
    if (n_next) {
      load_weights(b ^ 1, next, n_next);
      stage(b ^ 1, next, n_next);
    }

#pragma unroll 1
    for (int t = my_t; t < n; t += g.tiles_per_round) {
      const int oy0 = tile_y0[b][t] + grp * kRows, ox0 = tile_x0[b][t] + q * kCols;
      if (oy0 >= g.Ho || ox0 >= g.Wo) continue;
      // read here, used after the multiply-adds: its latency is hidden
      const float bias_c = __ldg(bias + tile_c[b][t]);
      float wt[KK];
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
        const float4* row = reinterpret_cast<const float4*>(weights_of(b) + t * kWP + 8 * dy);
        const float4 lo = row[0], hi = row[1];
        const float w8[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int dx = 0; dx < K; ++dx) wt[dy * K + dx] = w8[dx];
      }
      const unsigned short* base =
          input_of(b) + t * g.tile_elems + grp * kRows * S * g.pitch + q * kCols * S;
      float acc[kRows][kCols];
#pragma unroll
      for (int o = 0; o < kRows; ++o)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[o][j] = 0.0f;
      // each staged row's loads are issued a row ahead of its multiply-adds
      uint4 ahead[kLoads];
#pragma unroll
      for (int j = 0; j < kLoads; ++j) ahead[j] = reinterpret_cast<const uint4*>(base)[j];
#pragma unroll
      for (int r = 0; r < kIn; ++r) {
        uint4 cur[kLoads];
#pragma unroll
        for (int j = 0; j < kLoads; ++j) cur[j] = ahead[j];
        if (r + 1 < kIn) {
#pragma unroll
          for (int j = 0; j < kLoads; ++j)
            ahead[j] = reinterpret_cast<const uint4*>(base + (r + 1) * g.pitch)[j];
        }
        float v[8 * kLoads];
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          const uint32_t words[4] = {cur[j].x, cur[j].y, cur[j].z, cur[j].w};
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            v[8 * j + 2 * h] = __uint_as_float(words[h] << 16);
            v[8 * j + 2 * h + 1] = __uint_as_float(words[h] & 0xffff0000u);
          }
        }
#pragma unroll
        for (int o = 0; o < kRows; ++o) {
          const int dy = r - o * S;
          if (dy < 0 || dy >= K) continue;
#pragma unroll
          for (int dx = 0; dx < K; ++dx)
#pragma unroll
            for (int j = 0; j < kCols; ++j)
              acc[o][j] = __fmaf_rn(v[kLead - P + j * S + dx], wt[dy * K + dx], acc[o][j]);
        }
      }
      const __nv_bfloat162 b2 = __float2bfloat162_rn(bias_c);  // bias.to(bf16)
      unsigned short* dst = out + static_cast<long long>(tile_plane[b][t]) * g.Ho * g.Wo;
      const int n_valid = g.Wo - ox0 < kCols ? g.Wo - ox0 : kCols;
#pragma unroll
      for (int o = 0; o < kRows; ++o) {
        const int oy = oy0 + o;
        if (oy >= g.Ho) break;
        uint32_t pk[kCols / 2];
#pragma unroll
        for (int j = 0; j < kCols / 2; ++j)
          pk[j] = epilogue(acc[o][2 * j], acc[o][2 * j + 1], b2, act);
        unsigned short* orow = dst + static_cast<long long>(oy) * g.Wo + ox0;
        if (store_vec == 8 && n_valid == kCols) {
          *reinterpret_cast<uint4*>(orow) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
        } else if (store_vec == 4) {  // n_valid is 4 or 8
          *reinterpret_cast<uint2*>(orow) = make_uint2(pk[0], pk[1]);
          if (n_valid == kCols) *reinterpret_cast<uint2*>(orow + 4) = make_uint2(pk[2], pk[3]);
        } else {
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            if (j < n_valid) orow[j] = static_cast<unsigned short>(pk[j / 2] >> (16 * (j % 2)));
        }
      }
    }
    if (n_next) store_weights(b ^ 1, next, n_next);
  }
}

std::mutex g_mutex;
// (device, k, s, p) -> the device's SMs, once the instance may take
// kMaxShared bytes of dynamic shared memory there
std::map<std::tuple<int, int, int, int>, int> g_sms;
// (device, k, s, p, threads, shared bytes) -> CTAs an SM
std::map<std::tuple<int, int, int, int, int, int>, int> g_per_sm;

template <int K, int S, int P>
cudaError_t launch(const Geometry& g, const void* x, const void* w, const float* bias, void* out,
                   int C, int H, int W, int act, int store_vec, cudaStream_t stream) {
  const void* kernel = reinterpret_cast<const void*>(&depthwise_conv_kernel<K, S, P>);
  const int smem = 2 * g.buffer;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int sms = 0, per_sm = 0;
  {
    std::lock_guard<std::mutex> lock(g_mutex);
    const auto inst = std::make_tuple(dev, K, S, P);
    auto it = g_sms.find(inst);
    if (it == g_sms.end()) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
      if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return e;
      it = g_sms.emplace(inst, sms).first;
    }
    sms = it->second;
    const auto key = std::make_tuple(dev, K, S, P, g.threads, smem);
    const auto found = g_per_sm.find(key);
    if (found != g_per_sm.end()) {
      per_sm = found->second;
    } else {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, g.threads, smem);
      if (e != cudaSuccess) return e;
      if (per_sm < 1) return cudaErrorInvalidConfiguration;
      g_per_sm[key] = per_sm;
    }
  }
  const long long resident = static_cast<long long>(sms) * per_sm;
  // at most as many CTAs as are resident at once: each walks its units
  const int grid = static_cast<int>(g.units < resident ? g.units : resident);
  depthwise_conv_kernel<K, S, P><<<grid, g.threads, smem, stream>>>(
      static_cast<const unsigned short*>(x), static_cast<const unsigned short*>(w), bias,
      static_cast<unsigned short*>(out), g, C, H, W, act, store_vec);
  return cudaGetLastError();
}

// the pad is k / 2, or at stride 2 one less (SAME)
bool in_scope(long long planes, int H, int W, int k, int s, int p) {
  return planes >= 1 && H >= 1 && W >= 1 && (k == 3 || k == 5 || k == 7) && (s == 1 || s == 2) &&
         (p == k / 2 || (s == 2 && p == k / 2 - 1));
}

// plan and launch on the current device
cudaError_t run(const void* x, const void* w, const float* bias, void* out, long long planes,
                int C, int H, int W, int k, int s, int p, int act, cudaStream_t st) {
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const int chunk = W % 8 == 0 && xa % 16 == 0 ? 8 : W % 4 == 0 && xa % 8 == 0 ? 4 : 1;
  const Geometry g = plan(planes, C, H, W, k, s, p, chunk);
  if (g.tiles == 0) return cudaErrorInvalidValue;
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  const int store_vec = g.Wo % 8 == 0 && o % 16 == 0 ? 8 : g.Wo % 4 == 0 && o % 8 == 0 ? 4 : 1;
  const bool same = p != k / 2;
  switch (10 * k + s) {
    case 31: return launch<3, 1, 1>(g, x, w, bias, out, C, H, W, act, store_vec, st);
    case 32:
      return same ? launch<3, 2, 0>(g, x, w, bias, out, C, H, W, act, store_vec, st)
                  : launch<3, 2, 1>(g, x, w, bias, out, C, H, W, act, store_vec, st);
    case 51: return launch<5, 1, 2>(g, x, w, bias, out, C, H, W, act, store_vec, st);
    case 52:
      return same ? launch<5, 2, 1>(g, x, w, bias, out, C, H, W, act, store_vec, st)
                  : launch<5, 2, 2>(g, x, w, bias, out, C, H, W, act, store_vec, st);
    case 71: return launch<7, 1, 3>(g, x, w, bias, out, C, H, W, act, store_vec, st);
    default:
      return same ? launch<7, 2, 2>(g, x, w, bias, out, C, H, W, act, store_vec, st)
                  : launch<7, 2, 3>(g, x, w, bias, out, C, H, W, act, store_vec, st);
  }
}

}  // namespace

// x (B, C, H, W) bf16, w (C, 1, k, k) bf16, bias (C) fp32, out (B, C, Ho, Wo)
// bf16; p the pad before the plane (k / 2, or k / 2 - 1 at stride 2); act 0
// none, 1 ReLU6, 2 ReLU, 3 Swish.  Returns a CUDA error code.
extern "C" int lp_depthwise_conv(const void* x, const void* w, const float* bias, void* out,
                                 int B, int C, int H, int W, int k, int s, int p, int act,
                                 void* stream) {
  const long long planes = static_cast<long long>(B) * C;
  if (!in_scope(planes, H, W, k, s, p) || act < kActNone || act > kActSilu)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(run(x, w, bias, out, planes, C, H, W, k, s, p, act,
                              static_cast<cudaStream_t>(stream)));
}
