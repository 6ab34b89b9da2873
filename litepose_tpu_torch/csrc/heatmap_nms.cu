// kxk (any odd k up to 15) maxpool-equality NMS of heatmap planes, the
// suppressed map written out (K5).
//
// Replaces the Pallas TPU kernel `_nms_kernel`
// (litepose_tpu/ops/pallas_nms.py:27, reached through `heatmap_nms_pallas`),
// which the JAX per-image decode `top_k_peaks` runs
// (litepose_tpu/ops/nms.py:88-98).  Contract, bit for bit with the plain
// twin `litepose_tpu_torch.ops.nms.nms_suppress_ref`:
//   * det (planes, H, W) fp32 or bf16, contiguous; out the same shape and
//     dtype;
//   * each value is upcast to fp32; its window is the k x k max at stride
//     1, cells outside the plane counting as -inf (the TPU kernel pads with
//     -3e38, which differs only on planes holding values at or below it);
//   * a cell keeps its value, bit for bit (-0.0 included), when it equals
//     its window max, and becomes +0 otherwise;
//   * a NaN spreads through the window max (csrc/nms_common.cuh), so it
//     and every cell within r of it become +0.
// A max and an equality test of bf16 values are exact in bf16 (the upcast
// changes no order and no equality), so the ring instance compares bf16
// pairs as bf16x2 and keeps the cell's own bits on a match.
//
// What bounds it on an H100: bytes, each plane read once and written once
// (serving (64,14,224,224) bf16: 179.8 MB, 0.0537 ms at 3.35 TB/s; eval
// (32,14,448,448) fp32: 719.4 MB, 0.2147 ms).  The separable max is 4r
// compares a cell, far below the fp32 rate.  The first design (the tiled
// instance below) reached 35% of that bound at bf16: it staged bf16 as
// fp32, passed every cell through shared memory about 13 times (a column
// max into a second array, then a row max), spent about 35 instructions a
// cell with an integer division and modulo, and overlapped a tile's load
// with nothing but the other resident CTAs, 6 at most an SM.  Measured
// (PERF.md), this design runs within 3% of the same launch with the window
// max taken out (a build that only moves the bytes): what is left between
// it and the bound is the rate at which the card streams bulk loads in and
// 16-byte stores out, 80-83% of its peak (PyTorch's copy of the same
// bytes: 86-90%).
//
// Design, the ring instance (rows a whole number of 16-byte chunks, the
// base and the output 16-byte aligned, at most ring_threads(R) chunks a
// row):
//   1. Work: the planes are one run of planes * H rows; each CTA writes a
//      contiguous share of them (rows_per_cta, at least kMinRows), so the
//      grid is one wave of resident CTAs (the occupancy calculator's count
//      on every SM) and every CTA has the same rows +- 1.  A CTA's rows may
//      cross plane boundaries: after a plane's last row r rows of -inf go
//      through the vertical window, which finishes that plane and starts
//      the next one with -inf above it.  A CTA stages its rows and the r
//      rows either side of them that lie in the same plane, so a row is
//      read from HBM once and only the ends of a CTA's share read a halo
//      again (2r rows beside a share of 48 rows at serving, 191 at eval).
//   2. Asynchronous copies into a ring: rows of a plane, and the planes,
//      are contiguous, so a stage of stage_rows rows is one cp.async.bulk
//      into one of kStages slots of dynamic shared memory, completed on
//      the slot's mbarrier; the next stage lands while this one is
//      computed, and a slot is refilled after the block barrier that ends
//      its stage.  A stage is as many rows as the CTA's share of the SM's
//      shared memory holds at the occupancy its registers allow (32 CTAs
//      of one warp at serving, 8 of four warps at eval), so the ring costs
//      no CTA; two large stages beat three or four smaller ones on the
//      card, and a block barrier beat a count of the warps done with a
//      slot.  bf16 stays bf16 in the ring.
//   3. The separable max in registers: thread c owns the 16-byte chunk c
//      of every row (4 fp32 or 8 bf16 cells).  For each staged row it
//      reads its chunk and ceil(r / cells a chunk) chunks either side from
//      the ring (one 16-byte load each; -inf beyond the row's ends), takes
//      the horizontal window max of its cells in registers (bf16: pairs
//      shifted by one cell with __byte_perm, then max.NaN.bf16x2, the
//      instruction of __hmax2_nan), and pushes it into a window of the last
//      2r + 1 rows' maxima held in registers with the last r + 1 rows' own
//      cells.  The vertical max of that window is the max of row y - r's
//      windows; the equality test (set.eq.u32.bf16x2, __heq2_mask's
//      instruction, or an fp32 ==) keeps the cell's bits.  No second shared
//      array, no division in the loop.
//   4. The kept chunk goes out as one 16-byte evict-first store: a warp
//      writes 512 consecutive bytes of a row.
// Shapes the ring does not take (a row that is no 16-byte multiple, a base
// off 16 bytes, a row wider than the ring instance's threads) run the tiled
// instance: one CTA per (32 x 128 tile, plane), the tile and its halo
// staged in shared memory as fp32, a column-max then a row-max pass.
// lp_heatmap_nms_plan says which instance a launch takes and its geometry.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

#include "nms_common.cuh"

namespace {

constexpr int kMaxR = 7;  // k = 15; MAX_NMS_RADIUS in ops/library.py

// -- the tiled instance --------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kTileH = 32;   // rows a CTA writes
constexpr int kTileW = 128;  // columns a CTA writes

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// v came from an element of this type, so the conversion is exact
__device__ __forceinline__ void store(float* o, float v) { *o = v; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float v) {
  *reinterpret_cast<unsigned short*>(o) = static_cast<unsigned short>(__float_as_uint(v) >> 16);
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
    heatmap_nms_kernel(const T* __restrict__ det, T* __restrict__ out, int H, int W,
                       int tiles_x, int tiles, int vec) {
  constexpr int kLead = (R + 3) & ~3;           // staged columns before the tile's first
  constexpr int kPitch = kLead + kTileW + kLead;  // a staged row, in floats (16-byte multiple)
  constexpr int kRows = kTileH + 2 * R;         // staged rows
  constexpr int kCols = kTileW + 2 * R;         // staged columns a window reaches
  // staged row i is plane row y0 - R + i; staged column kLead + j is plane
  // column x0 + j
  __shared__ __align__(16) float raw[kRows * kPitch];
  __shared__ float colmax[kTileH * kPitch];

  const int plane = blockIdx.x / tiles;
  const int tile = blockIdx.x - plane * tiles;
  const int ty = tile / tiles_x;
  const int y0 = ty * kTileH, x0 = (tile - ty * tiles_x) * kTileW;
  const size_t base = static_cast<size_t>(plane) * H * W;
  const T* x = det + base;
  T* o = out + base;
  const int tid = threadIdx.x;

  // 1. the tile's columns; with vec every plane row starts 16-byte aligned
  // and W is a multiple of the vector, so a vector lies wholly inside or
  // wholly outside the plane
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    constexpr int kRowVecs = kTileW / V;
    constexpr int kVecs = kRows * kRowVecs;
    constexpr int kIters = (kVecs + kThreads - 1) / kThreads;
    uint4 u[kIters];
    bool in[kIters];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int v = tid + it * kThreads;
      const int i = v / kRowVecs, j = (v - i * kRowVecs) * V;
      const int yy = y0 - R + i, xx = x0 + j;
      in[it] = v < kVecs && yy >= 0 && yy < H && xx < W;
      u[it] = in[it] ? __ldg(reinterpret_cast<const uint4*>(x + static_cast<size_t>(yy) * W + xx))
                     : make_uint4(0u, 0u, 0u, 0u);
    }
    const float4 neg = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int v = tid + it * kThreads;
      if (v < kVecs) {
        const int i = v / kRowVecs, j = (v - i * kRowVecs) * V;
        float4* d = reinterpret_cast<float4*>(raw + i * kPitch + kLead + j);
        const uint4 w = u[it];
        if constexpr (sizeof(T) == 4) {
          d[0] = in[it] ? make_float4(__uint_as_float(w.x), __uint_as_float(w.y),
                                      __uint_as_float(w.z), __uint_as_float(w.w))
                        : neg;
        } else {  // bf16 pairs, low half first: the upper 16 bits of an fp32
          d[0] = in[it] ? make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xFFFF0000u),
                                      __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xFFFF0000u))
                        : neg;
          d[1] = in[it] ? make_float4(__uint_as_float(w.z << 16), __uint_as_float(w.z & 0xFFFF0000u),
                                      __uint_as_float(w.w << 16), __uint_as_float(w.w & 0xFFFF0000u))
                        : neg;
        }
      }
    }
  } else {
    for (int v = tid; v < kRows * kTileW; v += kThreads) {
      const int i = v / kTileW, j = v % kTileW;
      const int yy = y0 - R + i, xx = x0 + j;
      raw[i * kPitch + kLead + j] =
          yy >= 0 && yy < H && xx < W ? to_f32(x[static_cast<size_t>(yy) * W + xx]) : -INFINITY;
    }
  }
  // the halo columns, R either side
  if constexpr (R > 0) {
    for (int v = tid; v < kRows * 2 * R; v += kThreads) {
      const int i = v / (2 * R), e = v - i * (2 * R);
      const int j = e < R ? e - R : kTileW + e - R;
      const int yy = y0 - R + i, xx = x0 + j;
      raw[i * kPitch + kLead + j] = yy >= 0 && yy < H && xx >= 0 && xx < W
                                        ? to_f32(x[static_cast<size_t>(yy) * W + xx])
                                        : -INFINITY;
    }
  }
  __syncthreads();

  // 2. the column max over staged rows i .. i + 2R
  for (int v = tid; v < kTileH * kCols; v += kThreads) {
    const int i = v / kCols, c = kLead - R + (v - i * kCols);
    const float* p = raw + i * kPitch + c;
    float m = p[0];
#pragma unroll
    for (int d = 1; d <= 2 * R; ++d) m = max_nan(m, p[d * kPitch]);
    colmax[i * kPitch + c] = m;
  }
  __syncthreads();

  // 3. the row max, the equality test and the store
  for (int v = tid; v < kTileH * kTileW; v += kThreads) {
    const int i = v / kTileW, j = v % kTileW;
    const int yy = y0 + i, xx = x0 + j;
    if (yy < H && xx < W) {
      const float* p = colmax + i * kPitch + kLead + j - R;
      float m = p[0];
#pragma unroll
      for (int e = 1; e <= 2 * R; ++e) m = max_nan(m, p[e]);
      const float xv = raw[(i + R) * kPitch + kLead + j];
      store(o + static_cast<size_t>(yy) * W + xx, m == xv ? xv : 0.0f);
    }
  }
}


// -- the ring instance ---------------------------------------------------------

constexpr int kStages = 2;             // ring slots: one computed, one landing
constexpr int kMaxStageBytes = 16384;  // a stage's rows, at most (one row at least)
constexpr int kMinRows = 8;           // rows a CTA writes, at least (small launches)

// threads a CTA (one a 16-byte chunk of a row): the widest row the ring
// instance takes; the register window of r > 3 needs more than 128 a thread
__host__ __device__ constexpr int ring_threads(int r) { return r <= 3 ? 512 : 256; }

template <typename T>
struct Cells;

template <>
struct Cells<float> {
  static constexpr int kPerChunk = 4;
  static constexpr uint32_t kNegInf = 0xFF800000u;  // a word of -inf
  static __device__ __forceinline__ uint32_t max2(uint32_t a, uint32_t b) {
    return __float_as_uint(max_nan(__uint_as_float(a), __uint_as_float(b)));
  }
  // x when it equals its window max m, else +0
  static __device__ __forceinline__ uint32_t keep(uint32_t m, uint32_t x) {
    return __uint_as_float(m) == __uint_as_float(x) ? x : 0u;
  }
};

template <>
struct Cells<__nv_bfloat16> {
  static constexpr int kPerChunk = 8;
  static constexpr uint32_t kNegInf = 0xFF80FF80u;  // a pair of -inf
  // __hmax2_nan's instruction: a NaN in either half gives NaN
  static __device__ __forceinline__ uint32_t max2(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  // __heq2_mask's instruction: 0xFFFF for each equal half (NaN never, -0.0
  // equal to +0.0)
  static __device__ __forceinline__ uint32_t keep(uint32_t m, uint32_t x) {
    uint32_t eq;
    asm("set.eq.u32.bf16x2 %0, %1, %2;" : "=r"(eq) : "r"(m), "r"(x));
    return eq & x;
  }
};

// chunks read either side of a thread's own for the horizontal window
template <typename T, int R>
__host__ __device__ constexpr int side_chunks() {
  return (R + Cells<T>::kPerChunk - 1) / Cells<T>::kPerChunk;
}

__device__ __forceinline__ void unpack(const uint4& v, uint32_t* w) {
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

// h: the horizontal window max of the 4 words of the thread's own chunk;
// w: the words of side_chunks chunks left of it, its own, and as many right
template <typename T, int R>
__device__ __forceinline__ void row_max(const uint32_t* w, uint32_t* h) {
  constexpr int kOwn = 4 * side_chunks<T, R>();  // the own chunk's first word
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t m = w[kOwn + j];
#pragma unroll
      for (int d = 1; d <= R; ++d)
        m = Cells<T>::max2(Cells<T>::max2(m, w[kOwn + j - d]), w[kOwn + j + d]);
      h[j] = m;
    }
  } else {
    // word i holds cells 2i (low half) and 2i + 1; q[i] cells 2i + 1 and 2i + 2
    constexpr int kWords = 2 * kOwn + 4;
    uint32_t q[kWords - 1];
#pragma unroll
    for (int i = 0; i + 1 < kWords; ++i) q[i] = __byte_perm(w[i], w[i + 1], 0x5432);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = kOwn + k;
      uint32_t m = w[i];
      // the pair shifted by +-s cells: a word for even s, a q for odd s
#pragma unroll
      for (int s = 1; s <= R; ++s) {
        m = Cells<T>::max2(m, s & 1 ? q[i + (s - 1) / 2] : w[i + s / 2]);
        m = Cells<T>::max2(m, s & 1 ? q[i - (s + 1) / 2] : w[i - s / 2]);
      }
      h[k] = m;
    }
  }
}

// The vertical window of one thread's chunk, in registers, oldest first.
template <typename T, int R>
struct Window {
  uint32_t h[2 * R + 1][4];  // the last 2R + 1 rows' horizontal maxima
  uint32_t x[R + 1][4];      // the last R + 1 rows' own cells

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i <= 2 * R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) h[i][j] = Cells<T>::kNegInf;
  }

  __device__ __forceinline__ void push(const uint32_t* hrow, const uint32_t* xrow) {
#pragma unroll
    for (int i = 0; i < 2 * R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) h[i][j] = h[i + 1][j];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) x[i][j] = x[i + 1][j];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      h[2 * R][j] = hrow[j];
      x[R][j] = xrow[j];
    }
  }

  // the middle row's cells, each kept where it equals its window max
  __device__ __forceinline__ uint4 kept() const {
    uint32_t o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t m = h[0][j];
#pragma unroll
      for (int i = 1; i <= 2 * R; ++i) m = Cells<T>::max2(m, h[i][j]);
      o[j] = Cells<T>::keep(m, x[0][j]);
    }
    return make_uint4(o[0], o[1], o[2], o[3]);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// bytes (a multiple of 16, both ends 16-byte aligned) from global src into
// shared dst, counted on the mbarrier bar (whose one arrival this is)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// det, out: (planes, H, W) seen as rows * chunks 16-byte chunks; CTA b
// writes rows [b * rows_per_cta, (b + 1) * rows_per_cta) of the rows.
template <typename T, int R>
__global__ void __launch_bounds__(ring_threads(R))
    heatmap_nms_ring_kernel(const T* __restrict__ det, T* __restrict__ out, int H, int chunks,
                            long long rows, int rows_per_cta, int stage_rows) {
  constexpr int kSide = side_chunks<T, R>();
  extern __shared__ __align__(128) uint4 ring[];
  __shared__ __align__(8) unsigned long long full[kStages];  // a slot's copy has landed

  // this CTA's rows [g0, g1), and the rows it stages, [a, b): r more either
  // side within the same plane
  const long long g0 = static_cast<long long>(blockIdx.x) * rows_per_cta;
  const long long g1 = min(rows, g0 + rows_per_cta);
  const long long a = max(g0 - g0 % H, g0 - R);
  const long long b = min(g1 - 1 - (g1 - 1) % H + H, g1 + R);
  const int n = static_cast<int>(b - a);
  const int stages = (n + stage_rows - 1) / stage_rows;
  const int slot = stage_rows * chunks;  // chunks a slot
  const uint4* src = reinterpret_cast<const uint4*>(det) + a * chunks;
  uint4* dst = reinterpret_cast<uint4*>(out) + a * chunks;
  // the rows it writes, counted from a
  const int w0 = static_cast<int>(g0 - a), w1 = static_cast<int>(g1 - a);

  auto stage_in = [&](int j) {  // stage j into slot j % kStages, by thread 0
    const int r0 = j * stage_rows;
    const uint32_t bytes = static_cast<uint32_t>(min(stage_rows, n - r0)) * chunks * 16u;
    bulk_load(ring + (j % kStages) * slot, src + static_cast<size_t>(r0) * chunks, bytes,
              &full[j % kStages]);
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(&full[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int j = 0; j < min(kStages, stages); ++j) stage_in(j);

  const int c = threadIdx.x;
  const bool mine = c < chunks;
  const uint4 neg = make_uint4(Cells<T>::kNegInf, Cells<T>::kNegInf, Cells<T>::kNegInf,
                               Cells<T>::kNegInf);
  const uint32_t negw[4] = {Cells<T>::kNegInf, Cells<T>::kNegInf, Cells<T>::kNegInf,
                            Cells<T>::kNegInf};
  Window<T, R> win;
  win.clear();
  int yl = static_cast<int>(a % H);  // the plane row of staged row i
  const uint4* row = ring;
  int j = 0, k = 0;  // the stage of row i, and i's row within it
  bar_wait(&full[0], 0);
  for (int i = 0; i < n; ++i) {
    if (k == stage_rows) {
      __syncthreads();  // every thread is done with slot j % kStages
      if (threadIdx.x == 0 && j + kStages < stages) stage_in(j + kStages);
      ++j;
      k = 0;
      row = ring + (j % kStages) * slot;
      bar_wait(&full[j % kStages], (j / kStages) & 1);
    }
    if (mine) {
      uint32_t w[4 * (2 * kSide + 1)];
      unpack(row[c], w + 4 * kSide);
#pragma unroll
      for (int s = 1; s <= kSide; ++s) {
        const uint4 lv = row[max(c - s, 0)];
        const uint4 rv = row[min(c + s, chunks - 1)];
        unpack(c - s >= 0 ? lv : neg, w + 4 * (kSide - s));
        unpack(c + s < chunks ? rv : neg, w + 4 * (kSide + s));
      }
      uint32_t h[4];
      row_max<T, R>(w, h);
      win.push(h, w + 4 * kSide);
      // row i - R's cells are final: write them if they are this CTA's
      // and in row i's plane; after a plane's last row, R rows of -inf
      // finish its last R rows and are the -inf above the next plane
      const int top = i - yl;
      const int flush = yl == H - 1 ? R : 0;
#pragma unroll
      for (int f = 0; f <= R; ++f) {
        if (f > 0) {
          if (f > flush) break;
          win.push(negw, negw);
        }
        const int o = i - R + f;
        if (o >= w0 && o < w1 && o >= top) {
          const uint4 v = win.kept();
          // evict-first: the map is not read again while the launch runs
          __stcs(dst + static_cast<size_t>(o) * chunks + c, v);
        }
      }
    }
    row += chunks;
    ++k;
    if (++yl == H) yl = 0;
  }
}

// -- plans and launches --------------------------------------------------------

struct Plan {
  int instance;      // 1 ring, 2 tiled
  int threads;       // a CTA
  size_t smem;       // dynamic shared memory bytes a CTA
  int stage_rows;    // ring: rows a stage
  int ctas_per_sm;   // ring: the occupancy calculator's CTAs an SM
  long long grid;    // CTAs
  int rows_per_cta;  // ring: rows a CTA writes
  int budget;        // ring: the ring bytes a CTA may take
  int vec;           // tiled: 16-byte loads of the tile's columns
};

struct RingDevice {
  int sms;     // SMs
  int ctas;    // CTAs an SM holds by their threads and registers alone
  int budget;  // shared memory bytes a CTA may stage with that many an SM
};

std::mutex g_ring_mutex;
// (device, is_bf16, r, threads) -> what the ring plan needs of the card
std::map<std::tuple<int, int, int, int>, RingDevice> g_ring_devices;

// The current device's SMs, how many ring CTAs of this many threads an SM
// holds by registers and threads, and the shared memory that leaves each
// (the SM's, less the per-CTA reserve and static arrays); the kernel's
// carveout set to all shared memory first.  Cached per device and shape.
template <typename T, int R>
cudaError_t ring_device(int threads, RingDevice* d) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const auto key = std::make_tuple(dev, static_cast<int>(sizeof(T) == 2), R, threads);
  std::lock_guard<std::mutex> lock(g_ring_mutex);
  const auto it = g_ring_devices.find(key);
  if (it != g_ring_devices.end()) {
    *d = it->second;
    return cudaSuccess;
  }
  auto kernel = heatmap_nms_ring_kernel<T, R>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  int per_sm = 0, reserved = 0;
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&d->sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&d->ctas, kernel, threads, 0);
  if (e != cudaSuccess) return e;
  if (d->ctas < 1) return cudaErrorInvalidConfiguration;
  d->budget = per_sm / d->ctas - reserved - static_cast<int>(attr.sharedSizeBytes);
  g_ring_devices.emplace(key, *d);
  return cudaSuccess;
}

// The launch for det and out (the ring instance needs both 16-byte
// aligned).  The ring: as many CTAs an SM as registers allow, each with a
// ring of kStages stages of as many whole rows as its share of the SM's
// shared memory holds (kMaxStageBytes at most, one row at least), the rows
// shared out evenly over one wave of them.
template <typename T, int R>
cudaError_t plan_r(const void* det, const void* out, int planes, int H, int W, Plan* p) {
  const long long row_bytes = static_cast<long long>(W) * sizeof(T);
  const long long chunks = row_bytes / 16;
  if ((reinterpret_cast<uintptr_t>(det) | reinterpret_cast<uintptr_t>(out)) % 16 == 0 &&
      row_bytes % 16 == 0 && chunks <= ring_threads(R)) {
    p->instance = 1;
    p->threads = static_cast<int>((chunks + 31) / 32 * 32);
    p->vec = 0;
    RingDevice d;
    cudaError_t e = ring_device<T, R>(p->threads, &d);
    if (e != cudaSuccess) return e;
    const long long fit = std::min<long long>(d.budget / kStages, kMaxStageBytes) / row_bytes;
    p->stage_rows = static_cast<int>(std::max(1LL, fit));
    p->smem = static_cast<size_t>(kStages) * p->stage_rows * row_bytes;
    p->budget = d.budget;
    auto kernel = heatmap_nms_ring_kernel<T, R>;
    if (p->smem > 48 * 1024)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(p->smem));
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p->ctas_per_sm, kernel, p->threads,
                                                        p->smem);
    if (e != cudaSuccess) return e;
    if (p->ctas_per_sm < 1) return cudaErrorInvalidConfiguration;
    const long long rows = static_cast<long long>(planes) * H;
    const long long resident = static_cast<long long>(d.sms) * p->ctas_per_sm;
    const long long per = std::max<long long>(kMinRows, (rows + resident - 1) / resident);
    if (per > INT_MAX - 2 * kMaxR) return cudaErrorInvalidValue;
    p->rows_per_cta = static_cast<int>(per);
    p->grid = (rows + per - 1) / per;
    return cudaSuccess;
  }
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const long long tiles = static_cast<long long>((H + kTileH - 1) / kTileH) * tiles_x;
  p->instance = 2;
  p->threads = kThreads;
  p->smem = 0;
  p->stage_rows = p->ctas_per_sm = p->rows_per_cta = p->budget = 0;
  p->grid = tiles * planes;
  p->vec = reinterpret_cast<uintptr_t>(det) % 16 == 0 && (W * sizeof(T)) % 16 == 0;
  return p->grid > INT_MAX ? cudaErrorInvalidValue : cudaSuccess;
}

template <typename T, int R>
cudaError_t launch_r(const void* det, void* out, int planes, int H, int W, cudaStream_t stream) {
  Plan p;
  const cudaError_t e = plan_r<T, R>(det, out, planes, H, W, &p);
  if (e != cudaSuccess) return e;
  if (p.instance == 1) {
    heatmap_nms_ring_kernel<T, R><<<static_cast<unsigned>(p.grid), p.threads, p.smem, stream>>>(
        static_cast<const T*>(det), static_cast<T*>(out), H,
        static_cast<int>(static_cast<long long>(W) * sizeof(T) / 16),
        static_cast<long long>(planes) * H, p.rows_per_cta, p.stage_rows);
  } else {
    const int tiles_x = (W + kTileW - 1) / kTileW;
    heatmap_nms_kernel<T, R><<<static_cast<unsigned>(p.grid), kThreads, 0, stream>>>(
        static_cast<const T*>(det), static_cast<T*>(out), H, W, tiles_x,
        static_cast<int>(p.grid / planes), p.vec);
  }
  return cudaGetLastError();
}

// the radius as a template argument, so each window unrolls
template <typename T, template <typename, int> class F, typename... A>
cudaError_t by_radius(int r, A... args) {
  static_assert(kMaxR == 7, "one case a radius below");
  switch (r) {
    case 0: return F<T, 0>::run(args...);
    case 1: return F<T, 1>::run(args...);
    case 2: return F<T, 2>::run(args...);
    case 3: return F<T, 3>::run(args...);
    case 4: return F<T, 4>::run(args...);
    case 5: return F<T, 5>::run(args...);
    case 6: return F<T, 6>::run(args...);
    case 7: return F<T, 7>::run(args...);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int R>
struct Launch {
  static cudaError_t run(const void* det, void* out, int planes, int H, int W,
                         cudaStream_t stream) {
    return launch_r<T, R>(det, out, planes, H, W, stream);
  }
};

template <typename T, int R>
struct Planner {
  static cudaError_t run(const void* det, int planes, int H, int W, Plan* p) {
    return plan_r<T, R>(det, det, planes, H, W, p);
  }
};

}  // namespace

// det, out: (planes, H, W) fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1),
// contiguous, not overlapping; r = k // 2 in [0, 7].  One launch of the
// instance lp_heatmap_nms_plan names; returns cudaErrorInvalidValue for a
// shape the kernel does not take, else the launch's CUDA error (0 =
// success).
extern "C" int lp_heatmap_nms(const void* det, int is_bf16, void* out, int planes, int H,
                              int W, int r, void* stream) {
  if (planes < 1 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? by_radius<__nv_bfloat16, Launch>(r, det, out, planes, H, W, st)
              : by_radius<float, Launch>(r, det, out, planes, H, W, st));
}

// The launch lp_heatmap_nms makes for these arguments and an output as
// aligned as the allocator's, on the current device: info[0] the instance
// (1 ring, 2 tiled), [1] threads a CTA, [2] dynamic shared memory bytes a
// CTA, [3] rows a stage (ring), [4] stages (ring), [5] CTAs an SM (ring:
// the occupancy calculator's), [6] the grid, [7] rows a CTA writes (ring),
// [8] the shared memory bytes a ring CTA may stage at the occupancy its
// registers allow.  Returns a CUDA error code (0 = success).
extern "C" int lp_heatmap_nms_plan(const void* det, int is_bf16, int planes, int H, int W,
                                   int r, int* info) {
  if (planes < 1 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const cudaError_t e = is_bf16 ? by_radius<__nv_bfloat16, Planner>(r, det, planes, H, W, &p)
                                : by_radius<float, Planner>(r, det, planes, H, W, &p);
  if (e != cudaSuccess) return static_cast<int>(e);
  info[0] = p.instance;
  info[1] = p.threads;
  info[2] = static_cast<int>(p.smem);
  info[3] = p.stage_rows;
  info[4] = p.instance == 1 ? kStages : 0;
  info[5] = p.ctas_per_sm;
  info[6] = static_cast<int>(p.grid);
  info[7] = p.rows_per_cta;
  info[8] = p.budget;
  return 0;
}
