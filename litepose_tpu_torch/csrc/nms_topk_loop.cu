// kxk (any odd k) maxpool-equality NMS + exact top-M peak extraction,
// plane by plane by a serial chain over the plane's row keys (K1').
//
// Replaces the Pallas TPU kernel `_nms_topk_kernel`
// (litepose_tpu/ops/pallas_topk.py:111, reached through
// `nms_topk_pallas(..., _gather="sum" | "dot")`), the per-plane loop that
// the JAX package keeps as the baseline of K1's time; no config selects it.
// Its contract is K1's (csrc/nms_topk.cu), bit for bit with the plain twin
// `litepose_tpu_torch.ops.topk.nms_topk_ref`:
//   * NMS: a pixel keeps its value when it equals the max of its k x k
//     window (out-of-plane cells count as -inf), otherwise it becomes +0;
//     a NaN spreads through the window max (csrc/nms_common.cuh); bf16
//     input is upcast to fp32 before any compare;
//   * top-M of the suppressed plane, values descending (-0.0 equal to
//     +0.0 and returned bit for bit), ties to the lowest flat row-major
//     index; a plane with fewer than M peaks yields its zeros in flat
//     order, then its negatives.
// "dot" selected the TPU's row by an MXU product, whose bf16-split passes
// are not exact; the card has no such pass to keep, so both variants run
// this kernel.
//
// The algorithm stays the TPU kernel's: each row of a plane has a key (its
// best remaining cell's value); each of M rounds takes the largest row key
// (lower row first on ties), takes that row's best remaining cell as slot i
// and gives the row its next key.  It is not K1's band-and-merge selection.
//
// What bounds it on an H100: the read of the planes, once (as K1: serving
// b64 at 224^2 bf16, 89.9 MB, 0.027 ms at 3.35 TB/s; eval b32 at 448^2
// fp32, 359.7 MB, 0.107 ms).  Measured, the SMs' issue slots bound pass 1
// (about 108 instructions a warp per 64 cells: the window's loads and
// maxima, the shuffles, each cell's key and its insertion into the lane's
// list), and the M rounds of a plane are a dependent chain of one to two
// thousand cycles each on an SM busy with other planes' pass 1; with eight
// warps a CTA and 64 registers a thread four CTAs share an SM (PERF.md).
//
// Design (the costs of the earlier kernel, which kept only the row keys and
// recomputed a row from L2 each round, and what this one does about each):
//   1. Block barriers on the chain (5 a round): the rounds run in ONE warp
//      with no block barrier.  A row's key is its cache head's 32-bit
//      orderable value word; lane l keeps rows l, l + 32, ... (in registers
//      up to 512 rows); a round's argmax is two 32-bit warp reductions,
//      __reduce_max_sync on the value word, then __reduce_min_sync on the
//      row among the lanes holding it (the two-reduction argmin of K2 and
//      K3, group_common.cuh:first_min).  Only the lane owning the popped row
//      looks at its rows again.
//   2. A row recomputed from L2 every round: pass 1 leaves each row its
//      kFirst (2) largest cell keys in shared memory, in key order.  The
//      keys are a total order and a row's cells are taken in that order, so
//      popping the cache's head is exactly what a recompute would pick.  A
//      row is recomputed only when every key of its last fill was taken:
//      its 2r + 1 rows come into the ring (free once pass 1 is done) by the
//      chain warp's cp.async, and it refills with its next kCache (4) keys
//      below the one just taken.
//   3. Each input row read 2r + 1 times from global memory by scalar loads:
//      the staged instance streams the plane through a ring of 2C + 2r rows
//      in shared memory with 16-byte cp.async loads (C = the rows the CTA's
//      warps suppress between two barriers), the next chunk in flight while
//      the current one is suppressed, so each input byte crosses from HBM
//      once.  A warp suppresses a row in tiles of 64 columns, two adjacent
//      columns a lane: one 4-byte (bf16) or 8-byte (fp32) shared load a
//      window row, the vertical maxima of three tiles in registers, the
//      horizontal max by shuffles from the lanes ceil(r / 2) either side,
//      each from the tile the source lane picks; no row buffer is written.
//      The ring's rows are padded with -inf to a multiple of 64 columns, so
//      the tile loop tests no bound.
//   4. The O(i) "taken" scan at round i: gone.  The cells a row has given
//      are exactly its keys above its last popped one (a refill selects
//      below it), so nothing records positions.  A row's best keys come
//      from each lane's sorted list of its own best cells (registers),
//      merged by N rounds of the two reductions: no scan of the row.
// Chains in flight: a CTA is one plane (8 warps for pass 1, then warp 0 for
// the chain), four CTAs an SM; a plane's chain overlaps the other CTAs'
// pass 1, and its seven other warps wait for it to end.
//
// Cell key (K1's, with the column for the flat index):
//   orderable value (-0.0 as +0.0) << 32 | (0x7FFFFFFF - column) << 1 | negzero
// 0 is below every key (an empty cache slot); a row key of 0 is a row with
// no cell left.
//
// Instances, chosen by shape on the host (lp_nms_topk_loop_plan):
//   * staged (r <= kMaxShuffleR; kCache slots a row, 8 warps, the ring, the
//     shuffle horizontal max): shared memory (2C + 2r) ring_pitch(W)
//     sizeof(T) for the ring and 8 kCache H + 6 H for the rows, with C = 16
//     when that is at most kFastBytes, else C = 8, up to the 227 KB a CTA
//     may have.  It takes the 224^2, 448^2 and 512x704 planes, and at k = 5
//     fp32 planes up to about 2900 columns, bf16 up to about 5800.
//   * lean (one key a row, so every pop recomputes its row from global
//     memory; one warp; no ring; the vertical maxima in a shared row buffer
//     for the horizontal max, so any radius): 8 H + 4 (W + 2r) bytes, for
//     planes too wide or too tall for the staged one (more than about 6100
//     rows), or windows wider than 63.  It takes every shape the earlier
//     kernel took: that kernel needed 8 H + 32 (W + 2r) + 4 M bytes within
//     226 KB, more than this within 227 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "nms_common.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kWarps = 8;  // warps of a staged CTA
constexpr int kThreads = kWarps * 32;
constexpr int kCache = 4;  // S: the cell keys a row keeps on chip (staged)
constexpr int kFirst = 2;  // the keys pass 1 leaves a row (staged); a refill leaves kCache
constexpr int kMaxShuffleR = 31;  // the widest radius the shuffle horizontal max takes
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;
// dynamic shared memory a CTA may take (the kernel has no static shared)
constexpr size_t kSmemBytes = 227 * 1024;
// a staged CTA takes chunks of 2 rows a warp while it needs at most this
// (four CTAs an SM, as many as 64 registers a thread allow)
constexpr size_t kFastBytes = kSmemBytes / 4;
// the row keys a chain lane holds in registers (planes of up to 512 rows)
constexpr int kRegRows = 16;

__device__ __forceinline__ unsigned order_bits(unsigned bits) {
  if (bits == 0x80000000u) bits = 0u;  // -0.0 orders as +0.0
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

__device__ __forceinline__ u64 cell_key(unsigned ord, int col, unsigned negzero) {
  return (static_cast<u64>(ord) << 32) |
         (static_cast<u64>(0x7FFFFFFFu - static_cast<unsigned>(col)) << 1) | negzero;
}

__device__ __forceinline__ int key_col(u64 key) {
  return static_cast<int>(0x7FFFFFFFu - static_cast<unsigned>((key & 0xFFFFFFFFull) >> 1));
}

__device__ __forceinline__ float key_value(u64 key) {
  if (key & 1ull) return -0.0f;
  const unsigned ord = static_cast<unsigned>(key >> 32);
  return __uint_as_float((ord & 0x80000000u) ? (ord & 0x7FFFFFFFu) : ~ord);
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T to_elem(float v);
template <>
__device__ __forceinline__ float to_elem<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_elem<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Plane rows in the shared ring: row yy in slot yy % nr.
template <typename T>
struct RingRows {
  const T* base;
  int pitch, nr;
  __device__ const T* row(int yy) const { return base + (yy % nr) * pitch; }
  __device__ const T* next(const T* p) const {
    p += pitch;
    return p == base + nr * pitch ? base : p;
  }
};

// Plane rows in global memory.
template <typename T>
struct PlaneRows {
  const T* x;
  int W;
  __device__ const T* row(int yy) const { return x + static_cast<size_t>(yy) * W; }
  __device__ const T* next(const T* p) const { return p + W; }
};

// Two adjacent plane values (c0 even) as fp32: one 4-byte (bf16) or 8-byte
// (fp32) load from a padded ring row; from a global row, two loads with
// -inf past column W - 1.
template <typename T, bool kPadded>
__device__ __forceinline__ float2 load_pair(const T* row, int c0, int W) {
  if constexpr (kPadded) {
    if constexpr (sizeof(T) == 2) {
      const unsigned u = *reinterpret_cast<const unsigned*>(row + c0);  // low half first
      return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xFFFF0000u));
    } else {
      return *reinterpret_cast<const float2*>(row + c0);
    }
  } else {
    return make_float2(c0 < W ? to_f32(row[c0]) : -INFINITY,
                       c0 + 1 < W ? to_f32(row[c0 + 1]) : -INFINITY);
  }
}

// The window rows y - r .. y + r of a plane row (clipped to the plane):
// vmax(c) is their max at column c, vpair(c0) at columns c0 and c0 + 1.
// With a compile-time radius the pointers past the last row repeat it,
// which leaves the max unchanged.
template <typename T, int R, bool kPadded, class Rows>
struct Window {
  static constexpr int K = 2 * (R >= 0 ? R : 0) + 1;
  const Rows& rows;
  const T* p[K];
  int n, W;
  __device__ Window(const Rows& rows_, int H, int W_, int y, int r) : rows(rows_), W(W_) {
    const int ylo = max(y - r, 0);
    n = min(y + r, H - 1) - ylo + 1;
    p[0] = rows.row(ylo);
#pragma unroll
    for (int d = 1; d < K; ++d) p[d] = d < n ? rows.next(p[d - 1]) : p[d - 1];
  }
  __device__ float vmax(int c) const {  // the lean instance's column a lane
    const T* q = p[0];
    float m = to_f32(q[c]);
    for (int d = 1; d < n; ++d) {
      q = rows.next(q);
      m = max_nan(m, to_f32(q[c]));
    }
    return m;
  }
  __device__ float2 vpair(int c0) const {
    float2 m = load_pair<T, kPadded>(p[0], c0, W);
    auto add = [&](const T* q) {
      const float2 v = load_pair<T, kPadded>(q, c0, W);
      m.x = max_nan(m.x, v.x);
      m.y = max_nan(m.y, v.y);
    };
    if constexpr (R >= 0) {
#pragma unroll
      for (int d = 1; d < K; ++d) add(p[d]);
    } else {
      const T* q = p[0];
      for (int d = 1; d < n; ++d) {
        q = rows.next(q);
        add(q);
      }
    }
    return m;
  }
};

// The shared memory of a CTA: [ring: 2 chunk + 2r rows of ring_pitch(W)]
// [cache: S keys a row][row keys' value words][heads][fills][the lean
// instance's row buffer of W + 2r floats, r of -inf on each side].  chunk
// 0: no ring.
struct Layout {
  size_t ring, cache, rowv, head, fill, vm, total;
};

__host__ __device__ inline size_t up16(size_t b) { return (b + 15) & ~static_cast<size_t>(15); }

// A ring row's columns: W rounded up to the 64 a warp's tile takes.
__host__ __device__ inline int ring_pitch(int W) { return (W + 63) & ~63; }

__host__ __device__ inline Layout layout(int H, int W, int r, int elem, int chunk, int S,
                                         bool buffer) {
  const size_t h = static_cast<size_t>(H);
  Layout L;
  size_t o = 0;
  L.ring = o;
  o += up16(static_cast<size_t>(chunk ? 2 * chunk + 2 * r : 0) * ring_pitch(W) * elem);
  L.cache = o;
  o += up16(h * S * 8);
  L.rowv = o;
  o += S > 1 ? up16(h * 4) : 0;
  L.head = o;
  o += S > 1 ? up16(h) : 0;
  L.fill = o;
  o += S > 1 ? up16(h) : 0;
  L.vm = o;
  o += buffer ? up16(4 * (static_cast<size_t>(W) + 2 * r)) : 0;
  L.total = o;
  return L;
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gsrc) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(gsrc) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [a, b) of the plane x (W columns) into their ring slots (pitch
// columns), by threads t0, t0 + nt, ... (the CTA, or the chain warp): 16-
// byte cp.async pieces when vec (16-byte aligned rows), else element copies.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ x, T* ring, int W, int pitch,
                                           int nr, int a, int b, int vec, int t0, int nt) {
  if (a >= b) return;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int per = W / V;
    const int total = (b - a) * per;
    for (int i = t0; i < total; i += nt) {
      const int q = i / per, piece = i - q * per, yy = a + q;
      cp_async16(ring + static_cast<size_t>(yy % nr) * pitch + piece * V,
                 x + static_cast<size_t>(yy) * W + piece * V);
    }
  } else {
    const int total = (b - a) * W;
    for (int i = t0; i < total; i += nt) {
      const int q = i / W, c = i - q * W, yy = a + q;
      ring[static_cast<size_t>(yy % nr) * pitch + c] = x[static_cast<size_t>(yy) * W + c];
    }
  }
}

// Row y of the suppressed plane, by one warp (every lane calls it): its N
// largest cell keys (below `last` when kBelow), descending, into dst[0..N)
// by lane 0, 0 past the row's last cell; returns dst[0] to every lane.  Each
// lane keeps a sorted list of its own N best cells in registers; N rounds
// of the two warp reductions merge the lists.
//   kBuffer: a column a lane, the horizontal max from the row buffer vm (its
//     pads -inf), for any radius (the lean instance);
//   else: two adjacent columns a lane, tiles of 64 columns, the vertical
//     maxima of three tiles in registers and the horizontal max by
//     shuffles from the lanes ceil(r / 2) either side, each from the tile
//     the source lane picks (r <= kMaxShuffleR).  kPadded: rows of the ring,
//     -inf to a multiple of 64 columns, read without bounds tests.
template <typename T, int R, int N, bool kBuffer, bool kPadded, bool kBelow, class Rows>
__device__ u64 row_top(const Rows& rows, int H, int W, int y, int r_arg, float* vm, u64 last,
                       u64* dst) {
  const int r = R >= 0 ? R : r_arg;
  const int lane = threadIdx.x & 31;
  const Window<T, R, kPadded, Rows> win(rows, H, W, y, r);
  const T* xr = rows.row(y);
  // below (lo, lc): a smaller value word, or the same one at a later column
  const unsigned lo = static_cast<unsigned>(last >> 32);
  const int lc = kBelow ? key_col(last) : -1;
  unsigned ko[N], kc[N];  // value words (0: none) and column << 1 | negzero
#pragma unroll
  for (int t = 0; t < N; ++t) {
    ko[t] = 0;
    kc[t] = kNone;
  }
  // cell c with window max m and value xv into the lane's list; a lane's
  // columns ascend, so the strict > leaves a tie behind the earlier cell
  auto take = [&](int c, float m, float xv) {
    const unsigned bits = __float_as_uint(m == xv ? xv : 0.0f);
    unsigned o = order_bits(bits);
    if (kBelow && !(o < lo || (o == lo && c > lc))) o = 0;  // taken before
    if (c >= W) o = 0;                                       // a pad
    const unsigned cn = (static_cast<unsigned>(c) << 1) | (bits == 0x80000000u ? 1u : 0u);
#pragma unroll
    for (int t = N - 1; t >= 0; --t) {
      if (t > 0 && o > ko[t - 1]) {
        ko[t] = ko[t - 1];
        kc[t] = kc[t - 1];
      } else if (o > ko[t]) {
        ko[t] = o;
        kc[t] = cn;
      }
    }
  };
  if constexpr (kBuffer) {
    for (int c = lane; c < W; c += 32) vm[r + c] = win.vmax(c);
    __syncwarp();
    for (int c = lane; c < W; c += 32) {
      float m = vm[c];
      for (int d = 1; d <= 2 * r; ++d) m = max_nan(m, vm[c + d]);
      take(c, m, to_f32(xr[c]));
    }
    __syncwarp();  // read before the warp's next row writes it
  } else {
    // columns c0, c0 + 1 of tiles j - 1, j, j + 1; the lane e to the right
    // holds c0 + 2e, c0 + 2e + 1 (the next tile's when it wraps), the lane e
    // to the left c0 - 2e, c0 - 2e + 1
    const int nj = (W + 63) >> 6;
    const int E = (r + 1) >> 1;
    const float2 none = make_float2(-INFINITY, -INFINITY);
    float2 prev = none;
    float2 cur = win.vpair(2 * lane);
    for (int j = 0; j < nj; ++j) {
      const int c0 = 2 * lane + (j << 6);
      const float2 next = j + 1 < nj ? win.vpair(c0 + 64) : none;
      float ma = cur.x, mb = cur.y;
      if (r >= 1) {
        ma = max_nan(ma, cur.y);
        mb = max_nan(mb, cur.x);
      }
      auto across = [&](int e) {
        const int rs = (lane + e) & 31, ls = (lane - e) & 31;
        const float2 to_left = lane >= e ? cur : next;     // read by lane - e
        const float2 to_right = lane < 32 - e ? cur : prev;  // read by lane + e
        if (2 * e - 1 <= r) {
          const float ra = __shfl_sync(kFull, to_left.x, rs);   // c0 + 2e
          const float lb = __shfl_sync(kFull, to_right.y, ls);  // c0 - 2e + 1
          ma = max_nan(ma, lb);
          mb = max_nan(mb, ra);
          if (2 * e <= r) {
            ma = max_nan(ma, ra);
            mb = max_nan(mb, lb);
          }
        }
        if (2 * e <= r) {
          const float la = __shfl_sync(kFull, to_right.x, ls);  // c0 - 2e
          const float rb = __shfl_sync(kFull, to_left.y, rs);   // c0 + 2e + 1
          ma = max_nan(ma, la);
          mb = max_nan(mb, rb);
          if (2 * e + 1 <= r) {
            ma = max_nan(ma, rb);
            mb = max_nan(mb, la);
          }
        }
      };
      if constexpr (R >= 0) {
#pragma unroll
        for (int e = 1; e <= (R + 1) / 2; ++e) across(e);
      } else {
        for (int e = 1; e <= E; ++e) across(e);
      }
      const float2 xv = load_pair<T, kPadded>(xr, c0, W);
      take(c0, ma, xv.x);
      take(c0 + 1, mb, xv.y);
      prev = cur;
      cur = next;
    }
  }
  // the row's N best: N rounds over the lanes' list heads
  u64 first = 0;
#pragma unroll
  for (int s = 0; s < N; ++s) {
    const unsigned vmax = __reduce_max_sync(kFull, ko[0]);
    if (vmax == 0) {  // no cell left below: empty slots
      if (lane == 0)
        for (int t = s; t < N; ++t) dst[t] = 0ull;
      break;
    }
    const unsigned cw = __reduce_min_sync(kFull, ko[0] == vmax ? kc[0] : kNone);
    const u64 key = cell_key(vmax, static_cast<int>(cw >> 1), cw & 1u);
    if (lane == 0) dst[s] = key;
    if (s == 0) first = key;
    if (kc[0] == cw) {  // the lane that held it moves to its next best
#pragma unroll
      for (int t = 0; t + 1 < N; ++t) {
        ko[t] = ko[t + 1];
        kc[t] = kc[t + 1];
      }
      ko[N - 1] = 0;
      kc[N - 1] = kNone;
    }
  }
  return first;
}

// One CTA a plane.  kStaged: kWarps warps suppress the plane through the
// ring (chunk rows between barriers), kFirst keys a row, refills of S =
// kCache; else one warp reads the plane from global memory with the row
// buffer (the lean instance, S = 1).  Then warp 0 runs the M rounds.
template <typename T, int R, int S, bool kStaged>
__global__ void __launch_bounds__(kStaged ? kThreads : 32, kStaged ? 4 : 1)
    nms_topk_loop_kernel(const T* __restrict__ det, float* __restrict__ val,
                         int* __restrict__ pos, int H, int W, int M, int r_arg, int chunk,
                         int vec) {
  constexpr int N1 = kStaged ? kFirst : 1;  // the keys pass 1 leaves a row
  constexpr bool kBuffer = !kStaged;
  const int r = R >= 0 ? R : r_arg;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(H, W, r, sizeof(T), kStaged ? chunk : 0, S, kBuffer);
  T* ring = reinterpret_cast<T*>(smem + L.ring);
  u64* cache = reinterpret_cast<u64*>(smem + L.cache);
  unsigned* rowv = reinterpret_cast<unsigned*>(smem + L.rowv);
  unsigned char* head = smem + L.head;
  unsigned char* fill = smem + L.fill;
  float* vm = reinterpret_cast<float*>(smem + L.vm);

  const size_t plane = blockIdx.x;
  const T* x = det + plane * H * W;
  if constexpr (kBuffer) {
    for (int e = lane; e < 2 * r; e += 32) vm[e < r ? e : W + e] = -INFINITY;
    __syncwarp();
  }

  // pass 1: every row's N1 largest cell keys
  auto first_keys = [&](const auto& rows, int y) {
    const u64 k = row_top<T, R, N1, kBuffer, kStaged, false>(rows, H, W, y, r, vm, 0ull,
                                                             cache + y * S);
    if (S > 1 && lane == 0) {
      rowv[y] = static_cast<unsigned>(k >> 32);
      head[y] = 0;
      fill[y] = N1;
    }
  };
  if constexpr (kStaged) {
    const int nr = 2 * chunk + 2 * r, pitch = ring_pitch(W);
    const RingRows<T> rows{ring, pitch, nr};
    // the pads past column W - 1 of every slot: -inf, never staged over
    const int pad = pitch - W;
    for (int i = threadIdx.x; i < nr * pad; i += kThreads)
      ring[(i / pad) * pitch + W + i % pad] = to_elem<T>(-INFINITY);
    stage_rows(x, ring, W, pitch, nr, 0, min(chunk + r, H), vec, threadIdx.x, kThreads);
    cp_async_commit();
    for (int y0 = 0; y0 < H; y0 += chunk) {
      // the next chunk's new rows into slots no row of this chunk's windows holds
      stage_rows(x, ring, W, pitch, nr, min(y0 + chunk + r, H), min(y0 + 2 * chunk + r, H),
                 vec, threadIdx.x, kThreads);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const int y1 = min(y0 + chunk, H);
      for (int y = y0 + warp; y < y1; y += kWarps) first_keys(rows, y);
      __syncthreads();
    }
    if (warp != 0) return;
  } else {
    const PlaneRows<T> rows{x, W};
    for (int y = 0; y < H; ++y) first_keys(rows, y);
  }

  // the chain: M rounds in warp 0, no block barrier.  A lane's best row
  // key: from its kRegRows registers (rows lane + 32 t) when the plane has
  // at most 32 kRegRows rows, else from the shared row keys.
  auto row_value = [&](int y) -> unsigned {
    return S > 1 ? rowv[y] : static_cast<unsigned>(cache[y] >> 32);
  };
  const bool in_regs = H <= 32 * kRegRows;
  unsigned rv[kRegRows];
#pragma unroll
  for (int t = 0; t < kRegRows; ++t)
    rv[t] = in_regs && lane + 32 * t < H ? row_value(lane + 32 * t) : 0u;
  unsigned bv, by;
  auto lane_best = [&]() {  // the largest value, on the lane's lowest row
    bv = 0;
    by = kNone;
    if (in_regs) {
#pragma unroll
      for (int t = 0; t < kRegRows; ++t)
        if (rv[t] > bv) {
          bv = rv[t];
          by = static_cast<unsigned>(lane + 32 * t);
        }
    } else {
#pragma unroll 4
      for (int y = lane; y < H; y += 32) {
        const unsigned v = row_value(y);
        if (v > bv) {
          bv = v;
          by = static_cast<unsigned>(y);
        }
      }
    }
  };
  float* out_v = val + plane * M;
  int* out_p = pos + plane * M;
  lane_best();
  for (int i = 0; i < M; ++i) {
    const unsigned vmax = __reduce_max_sync(kFull, bv);
    const int y = static_cast<int>(__reduce_min_sync(kFull, bv == vmax ? by : kNone));
    const int h = S > 1 ? head[y] : 0;
    const int filled = S > 1 ? fill[y] : 1;
    const u64 key = cache[y * S + h];
    if (lane == 0) {
      out_v[i] = key_value(key);
      out_p[i] = y * W + key_col(key);
    }
    u64 next;
    if (h + 1 == filled) {  // every key of the last fill taken: the next S from the plane
      if constexpr (kStaged) {
        // the window's rows into the ring (free since pass 1), then its path
        const int nr = 2 * chunk + 2 * r, pitch = ring_pitch(W);
        stage_rows(x, ring, W, pitch, nr, max(y - r, 0), min(y + r + 1, H), vec, lane, 32);
        cp_async_commit();
        cp_async_wait<0>();
        __syncwarp();
        next = row_top<T, R, S, false, true, true>(RingRows<T>{ring, pitch, nr}, H, W, y, r, vm,
                                                   key, cache + y * S);
      } else {
        next = row_top<T, R, S, true, false, true>(PlaneRows<T>{x, W}, H, W, y, r, vm, key,
                                                   cache + y * S);
      }
      if (S > 1 && lane == 0) {
        head[y] = 0;
        fill[y] = S;
      }
    } else {
      next = cache[y * S + h + 1];
      if (lane == 0) head[y] = static_cast<unsigned char>(h + 1);
    }
    if (S > 1 && lane == 0) rowv[y] = static_cast<unsigned>(next >> 32);
    __syncwarp();
    if (lane == (y & 31)) {
      if (in_regs) {
#pragma unroll
        for (int t = 0; t < kRegRows; ++t)
          if (t == (y >> 5)) rv[t] = static_cast<unsigned>(next >> 32);
      }
      lane_best();
    }
  }
}

// 1: the staged instance, 2: the lean one, -1: neither fits; *chunk and
// *smem for the instance chosen (the lean one's bytes when -1).
int plan(int H, int W, int r, int elem, int* chunk, size_t* smem) {
  if (H < 1 || W < 1 || r < 0) return -1;
  if (r <= kMaxShuffleR) {
    for (int c = 2 * kWarps; c >= kWarps; c -= kWarps) {
      const size_t b = layout(H, W, r, elem, c, kCache, false).total;
      if (b <= (c == 2 * kWarps ? kFastBytes : kSmemBytes)) {
        *chunk = c;
        *smem = b;
        return 1;
      }
    }
  }
  *chunk = 0;
  *smem = layout(H, W, r, elem, 0, 1, true).total;
  return *smem <= kSmemBytes ? 2 : -1;
}

template <typename T, int R, int S, bool kStaged>
cudaError_t launch_one(const void* det, float* val, int* pos, int planes, int H, int W, int M,
                       int r, int chunk, int vec, size_t smem, cudaStream_t stream) {
  auto kernel = nms_topk_loop_kernel<T, R, S, kStaged>;
  // all of the SM's shared memory to the CTAs (not L1), so as many as the
  // registers allow share it
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<planes, kStaged ? kThreads : 32, smem, stream>>>(static_cast<const T*>(det), val, pos,
                                                             H, W, M, r, chunk, vec);
  return cudaGetLastError();
}

// the windows 3 and 5 (the callers' values) unrolled in the staged
// instance, any other odd one at run time; the lean instance at run time
template <typename T>
cudaError_t launch_t(int instance, const void* det, float* val, int* pos, int planes, int H,
                     int W, int M, int r, int chunk, int vec, size_t smem, cudaStream_t st) {
  if (instance == 2)
    return launch_one<T, -1, 1, false>(det, val, pos, planes, H, W, M, r, 0, 0, smem, st);
  switch (r) {
    case 1:
      return launch_one<T, 1, kCache, true>(det, val, pos, planes, H, W, M, r, chunk, vec, smem,
                                            st);
    case 2:
      return launch_one<T, 2, kCache, true>(det, val, pos, planes, H, W, M, r, chunk, vec, smem,
                                            st);
    default:
      return launch_one<T, -1, kCache, true>(det, val, pos, planes, H, W, M, r, chunk, vec, smem,
                                             st);
  }
}

}  // namespace

// The instance the kernel runs for (H, W) planes of fp32 (is_bf16 = 0) or
// bf16 at NMS radius r: 1 staged, 2 lean, -1 when the planes exceed even
// the lean one.  *smem: the chosen instance's shared memory bytes (the lean
// one's when -1); *budget: the bytes a CTA may take.
extern "C" int lp_nms_topk_loop_plan(int H, int W, int r, int is_bf16, int* smem, int* budget) {
  int chunk;
  size_t bytes;
  const int instance = plan(H, W, r, is_bf16 ? 2 : 4, &chunk, &bytes);
  *smem = bytes > static_cast<size_t>(INT32_MAX) ? INT32_MAX : static_cast<int>(bytes);
  *budget = static_cast<int>(kSmemBytes);
  return instance;
}

// det: (planes, H, W) fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1), contiguous;
// val/pos: (planes, M); r = k // 2; 1 <= M <= H * W.  One launch, one CTA a
// plane; returns cudaErrorInvalidValue for a shape it does not take, else
// the launch's CUDA error (0 = success).
extern "C" int lp_nms_topk_loop(const void* det, int is_bf16, float* val, int* pos, int planes,
                                int H, int W, int M, int r, void* stream) {
  int chunk;
  size_t smem;
  const int instance = plan(H, W, r, is_bf16 ? 2 : 4, &chunk, &smem);
  if (planes < 1 || M < 1 || static_cast<long long>(M) > static_cast<long long>(H) * W ||
      instance < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte ring loads: every plane row starts 16-byte aligned
  const int elem = is_bf16 ? 2 : 4;
  const int vec = reinterpret_cast<uintptr_t>(det) % 16 == 0 && (W * elem) % 16 == 0;
  const cudaError_t e =
      is_bf16 ? launch_t<__nv_bfloat16>(instance, det, val, pos, planes, H, W, M, r, chunk, vec,
                                        smem, st)
              : launch_t<float>(instance, det, val, pos, planes, H, W, M, r, chunk, vec, smem, st);
  return static_cast<int>(e);
}
