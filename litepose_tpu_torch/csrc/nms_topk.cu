// Fused kxk (any odd k) maxpool-equality NMS + exact top-M peak extraction
// (K1), in row bands with a merge per plane.
//
// Replaces the Pallas TPU kernel `_nms_topk_kernel_vec`
// (litepose_tpu/ops/pallas_topk.py:43, reached through `nms_topk_pallas`),
// and on the serving path also `_nms_kernel` (pallas_nms.py:27).  Contract,
// bit for bit with `heatmap_nms` + `lax.top_k` on fp32 and with the plain
// twin `litepose_tpu_torch.ops.topk.nms_topk_ref`:
//   * NMS: a pixel keeps its value when it equals the max of its k x k
//     window (out-of-plane cells count as -inf), otherwise it becomes +0;
//     bf16 input is upcast to fp32 before any compare;
//   * top-M of the suppressed plane, values descending, ties to the lowest
//     flat row-major index; a plane with fewer than M peaks yields its
//     zeros in flat order.
//
// What bounds it on an H100: the read of the planes, once (serving b64 at
// 224^2 bf16: 89.9 MB, 0.027 ms at 3.35 TB/s; eval b32 at 448^2 fp32:
// 359.7 MB, 0.107 ms).  The separable max is 2k compares a pixel, far
// below the fp32 rate.  The earlier one-CTA-per-plane version took the
// window max from global memory (k*k loads a pixel), wrote the whole
// suppressed plane to a scratch buffer and ran M serial rounds of block
// argmax; this one keeps everything but the candidates on chip.  It still
// runs at about a tenth of that bound at the serving shape: a CTA's load
// burst, its two passes through shared memory (about 12 shared loads a
// pixel) and the selection's barriers run in series, three CTAs an SM
// (PERF.md); overlapping the next band's loads is the next step.
//
// Design.  Order every pixel by one 64-bit key,
//   (orderable_u32(value) << 32) | ((0x7FFFFFFF - flat_index) << 1) | negzero,
// larger first: value descending (-0.0 ordered as +0.0; the low bit gives
// -0.0 back bit for bit), then flat index ascending.  The order is total,
// so the top-M of the union of the bands' top-Ms is the plane's top-M.
//   Band CTA (grid x: band, y: plane): rows [y0 - r, y0 + rows + r) of the
//   plane into shared memory as fp32 with 16-byte loads (8 bf16 or 4 fp32 a
//   thread), the vertical then horizontal max there, the equality test, and
//   kPix suppressed values a thread in registers.  Its top-M: each warp's
//   ceil(M / kWarps) largest thread maxima give a threshold tau (the M-th
//   largest of them, a key at most the band's M-th largest); the pixels
//   with key >= tau (about M to 2M on heatmaps, at most every pixel of the
//   band on a skewed plateau) go to a shared list, and each takes the slot
//   of its rank there.  The list reuses the band's rows: their
//   (band_h + 2r) * W + band_h * (W + 2r) floats hold a 64-bit key for
//   each of the band_h * W pixels, so it cannot overflow.  Ranking costs
//   (list length)^2 / kThreads compares a thread.
//   Merge (a second launch, one CTA a plane): the n_bands x M band keys
//   into registers and the same selection on them, writing values and
//   indices.  A merge by the plane's last band, behind a fence and an
//   atomic ticket, saves the launch but measured slower: every band CTA
//   waits on its fence.
//   The geometry (band height, shared memory) is worked out here from
//   kThreads, kPix and kSmemBytes; lp_nms_topk_bands and lp_nms_topk_limits
//   give the caller the band count and the limits of the shapes taken.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPix = 16;                     // elements a thread holds
constexpr int kKeys = kThreads * kPix;       // elements a CTA holds
// dynamic shared memory a CTA may take: the 227 KB of an H100 CTA less the
// static SelectShared
constexpr int kSmemBytes = 222 * 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ u64 pack_key(float v, int idx) {
  unsigned bits = __float_as_uint(v);
  const unsigned negzero = bits == 0x80000000u;
  if (negzero) bits = 0u;
  const unsigned ord = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  return (static_cast<u64>(ord) << 32) |
         (static_cast<u64>(0x7FFFFFFFu - static_cast<unsigned>(idx)) << 1) | negzero;
}

__device__ __forceinline__ float key_value(u64 key) {
  if (key & 1ull) return -0.0f;
  const unsigned ord = static_cast<unsigned>(key >> 32);
  return __uint_as_float((ord & 0x80000000u) ? (ord & 0x7FFFFFFFu) : ~ord);
}

__device__ __forceinline__ int key_index(u64 key) {
  return static_cast<int>(0x7FFFFFFFu - static_cast<unsigned>((key & 0xFFFFFFFFull) >> 1));
}

__device__ __forceinline__ u64 umax64(u64 a, u64 b) { return a > b ? a : b; }

__device__ __forceinline__ u64 warp_max(u64 v) {
  for (int off = 16; off > 0; off >>= 1) v = umax64(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

struct SelectShared {
  u64 tops[kThreads];  // each warp's largest thread maxima
  u64 tau;
  int n_cand;
};
static_assert(kSmemBytes + sizeof(SelectShared) <= 227 * 1024,
              "a CTA's shared memory exceeds the H100's 227 KB");

// The top-m keys, descending, of the elements a CTA holds, kPix at most a
// thread: emit(rank, key) for every rank < m, with key 0 where fewer than m
// elements exist.  tmax is the thread's largest key (0 when it holds none);
// collect(tau, push) calls push(key) for each of its keys >= tau (all of
// them when tau is 0).  m <= kThreads; cand is shared memory for every key
// the CTA holds.  All threads call it.
template <class Collect, class Emit>
__device__ __forceinline__ void select_top(u64 tmax, Collect collect, int m, Emit emit,
                                           SelectShared& sh, u64* cand) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // each warp's q largest thread maxima (distinct pixels, or 0)
  const int q = (m + kWarps - 1) / kWarps;
  u64 bound = ~0ull;
  for (int t = 0; t < q; ++t) {
    const u64 top = warp_max(tmax < bound ? tmax : 0ull);
    if (lane == 0) sh.tops[warp * q + t] = top;
    bound = top;
  }
  if (tid == 0) {
    sh.tau = 0;
    sh.n_cand = 0;
  }
  __syncthreads();
  // tau: the m-th largest of the kWarps * q maxima, 0 when fewer than m are
  // pixels.  At least m pixels have keys >= tau, so the top-m all do.
  const int nt = kWarps * q;
  for (int i = tid; i < nt; i += kThreads) {
    const u64 k = sh.tops[i];
    if (k == 0) continue;
    int rank = 0;
    for (int j = 0; j < nt; ++j) rank += sh.tops[j] > k;
    if (rank == m - 1) sh.tau = k;
  }
  __syncthreads();
  collect(sh.tau, [&](u64 k) { cand[atomicAdd(&sh.n_cand, 1)] = k; });
  __syncthreads();
  // each candidate's rank among the candidates is its output slot
  const int nc = sh.n_cand;
  for (int i = tid; i < nc; i += kThreads) {
    const u64 k = cand[i];
    int rank = 0;
    for (int j = 0; j < nc; ++j) rank += cand[j] > k;
    if (rank < m) emit(rank, k);
  }
  for (int r = nc + tid; r < m; r += kThreads) emit(r, 0ull);
}

// Band row of band pixel i (< 2^13) for inv_w = 1 / W in fp32: the error of
// (i + 0.5) * inv_w stays far below its distance 0.5 / W to an integer.
__device__ __forceinline__ int row_of(int i, float inv_w) {
  return __float2int_rz((static_cast<float>(i) + 0.5f) * inv_w);
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// n elements of src (row-contiguous plane rows) into dst as fp32; vec: 16-
// byte loads (src and dst 16-byte aligned, n a multiple of 16 / sizeof(T)).
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, float* dst, int n,
                                          int vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    for (int i = threadIdx.x; i < n / V; i += kThreads) {
      const uint4 u = __ldg(s4 + i);
      float4* d4 = reinterpret_cast<float4*>(dst + i * V);
      if (sizeof(T) == 4) {
        d4[0] = make_float4(__uint_as_float(u.x), __uint_as_float(u.y),
                            __uint_as_float(u.z), __uint_as_float(u.w));
      } else {  // bf16 pairs, low half first: the upper 16 bits of an fp32
        d4[0] = make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xFFFF0000u),
                            __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xFFFF0000u));
        d4[1] = make_float4(__uint_as_float(u.z << 16), __uint_as_float(u.z & 0xFFFF0000u),
                            __uint_as_float(u.w << 16), __uint_as_float(u.w & 0xFFFF0000u));
      }
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = to_f32(src[i]);
  }
}

// R: the NMS radius k // 2 when it is a compile-time constant, -1 for any
// radius r_arg given at run time.
// Three CTAs an SM (40 registers a thread) when a band's shared memory
// allows: more bands in flight hide each one's serial load-compute-select
// chain.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads, 3)
    nms_topk_band_kernel(const T* __restrict__ det, u64* __restrict__ band_keys,
                         int H, int W, int M, int r_arg, int band_h, int vec) {
  const int r = R >= 0 ? R : r_arg;
  const int Wp = W + 2 * r;
  extern __shared__ __align__(16) unsigned char smem[];
  float* raw = reinterpret_cast<float*>(smem);  // (band_h + 2r) x W, from row y0 - r
  float* vm = raw + (band_h + 2 * r) * W;       // band_h x Wp vertical maxima, r
                                                // columns of -inf on each side
  u64* cand = reinterpret_cast<u64*>(smem);     // reuses raw and vm once they are read
  __shared__ SelectShared sh;

  const int band = blockIdx.x, n_bands = gridDim.x;
  const size_t plane = blockIdx.y;
  const int tid = threadIdx.x;
  const int y0 = band * band_h;
  const int rows = min(band_h, H - y0);
  const int npix = rows * W;
  const float inv_w = 1.0f / static_cast<float>(W);
  const T* x = det + plane * H * W;

  // 1. rows y0 - r .. y0 + rows + r - 1; rows outside the plane are -inf
  const int ylo = max(y0 - r, 0), yhi = min(y0 + rows + r, H);
  const int lead = (ylo - (y0 - r)) * W;
  const int n_in = (yhi - ylo) * W;
  const int total = (rows + 2 * r) * W;
  for (int i = tid; i < lead; i += kThreads) raw[i] = -INFINITY;
  for (int i = lead + n_in + tid; i < total; i += kThreads) raw[i] = -INFINITY;
  for (int i = tid; i < rows * 2 * r; i += kThreads) {
    const int yb = i / (2 * r), e = i - yb * 2 * r;
    vm[yb * Wp + (e < r ? e : W + e)] = -INFINITY;
  }
  load_rows(x + static_cast<size_t>(ylo) * W, raw + lead, n_in, vec);
  __syncthreads();

  // 2. vertical max over 2r + 1 rows
  for (int i = tid; i < npix; i += kThreads) {
    const int yb = row_of(i, inv_w);
    const float* col = raw + i;  // raw row yb (plane row y0 + yb - r)
    float m = col[0];
#pragma unroll
    for (int d = 1; d <= 2 * r; ++d) m = fmaxf(m, col[d * W]);
    vm[yb * Wp + r + (i - yb * W)] = m;
  }
  __syncthreads();

  // 3. horizontal max and the equality test; element j of a thread is band
  // pixel tid + j * kThreads.  The thread's first largest value gives its
  // largest key (the key orders by value, then by lower index).
  float s[kPix];
  float tv = 0.0f;
  int ti = -1;
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int i = tid + j * kThreads;
    float v = 0.0f;
    if (i < npix) {
      const int yb = row_of(i, inv_w);
      const float* win = vm + yb * Wp + (i - yb * W);  // columns c - r .. c + r
      float m = win[0];
#pragma unroll
      for (int d = 1; d <= 2 * r; ++d) m = fmaxf(m, win[d]);
      const float xv = raw[i + r * W];
      v = (m == xv) ? xv : 0.0f;
      if (ti < 0 || v > tv) {
        tv = v;
        ti = i;
      }
    }
    s[j] = v;
  }

  // 4. the band's top-M keys to band_keys[plane][band]; a pixel is a
  // candidate when its (value, index) is at or above tau's, compared as
  // floats first (-0.0 == +0.0, as the key orders them)
  const int base = y0 * W;
  u64* out = band_keys + (plane * n_bands + band) * M;
  select_top(
      ti < 0 ? 0ull : pack_key(tv, base + ti),
      [&](u64 tau, auto&& push) {
        const float tau_v = key_value(tau);
        const int tau_i = key_index(tau) - base;
#pragma unroll
        for (int j = 0; j < kPix; ++j) {
          const int i = tid + j * kThreads;
          if (i < npix && (tau == 0 || s[j] > tau_v || (s[j] == tau_v && i <= tau_i)))
            push(pack_key(s[j], base + i));
        }
      },
      M, [&](int rank, u64 k) { out[rank] = k; }, sh, cand);
}

// The plane's top-M over its bands' keys: one CTA a plane, after the band
// kernel; dynamic shared memory for the n_bands * M keys.
__global__ void __launch_bounds__(kThreads)
    nms_topk_merge_kernel(const u64* __restrict__ band_keys, float* __restrict__ val,
                          int* __restrict__ pos, int n_bands, int M) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* cand = reinterpret_cast<u64*>(smem);
  __shared__ SelectShared sh;
  const size_t plane = blockIdx.x;
  const int tid = threadIdx.x;
  const u64* keys = band_keys + plane * n_bands * M;
  const int n_keys = n_bands * M;
  u64 mk[kPix];
  u64 mmax = 0;
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int i = tid + j * kThreads;
    mk[j] = i < n_keys ? keys[i] : 0ull;
    mmax = umax64(mmax, mk[j]);
  }
  float* out_v = val + plane * M;
  int* out_p = pos + plane * M;
  select_top(
      mmax,
      [&](u64 tau, auto&& push) {
#pragma unroll
        for (int j = 0; j < kPix; ++j)
          if (mk[j] != 0 && mk[j] >= tau) push(mk[j]);
      },
      M,
      [&](int rank, u64 k) {
        out_v[rank] = key_value(k);
        out_p[rank] = key_index(k);
      },
      sh, cand);
}

// The band kernel's geometry for (H, W) planes, M peaks and NMS radius r.
struct Bands {
  int h, n;     // band height, band count
  size_t smem;  // dynamic shared memory bytes of a band CTA
};

// The widest plane a band of one row takes: (1 + 2r) * W + (W + 2r) floats.
int widest(int r) { return std::min(kKeys, (kSmemBytes / 4 - 2 * r) / (2 + 2 * r)); }

// 0 and the geometry in *b when the kernel takes the shape; -1 when W is
// wider than widest(r); -2 when the merge's n_bands * M keys exceed kKeys
// or M exceeds kThreads.
int plan_bands(int H, int W, int M, int r, Bands* b) {
  if (W < 1 || W > widest(r)) return -1;
  // band_h rows take (band_h + 2r) * W + band_h * (W + 2r) floats
  b->h = std::min({H, kKeys / W, (kSmemBytes / 4 - 2 * r * W) / (2 * W + 2 * r)});
  b->n = (H + b->h - 1) / b->h;
  b->smem = sizeof(float) * ((b->h + 2 * r) * W + b->h * (W + 2 * r));
  if (static_cast<long long>(b->n) * M > kKeys || M > kThreads) return -2;
  return 0;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int R>
cudaError_t launch_r(const T* det, u64* band_keys, int planes, int H, int W, int M, int r,
                     const Bands& b, int vec, cudaStream_t stream) {
  const cudaError_t e = allow_smem(nms_topk_band_kernel<T, R>, b.smem);
  if (e != cudaSuccess) return e;
  nms_topk_band_kernel<T, R><<<dim3(b.n, planes), kThreads, b.smem, stream>>>(
      det, band_keys, H, W, M, r, b.h, vec);
  return cudaGetLastError();
}

// the windows 3 and 5 (the callers' values) unrolled, any other odd one at
// run time
template <typename T>
cudaError_t launch_bands(const void* det, void* band_keys, int planes, int H, int W, int M,
                         int r, const Bands& b, cudaStream_t stream) {
  const T* x = static_cast<const T*>(det);
  u64* keys = static_cast<u64*>(band_keys);
  // 16-byte loads: every plane row starts 16-byte aligned
  const int vec = reinterpret_cast<uintptr_t>(det) % 16 == 0 && (W * sizeof(T)) % 16 == 0;
  switch (r) {
    case 1:
      return launch_r<T, 1>(x, keys, planes, H, W, M, r, b, vec, stream);
    case 2:
      return launch_r<T, 2>(x, keys, planes, H, W, M, r, b, vec, stream);
    default:
      return launch_r<T, -1>(x, keys, planes, H, W, M, r, b, vec, stream);
  }
}

}  // namespace

// The number of row bands of the kernel for (H, W) planes, M peaks and NMS
// radius r: the band_keys scratch lp_nms_topk takes is (planes, bands, M)
// uint64.  -1 when W is wider than the widest plane, -2 when the bands' keys
// exceed the merge (both limits from lp_nms_topk_limits).
extern "C" int lp_nms_topk_bands(int H, int W, int M, int r) {
  Bands b;
  const int e = plan_bands(H, W, M, r, &b);
  return e ? e : b.n;
}

// The limits of the shapes the kernel takes at NMS radius r: planes at most
// *widest wide, at most *merge_keys band keys (bands * M) a plane, and M at
// most *max_m.
extern "C" int lp_nms_topk_limits(int r, int* widest_w, int* merge_keys, int* max_m) {
  *widest_w = widest(r);
  *merge_keys = kKeys;
  *max_m = kThreads;
  return 0;
}

// det: (planes, H, W) fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1), contiguous.
// band_keys: (planes, lp_nms_topk_bands(H, W, M, r), M) uint64 scratch;
// val/pos: (planes, M).  r = k // 2; planes <= 65535.  Two launches, the
// bands' and the merge's; returns cudaErrorInvalidValue for a shape the
// kernel does not take, else the first CUDA error (0 = success).
extern "C" int lp_nms_topk(const void* det, int is_bf16, void* band_keys, float* val,
                           int* pos, int planes, int H, int W, int M, int r, void* stream) {
  Bands b;
  if (plan_bands(H, W, M, r, &b) != 0 || H < 1 || M < 1 || r < 0 || planes < 1 ||
      planes > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = is_bf16
                      ? launch_bands<__nv_bfloat16>(det, band_keys, planes, H, W, M, r, b, st)
                      : launch_bands<float>(det, band_keys, planes, H, W, M, r, b, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t merge_smem = static_cast<size_t>(b.n) * M * sizeof(u64);
  e = allow_smem(nms_topk_merge_kernel, merge_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  nms_topk_merge_kernel<<<planes, kThreads, merge_smem, st>>>(
      static_cast<const u64*>(band_keys), val, pos, b.n, M);
  return static_cast<int>(cudaGetLastError());
}
