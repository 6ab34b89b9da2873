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
//
// What bounds it on an H100: bytes, each plane read once and written once
// (serving (64,14,224,224) bf16: 179.8 MB, 0.0537 ms at 3.35 TB/s; eval
// (32,14,448,448) fp32: 719.4 MB, 0.2147 ms).  The separable max is 4r
// compares a cell, far below the fp32 rate.
//
// Design: separable, as the TPU kernel is.  One CTA per (tile of kTileH
// rows x kTileW columns, plane), 256 threads:
//   1. the tile's cells and r halo rows and columns around them into shared
//      memory as fp32 (-inf outside the plane): the tile's columns by
//      16-byte loads (4 fp32 or 8 bf16), every load of a thread issued
//      before the first is stored; the halo columns by scalar loads;
//   2. the column max: for each tile row and staged column, the max over
//      its 2r + 1 staged rows, into a second shared array;
//   3. the row max over the 2r + 1 column maxima around each cell, the
//      equality test against the staged cell and the store; a warp writes
//      32 consecutive cells of a row.
// The halo is read again by the neighbouring tiles, mostly from L2:
// (kTileH + 2r) / kTileH of the rows and (kTileW + 2r) / kTileW of the
// columns.  The radius is a template parameter, so each window unrolls.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include "nms_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileH = 32;   // rows a CTA writes
constexpr int kTileW = 128;  // columns a CTA writes
constexpr int kMaxR = 7;     // k = 15; MAX_NMS_RADIUS in ops/library.py

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

template <typename T, int R>
cudaError_t launch_r(const void* det, void* out, int planes, int H, int W, cudaStream_t stream) {
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const long long tiles = static_cast<long long>((H + kTileH - 1) / kTileH) * tiles_x;
  if (tiles * planes > INT_MAX) return cudaErrorInvalidValue;
  const int vec = reinterpret_cast<uintptr_t>(det) % 16 == 0 && (W * sizeof(T)) % 16 == 0;
  heatmap_nms_kernel<T, R><<<static_cast<unsigned>(tiles * planes), kThreads, 0, stream>>>(
      static_cast<const T*>(det), static_cast<T*>(out), H, W, tiles_x,
      static_cast<int>(tiles), vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* det, void* out, int planes, int H, int W, int r,
                   cudaStream_t stream) {
  static_assert(kMaxR == 7, "one case a radius below");
  switch (r) {
    case 0: return launch_r<T, 0>(det, out, planes, H, W, stream);
    case 1: return launch_r<T, 1>(det, out, planes, H, W, stream);
    case 2: return launch_r<T, 2>(det, out, planes, H, W, stream);
    case 3: return launch_r<T, 3>(det, out, planes, H, W, stream);
    case 4: return launch_r<T, 4>(det, out, planes, H, W, stream);
    case 5: return launch_r<T, 5>(det, out, planes, H, W, stream);
    case 6: return launch_r<T, 6>(det, out, planes, H, W, stream);
    case 7: return launch_r<T, 7>(det, out, planes, H, W, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// det, out: (planes, H, W) fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1),
// contiguous, not overlapping; r = k // 2 in [0, 7].  One launch; returns
// cudaErrorInvalidValue for a shape the kernel does not take, else the
// launch's CUDA error (0 = success).
extern "C" int lp_heatmap_nms(const void* det, int is_bf16, void* out, int planes, int H,
                              int W, int r, void* stream) {
  if (planes < 1 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? launch<__nv_bfloat16>(det, out, planes, H, W, r, st)
                                  : launch<float>(det, out, planes, H, W, r, st));
}
