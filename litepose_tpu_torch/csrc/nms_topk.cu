// Fused 5x5 (any odd k) maxpool-equality NMS + exact top-M peak extraction.
//
// Replaces the Pallas TPU kernel `_nms_topk_kernel_vec`
// (litepose_tpu/ops/pallas_topk.py, reached through `nms_topk_pallas`).
// Contract, bit for bit with `heatmap_nms` + `lax.top_k` on fp32:
//   * NMS: a pixel keeps its value when it equals the max of its k x k
//     window (out-of-plane cells count as -inf), otherwise it becomes +0;
//     bf16 input is upcast to fp32 before any compare;
//   * top-M of the suppressed plane, values descending, ties to the lowest
//     flat row-major index; a plane with fewer than M peaks yields its
//     zeros in flat order.
//
// Design.  One CTA per (image, joint) plane.
//   Phase 1 (one warp per row): window max straight from global memory
//   (the plane sits in L1/L2), the suppressed plane goes to a scratch
//   buffer the caller allocates, and each row's max goes to shared memory.
//   Nothing depends on holding the plane in shared memory, so planes of
//   any size run (a 448^2 fp32 plane is 784 KB, beyond the 227 KB a CTA
//   can hold).
//   Phase 2 (M rounds): block argmax over the row maxima (lowest row on
//   ties), then warp 0 rescans that one row (lowest column on ties),
//   records the cell, masks it with -inf in the scratch plane and
//   recomputes the row's max.  This is the row-hierarchical extraction of
//   the TPU kernel; each round touches H + 2W floats instead of H*W.
//
// What bounds it on an H100: phase 1 is k*k loads per pixel served from
// L1 (the input is read from HBM once and the scratch plane written
// once); phase 2 is latency-bound, 2 block barriers per round.  The first
// version keeps both simple; a separable max in shared-memory row bands
// is the obvious next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// (value, index) order of the extraction: larger value first, lower index
// first among equal values.
__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov,
                                             int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    argmax_merge(v, i, ov, oi);
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    nms_topk_kernel(const T* __restrict__ det, float* __restrict__ sup,
                    float* __restrict__ val, int* __restrict__ pos, int H,
                    int W, int M, int r) {
  extern __shared__ float rowmax[];  // H floats
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];

  const size_t plane = blockIdx.x;
  const size_t hw = static_cast<size_t>(H) * W;
  const T* x = det + plane * hw;
  float* s = sup + plane * hw;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // ---- phase 1: maxpool-equality NMS, one warp per row ----
  for (int y = warp; y < H; y += kWarps) {
    const int y0 = max(y - r, 0), y1 = min(y + r, H - 1);
    float rmax = -INFINITY;
    for (int c = lane; c < W; c += 32) {
      const int c0 = max(c - r, 0), c1 = min(c + r, W - 1);
      float m = -INFINITY;
      for (int yy = y0; yy <= y1; ++yy) {
        const T* xr = x + static_cast<size_t>(yy) * W;
        for (int cc = c0; cc <= c1; ++cc) m = fmaxf(m, to_f32(xr[cc]));
      }
      float v = to_f32(x[static_cast<size_t>(y) * W + c]);
      v = (m == v) ? v : 0.0f;
      s[static_cast<size_t>(y) * W + c] = v;
      rmax = fmaxf(rmax, v);
    }
    rmax = warp_max(rmax);
    if (lane == 0) rowmax[y] = rmax;
  }
  __syncthreads();

  // ---- phase 2: M rounds of row-hierarchical extraction ----
  float* out_v = val + plane * M;
  int* out_p = pos + plane * M;
  for (int i = 0; i < M; ++i) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int y = threadIdx.x; y < H; y += kThreads)
      argmax_merge(bv, bi, rowmax[y], y);
    warp_argmax(bv, bi);
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kWarps ? red_v[lane] : -INFINITY;
      bi = lane < kWarps ? red_i[lane] : INT_MAX;
      warp_argmax(bv, bi);
      const int row = bi;
      float* srow = s + static_cast<size_t>(row) * W;
      // first column holding the row max; taken cells hold -inf
      int first = INT_MAX;
      for (int c = lane; c < W; c += 32) {
        if (srow[c] == bv) {
          first = c;
          break;
        }
      }
      first = warp_min(first);
      if (first == INT_MAX) first = 0;  // only a NaN plane gets here
      float nm = -INFINITY;
      for (int c = lane; c < W; c += 32)
        if (c != first) nm = fmaxf(nm, srow[c]);
      nm = warp_max(nm);
      if (lane == 0) {
        out_v[i] = srow[first];
        out_p[i] = row * W + first;
        srow[first] = -INFINITY;
        rowmax[row] = nm;
      }
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const void* det, float* sup, float* val, int* pos,
                   int planes, int H, int W, int M, int r,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(H) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_topk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  nms_topk_kernel<T><<<planes, kThreads, smem, stream>>>(
      static_cast<const T*>(det), sup, val, pos, H, W, M, r);
  return cudaGetLastError();
}

}  // namespace

// det: (planes, H, W) fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1), contiguous.
// sup: (planes, H, W) fp32 scratch.  val/pos: (planes, M).  r = k // 2.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int lp_nms_topk(const void* det, int is_bf16, float* sup,
                           float* val, int* pos, int planes, int H, int W,
                           int M, int r, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      is_bf16 ? launch<__nv_bfloat16>(det, sup, val, pos, planes, H, W, M, r,
                                      st)
              : launch<float>(det, sup, val, pos, planes, H, W, M, r, st);
  return static_cast<int>(e);
}
