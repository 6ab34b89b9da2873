// kxk (any odd k) maxpool-equality NMS + exact top-M peak extraction,
// plane by plane with a row-max vector (K1').
//
// Replaces the Pallas TPU kernel `_nms_topk_kernel`
// (litepose_tpu/ops/pallas_topk.py:111, reached through
// `nms_topk_pallas(..., _gather="sum" | "dot")`), the per-plane loop that
// the JAX package keeps as the baseline of K1's time; no config selects it.
// Its contract is K1's (csrc/nms_topk.cu), bit for bit with the plain twin
// `litepose_tpu_torch.ops.topk.nms_topk_ref`:
//   * NMS: a pixel keeps its value when it equals the max of its k x k
//     window (out-of-plane cells count as -inf), otherwise it becomes +0;
//     bf16 input is upcast to fp32 before any compare;
//   * top-M of the suppressed plane, values descending (-0.0 equal to
//     +0.0), ties to the lowest flat row-major index; a plane with fewer
//     than M peaks yields its zeros in flat order, then its negatives.
// "dot" selected the TPU's row by an MXU product, whose bf16-split passes
// are not exact; the card has no such pass to keep, so both variants run
// this kernel.
//
// What bounds it on an H100: the same plane read as K1 (bytes), but its M
// rounds are a serial chain a plane, each a block-wide argmax, one row
// recomputed from L2 and two block reductions, about five barriers a round;
// with one CTA a plane the chain, not the bytes, sets the time.  It is the
// baseline K1's banded design was measured against, not the fast path.
//
// Design.  The TPU kernel holds KB whole suppressed planes in VMEM; a 448^2
// fp32 plane is 784 KB, beyond the 227 KB of shared memory a CTA may have,
// so nothing plane-sized is kept:
//   pass 1 (each warp a row at a time): the row's vertical maxima over its
//     2r + 1 input rows into the warp's row buffer (r columns of -inf on
//     each side), then the horizontal max, the equality test and the row's
//     largest cell key; only the H row keys stay in shared memory;
//   round i < M: the block's largest row key gives the row (value, then
//     lower row first); the block recomputes that row's suppressed values
//     from the input (the same code as pass 1, so the same bits), masks the
//     cells earlier rounds took by their recorded positions (value ties
//     would otherwise re-resolve to the same column), and takes the two
//     largest cell keys: the first is slot i (its value read back from the
//     row, -0.0 kept), the second the row's new key.
// Cell key: orderable value (-0.0 as +0.0) << 32 | (0xFFFFFFFF - column);
// row key: the same value bits << 32 | (0xFFFFFFFF - row); 0 is below every
// key (a row with every cell taken).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// dynamic shared memory a CTA may take: the 227 KB of an H100 CTA less the
// static reduction slots
constexpr int kSmemBytes = 226 * 1024;

__device__ __forceinline__ u64 value_bits(float v) {
  unsigned bits = __float_as_uint(v);
  if (bits == 0x80000000u) bits = 0u;  // -0.0 orders as +0.0
  const unsigned ord = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  return static_cast<u64>(ord) << 32;
}

__device__ __forceinline__ u64 index_key(u64 value, int idx) {
  return value | (0xFFFFFFFFu - static_cast<unsigned>(idx));
}

__device__ __forceinline__ int key_index(u64 key) {
  return static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(key & 0xFFFFFFFFull));
}

__device__ __forceinline__ u64 umax64(u64 a, u64 b) { return a > b ? a : b; }
__device__ __forceinline__ u64 umin64(u64 a, u64 b) { return a < b ? a : b; }

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// vm[r + c] = the max of rows y - r .. y + r at column c, for the columns c
// this thread takes (first, first + step, ...); rows outside are -inf.
template <typename T>
__device__ __forceinline__ void vertical_max(const T* __restrict__ x, int H, int W, int y,
                                             int r, float* vm, int first, int step) {
  const int ylo = max(y - r, 0), yhi = min(y + r, H - 1);
  for (int c = first; c < W; c += step) {
    float m = -INFINITY;
    for (int yy = ylo; yy <= yhi; ++yy) m = fmaxf(m, to_f32(x[static_cast<size_t>(yy) * W + c]));
    vm[r + c] = m;
  }
}

// The suppressed value of (y, c) from the row's vertical maxima vm.
template <typename T>
__device__ __forceinline__ float suppressed(const T* __restrict__ x, int W, int y, int r,
                                            const float* vm, int c) {
  float m = vm[c];
  for (int d = 1; d <= 2 * r; ++d) m = fmaxf(m, vm[c + d]);
  const float xv = to_f32(x[static_cast<size_t>(y) * W + c]);
  return m == xv ? xv : 0.0f;
}

__device__ __forceinline__ u64 warp_max(u64 v) {
  for (int off = 16; off > 0; off >>= 1) v = umax64(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// (a, b) = the two largest of the block's (a, b) pairs (a >= b in each);
// red holds 2 * (kWarps + 1) keys.  All threads call it.
__device__ __forceinline__ void block_top2(u64& a, u64& b, u64* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    const u64 oa = __shfl_xor_sync(kFull, a, off), ob = __shfl_xor_sync(kFull, b, off);
    b = umax64(umin64(a, oa), umax64(b, ob));
    a = umax64(a, oa);
  }
  if (lane == 0) {
    red[2 * warp] = a;
    red[2 * warp + 1] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? red[2 * lane] : 0ull;
    b = lane < kWarps ? red[2 * lane + 1] : 0ull;
    for (int off = 16; off > 0; off >>= 1) {
      const u64 oa = __shfl_xor_sync(kFull, a, off), ob = __shfl_xor_sync(kFull, b, off);
      b = umax64(umin64(a, oa), umax64(b, ob));
      a = umax64(a, oa);
    }
    if (lane == 0) {
      red[2 * kWarps] = a;
      red[2 * kWarps + 1] = b;
    }
  }
  __syncthreads();
  a = red[2 * kWarps];
  b = red[2 * kWarps + 1];
}

// Shared memory of a plane's CTA: H row keys, kWarps row buffers of W + 2r
// floats, M recorded positions.
size_t smem_bytes(int H, int W, int M, int r) {
  return sizeof(u64) * H + sizeof(float) * kWarps * (W + 2 * r) + sizeof(int) * M;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    nms_topk_loop_kernel(const T* __restrict__ det, float* __restrict__ val,
                         int* __restrict__ pos, int H, int W, int M, int r) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* rowkey = reinterpret_cast<u64*>(smem);
  float* vbuf = reinterpret_cast<float*>(rowkey + H);
  const int Wp = W + 2 * r;
  int* taken = reinterpret_cast<int*>(vbuf + kWarps * Wp);
  __shared__ u64 red[2 * (kWarps + 1)];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t plane = blockIdx.x;
  const T* x = det + plane * H * W;

  // pass 1: every row's largest cell key, a warp a row
  float* vm = vbuf + warp * Wp;
  for (int e = lane; e < 2 * r; e += 32) vm[e < r ? e : W + e] = -INFINITY;
  for (int y = warp; y < H; y += kWarps) {
    __syncwarp();
    vertical_max(x, H, W, y, r, vm, lane, 32);
    __syncwarp();
    u64 best = 0;
    for (int c = lane; c < W; c += 32)
      best = umax64(best, index_key(value_bits(suppressed(x, W, y, r, vm, c)), c));
    best = warp_max(best);
    if (lane == 0) rowkey[y] = index_key(best & 0xFFFFFFFF00000000ull, y);
  }
  __syncthreads();

  // M rounds on warp 0's row buffer, recomputed by the whole block
  float* row = vbuf;
  float* out_v = val + plane * M;
  int* out_p = pos + plane * M;
  for (int i = 0; i < M; ++i) {
    u64 a = 0, b = 0;
    for (int y = tid; y < H; y += kThreads) a = umax64(a, rowkey[y]);
    block_top2(a, b, red);
    const int y = key_index(a);
    vertical_max(x, H, W, y, r, row, tid, kThreads);
    __syncthreads();
    a = b = 0;
    for (int c = tid; c < W; c += kThreads) {
      const int flat = y * W + c;
      bool done = false;
      for (int j = 0; j < i; ++j) done |= taken[j] == flat;
      if (done) continue;
      const u64 k = index_key(value_bits(suppressed(x, W, y, r, row, c)), c);
      if (k > a) {
        b = a;
        a = k;
      } else if (k > b) {
        b = k;
      }
    }
    block_top2(a, b, red);
    if (tid == 0) {
      const int c = key_index(a);
      out_v[i] = suppressed(x, W, y, r, row, c);
      out_p[i] = y * W + c;
      taken[i] = y * W + c;
      rowkey[y] = b ? index_key(b & 0xFFFFFFFF00000000ull, y) : 0ull;
    }
    __syncthreads();
  }
}

}  // namespace

// The dynamic shared memory a plane's CTA takes for (H, W) planes, M peaks
// and NMS radius r, or -1 when it exceeds what a CTA may have.
extern "C" int lp_nms_topk_loop_smem(int H, int W, int M, int r) {
  if (H < 1 || W < 1 || M < 1 || r < 0) return -1;
  const size_t bytes = smem_bytes(H, W, M, r);
  return bytes > static_cast<size_t>(kSmemBytes) ? -1 : static_cast<int>(bytes);
}

// det: (planes, H, W) fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1), contiguous;
// val/pos: (planes, M); r = k // 2; 1 <= M <= H * W.  One launch, one CTA a
// plane; returns cudaErrorInvalidValue for a shape it does not take, else
// the launch's CUDA error (0 = success).
extern "C" int lp_nms_topk_loop(const void* det, int is_bf16, float* val, int* pos, int planes,
                                int H, int W, int M, int r, void* stream) {
  if (planes < 1 || H < 1 || W < 1 || M < 1 || r < 0 ||
      static_cast<long long>(M) > static_cast<long long>(H) * W ||
      lp_nms_topk_loop_smem(H, W, M, r) < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(H, W, M, r);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (is_bf16) {
    e = cudaFuncSetAttribute(nms_topk_loop_kernel<__nv_bfloat16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    nms_topk_loop_kernel<__nv_bfloat16><<<planes, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(det), val, pos, H, W, M, r);
  } else {
    e = cudaFuncSetAttribute(nms_topk_loop_kernel<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    nms_topk_loop_kernel<float><<<planes, kThreads, smem, st>>>(
        static_cast<const float*>(det), val, pos, H, W, M, r);
  }
  return static_cast<int>(cudaGetLastError());
}
