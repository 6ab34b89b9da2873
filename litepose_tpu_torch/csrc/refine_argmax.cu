// Penalized argmax of the refine step (K4), tiled over (plane, pixel tile).
//
// Replaces the Pallas TPU kernel `_refine_kernel`
// (litepose_tpu/ops/pallas_refine.py:38, reached through
// `refine_argmax_pallas`).  Contract, bit for bit with that kernel and with
// the plain twin `litepose_tpu_torch.ops.refine.refine_argmax_ref`: for
// every person slot p of image b with need[b][k][p] != 0,
//   pos[b][k][p] = the flat row-major argmax over the (H, W) plane of
//     det[b][k] - rint(tt),  tt = |tag - prev[b][p]|          (T = 1)
//                            tt = sqrt(d0*d0 + d1*d1)         (T = 2)
//   with ties to the lowest flat index; slots with need == 0 hold 0.
//
// What bounds it on an H100: the read of det and tag, once per plane that
// has a needed slot, 4 (1 + T) bytes a pixel (eval protocol b32 at 448^2,
// T = 2: 1.08 GB, 0.32 ms at 3.35 TB/s), against about 9 fp32 operations
// per (pixel, needed slot) (3712 slots: 6.7 GFLOP, 0.10 ms at 67 TFLOP/s;
// the IEEE square root is a sequence of several instructions, so issue,
// not the FLOP count, is the nearer wall: the kernel runs at about a third
// of the byte bound, PERF.md).
//
// Design.  One CTA per (plane, tile of kTile pixels), so the card is full
// whatever the slot counts (the plane-per-CTA version left the planes with
// the most slots as the tail).  A CTA lists its plane's needed slots with a
// ballot and returns before it loads a pixel when there are none.  It loads
// its tile once, with 16-byte loads, into registers, then loops over the
// listed slots only (a runtime count): a thread-local best in increasing
// index order (strict > keeps the first index), a warp-shuffle max of the
// 64-bit key
//   (orderable_u32(penal) << 32) | (0xFFFFFFFF - flat_index),
// and, per (CTA, slot), one atomicMax into a zero-filled (B, K, P) scratch.
// The key's maximum is the largest penalty at the lowest index whatever the
// order the CTAs run in.  A second launch writes pos = need ? index : 0.
//
// Exactness: the round-to-nearest intrinsics keep nvcc from contracting
// d0*d0 + d1*d1 into an FMA (the library is also built with --fmad=false);
// rintf rounds half to even, as torch.round and jnp.round do.  The twin
// compares floats, where -0.0 == +0.0, so the key turns -0.0 into +0.0.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                              // pixels per 16-byte load
constexpr int kLoads = 4;                            // loads per thread and input plane
constexpr int kPix = kVec * kLoads;                  // pixels per thread
constexpr int kTile = kThreads * kPix;               // pixels per CTA
constexpr unsigned kFull = 0xffffffffu;

// penal's float order as an unsigned order, -0.0 taken as +0.0
__device__ __forceinline__ unsigned orderable(float v) {
  unsigned bits = __float_as_uint(v);
  if (bits == 0x80000000u) bits = 0u;
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

__device__ __forceinline__ u64 make_key(float v, int idx) {
  return (static_cast<u64>(orderable(v)) << 32) |
         static_cast<u64>(0xFFFFFFFFu - static_cast<unsigned>(idx));
}

__device__ __forceinline__ u64 warp_max(u64 v) {
  for (int off = 16; off > 0; off >>= 1) {
    const u64 o = __shfl_xor_sync(kFull, v, off);
    v = o > v ? o : v;
  }
  return v;
}

template <int T>
__device__ __forceinline__ float penalty(float x, float t0, float t1, float q0,
                                         float q1) {
  float tt;
  if (T == 1) {
    tt = fabsf(__fsub_rn(t0, q0));
  } else {
    const float d0 = __fsub_rn(t0, q0);
    const float d1 = __fsub_rn(t1, q1);
    tt = __fsqrt_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)));
  }
  return __fsub_rn(x, rintf(tt));
}

// Flat index of a thread's e-th pixel: 16-byte load l = e / kVec covers
// pixels base + (l * kThreads + tid) * kVec + [0, kVec), so e runs in
// increasing index order within the thread.
__device__ __forceinline__ int pixel_of(int base, int tid, int e) {
  return base + ((e / kVec) * kThreads + tid) * kVec + e % kVec;
}

template <int T>
__global__ void __launch_bounds__(kThreads)
    refine_argmax_tile_kernel(const int* __restrict__ need,
                              const float* __restrict__ prev,
                              const float* __restrict__ det,
                              const float* __restrict__ tag,
                              u64* __restrict__ best, int P, int K, int HW,
                              int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* red = reinterpret_cast<u64*>(smem);                   // kWarps x P
  float* prev_s = reinterpret_cast<float*>(red + kWarps * P);  // P x 2
  int* slot_of = reinterpret_cast<int*>(prev_s + 2 * P);     // P
  __shared__ int n_listed;

  const size_t bk = blockIdx.y;  // b * K + k
  const int b = static_cast<int>(bk / K);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int* need_bk = need + bk * P;
  const float* prev_b = prev + static_cast<size_t>(b) * P * T;

  // the plane's needed slots, in slot order
  if (warp == 0) {
    int n = 0;
    for (int s0 = 0; s0 < P; s0 += 32) {
      const int s = s0 + lane;
      const bool on = s < P && need_bk[s] != 0;
      const unsigned mask = __ballot_sync(kFull, on);
      if (on) {
        const int at = n + __popc(mask & ((1u << lane) - 1u));
        slot_of[at] = s;
        prev_s[2 * at] = prev_b[s * T];
        prev_s[2 * at + 1] = T == 2 ? prev_b[s * T + 1] : 0.0f;
      }
      n += __popc(mask);
    }
    if (lane == 0) n_listed = n;
  }
  __syncthreads();
  const int n = n_listed;
  if (n == 0) return;  // block-uniform: no pixel of this plane is needed

  // the tile, once, into registers
  const int base = blockIdx.x * kTile;
  const bool full = base + kTile <= HW;
  const float* det_p = det + bk * HW;
  const float* tag_p = tag + bk * T * HW;
  float x[kPix], t0[kPix], t1[kPix];
#pragma unroll
  for (int l = 0; l < kLoads; ++l) {
    const int p = base + (l * kThreads + tid) * kVec;
    if (vec && p + kVec <= HW) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(det_p + p));
      const float4 c = __ldg(reinterpret_cast<const float4*>(tag_p + p));
      x[l * kVec] = a.x, x[l * kVec + 1] = a.y, x[l * kVec + 2] = a.z, x[l * kVec + 3] = a.w;
      t0[l * kVec] = c.x, t0[l * kVec + 1] = c.y, t0[l * kVec + 2] = c.z, t0[l * kVec + 3] = c.w;
      if (T == 2) {
        const float4 d = __ldg(reinterpret_cast<const float4*>(tag_p + HW + p));
        t1[l * kVec] = d.x, t1[l * kVec + 1] = d.y, t1[l * kVec + 2] = d.z, t1[l * kVec + 3] = d.w;
      }
    } else {
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const bool in = p + v < HW;
        x[l * kVec + v] = in ? det_p[p + v] : 0.0f;
        t0[l * kVec + v] = in ? tag_p[p + v] : 0.0f;
        if (T == 2) t1[l * kVec + v] = in ? tag_p[HW + p + v] : 0.0f;
      }
    }
    if (T == 1) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) t1[l * kVec + v] = 0.0f;
    }
  }

  // a thread with no pixel in the plane (last tile) offers key 0
  const int first = pixel_of(base, tid, 0);
  const bool has_first = first < HW;
  for (int si = 0; si < n; ++si) {
    const float q0 = prev_s[2 * si], q1 = prev_s[2 * si + 1];
    float bv = penalty<T>(x[0], t0[0], t1[0], q0, q1);
    int bi = first;
#pragma unroll
    for (int e = 1; e < kPix; ++e) {
      const float pv = penalty<T>(x[e], t0[e], t1[e], q0, q1);
      const int idx = pixel_of(base, tid, e);
      if (pv > bv && (full || idx < HW)) {
        bv = pv;
        bi = idx;
      }
    }
    const u64 key = warp_max(has_first ? make_key(bv, bi) : 0ull);
    if (lane == 0) red[warp * P + si] = key;
  }
  __syncthreads();
  for (int si = tid; si < n; si += kThreads) {
    u64 m = red[si];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const u64 o = red[w * P + si];
      m = o > m ? o : m;
    }
    atomicMax(best + bk * P + slot_of[si], m);
  }
}

__global__ void refine_finalize_kernel(const int* __restrict__ need,
                                       const u64* __restrict__ best,
                                       int* __restrict__ pos, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    pos[i] = need[i] != 0
                 ? static_cast<int>(0xFFFFFFFFu -
                                    static_cast<unsigned>(best[i] & 0xFFFFFFFFull))
                 : 0;
}

}  // namespace

// need: (B, K, P) int32, prev: (B, P, T) fp32, det: (B, K, H, W) fp32, tag:
// (B, K, T, H, W) fp32, all contiguous on the device; best: (B, K, P) uint64
// scratch, zero-filled by the caller; pos: (B, K, P) int32.  HW = H * W <
// 2^31 - 1, B * K <= 65535, T in {1, 2}; vec != 0 when HW % 4 == 0 and det
// and tag are 16-byte aligned.  Returns cudaGetLastError() after the two
// launches.
extern "C" int lp_refine_argmax(const int* need, const float* prev,
                                const float* det, const float* tag, void* best,
                                int* pos, int B, int K, int P, int T, int HW,
                                int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* scratch = static_cast<u64*>(best);
  const dim3 grid((HW + kTile - 1) / kTile, B * K);
  const size_t smem = static_cast<size_t>(P) * (kWarps * sizeof(u64) + 2 * sizeof(float) +
                                                sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        T == 1 ? refine_argmax_tile_kernel<1> : refine_argmax_tile_kernel<2>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (T == 1) {
    refine_argmax_tile_kernel<1><<<grid, kThreads, smem, s>>>(need, prev, det, tag,
                                                              scratch, P, K, HW, vec);
  } else {
    refine_argmax_tile_kernel<2><<<grid, kThreads, smem, s>>>(need, prev, det, tag,
                                                              scratch, P, K, HW, vec);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n = B * K * P;
  refine_finalize_kernel<<<(n + 255) / 256, 256, 0, s>>>(need, scratch, pos, n);
  return static_cast<int>(cudaGetLastError());
}
