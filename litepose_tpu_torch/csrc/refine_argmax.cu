// Penalized argmax of the refine step (K4), one CTA per (image, joint).
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
// Design.  The TPU kernel holds one (image, joint) plane in VMEM and serves
// every person slot from it.  At eval sizes a plane does not fit in shared
// memory (448 x 448 fp32 is 784 KB, T = 2 tags add 1.6 MB), so the CTA
// streams the plane once for all its needed slots: the block first lists
// the needed slots (up to kSlots per pass; more slots take more passes)
// and their mean tags in shared memory, then each thread walks the pixels
// i = tid, tid + 256, ... in increasing order, keeping a running (max,
// index) per listed slot in registers (a strict > keeps the first index),
// and a shuffle + shared-memory reduction per slot picks the larger value,
// the lower index on ties.
//
// What bounds it: the arithmetic.  Each pixel is read once (4 (1 + T)
// bytes), and each needed slot costs about 15 instructions per pixel, the
// IEEE square root and rint among them; with tens of needed slots per
// plane the kernel is compute-bound, far above the plane's read time.
//
// Exactness: the round-to-nearest intrinsics keep nvcc from contracting
// d0*d0 + d1*d1 into an FMA (the library is also built with --fmad=false);
// rintf rounds half to even, as torch.round and jnp.round do.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 40;  // slots served per pass over the plane
constexpr unsigned kFull = 0xffffffffu;

// (ov, oi) beats (v, i): a larger value, or an equal value at a lower
// index; index -1 marks a thread that saw no pixel.
__device__ __forceinline__ bool beats(float ov, int oi, float v, int i) {
  return oi >= 0 && (i < 0 || ov > v || (ov == v && oi < i));
}

template <int T>
__global__ void __launch_bounds__(kThreads)
    refine_argmax_kernel(const int* __restrict__ need,
                         const float* __restrict__ prev,
                         const float* __restrict__ det,
                         const float* __restrict__ tag, int* __restrict__ pos,
                         int K, int P, int HW) {
  __shared__ int slot_of[kSlots];
  __shared__ float prev_s[kSlots][2];
  __shared__ int n_listed;
  __shared__ float red_v[kWarps][kSlots];
  __shared__ int red_i[kWarps][kSlots];

  const int bk = blockIdx.x;  // b * K + k
  const int b = bk / K;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int* need_bk = need + static_cast<size_t>(bk) * P;
  int* pos_bk = pos + static_cast<size_t>(bk) * P;
  const float* det_p = det + static_cast<size_t>(bk) * HW;
  const float* tag_p = tag + static_cast<size_t>(bk) * T * HW;
  const float* prev_b = prev + static_cast<size_t>(b) * P * T;

  for (int s = tid; s < P; s += kThreads) pos_bk[s] = 0;

  for (int base = 0; base < P; base += kSlots) {
    __syncthreads();
    if (tid == 0) {
      int n = 0;
      for (int s = base; s < min(P, base + kSlots); ++s) {
        if (need_bk[s] != 0) {
          slot_of[n] = s;
          prev_s[n][0] = prev_b[s * T];
          prev_s[n][1] = T == 2 ? prev_b[s * T + 1] : 0.0f;
          ++n;
        }
      }
      n_listed = n;
    }
    __syncthreads();
    const int n = n_listed;
    if (n == 0) continue;  // block-uniform

    float best[kSlots];
    int arg[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      best[s] = -INFINITY;
      arg[s] = -1;
    }
    for (int i = tid; i < HW; i += kThreads) {
      const float x = det_p[i];
      const float t0 = tag_p[i];
      const float t1 = T == 2 ? tag_p[HW + i] : 0.0f;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (s < n) {
          float tt;
          if (T == 1) {
            tt = fabsf(__fsub_rn(t0, prev_s[s][0]));
          } else {
            const float d0 = __fsub_rn(t0, prev_s[s][0]);
            const float d1 = __fsub_rn(t1, prev_s[s][1]);
            tt = __fsqrt_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)));
          }
          const float penal = __fsub_rn(x, rintf(tt));
          if (arg[s] < 0 || penal > best[s]) {
            best[s] = penal;
            arg[s] = i;
          }
        }
      }
    }

#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (s < n) {
        float v = best[s];
        int a = arg[s];
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(kFull, v, off);
          const int oa = __shfl_xor_sync(kFull, a, off);
          if (beats(ov, oa, v, a)) {
            v = ov;
            a = oa;
          }
        }
        if (lane == 0) {
          red_v[warp][s] = v;
          red_i[warp][s] = a;
        }
      }
    }
    __syncthreads();
    if (tid < n) {
      float v = red_v[0][tid];
      int a = red_i[0][tid];
      for (int w = 1; w < kWarps; ++w) {
        if (beats(red_v[w][tid], red_i[w][tid], v, a)) {
          v = red_v[w][tid];
          a = red_i[w][tid];
        }
      }
      pos_bk[slot_of[tid]] = a;
    }
  }
}

}  // namespace

// need: (B, K, P) int32, prev: (B, P, T) fp32, det: (B, K, H, W) fp32, tag:
// (B, K, T, H, W) fp32, all contiguous on the device; pos: (B, K, P) int32.
// HW = H * W.  Requires T in {1, 2}.  Returns cudaGetLastError() after the
// launch.
extern "C" int lp_refine_argmax(const int* need, const float* prev,
                                const float* det, const float* tag, int* pos,
                                int B, int K, int P, int T, int HW,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T == 1) {
    refine_argmax_kernel<1><<<B * K, kThreads, 0, s>>>(need, prev, det, tag,
                                                       pos, K, P, HW);
  } else {
    refine_argmax_kernel<2><<<B * K, kThreads, 0, s>>>(need, prev, det, tag,
                                                       pos, K, P, HW);
  }
  return static_cast<int>(cudaGetLastError());
}
