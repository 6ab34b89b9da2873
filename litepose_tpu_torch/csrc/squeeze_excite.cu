// Squeeze-excitation of an MBConv block at bf16 eval (EfficientHRNet's
// EfficientNet backbone): the mean of each (image, channel) plane of the
// depthwise conv's output y, two small linears with Swish and a sigmoid (the
// gate), and y scaled by its channel's gate, in two launches.
//
// Replaces no Pallas kernel: the JAX package leaves the block to XLA (a mean,
// two dots with their biases, Swish, a sigmoid, a broadcast multiply).  The
// port ran them as ATen ops: a cast of y to fp32, the mean, a cast back, two
// GEMMs and their bias adds, Swish as a sigmoid and a multiply, the sigmoid
// and the broadcast multiply, about nine launches a block, three of them
// passes over y or its fp32 copy.
//
// Contract, with the plain twin litepose_tpu_torch.ops.squeeze_excite.
// squeeze_excite_ref (the module's sequence):
//   * y (B, C, H, W) bf16 NCHW; w1 (R, C), b1 (R), w2 (C, R), b2 (C) bf16;
//     all contiguous; out of y's shape and layout, and it may be y itself (a
//     thread reads each element of y before it writes the same one of out);
//   * m = bf16(the fp32 mean of y's plane), as y.float().mean() cast back;
//   * h = Swish(bf16(bf16(m . w1[r]) + b1[r])): the dot's fp32 sum rounded
//     once, as a bf16 matmul rounds it, then the bias add rounded, then
//     Swish as the layers round it (conv_common.cuh);
//   * g = sigmoid(bf16(bf16(h . w2[c]) + b2[c])), rounded to bf16;
//   * out = bf16(y * g).
//   Every product of two bf16 values is exact in fp32, and every step rounds
//   where the twin rounds; only the order of the fp32 sums (the plane's, the
//   dots') differs from ATen's reduction and cuBLAS's, so an output differs
//   from the twin's where such a sum lies at a rounding boundary of its bf16
//   value: by an ulp of the gate, and then of out.
//
// What bounds it on an H100: bytes.  y is read twice (the mean, the scale)
// and out written once; the gate's own work (2 R C multiply-adds an image,
// R <= 44 and C <= 1056 in EfficientHRNet-H-1) is a few microseconds.  A
// least time of one read and one write of y is the kernel-free ideal, which
// a mean taken inside the depthwise conv's epilogue would reach.
//
// Design:
//   1. The gate kernel, grid (CTAs an image, B): one warp a plane at a time,
//      each lane 16-byte loads (8 bf16), four in flight, into four fp32
//      sums, then the lanes' sums by a shuffle tree: a fixed order, so a
//      launch gives the same means every time.  Each CTA, done with its
//      planes, makes its means visible (__threadfence) and counts itself in
//      on a per-image counter; the CTA that arrives last computes the
//      image's gate: the means rounded to bf16 in shared memory, the first
//      linear one warp an output (lanes across C, a shuffle tree), the
//      second one thread an output, and sets the counter back to 0 for the
//      next launch on the stream (the wrapper keeps one set of counters a
//      stream).
//   2. The scale kernel: a persistent grid walks y 8 elements (16 bytes) a
//      thread, each lane with its plane's gate (a plane of H W no multiple of
//      8, as 30^2 and 15^2 are, ends inside an item: the lanes walk across
//      it), bf16 products stored as 16 bytes; one element a thread where y
//      or out is off 16 bytes or B C H W no multiple of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "conv_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxShared = 48 * 1024;  // the means and the hidden layer, fp32
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float bf16_to_float(unsigned short h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the 8 bf16 values of a 16-byte word, summed in order into acc
__device__ __forceinline__ float add8(float acc, const uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc += __uint_as_float(w[i] << 16);
    acc += __uint_as_float(w[i] & 0xffff0000u);
  }
  return acc;
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

__global__ void __launch_bounds__(kThreads)
    squeeze_excite_gate_kernel(const unsigned short* __restrict__ y,
                               const unsigned short* __restrict__ w1,
                               const unsigned short* __restrict__ b1,
                               const unsigned short* __restrict__ w2,
                               const unsigned short* __restrict__ b2, float* __restrict__ means,
                               float* __restrict__ gate, unsigned* __restrict__ arrived, int C,
                               int HW, int R, int vec) {
  extern __shared__ float smem[];  // C means, then R hidden values
  __shared__ bool last;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c = blockIdx.x * kWarps + warp; c < C; c += gridDim.x * kWarps) {
    const long long plane = static_cast<long long>(b) * C + c;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (vec) {
      const uint4* p = reinterpret_cast<const uint4*>(y + plane * HW);
      const int n = HW / 8;
      int i = lane;
      for (; i + 96 < n; i += 128) {
        const uint4 v0 = p[i], v1 = p[i + 32], v2 = p[i + 64], v3 = p[i + 96];
        acc[0] = add8(acc[0], v0);
        acc[1] = add8(acc[1], v1);
        acc[2] = add8(acc[2], v2);
        acc[3] = add8(acc[3], v3);
      }
      for (; i < n; i += 32) acc[0] = add8(acc[0], p[i]);
    } else {
      const unsigned short* p = y + plane * HW;
      for (int i = lane; i < HW; i += 32) acc[0] += bf16_to_float(p[i]);
    }
    const float s = warp_sum((acc[0] + acc[1]) + (acc[2] + acc[3]));
    if (lane == 0) means[plane] = s / static_cast<float>(HW);
  }
  // this CTA's means are visible before it counts itself in
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(arrived + b, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last CTA of image b: its gate
  float* m = smem;
  float* h = smem + C;
  for (int c = threadIdx.x; c < C; c += kThreads)
    m[c] = round_bf16(__ldcg(means + static_cast<long long>(b) * C + c));
  __syncthreads();
  for (int r = warp; r < R; r += kWarps) {
    const unsigned short* row = w1 + static_cast<long long>(r) * C;
    float d = 0.0f;
    for (int c = lane; c < C; c += 32) d += m[c] * bf16_to_float(row[c]);
    d = warp_sum(d);
    if (lane == 0) h[r] = silu_bf16(round_bf16(round_bf16(d) + bf16_to_float(b1[r])));
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const unsigned short* row = w2 + static_cast<long long>(c) * R;
    float d = 0.0f;
    for (int r = 0; r < R; ++r) d += h[r] * bf16_to_float(row[r]);
    gate[static_cast<long long>(b) * C + c] =
        sigmoid_bf16(round_bf16(round_bf16(d) + bf16_to_float(b2[c])));
  }
  if (threadIdx.x == 0) arrived[b] = 0;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    squeeze_excite_scale_kernel(const unsigned short* y, const float* __restrict__ gate,
                                unsigned short* out, int n_items, int HW, Divmod by_hw) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_items; i += stride) {
    const int e = i * V;
    int plane = fast_div(e, by_hw);
    if constexpr (V == 8) {
      int pos = e - plane * HW;
      const uint4 v = reinterpret_cast<const uint4*>(y)[i];
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      uint32_t o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float g = gate[plane];
        const __nv_bfloat16 lo = __float2bfloat16_rn(__uint_as_float(w[j] << 16) * g);
        if (++pos == HW) {
          pos = 0;
          g = gate[++plane];
        }
        const __nv_bfloat16 hi = __float2bfloat16_rn(__uint_as_float(w[j] & 0xffff0000u) * g);
        if (++pos == HW) {
          pos = 0;
          ++plane;
        }
        o[j] = static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
               (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
      }
      reinterpret_cast<uint4*>(out)[i] = make_uint4(o[0], o[1], o[2], o[3]);
    } else {
      out[e] = __bfloat16_as_ushort(__float2bfloat16_rn(bf16_to_float(y[e]) * gate[plane]));
    }
  }
}

// SMs by device, 0 until the first launch asks
std::atomic<int> g_sms[kMaxDevices];

}  // namespace

// y (B, C, H, W) bf16 NCHW, w1 (R, C), b1 (R), w2 (C, R), b2 (C) bf16; means
// and gate fp32 scratch of B C each; arrived B unsigned counters, all 0 (and
// left 0); out of y's shape (may be y).  B C H W below 2^31, B at most 65535.
// Two launches.  Returns a CUDA error code.
extern "C" int lp_squeeze_excite(const void* y, const void* w1, const void* b1, const void* w2,
                                 const void* b2, void* means, void* gate, void* arrived,
                                 void* out, int B, int C, int H, int W, int R, void* stream) {
  const long long n = static_cast<long long>(B) * C * H * W;
  if (B < 1 || B > 65535 || C < 1 || H < 1 || W < 1 || R < 1 || n >= (1LL << 31) ||
      (C + R) * 4 > kMaxShared)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidValue);
  int sms = g_sms[dev].load(std::memory_order_relaxed);
  if (sms == 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    g_sms[dev].store(sms, std::memory_order_relaxed);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int HW = H * W;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  // enough warps to fill the card twice over (8 CTAs of 256 threads an SM),
  // no more CTAs an image than its planes need
  const int per_image = (C + kWarps - 1) / kWarps;
  const int fill = 16 * sms / B > 1 ? 16 * sms / B : 1;
  const dim3 grid(per_image < fill ? per_image : fill, B);
  squeeze_excite_gate_kernel<<<grid, kThreads, (C + R) * 4, st>>>(
      static_cast<const unsigned short*>(y), static_cast<const unsigned short*>(w1),
      static_cast<const unsigned short*>(b1), static_cast<const unsigned short*>(w2),
      static_cast<const unsigned short*>(b2), static_cast<float*>(means),
      static_cast<float*>(gate), static_cast<unsigned*>(arrived), C, HW, R,
      HW % 8 == 0 && aligned(y));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool vec = n % 8 == 0 && aligned(y) && aligned(out);
  const int n_items = static_cast<int>(vec ? n / 8 : n);
  const int needed = (n_items + kThreads - 1) / kThreads;
  const int resident = 8 * sms;
  const int blocks = needed < resident ? needed : resident;
  const Divmod by_hw = divmod_of(HW);
  const auto* y16 = static_cast<const unsigned short*>(y);
  auto* out16 = static_cast<unsigned short*>(out);
  const auto* g = static_cast<const float*>(gate);
  if (vec) {
    squeeze_excite_scale_kernel<8><<<blocks, kThreads, 0, st>>>(y16, g, out16, n_items, HW, by_hw);
  } else {
    squeeze_excite_scale_kernel<1><<<blocks, kThreads, 0, st>>>(y16, g, out16, n_items, HW, by_hw);
  }
  return static_cast<int>(cudaGetLastError());
}
