// The epilogue of a folded dense conv at bf16 eval: the folded-BN bias, an
// optional residual (of the output's shape, or a finer sum the output is
// nearest-upsampled into), then none, ReLU, ReLU6 or Swish, as one pass over
// the conv's output (K7).
//
// Replaces no Pallas kernel: the JAX package leaves every convolution to
// lax.conv_general_dilated and the bias add, residual add and activation
// after it to XLA, which fuses them.  The port ran them as ATen ops after
// cuDNN's conv: a per-call bias.to(bf16) copy (LitePose's fp32 bias), a
// broadcast add of the (C, 1, 1) bias (TensorIterator's generic, unvectorized
// elementwise kernel), the residual add or, in HigherHRNet's fuse, a nearest
// upsample and then the add, and a clamp or relu: up to five passes over the
// output and five launches where one does.
//
// Contract, with the plain twin litepose_tpu_torch.ops.epilogue.
// conv_epilogue_ref (+ bias.to(bf16), the upsample, + residual, clamp / relu):
//   * y (B, C, H, W) bf16, NCHW-contiguous or channels-last; bias (C) fp32
//     or bf16, contiguous; residual, when given, in y's layout, of y's shape
//     or of (B, C, H << k, W << k) for k in 1..3; out of the residual's
//     shape, else y's, in y's layout, and where it is y's shape it may be y
//     itself (layers.conv_bn holds its conv's output privately and lets the
//     epilogue overwrite it: a thread reads each element of y before it
//     writes the same element of out, so y and out are not restrict);
//   * t = bf16(y + bf16(bias)): the bias rounded to nearest even
//     (__float2bfloat16_rn, as bias.to(bf16) rounds it on the card), the sum
//     taken in fp32 and rounded once, as ATen's bf16 add;
//   * with a residual r, bf16(t' + r), t' the element of t at (h >> k,
//     w >> k): nearest upsampling copies, and the fp32 sum of two bf16
//     values commutes, so this is upsample(t) + r and r + upsample(t);
//   * then ReLU6 or ReLU as ATen's clamp(x, 0, 6) and clamp_min(x, 0) (what
//     torch.relu runs): a NaN is returned as it is, anything else through
//     the same fp32 max / min ATen's kernels take after their NaN test, so
//     NaN, +-0 and +-inf come out as they come out of ATen; or Swish as
//     the layers round it, x * torch.sigmoid(x) (conv_common.cuh: ATen's
//     sigmoid in fp32 rounded to bf16, then the product rounded).
// Every step rounds as the unfused sequence does and no sum is reordered:
// the output equals it bit for bit.
//
// What bounds it on an H100: bytes.  An element costs 4 bytes (y read, out
// written), 6 with a residual, against one or two fp32 adds and a max: the
// epilogues of a LitePose-Auto-S@448 call at b64 move about 9.7 GB, those of
// a HigherHRNet-W48@640 forward at b16 about 21 GB, 2.9 and 6.3 ms at
// 3.35 TB/s.
//
// Design:
//   1. 16 bytes a thread: each work item is 8 consecutive elements of the
//      output in memory, loaded, computed in registers and stored as
//      16-byte ld.global / st.global (the same code at 1 element an item
//      where a base is off 16 bytes or the element count no multiple of 8).
//   2. A persistent grid: as many CTAs of 256 threads as the card holds at
//      once, at most one an item's worth; each walks the items with the
//      grid's stride, so LitePose's 14^2 and 7^2 planes and W48's 20^2
//      branch fill the card as its 160^2 planes do, and no tail wave idles.
//   3. The bias, rounded to bf16 once, lives in shared memory: each CTA
//      stages its C values when it starts.  An item's lanes take their
//      channel from the layout: channels-last, 8 consecutive channels (one
//      16-byte shared load where C is a multiple of 8, as every width of the
//      served models is); NCHW, one channel for the 8 lanes where H*W is a
//      multiple of 8, else a walk across the plane boundary (Auto-S's 14^2
//      and 7^2 planes).  The divisions by C and H*W are a multiply-high and
//      a shift (Divmod).
//   4. The upsampled residual: items walk the output as in the other
//      instances, and an item reads y's element at (h >> k, w >> k), 8
//      channels at once (channels-last; one element NCHW).  4^k items read
//      each element of y, all but the first from L2 (y is a 4^k-th of the
//      output), so HBM sees y once, where ATen wrote the upsampled copy and
//      read it back.  (A first design, a thread a pixel of y writing the
//      2^k x 2^k outputs it covers, left a 4^k-th of the threads to walk
//      those blocks serially: 34-61% of the bound at W48's fuse shapes.)
//   5. The layout, the width of an item and the instance (no residual,
//      residual of y's shape, upsampled) are chosen from what the launch
//      sees: the pointers' alignment, C, H*W and the residual's shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "conv_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 24576;  // the bias in shared memory: 48 KB of bf16
constexpr int kNoResidual = 0, kSameShape = 1, kUpsampled = 2;

struct Params {
  int n_items;       // items of the output: its elements over the item's width
  int C;
  int inner;         // elements from one channel to the next: 1 (channels-last) or Ho*Wo
  int nhwc;
  int lanes;         // kSameChannel, kConsecutive or kWalk (below)
  Divmod by_inner, by_c;
  // y's H and W, the shift k of an upsampled residual, and out's Ho, Wo
  int H, W, k, Ho, Wo;
  Divmod by_w, by_h;  // by Wo and Ho
};

// how an item's lanes find their channels
constexpr int kSameChannel = 0;  // NCHW, H*W a multiple of the width: one channel
constexpr int kConsecutive = 1;  // channels-last, C a multiple of the width: c0, c0 + 1, ...
constexpr int kWalk = 2;         // anything else: lane by lane across the boundaries

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

// ATen's clamp / clamp_min on a bf16 value in fp32: NaN returned as it is,
// else the fp32 max and min after the NaN test (their +-0 and inf rules)
__device__ __forceinline__ float activate(float v, int act) {
  if (act == kActNone || isnan(v)) return v;
  v = fmaxf(v, 0.0f);
  return act == kActRelu6 ? fminf(v, 6.0f) : v;
}

// bf16(a + b) for two bf16 values, as bits: fp32 sum, rounded to nearest even
__device__ __forceinline__ uint32_t add_bf16(uint32_t a, uint32_t b) {
  const __nv_bfloat16 s =
      __float2bfloat16_rn(bf16_bits_to_float(a) + bf16_bits_to_float(b));
  return __bfloat16_as_ushort(s);
}

__device__ __forceinline__ uint32_t act_bf16(uint32_t a, int act) {
  if (act == kActNone) return a;
  const float v = bf16_bits_to_float(a);
  return __bfloat16_as_ushort(
      __float2bfloat16_rn(act == kActSilu ? silu_bf16(v) : activate(v, act)));
}

template <int V>
struct Vec;
template <>
struct Vec<8> {
  using T = uint4;
};
template <>
struct Vec<1> {
  using T = unsigned short;
};

template <int V>
__device__ __forceinline__ void unpack(const typename Vec<V>::T& v, uint32_t (&e)[V]) {
  if constexpr (V == 8) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      e[2 * i] = w[i] & 0xffffu;
      e[2 * i + 1] = w[i] >> 16;
    }
  } else {
    e[0] = v;
  }
}

template <int V>
__device__ __forceinline__ typename Vec<V>::T pack(const uint32_t (&e)[V]) {
  if constexpr (V == 8) {
    return make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16), e[4] | (e[5] << 16),
                      e[6] | (e[7] << 16));
  } else {
    return static_cast<unsigned short>(e[0]);
  }
}

// the bf16 bias of each of an item's V lanes, the item's first element at e
template <int V>
__device__ __forceinline__ void lane_bias(const Params& p, const unsigned short* sbias, int e,
                                          uint32_t (&b)[V]) {
  const int q = fast_div(e, p.by_inner);
  int c = q - fast_div(q, p.by_c) * p.C;
  if (p.lanes == kSameChannel) {
#pragma unroll
    for (int l = 0; l < V; ++l) b[l] = sbias[c];
  } else if (p.lanes == kConsecutive) {
    if constexpr (V == 8) {
      unpack<8>(*reinterpret_cast<const uint4*>(sbias + c), b);
    } else {
#pragma unroll
      for (int l = 0; l < V; ++l) b[l] = sbias[c + l];
    }
  } else {
    int pos = e - q * p.inner;
#pragma unroll
    for (int l = 0; l < V; ++l) {
      b[l] = sbias[c];
      if (++pos == p.inner) {
        pos = 0;
        c = c + 1 == p.C ? 0 : c + 1;
      }
    }
  }
}

template <int V, int kMode>
__global__ void __launch_bounds__(kThreads)
    conv_epilogue_kernel(const unsigned short* y, const void* __restrict__ bias, int bias_bf16,
                         const unsigned short* __restrict__ res, unsigned short* out,
                         const Params p, int act) {
  using T = typename Vec<V>::T;
  extern __shared__ __align__(16) unsigned short sbias[];
  for (int c = threadIdx.x; c < p.C; c += blockDim.x) {
    sbias[c] = bias_bf16 ? static_cast<const unsigned short*>(bias)[c]
                         : __bfloat16_as_ushort(
                               __float2bfloat16_rn(static_cast<const float*>(bias)[c]));
  }
  __syncthreads();
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < p.n_items; i += stride) {
    // the item: V elements of the output from element e on; the residual's
    // are the same elements, y's the same unless y is upsampled into it
    const int e = i * V;
    uint32_t t[V], b[V];
    if constexpr (kMode == kUpsampled) {
      // y's element under output (h, w) is at (h >> k, w >> k) of its plane;
      // channels-last items are V channels of one pixel, NCHW ones (V == 1)
      // one element
      long long ye;
      if (p.nhwc) {
        const int px = fast_div(e, p.by_c);
        const int c = e - px * p.C;
        const int bh = fast_div(px, p.by_w);
        const int w = px - bh * p.Wo;
        const int b_ = fast_div(bh, p.by_h);
        const int h = bh - b_ * p.Ho;
        ye = ((static_cast<long long>(b_) * p.H + (h >> p.k)) * p.W + (w >> p.k)) * p.C + c;
      } else {
        const int plane = fast_div(e, p.by_inner);
        const int pos = e - plane * p.inner;
        const int h = fast_div(pos, p.by_w);
        const int w = pos - h * p.Wo;
        ye = (static_cast<long long>(plane) * p.H + (h >> p.k)) * p.W + (w >> p.k);
      }
      unpack<V>(*reinterpret_cast<const T*>(y + ye), t);
    } else {
      unpack<V>(reinterpret_cast<const T*>(y)[i], t);
    }
    lane_bias<V>(p, sbias, e, b);
#pragma unroll
    for (int l = 0; l < V; ++l) t[l] = add_bf16(t[l], b[l]);
    if constexpr (kMode != kNoResidual) {
      uint32_t r[V];
      unpack<V>(reinterpret_cast<const T*>(res)[i], r);
#pragma unroll
      for (int l = 0; l < V; ++l) t[l] = add_bf16(t[l], r[l]);
    }
#pragma unroll
    for (int l = 0; l < V; ++l) t[l] = act_bf16(t[l], act);
    reinterpret_cast<T*>(out)[i] = pack<V>(t);
  }
}

constexpr int kMaxDevices = 64;
// CTAs the card holds at once, by device and instance (2 widths x 3
// modes); 0 until the first launch asks
std::atomic<int> g_resident[kMaxDevices][6];

template <int V, int kMode>
cudaError_t launch(const Params& p, const void* y, const void* bias, int bias_bf16,
                   const void* res, void* out, int act, cudaStream_t stream) {
  const void* kernel = reinterpret_cast<const void*>(&conv_epilogue_kernel<V, kMode>);
  const int smem = ((p.C + 7) / 8) * 16;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices || smem > 48 * 1024) return cudaErrorInvalidValue;
  std::atomic<int>& cached = g_resident[dev][3 * (V == 8) + kMode];
  int resident = cached.load(std::memory_order_relaxed);
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident = sms * per_sm;
    cached.store(resident, std::memory_order_relaxed);
  }
  const int needed = (p.n_items + kThreads - 1) / kThreads;
  const unsigned short* y16 = static_cast<const unsigned short*>(y);
  const unsigned short* res16 = static_cast<const unsigned short*>(res);
  unsigned short* out16 = static_cast<unsigned short*>(out);
  Params params = p;
  void* args[] = {&y16, &bias, &bias_bf16, &res16, &out16, &params, &act};
  // the launch's own error code: no cudaGetLastError after it
  return cudaLaunchKernel(kernel, dim3(needed < resident ? needed : resident), dim3(kThreads),
                          args, smem, stream);
}

template <int V>
cudaError_t launch_mode(int mode, const Params& p, const void* y, const void* bias,
                        int bias_bf16, const void* res, void* out, int act, cudaStream_t st) {
  switch (mode) {
    case kNoResidual: return launch<V, kNoResidual>(p, y, bias, bias_bf16, res, out, act, st);
    case kSameShape: return launch<V, kSameShape>(p, y, bias, bias_bf16, res, out, act, st);
    default: return launch<V, kUpsampled>(p, y, bias, bias_bf16, res, out, act, st);
  }
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

// y (B, C, H, W) bf16, NCHW (nhwc 0) or channels-last (nhwc 1); bias (C)
// fp32 (bias_bf16 0) or bf16; res null, of y's shape (k 0) or (B, C, H << k,
// W << k) (k 1..3), in y's layout; out of res's shape, else y's (and then
// may be y); act 0 none, 1 ReLU6, 2 ReLU, 3 Swish.  Every element count
// below 2^31.
// Returns a CUDA error code.
extern "C" int lp_conv_epilogue(const void* y, const void* bias, int bias_bf16, const void* res,
                                void* out, int B, int C, int H, int W, int k, int nhwc, int act,
                                void* stream) {
  const long long n = static_cast<long long>(B) * C * H * W;
  if (B < 0 || C < 1 || C > kMaxChannels || H < 0 || W < 0 || k < 0 || k > 3 ||
      (k > 0 && res == nullptr) || act < kActNone || act > kActSilu ||
      (n << (2 * k)) >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int mode = res == nullptr ? kNoResidual : k == 0 ? kSameShape : kUpsampled;
  const int Ho = H << k, Wo = W << k;
  const long long n_out = n << (2 * k);
  // 8 elements an item where the pointers and shapes allow (an upsampled
  // item is 8 channels of one pixel, channels-last), else one
  const bool fits = mode == kUpsampled ? nhwc && C % 8 == 0 : n % 8 == 0;
  const int V = fits && aligned(y, 16) && aligned(out, 16) &&
                (res == nullptr || aligned(res, 16)) ? 8 : 1;
  Params p{};
  p.n_items = static_cast<int>(n_out / V);
  p.C = C;
  p.inner = nhwc ? 1 : Ho * Wo;  // elements of the output from one channel to the next
  p.nhwc = nhwc;
  p.lanes = !nhwc && p.inner % V == 0 ? kSameChannel
            : nhwc && C % V == 0      ? kConsecutive
                                      : kWalk;
  p.by_inner = divmod_of(p.inner);
  p.by_c = divmod_of(C);
  p.H = H;
  p.W = W;
  p.k = k;
  p.Ho = Ho;
  p.Wo = Wo;
  p.by_w = divmod_of(Wo);
  p.by_h = divmod_of(Ho);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(V == 8 ? launch_mode<8>(mode, p, y, bias, bias_bf16, res, out, act, st)
                                 : launch_mode<1>(mode, p, y, bias, bias_bf16, res, out, act, st));
}
