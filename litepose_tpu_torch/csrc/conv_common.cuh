// What the conv kernels of a folded pair share: K6's depthwise conv
// (depthwise_conv.cu), K7's epilogue pass (conv_epilogue.cu), K8's conv with
// the epilogue in its store (dense_conv3x3.cu) and the squeeze-excitation
// (squeeze_excite.cu): the activations' codes, Swish and the sigmoid as the
// layers round them in bf16, and the multiply-high division they take their
// indices with.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace {

// the codes of ops.depthwise.ACTS; K8 takes the first three
constexpr int kActNone = 0, kActRelu6 = 1, kActRelu = 2, kActSilu = 3;

// torch.sigmoid of a bf16 value x on the card: ATen's 1 / (1 + exp(-x)) in
// fp32 (expf and an IEEE division: no fast math), rounded to bf16
__device__ __forceinline__ float sigmoid_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(1.0f / (1.0f + expf(-x))));
}

// Swish as the layers apply it to a bf16 value x, x * torch.sigmoid(x): the
// sigmoid rounded to bf16, then the product of the two bf16 values in fp32
// rounded to bf16 (returned as the fp32 value of that bf16)
__device__ __forceinline__ float silu_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x * sigmoid_bf16(x)));
}

// n / d for 0 <= n < 2^31 by a multiply-high and a shift: with l =
// ceil(log2 d) and m = ceil(2^(31 + l) / d), n / d = (n * m) >> (31 + l)
struct Divmod {
  int d;
  unsigned m;
  int shift;
};

inline Divmod divmod_of(int d) {
  Divmod f{d, 0u, 0};
  if (d > 1) {
    int l = 0;
    while ((1LL << l) < d) ++l;
    f.m = static_cast<unsigned>(((1ULL << (31 + l)) + d - 1) / d);
    f.shift = l - 1;
  }
  return f;
}

__device__ __forceinline__ int fast_div(int n, const Divmod& f) {
  return f.d == 1 ? n : static_cast<int>(__umulhi(static_cast<unsigned>(n), f.m) >> f.shift);
}

}  // namespace
