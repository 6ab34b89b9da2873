// What the two kernels after a folded dense conv share: K7's epilogue pass
// (conv_epilogue.cu) and K8's conv with the epilogue in its store
// (dense_conv3x3.cu): the activations' codes and the multiply-high division
// both take their indices with.

#pragma once

#include <cstdint>

namespace {

constexpr int kActNone = 0, kActRelu6 = 1, kActRelu = 2;

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
