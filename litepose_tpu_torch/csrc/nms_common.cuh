// The window max of the NMS kernels (K1 csrc/nms_topk.cu, K1'
// csrc/nms_topk_loop.cu, K5 csrc/heatmap_nms.cu).
//
// The plain twins take the window max with torch's max_pool2d and the TPU
// kernels with jnp.maximum; both propagate a NaN, so every cell whose
// window holds a NaN fails the equality test and becomes +0 (the NaN cell
// too: NaN == NaN is false).  fmaxf drops a NaN and would keep the largest
// finite neighbour of one; max.NaN.f32 (sm_80 and later) returns NaN when
// either operand is NaN, in one instruction like fmaxf.

#pragma once

namespace {

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

}  // namespace
