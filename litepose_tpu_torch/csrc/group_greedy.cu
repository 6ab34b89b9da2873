// Greedy associative-embedding grouping (K2), one warp per image.
//
// Replaces the greedy branch of the Pallas TPU kernel `_group_kernel`
// (litepose_tpu/ops/pallas_group.py, reached through
// `match_by_tag_batch_pallas`).  The per-joint loop, the cost and the
// join/spawn bookkeeping are shared with K3 (group_common.cuh); the
// assignment here: min(M, P) rounds of global-min assignment over the
// BIG-masked cost, ties to the lowest row-major index, bit for bit with the
// plain twin `litepose_tpu_torch.ops.hungarian.greedy_assign`.
//
// Design.  The TPU kernel lays 128 images on the vector lanes; here each
// image is one warp and each peak row m is one lane.  A lane keeps its row's
// first minimum; a round is a 5-step shuffle argmin over the lanes, and
// only rows whose minimum sat in the killed column rescan.
//
// What bounds it: it is latency-bound (14 steps x 30 dependent rounds per
// image, a few hundred instructions each) and moves only
// B*K*M*(T+2)*4 bytes; at serving batch sizes the 64 warps do not fill
// the card, which matters little next to the forward pass.

#include "group_common.cuh"

namespace {

using namespace lp_group;

struct GreedyAssign {
  __device__ int operator()(Shared& sh, const Step& st, int lane, int M,
                            int P) const {
    float rmin = kBig;
    int rarg = 0;
    if (st.has) {
      for (int g = 0; g < P; ++g) {
        const float c = sh.cost[lane][g];
        if (c < rmin) {
          rmin = c;
          rarg = g;
        }
      }
    }
    int assign = M;  // M = unassigned
    bool row_dead = false;
    const int rounds = min(M, P);
    for (int it = 0; it < rounds; ++it) {
      float bv = rmin;
      int bi = lane * P + rarg;
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, off);
        const int oi = __shfl_xor_sync(kFull, bi, off);
        if (ov < bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (!(bv < kBig)) break;  // warp-uniform: nothing left to assign
      const int ms = bi / P;
      const int gs = bi % P;
      if (lane == ms) {
        assign = gs;
        row_dead = true;
        rmin = kBig;
      }
      if (st.has && !row_dead) {
        sh.cost[lane][gs] = kBig;
        if (rarg == gs) {
          rmin = kBig;
          rarg = 0;
          for (int g = 0; g < P; ++g) {
            const float c = sh.cost[lane][g];
            if (c < rmin) {
              rmin = c;
              rarg = g;
            }
          }
        }
      }
    }
    return assign;
  }
};

__global__ void __launch_bounds__(32)
    group_greedy_kernel(const float* __restrict__ tag,
                        const float* __restrict__ val,
                        const int* __restrict__ order, int* __restrict__ cid,
                        int* __restrict__ ncl, int K, int M, int T,
                        int n_steps, int P, int PC, float det_thr,
                        float tag_thr, int use_val, int ignore_too_much) {
  __shared__ Shared sh;
  group_image(sh, GreedyAssign{}, /*mask_rows=*/true, tag, val, order, cid,
              ncl, K, M, T, n_steps, P, PC, det_thr, tag_thr, use_val,
              ignore_too_much);
}

}  // namespace

// tag: (B, K, M, T) fp32, val: (B, K, M) fp32, order: (n_steps,) int32 on
// the device; cid: (B, K, M) int32, ncl: (B,) int32.  Requires M <= 32,
// P <= 32, T in {1, 2}.  Returns cudaGetLastError() after the launch.
extern "C" int lp_group_greedy(const float* tag, const float* val,
                               const int* order, int* cid, int* ncl, int B,
                               int K, int M, int T, int n_steps, int P,
                               int PC, float det_thr, float tag_thr,
                               int use_val, int ignore_too_much,
                               void* stream) {
  group_greedy_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      tag, val, order, cid, ncl, K, M, T, n_steps, P, PC, det_thr, tag_thr,
      use_val, ignore_too_much);
  return static_cast<int>(cudaGetLastError());
}
