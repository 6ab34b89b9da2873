// Associative-embedding grouping with the exact Jonker-Volgenant assignment
// (K3), one warp per image.
//
// Replaces `_jv_assign` (litepose_tpu/ops/pallas_group.py:56), the
// Hungarian branch of the Pallas TPU kernel `_group_kernel`.  The per-joint
// loop, the cost and the join/spawn bookkeeping are K2's
// (group_common.cuh); each joint step assigns the first n_solve =
// (do_match ? n_valid : 0) rows of the full PAD-padded M x M cost, n_valid
// the rows above the detection threshold (a prefix: scores arrive sorted).
// Bit for bit with the plain twin
// `litepose_tpu_torch.ops.hungarian.hungarian_prefix`, which follows the
// TPU kernel op for op: the grouping's costs tie often (a tag distance
// rounded to an integer, times 100), so only the same fp32 operations in
// the same order give the same people.
//
// The solver, per row i = 1..n_solve, 1-indexed columns with a sentinel
// column 0:
//   sweep: used[j0] = 1; i0 = p[j0]; cur_j = (a[i0][j] - u[i0]) - v_j;
//     minv_j, way_j = cur_j, j0 where cur_j < minv_j on unused j;
//     delta, j1 = the first minimum of minv over unused j >= 1 (INF = 1e18
//     elsewhere); u[p[j]] += delta, v_j -= delta on used j, minv_j -= delta
//     on unused j; j0 = j1; stop when p[j1] == 0 (at most i + 1 sweeps);
//   augment: walk `way` back from j0 to column 0, p[j0] = p[way[j0]].
//
// Design.  The TPU kernel lays 128 images on the vector lanes and turns
// every gather into a one-hot reduction.  Here each image is one warp and
// lane j owns column j of the padded problem (M + 1 = 31 columns for M =
// 30; lane 31 idles at INF): its v, minv, used, way and p live in
// registers, u and the cost in shared memory.  p[j0] and way[j0] are one
// shuffle each; the argmin is a 5-step shuffle reduction over (value,
// column) that keeps the lowest column on ties, as jnp.argmin does.
//
// What bounds it: latency.  A sweep is a chain of about 40 dependent
// instructions (two shuffles, a shared load, the 5-step reduction); an
// image runs up to 14 steps x sum_{i<=30} (i + 1) sweeps, most steps far
// fewer.  64 images fill 64 of the 132 SMs with one warp each.

#include "group_common.cuh"

namespace {

using namespace lp_group;

constexpr float kInf = 1e18f;

struct HungarianAssign {
  __device__ int operator()(Shared& sh, const Step& st, int lane, int M,
                            int P) const {
    const int n = M;  // square: M peaks == P columns (checked by the wrapper)
    const int n_valid = __popc(__ballot_sync(kFull, st.mask));
    const int n_solve = st.do_match ? n_valid : 0;  // warp-uniform

    sh.u[lane] = 0.0f;
    float v = 0.0f;
    int p = 0;  // p[lane]: row (1-indexed) of column `lane`, 0 = free
    __syncwarp();
    for (int r = 0; r < n_solve; ++r) {
      const int i = r + 1;
      if (lane == 0) p = i;
      float minv = kInf;
      bool used = false;
      int way = 0;
      int j0 = 0;
      for (int sweep = 0; sweep <= i; ++sweep) {
        if (lane == j0) used = true;
        const int i0 = __shfl_sync(kFull, p, j0);
        const float u_i0 = sh.u[i0];
        const float a = (lane >= 1 && lane <= n) ? sh.cost[i0 - 1][lane - 1] : 0.0f;
        const float cur = __fsub_rn(__fsub_rn(a, u_i0), v);
        if (cur < minv && !used) {
          minv = cur;
          way = j0;
        }
        float bv = (used || lane == 0 || lane > n) ? kInf : minv;
        int bj = lane;
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(kFull, bv, off);
          const int oj = __shfl_xor_sync(kFull, bj, off);
          if (ov < bv || (ov == bv && oj < bj)) {
            bv = ov;
            bj = oj;
          }
        }
        const float delta = bv;
        __syncwarp();  // every lane has read u[i0]
        // the used columns' rows are distinct: no two lanes share a u slot
        if (used) {
          sh.u[p] = __fadd_rn(sh.u[p], delta);
          v = __fsub_rn(v, delta);
        } else {
          minv = __fsub_rn(minv, delta);
        }
        __syncwarp();
        j0 = bj;
        if (__shfl_sync(kFull, p, j0) == 0) break;  // warp-uniform
      }
      for (int s = 0; s <= i && j0 != 0; ++s) {  // augment
        const int j1 = __shfl_sync(kFull, way, j0);
        const int p_j1 = __shfl_sync(kFull, p, j1);
        if (lane == j0) p = p_j1;
        j0 = j1;
      }
    }
    // invert: row m holds column j - 1 where p[j] == m + 1; M = unassigned
    sh.assign[lane] = M;
    __syncwarp();
    if (lane >= 1 && lane <= n && p >= 1) sh.assign[p - 1] = lane - 1;
    __syncwarp();
    const int a = sh.assign[lane];
    __syncwarp();
    return a;
  }
};

__global__ void __launch_bounds__(32)
    group_hungarian_kernel(const float* __restrict__ tag,
                           const float* __restrict__ val,
                           const int* __restrict__ order,
                           int* __restrict__ cid, int* __restrict__ ncl, int K,
                           int M, int T, int n_steps, int P, int PC,
                           float det_thr, float tag_thr, int use_val,
                           int ignore_too_much) {
  __shared__ Shared sh;
  group_image(sh, HungarianAssign{}, /*mask_rows=*/false, tag, val, order,
              cid, ncl, K, M, T, n_steps, P, PC, det_thr, tag_thr, use_val,
              ignore_too_much);
}

}  // namespace

// tag: (B, K, M, T) fp32, val: (B, K, M) fp32 (sorted descending per
// joint), order: (n_steps,) int32 on the device; cid: (B, K, M) int32, ncl:
// (B,) int32.  Requires M == P <= 31, T in {1, 2}.  Returns
// cudaGetLastError() after the launch.
extern "C" int lp_group_hungarian(const float* tag, const float* val,
                                  const int* order, int* cid, int* ncl, int B,
                                  int K, int M, int T, int n_steps, int P,
                                  int PC, float det_thr, float tag_thr,
                                  int use_val, int ignore_too_much,
                                  void* stream) {
  group_hungarian_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      tag, val, order, cid, ncl, K, M, T, n_steps, P, PC, det_thr, tag_thr,
      use_val, ignore_too_much);
  return static_cast<int>(cudaGetLastError());
}
