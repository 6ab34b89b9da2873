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
// What bounds it on an H100: the dependent chain of one sweep.  Bytes and
// operations are nothing (0.0002 ms at 64 images); the sweeps of a row, the
// rows of a joint step and the joint steps are sequential, and the twin's
// exact steps are required, so an image's time is its number of sweeps and
// augment steps (up to 2596 + 800 for the all-valid image of chip_smoke.py)
// times the latency of one.  64 images fill 64 of the 132 SMs with one
// warp each.
//
// Design: a sweep as a short chain.  Lane j owns column j of the padded
// problem (M + 1 = 31 columns for M = 30; lanes past M idle): its v, minv
// (with minv's order-preserving key), used, way, p and, in registers, the
// potential u of the row on it, up = u[p[j]].  The twin adds delta to
// u[p[j]] for the used columns and p does not change during a search, so
// `up += delta` on the used lanes is the same update, and the potential of
// the row a sweep reaches is a shuffle from j0 that needs no row index.  A
// sweep is: that shuffle beside the shared load of the row's cost (row-major,
// stride 33; the row's offset rides along with j0); two subtractions and the
// minv select (the key of cur computed beside the compare); the masked key
// (INF's key for column 0 and used columns, as the twin masks them; lanes
// past M above every key); one `__reduce_min_sync` for the least key and a
// second over (lane, p, row offset) of the lanes holding it, whose least is
// the first minimum j1, p[j1] (the break test) and the next row's offset at
// once; delta decoded from the least key.  The updates of up, v and minv
// run beside the next sweep's shuffle and load.  No shared-memory potential
// and no barrier inside a sweep.  The augment reads p[way[j]] and its up on
// every lane in one shuffle each first (each path column's p[way[j]] is read
// before the walk rewrites it), then the walk only chases `way`: one
// shuffle a step.  The cost build is straight-line code over 32 columns
// (`cost_row`), so the columns' square roots and roundings interleave.
//
// The key maps -0.0 to +0.0, so the decoded delta is +0.0 where the least
// masked minv is a zero of either sign; no -0.0 arises from these costs
// (every value is a difference of finite floats starting from +0.0 and
// non-negative distances), and a zero's sign could change only another
// zero's sign, never an assignment.

#include "group_common.cuh"

namespace {

using namespace lp_group;

constexpr float kInf = 1e18f;

template <int T>
struct HungarianAssign {
  float (&cost)[kMaxRows][kMaxCols + 1];
  int (&inverse)[kMaxRows];

  __device__ int assign(const Step& st, const Clusters<T>& cl, int lane, int M, int P,
                        int use_val) {
    float row[kMaxCols];
    cost_row<T>(st, cl, use_val, row);
#pragma unroll
    for (int g = 0; g < kMaxCols; ++g) {
      if (st.has && g < P) cost[lane][g] = row[g];
    }
    const int n = M;  // square: M peaks == P columns (checked by the wrapper)
    const int n_valid = __popc(__ballot_sync(kFull, st.mask));
    const int n_solve = st.do_match ? n_valid : 0;  // warp-uniform
    const bool column = lane >= 1 && lane <= n;
    // column `lane` of row 0; a row's offset below is in bytes, so a
    // sweep's load address is one add
    const char* cost_col = reinterpret_cast<const char*>(&cost[0][column ? lane - 1 : 0]);
    constexpr int kRowBytes = (kMaxCols + 1) * 4;
    const unsigned inf_key = float_key(kInf);
    // the key of a column that is not open: INF's (column 0 and used
    // columns, as the twin masks them), or above every key (lanes past M)
    const unsigned shut_key = lane > n ? kNoKey : inf_key;
    __syncwarp();

    float up = 0.0f;  // u[p[lane]]: potential of the row on column `lane`
    float v = 0.0f;   // v[lane]: potential of column `lane`
    int p = 0;        // p[lane]: row (1-indexed) of column `lane`, 0 = free
    int roff = 0;     // (p - 1) * kRowBytes: that row's byte offset in `cost`
    for (int r = 0; r < n_solve; ++r) {
      const int i = r + 1;
      if (lane == 0) {  // row i, untouched so far: u[i] = 0
        p = i;
        roff = r * kRowBytes;
        up = 0.0f;
      }
      float minv = kInf;
      unsigned kminv = inf_key;  // float_key(minv)
      bool open = column;        // an unused column of the problem
      int way = 0;
      int j0 = 0;
      int roff0 = r * kRowBytes;  // roff of column j0
      for (int sweep = 0; sweep <= i; ++sweep) {
        open &= lane != j0;
        const unsigned kprev = open ? kminv : shut_key;  // beside the loads
        const float u_i0 = __shfl_sync(kFull, up, j0);
        const float a = column ? *reinterpret_cast<const float*>(cost_col + roff0) : 0.0f;
        const float cur = __fsub_rn(__fsub_rn(a, u_i0), v);
        const bool better = open && cur < minv;
        const unsigned key = better ? float_key(cur) : kprev;
        if (better) {
          minv = cur;
          way = j0;
        }
        unsigned kmin;
        const unsigned hit = first_min(key, (lane << 24) | (p << 16) | roff, kmin);
        const float delta = key_float(kmin);
        if (open) {
          minv = __fsub_rn(minv, delta);
          kminv = float_key(minv);
        } else {  // used columns; lanes past M carry nothing the twin reads
          up = __fadd_rn(up, delta);
          v = __fsub_rn(v, delta);
        }
        j0 = hit >> 24;
        roff0 = hit & 0xffff;
        if (((hit >> 16) & 0xff) == 0) break;  // warp-uniform: column j0 is free
      }
      // p[way[lane]] and its potential, read before the walk rewrites them
      const int pw = __shfl_sync(kFull, p, way);
      const float upw = __shfl_sync(kFull, up, way);
      for (int s = 0; s <= i && j0 != 0; ++s) {  // augment
        const int j1 = __shfl_sync(kFull, way, j0);
        if (lane == j0) {
          p = pw;
          up = upw;
          roff = (pw - 1) * kRowBytes;
        }
        j0 = j1;
      }
    }
    // invert: row m holds column j - 1 where p[j] == m + 1; M = unassigned
    inverse[lane] = M;
    __syncwarp();
    if (column && p >= 1) inverse[p - 1] = lane - 1;
    __syncwarp();
    const int a = inverse[lane];
    __syncwarp();
    return a;
  }
};

template <int T>
__global__ void __launch_bounds__(32)
    group_hungarian_kernel(const float* __restrict__ tag, const float* __restrict__ val,
                           const int* __restrict__ order, int* __restrict__ cid,
                           int* __restrict__ ncl, int K, int M, int nt, int n_steps,
                           int P, int PC, float det_thr, float tag_thr, int use_val,
                           int ignore_too_much) {
  __shared__ float cost[kMaxRows][kMaxCols + 1];
  __shared__ int inverse[kMaxRows];
  HungarianAssign<T> mode{cost, inverse};
  group_image<T>(mode, tag, val, order, cid, ncl, K, M, nt, n_steps, P, PC, det_thr, tag_thr,
                 use_val, ignore_too_much);
}

}  // namespace

// tag: (B, K, M, T) fp32, val: (B, K, M) fp32 (sorted descending per
// joint), order: (n_steps,) int32 on the device; cid: (B, K, M) int32, ncl:
// (B,) int32.  Requires M == P <= 31, 1 <= T <= kMaxTagDim and
// K*M*(T+1) + n_steps <= 10240.  Returns a CUDA error code (0 = launched).
extern "C" int lp_group_hungarian(const float* tag, const float* val, const int* order,
                                  int* cid, int* ncl, int B, int K, int M, int T,
                                  int n_steps, int P, int PC, float det_thr, float tag_thr,
                                  int use_val, int ignore_too_much, void* stream) {
  return launch_group(group_hungarian_kernel<1>, group_hungarian_kernel<2>,
                      group_hungarian_kernel<0>, tag, val, order, cid, ncl, B, K, M, T,
                      n_steps, P, PC, det_thr, tag_thr, use_val, ignore_too_much, stream);
}
