// Greedy associative-embedding grouping, one warp per image.
//
// Replaces the greedy branch of the Pallas TPU kernel `_group_kernel`
// (litepose_tpu/ops/pallas_group.py, reached through
// `match_by_tag_batch_pallas`).  Contract, bit for bit with that kernel and
// with the plain twin `litepose_tpu_torch.ops.group.match_by_tag`:
//   for each joint k in joint order, with the running cluster means
//   mean_g = tag_sum_g / max(cnt_g, 1):
//     diff[m][g] = |tag_m - mean_g| (T = 1) or sqrt(sum_t d_t*d_t) (T = 2)
//     cost = min(rint(diff) * 100, 8e3) - val_m   (use_detection_val)
//          | min(diff, 8e3)                        (otherwise)
//     columns g >= live clusters cost PAD = 1e4; rows below the detection
//     threshold, and every row of a step that does not match, cost BIG;
//   min(M, P) rounds of global-min assignment (ties to the lowest row-major
//   index), then join (matched diff < tag_threshold) or spawn in peak order
//   up to max_clusters, with running tag sums and counts.
// Output: cluster id per (joint, peak) (-1 = none) and clusters per image.
//
// Design.  The TPU kernel lays 128 images on the vector lanes; here each
// image is one warp and each peak row m is one lane, so the 30 x 30 cost
// matrix is one shared-memory row per lane.  A lane keeps its row's first
// minimum; a round is a 5-step shuffle argmin over the lanes, and only
// rows whose minimum sat in the killed column rescan.  All state (tag sums,
// counts, cluster count) stays on chip for the 14 sequential joint steps.
//
// What bounds it: it is latency-bound (14 steps x 30 dependent rounds per
// image, a few hundred instructions each) and moves only
// B*K*M*(T+2)*4 bytes; at serving batch sizes the 64 warps do not fill
// the card, which matters little next to the forward pass.
//
// Exactness: the arithmetic uses the round-to-nearest intrinsics, so nvcc
// cannot contract `rint(d) * 100 - val` or `d0*d0 + d1*d1` into FMAs (the
// library is also built with --fmad=false), and the division and square
// root stay IEEE (never build with --use_fast_math).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxRows = 32;  // peaks per joint, one lane each
constexpr int kMaxCols = 32;  // assignment columns (max_people)
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 3e38f;
constexpr float kClip = 8e3f;
constexpr float kPad = 1e4f;

__global__ void __launch_bounds__(32)
    group_greedy_kernel(const float* __restrict__ tag,
                        const float* __restrict__ val,
                        const int* __restrict__ order, int* __restrict__ cid,
                        int* __restrict__ ncl, int K, int M, int T,
                        int n_steps, int P, int PC, float det_thr,
                        float tag_thr, int use_val, int ignore_too_much) {
  __shared__ float cost[kMaxRows][kMaxCols + 1];
  __shared__ float diff[kMaxRows][kMaxCols + 1];
  __shared__ float mean[kMaxCols][2];
  __shared__ float tag_sum[kMaxCols][2];
  __shared__ float tag_cnt[kMaxCols];

  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const float* tag_b = tag + static_cast<size_t>(b) * K * M * T;
  const float* val_b = val + static_cast<size_t>(b) * K * M;
  int* cid_b = cid + static_cast<size_t>(b) * K * M;

  for (int i = lane; i < K * M; i += 32) cid_b[i] = -1;
  if (lane < P) {
    tag_sum[lane][0] = 0.0f;
    tag_sum[lane][1] = 0.0f;
    tag_cnt[lane] = 0.0f;
  }
  int n_cl = 0;  // warp-uniform
  const bool has = lane < M;
  __syncwarp();

  for (int step = 0; step < n_steps; ++step) {
    const int k = order[step];
    const size_t row = static_cast<size_t>(k) * M + lane;
    const float v = has ? val_b[row] : 0.0f;
    const float t0 = has ? tag_b[row * T] : 0.0f;
    const float t1 = (has && T == 2) ? tag_b[row * T + 1] : 0.0f;
    const bool mask = has && (v > det_thr);
    const bool is_first = step == 0 || n_cl == 0;
    const bool skip = ignore_too_much && !is_first && n_cl >= P;
    const bool do_match = !is_first && !skip;
    const int G = min(n_cl, P);

    if (lane < P) {
      const float cnt = fmaxf(tag_cnt[lane], 1.0f);
      mean[lane][0] = __fdiv_rn(tag_sum[lane][0], cnt);
      mean[lane][1] = __fdiv_rn(tag_sum[lane][1], cnt);
    }
    __syncwarp();

    // ---- this lane's cost row, and its first minimum ----
    float rmin = kBig;
    int rarg = 0;
    if (has) {
      for (int g = 0; g < P; ++g) {
        float d;
        if (T == 1) {
          d = fabsf(__fsub_rn(t0, mean[g][0]));
        } else {
          const float d0 = __fsub_rn(t0, mean[g][0]);
          const float d1 = __fsub_rn(t1, mean[g][1]);
          d = __fsqrt_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)));
        }
        diff[lane][g] = d;
        float c = use_val ? __fsub_rn(fminf(__fmul_rn(rintf(d), 100.0f), kClip), v)
                          : fminf(d, kClip);
        if (g >= G) c = kPad;
        if (!(mask && do_match)) c = kBig;
        cost[lane][g] = c;
        if (c < rmin) {
          rmin = c;
          rarg = g;
        }
      }
    }

    // ---- greedy global-min assignment ----
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
      if (has && !row_dead) {
        cost[lane][gs] = kBig;
        if (rarg == gs) {
          rmin = kBig;
          rarg = 0;
          for (int g = 0; g < P; ++g) {
            const float c = cost[lane][g];
            if (c < rmin) {
              rmin = c;
              rarg = g;
            }
          }
        }
      }
    }

    // ---- join / spawn ----
    const float md = has ? diff[lane][min(assign, P - 1)] : 0.0f;
    const bool join = do_match && mask && assign < G && md < tag_thr;
    const bool spawn = mask && (is_first || (do_match && !join));
    const unsigned spawn_bits = __ballot_sync(kFull, spawn);
    const unsigned upto = lane == 31 ? kFull : ((2u << lane) - 1u);
    const int slot = n_cl + __popc(spawn_bits & upto) - 1;
    const int cid_spawn = (spawn && slot < PC) ? slot : -1;
    const int cid_join = join ? assign : -1;
    if (has) cid_b[row] = max(cid_join, cid_spawn);

    // join slots are < G <= n_cl and spawn slots >= n_cl: no lane shares one
    if (join) {
      tag_sum[assign][0] = __fadd_rn(tag_sum[assign][0], t0);
      tag_sum[assign][1] = __fadd_rn(tag_sum[assign][1], t1);
      tag_cnt[assign] = __fadd_rn(tag_cnt[assign], 1.0f);
    }
    if (cid_spawn >= 0 && cid_spawn < P) {
      tag_sum[cid_spawn][0] = t0;
      tag_sum[cid_spawn][1] = t1;
      tag_cnt[cid_spawn] = 1.0f;
    }
    n_cl = min(n_cl + __popc(spawn_bits), PC);
    __syncwarp();
  }
  if (lane == 0) ncl[b] = n_cl;
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
