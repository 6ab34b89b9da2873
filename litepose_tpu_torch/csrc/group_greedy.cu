// Greedy associative-embedding grouping (K2), one warp per image.
//
// Replaces the greedy branch of the Pallas TPU kernel `_group_kernel`
// (litepose_tpu/ops/pallas_group.py:164, reached through
// `match_by_tag_batch_pallas`).  The per-joint loop, the cost and the
// join/spawn bookkeeping are shared with K3 (group_common.cuh); the
// assignment here: min(M, P) rounds of global-min assignment over the
// BIG-masked cost, ties to the lowest row-major index, bit for bit with the
// plain twin `litepose_tpu_torch.ops.hungarian.greedy_assign`.
//
// What bounds it on an H100: the dependent chain of one round.  It moves
// only B*K*M*(T+2)*4 bytes; the rounds of a joint step and the joint steps
// are sequential, so an image's time is its number of rounds (up to 30 a
// joint; 145 over 14 joints for the slowest image of chip_smoke.py) times
// the latency of one, plus the cost rows it builds.  At serving batch sizes
// the 64 warps do not fill the card, which matters little next to the
// forward pass.
//
// Design: a round in registers, with no division and no shared memory.
// Lane m builds its row of the cost in a 32-entry register array by
// straight-line code (BIG past P; every loop over columns is unrolled, so no
// index is dynamic) and keeps its first minimum (rmin, rarg) with rmin's
// order-preserving key.  A round is one `__reduce_min_sync` over the open
// rows' keys and a second over (lane, rarg) of the rows holding the least,
// whose least is the lowest such row ms and its column gs at once (a lower
// row always has the lower row-major index, so this is the twin's tie
// rule).  The killed columns are one warp-uniform bitmask; a row whose rarg
// was gs takes its new first minimum by a 5-level tree over (value, column)
// that keeps the lower column on ties, with killed columns read as BIG.

#include "group_common.cuh"

namespace {

using namespace lp_group;

// One level of the tree: pair i of W takes entries 2i and 2i + 1, the
// right one only when strictly less.
template <int W>
__device__ __forceinline__ void tree_level(float (&v)[kMaxCols / 2], int (&a)[kMaxCols / 2]) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const bool right = v[2 * i + 1] < v[2 * i];
    v[i] = right ? v[2 * i + 1] : v[2 * i];
    a[i] = right ? a[2 * i + 1] : a[2 * i];
  }
}

// The first minimum of the row, killed columns read as BIG: a tree over
// (value, column) pairs, every index known at compile time.
__device__ __forceinline__ void row_first_min(const float (&row)[kMaxCols], unsigned dead,
                                              float& best, int& arg) {
  float v[kMaxCols / 2];
  int a[kMaxCols / 2];
#pragma unroll
  for (int i = 0; i < kMaxCols / 2; ++i) {
    const float l = (dead & (1u << (2 * i))) ? kBig : row[2 * i];
    const float r = (dead & (2u << (2 * i))) ? kBig : row[2 * i + 1];
    const bool right = r < l;
    v[i] = right ? r : l;
    a[i] = right ? 2 * i + 1 : 2 * i;
  }
  tree_level<8>(v, a);
  tree_level<4>(v, a);
  tree_level<2>(v, a);
  tree_level<1>(v, a);
  best = v[0];
  arg = a[0];
}

template <int T>
struct GreedyAssign {
  __device__ int assign(const Step& st, const Clusters<T>& cl, int lane, int M, int P,
                        int use_val) const {
    // rows below the detection threshold, and every row of a step that does
    // not match, cost BIG (the twin's row masking), as do columns >= P
    const bool live_row = st.has && st.mask && st.do_match;
    float row[kMaxCols];
    cost_row<T>(st, cl, use_val, row);
#pragma unroll
    for (int g = 0; g < kMaxCols; ++g) row[g] = (live_row && g < P) ? row[g] : kBig;
    float rmin;
    int rarg;
    row_first_min(row, 0u, rmin, rarg);
    unsigned krow = float_key(rmin);

    const unsigned big_key = float_key(kBig);
    unsigned dead = 0;   // killed columns, warp-uniform
    bool open = st.has;  // the row has no column yet
    int assign = M;      // M = unassigned
    const int rounds = min(M, P);
    for (int it = 0; it < rounds; ++it) {
      const unsigned key = open ? krow : kNoKey;
      unsigned kmin;
      const unsigned hit = first_min(key, (lane << 5) | rarg, kmin);
      if (kmin >= big_key) break;  // warp-uniform: the least cost is BIG
      const int gs = hit & 31;
      dead |= 1u << gs;
      if (lane == static_cast<int>(hit >> 5)) {
        assign = gs;
        open = false;
      } else if (open && rarg == gs) {
        row_first_min(row, dead, rmin, rarg);
        krow = float_key(rmin);
      }
    }
    return assign;
  }
};

template <int T>
__global__ void __launch_bounds__(32)
    group_greedy_kernel(const float* __restrict__ tag, const float* __restrict__ val,
                        const int* __restrict__ order, int* __restrict__ cid,
                        int* __restrict__ ncl, int K, int M, int nt, int n_steps, int P,
                        int PC, float det_thr, float tag_thr, int use_val,
                        int ignore_too_much) {
  GreedyAssign<T> mode;
  group_image<T>(mode, tag, val, order, cid, ncl, K, M, nt, n_steps, P, PC, det_thr, tag_thr,
                 use_val, ignore_too_much);
}

// Counts the floats whose bit patterns lie in [lo, hi] where sqrt_fast
// differs from __fsqrt_rn: the card check of sqrt_fast's range.
__global__ void sqrt_check_kernel(unsigned lo, unsigned hi, unsigned long long* bad) {
  const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  unsigned n = 0;
  for (unsigned long long b = lo + blockIdx.x * static_cast<unsigned long long>(blockDim.x) +
                              threadIdx.x;
       b <= hi; b += stride) {
    const float x = __uint_as_float(static_cast<unsigned>(b));
    n += __float_as_uint(sqrt_fast(x)) != __float_as_uint(__fsqrt_rn(x));
  }
  if (n) atomicAdd(bad, static_cast<unsigned long long>(n));
}

}  // namespace

// Adds to *bad (int64 on the device) the number of floats with bit patterns
// in [lo, hi] where the grouping kernels' sqrt_fast differs from
// __fsqrt_rn.  Returns a CUDA error code (0 = launched).
extern "C" int lp_group_sqrt_mismatches(unsigned lo, unsigned hi, unsigned long long* bad,
                                        void* stream) {
  sqrt_check_kernel<<<1056, 256, 0, static_cast<cudaStream_t>(stream)>>>(lo, hi, bad);
  return static_cast<int>(cudaGetLastError());
}

// tag: (B, K, M, T) fp32, val: (B, K, M) fp32, order: (n_steps,) int32 on
// the device; cid: (B, K, M) int32, ncl: (B,) int32.  Requires M <= 32,
// P <= 32, 1 <= T <= kMaxTagDim and K*M*(T+1) + n_steps <= 10240.  Returns
// a CUDA error code (0 = launched).
extern "C" int lp_group_greedy(const float* tag, const float* val, const int* order,
                               int* cid, int* ncl, int B, int K, int M, int T, int n_steps,
                               int P, int PC, float det_thr, float tag_thr, int use_val,
                               int ignore_too_much, void* stream) {
  return launch_group(group_greedy_kernel<1>, group_greedy_kernel<2>, group_greedy_kernel<0>,
                      tag, val, order, cid, ncl, B, K, M, T, n_steps, P, PC, det_thr,
                      tag_thr, use_val, ignore_too_much, stream);
}
