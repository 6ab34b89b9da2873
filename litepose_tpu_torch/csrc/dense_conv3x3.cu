// A dense 3x3 stride-1 conv of a folded conv-BN pair at bf16 eval, with
// K7's epilogue in its store (K8): channels-last x (B, H, W, Cin) bf16, the
// folded weights (Cout, 3, 3, Cin) bf16 (a channels-last (Cout, Cin, 3, 3)),
// padding 1, then the folded-BN bias, an optional residual of the output's
// shape and none, ReLU6 or ReLU, written once, channels-last.
//
// Replaces no Pallas kernel: the JAX package leaves the conv to
// lax.conv_general_dilated and the bias, residual and activation after it
// to XLA, which fuses them.  The port ran cuDNN's conv, which wrote y, and
// then K7 (conv_epilogue.cu), which read y back and wrote it again: the 4 to
// 6 bytes an element of K7 and two launches where one does.
//
// Contract, with the plain twin litepose_tpu_torch.ops.dense_conv.
// conv3x3_bn_act_ref (F.conv2d in bf16, then ops.epilogue.unfused):
//   * Cin and Cout multiples of 16, Cout at most kMaxCout, W at most
//     kMaxWidth, B H W max(Cin, Cout) below 2^31 (the tile and ring counts
//     stay ints), every tensor 16-byte aligned; bias (Cout) fp32;
//     residual null or of the output's shape (B, H, W, Cout), channels-last;
//   * the conv's sum is taken in fp32 by the tensor cores and rounded to
//     bf16 once: that is y, the parent's conv output up to the order of the
//     fp32 sum (cuDNN sums in another order);
//   * then K7's contract in K7's order: t = bf16(y + bf16(bias)), bf16(t +
//     r) where there is a residual, then ReLU6 / ReLU as ATen's clamp, NaN
//     passed through.  Given y, the epilogue equals ATen's sequence bit for
//     bit (epilogue_pair below says why its bf16x2 instructions do).
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s; the seven shapes
// of HigherHRNet-W48@640 at b16, one conv each, input and output read and
// written once, a residual where a BasicBlock's conv2 adds one):
//   48 -> 48 @ 160^2 (64 convs): 17.0 GFLOP, 17.2 us; 78.6 MB (118 MB with
//     the residual), 23.5 us (35.2 us): bytes;
//   48 -> 48 @ 320^2 (8): 68.0 GFLOP, 68.7 us; 315 MB (472 MB), 94 us
//     (141 us): bytes;
//   96 -> 96 @ 80^2 (64), 192 -> 192 @ 40^2 (56), 384 -> 384 @ 20^2 (24):
//     17.0 GFLOP each, 17.2 us, against 39.3, 20.3 and 12.5 MB (weights
//     included), 11.7, 6.1 and 3.7 us: operations;
//   64 -> 64 @ 160^2 (4): 30.2 GFLOP, 30.5 us; 105 MB, 31.3 us: both;
//   256 -> 48 @ 160^2 (1): 90.6 GFLOP, 91.6 us; 249 MB, 74.3 us: operations.
//
// Design:
//   1. An implicit GEMM over padded rows: M runs over the pixels of k
//      output rows of one image, each row padded to Wp = Ws + 2 columns,
//      N over Cout, K over the nine taps and Cin.  A tile's input is its
//      halo, the k + 2 padded input rows around it, and GEMM row i (output
//      row i / Wp, column i % Wp) meets tap (dy, dx) at halo pixel i + dy Wp
//      + dx: every tap of a tile is the same run of rows, shifted, so the
//      halo is staged once and the nine taps are nine views of it in
//      shared memory.  The two padding columns of each row are computed and
//      dropped, as are the rows past k Wp of a tile's BM: 7-28% more
//      operations, from 160^2 to 20^2.  Planes wider than 254 are cut into
//      column slabs (W48's 320^2 into two of 160).
//   2. All global traffic is TMA, issued by single threads of a third
//      warpgroup: a halo is one 4-D box (16 channels, Wp columns, k + 2
//      rows, one image) a 16-channel block of the stage's Cin slice, the
//      padding and the rows past the image zero-filled by the copy engine
//      (coordinates -1 and past the edge); weights one 2-D box (16
//      channels, BN rows) a tap and block, resident for the whole launch
//      where a single N tile's fit beside three stages (W48's 48- and
//      64-channel convs); the residual and the output one 4-D box (BN
//      channels, Ws columns, k rows) a tile, the rows and columns past the
//      image clipped by the copy engine.  Stages of a 16- or 32-channel
//      slice fill a ring of 2-6, each completing on its barrier by bytes:
//      no thread spends instructions on addresses, and a row of 16
//      channels is one 32-byte piece of the copy engine's work.
//   3. Shared memory rows of 32 bytes (16 channels) under the 32-byte
//      swizzle, which TMA writes and wgmma reads by the same address bits,
//      so a tap's view may start at any pixel.  wgmma m64nBNk16, A and B
//      from shared memory, fp32 accumulators in registers: two consumer
//      warpgroups, each MW m64 tiles of the tile's BM = 128 MW rows, BN the
//      widest of 96, 64, 48, 32, 16 that divides Cout (192 and 384 split
//      into 96-wide N tiles).  Consumers release a stage as soon as its
//      wgmmas retire, so the producer loads the next tile's stages while
//      they run this tile's epilogue; CTAs are persistent and walk the
//      tiles in order.
//   4. The epilogue in registers, two channels an instruction: the
//      consumers round their accumulators to bf16, add the bias and, where
//      there is one, the residual (its box loaded into the output tile in
//      shared memory while they ran the tile's wgmmas), apply the
//      activation and write the output tile; one thread stores it as one
//      box, and the next tile's residual box follows once the store has
//      read it.  The 48-channel shapes, bound by bytes, so move each byte
//      of input, residual and output once through the copy engine.
//   5. The seven shapes: the byte-bound 48 -> 48 @ 160^2 and 320^2 (and 64
//      -> 64 @ 160^2) keep their weights resident and take 512 rows a tile
//      (MW = 4), so the halo is 5 / 3 of the tile's input and every other
//      byte moves once; the operation-bound 96 @ 80^2, 192 @ 40^2 and 384 @
//      20^2 take BN = 96, the widest N a warpgroup's two m64 tiles hold in
//      registers, and stream their weights a 16- or 32-channel slice a
//      stage; 256 -> 48 streams them at BN = 48.  The instance (BN, MW), k,
//      the slab and the stage's slice are chosen from what the launch sees:
//      Cin, Cout, H and W.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "conv_common.cuh"

namespace {

constexpr int kConsumers = 2;                         // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);      // and one of copy threads
constexpr int kMaxStages = 6;
constexpr int kSmemBytes = 232448;                    // a CTA's most, 227 KB
constexpr int kBiasOffset = 128;                      // the barriers before it
constexpr int kMaxCout = 512;                         // the bias as bf16 after them
constexpr int kDataOffset = kBiasOffset + 2 * kMaxCout;
constexpr int kMaxWidth = 1024;
constexpr int kMaxSlab = 254;                         // a TMA box is at most 256 wide
constexpr int kCopyRegs = 56, kConsumerRegs = 224;
// a shared row holds 16 channels of a pixel (or of a weight row): 32 bytes
// under the 32-byte swizzle (wgmma's layout type 3)
constexpr int kBlockChannels = 16;
constexpr int kRowBytes = 2 * kBlockChannels;
constexpr uint64_t kLayoutSw32 = 3;

struct Params {
  int B, H, W, Cin, Cout;
  int Ws, Wp;      // a slab's width, and padded: Ws + 2
  int k;           // output rows a tile
  int slabs, blocks;  // column slabs of a row, row blocks of an image
  int n_tiles;     // Cout / BN
  int units;       // tiles x N tiles
  int KC;          // channels of Cin a stage
  int nblk;        // 16-channel blocks a stage
  int chunks;      // Cin / KC
  int block_bytes; // a halo block: at least (k + 2) Wp and BM + 2 Wp + 2 pixels
  int stages;
  int halo_bytes;  // nblk blocks
  int stage_bytes;
  int stage_tx;    // bytes the copies of a stage bring
  int resident;    // whether the weights stay in shared memory for the whole launch
  int weights;     // their offset (resident) and bytes
  int weight_bytes;
  int tile;        // offset of the output tile (k Ws BN bf16), its bytes, rounded
  int tile_bytes;
  int tile_tx;     // and as a box brings them
  int residual;    // whether a residual is added
  int act;
  Divmod by_wp;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// waits for the phase after ``parity``; a wait of some 2^26 tries (seconds)
// is a broken ring, and traps: the launch fails where it would hang
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (int tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1 << 26)) __trap();
  }
}

// a box of a tensor map into shared memory, completing on ``bar`` by bytes
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// a box of shared memory out to a tensor map (the part inside the tensor)
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the stores committed so far have read their shared memory (kRead) or are
// done
template <bool kRead>
__device__ __forceinline__ void tma_store_wait() {
  if (kRead)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// this thread's shared-memory writes made visible to the async proxy (the
// TMA store that reads them)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a wgmma operand in shared memory, K-major, 32-byte rows under the 32-byte
// swizzle: 8-row groups 256 bytes apart; a k16 step is one row, so the
// leading offset is unused (1)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>((8 * kRowBytes) >> 4) << 32) | (kLayoutSw32 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmmas
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, fp32) += A (64 x 16) B (16 x N), both bf16 from shared memory
template <int N>
struct Mma;

template <>
struct Mma<16> {
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<48> {
  static __device__ __forceinline__ void run(float (&d)[24], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23}, "
        "%24, %25, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<96> {
  static __device__ __forceinline__ void run(float (&d)[48], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47}, "
        "%48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(a), "l"(b), "r"(1));
  }
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t w) {
  return *reinterpret_cast<const __nv_bfloat162*>(&w);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the epilogue of two channels: y + the bias, + the residual r (where there
// is one), the activation, each rounded to bf16.  A bf16x2 add rounds the
// exact sum once, which for two bf16 values is their fp32 sum rounded to
// bf16, as ATen adds: the sum is exact in fp32 unless the exponents lie 16
// or more apart, and then the smaller is below a quarter ulp of the larger
// either way; a NaN comes out canonical, as cvt.rn.bf16.f32 makes it.  ReLU
// is the NaN-propagating max with 0 (the fp32 max's ordering of -0 and +0),
// ReLU6 then the NaN-propagating min with 6: clamp's results, every non-NaN
// one a bf16 already.
__device__ __forceinline__ uint32_t epilogue_pair(uint32_t y, uint32_t b, bool residual,
                                                  uint32_t r, int act) {
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.0f), six = __float2bfloat162_rn(6.0f);
  __nv_bfloat162 t = __hadd2(as_bf162(y), as_bf162(b));
  if (residual) t = __hadd2(t, as_bf162(r));
  if (act != kActNone) {
    t = __hmax2_nan(t, zero);
    if (act == kActRelu6) t = __hmin2_nan(t, six);
  }
  return as_u32(t);
}

template <int BN, int MW>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_bn_act_kernel(const __grid_constant__ CUtensorMap x_map,
                          const __grid_constant__ CUtensorMap w_map,
                          const __grid_constant__ CUtensorMap out_map,
                          const __grid_constant__ CUtensorMap res_map,
                          const float* __restrict__ bias, const Params p) {
  constexpr int R = BN / 2;  // accumulators a thread, per m64 tile
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  uint64_t* loaded = empty + kMaxStages;  // the resident weights
  uint64_t* staged = loaded + 1;          // the output tile written
  uint64_t* stage_free = staged + 1;      // and read by its store
  uint64_t* res_full = stage_free + 1;    // the residual box in the output tile
  unsigned short* sbias = reinterpret_cast<unsigned short*>(smem + kBiasOffset);
  // the data 1024-byte aligned (the swizzle's pattern follows address bits)
  const uint32_t offset = ((smem_u32(smem) + kDataOffset + 1023) & ~1023u) - smem_u32(smem);
  const uint32_t data = smem_u32(smem) + offset;

  for (int c = threadIdx.x; c < p.Cout; c += kThreads) {
    sbias[c] = __bfloat16_as_ushort(__float2bfloat16_rn(bias[c]));
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(smem_u32(full + s), 1);                   // the producer, with the bytes
      mbar_init(smem_u32(empty + s), 4 * kConsumers);     // every consumer warp
    }
    mbar_init(smem_u32(loaded), 1);
    mbar_init(smem_u32(staged), 128 * kConsumers);       // every consumer thread
    mbar_init(smem_u32(stage_free), 1);
    mbar_init(smem_u32(res_full), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nblk = p.nblk;
  const int tiles_per_image = p.slabs * p.blocks;
  if (threadIdx.x >= 128 * kConsumers) {
    // ---- the copy warpgroup: lane 0 of warp 0 loads, lane 0 of warp 1 stores ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kCopyRegs));
    const int ct = threadIdx.x - 128 * kConsumers;
    if (ct == 32) {
      int tiles = 0;
      for (int unit = blockIdx.x; unit < p.units; unit += gridDim.x, ++tiles) {
        const int tile = unit / p.n_tiles;
        const int n0 = (unit - tile * p.n_tiles) * BN;
        const int b = tile / tiles_per_image;
        const int rest = tile - b * tiles_per_image;
        const int slab = rest / p.blocks;
        const int h0 = (rest - slab * p.blocks) * p.k;
        if (p.residual) {
          // the tile is free: the store before has read it
          mbar_expect_tx(smem_u32(res_full), p.tile_tx);
          tma_load_4d(data + p.tile, &res_map, smem_u32(res_full), n0, slab * p.Ws, h0, b);
        }
        mbar_wait(smem_u32(staged), tiles & 1);
        tma_store_4d(&out_map, data + p.tile, n0, slab * p.Ws, h0, b);
        tma_store_wait<true>();
        mbar_arrive(smem_u32(stage_free));
      }
      tma_store_wait<false>();
      return;
    }
    if (ct != 0) return;
    if (p.resident) {
      // every slice's weights, once: slice, tap, block, then the N tile's rows
      const uint32_t bar = smem_u32(loaded);
      mbar_expect_tx(bar, p.weight_bytes);
      for (int kc = 0; kc < p.chunks; ++kc)
        for (int tap = 0; tap < 9; ++tap)
          for (int l = 0; l < nblk; ++l)
            tma_load_2d(data + p.weights + ((kc * 9 + tap) * nblk + l) * BN * kRowBytes,
                        &w_map, bar, tap * p.Cin + kc * p.KC + kBlockChannels * l, 0);
    }
    int item = 0;
    for (int unit = blockIdx.x; unit < p.units; unit += gridDim.x) {
      const int tile = unit / p.n_tiles;
      const int n0 = (unit - tile * p.n_tiles) * BN;
      const int b = tile / tiles_per_image;
      const int rest = tile - b * tiles_per_image;
      const int slab = rest / p.blocks;
      const int h0 = (rest - slab * p.blocks) * p.k;
      for (int kc = 0; kc < p.chunks; ++kc, ++item) {
        const int s = item % p.stages;
        mbar_wait(smem_u32(empty + s), ((item / p.stages) & 1) ^ 1);
        const uint32_t bar = smem_u32(full + s);
        mbar_expect_tx(bar, p.stage_tx);
        const uint32_t halo = data + s * p.stage_bytes;
        const uint32_t wts = halo + p.halo_bytes;
        for (int l = 0; l < nblk; ++l) {
          // rows h0 - 1 .. h0 + k, columns slab Ws - 1 .. slab Ws + Ws
          tma_load_4d(halo + l * p.block_bytes, &x_map, bar, kc * p.KC + kBlockChannels * l,
                      slab * p.Ws - 1, h0 - 1, b);
        }
        for (int tap = 0; tap < 9 * !p.resident; ++tap) {
          for (int l = 0; l < nblk; ++l) {
            tma_load_2d(wts + (tap * nblk + l) * BN * kRowBytes, &w_map, bar,
                        tap * p.Cin + kc * p.KC + kBlockChannels * l, n0);
          }
        }
      }
    }
  } else {
    // ---- the consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    float acc[MW][R];
    int tiles = 0;  // tiles this CTA's consumers have written
    if (p.resident) mbar_wait(smem_u32(loaded), 0);
    int item = 0;
    for (int unit = blockIdx.x; unit < p.units; unit += gridDim.x, ++tiles) {
      const int tile = unit / p.n_tiles;
      const int n0 = (unit - tile * p.n_tiles) * BN;
#pragma unroll
      for (int m = 0; m < MW; ++m) {
#pragma unroll
        for (int i = 0; i < R; ++i) acc[m][i] = 0.0f;
      }
      int held = -1;  // the stage whose wgmmas may still be in flight
      for (int kc = 0; kc < p.chunks; ++kc, ++item) {
        const int s = item % p.stages;
        mbar_wait(smem_u32(full + s), (item / p.stages) & 1);
        const uint32_t halo = data + s * p.stage_bytes;
        const uint32_t wts = p.resident ? data + p.weights + kc * 9 * nblk * BN * kRowBytes
                                        : halo + p.halo_bytes;
#pragma unroll
        for (int m = 0; m < MW; ++m) fence_regs(acc[m]);
        wgmma_fence();
        for (int l = 0; l < nblk; ++l) {
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) {
            const int shift = (tap / 3) * p.Wp + tap % 3;
            const uint64_t db = smem_desc(wts + (tap * nblk + l) * BN * kRowBytes);
#pragma unroll
            for (int m = 0; m < MW; ++m) {
              const uint64_t da = smem_desc(halo + l * p.block_bytes +
                                            ((wg * MW + m) * 64 + shift) * kRowBytes);
              Mma<BN>::run(acc[m], da, db);
            }
          }
        }
        wgmma_commit();
#pragma unroll
        for (int m = 0; m < MW; ++m) fence_regs(acc[m]);
        if (held >= 0) {
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(smem_u32(empty + held));
        }
        held = s;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < MW; ++m) fence_regs(acc[m]);
      if (lane == 0) mbar_arrive(smem_u32(empty + held));

      // the epilogue into the output tile (k rows of Ws pixels of BN
      // channels), once it holds this tile's residual or the store before
      // has read it: accumulator d[4j + 2h + e] of an m64 tile is its row
      // 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e
      if (p.residual)
        mbar_wait(smem_u32(res_full), tiles & 1);
      else if (tiles > 0)
        mbar_wait(smem_u32(stage_free), (tiles - 1) & 1);
      uint32_t b2[BN / 8];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        b2[j] = *reinterpret_cast<const uint32_t*>(sbias + n0 + 8 * j + 2 * (lane % 4));
      unsigned short* out_tile = reinterpret_cast<unsigned short*>(smem + offset + p.tile);
#pragma unroll
      for (int m = 0; m < MW; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = (wg * MW + m) * 64 + warp * 16 + lane / 4 + 8 * h;
          const int dh = fast_div(i, p.by_wp);
          const int col = i - dh * p.Wp;
          if (dh >= p.k || col >= p.Ws) continue;  // a padding column or a row past BM
          uint32_t* at = reinterpret_cast<uint32_t*>(out_tile + (dh * p.Ws + col) * BN +
                                                     2 * (lane % 4));
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const uint32_t y = pack_bf16x2(acc[m][4 * j + 2 * h], acc[m][4 * j + 2 * h + 1]);
            at[4 * j] = epilogue_pair(y, b2[j], p.residual, p.residual ? at[4 * j] : 0u, p.act);
          }
        }
      }
      fence_proxy_async();
      mbar_arrive(smem_u32(staged));
    }
  }
}

constexpr int kMaxDevices = 64;
// the instances (BN, MW): BN the widest of 96, 64, 48, 32, 16 that divides
// Cout; MW m64 tiles a consumer warpgroup, so that its accumulators stay at
// 32-128 registers a thread
constexpr int kInstances = 5;
constexpr int kWidths[kInstances] = {96, 64, 48, 32, 16};
constexpr int kMws[kInstances] = {2, 4, 4, 4, 4};
// whether an instance's shared memory limit is raised, by device
std::atomic<int> g_ready[kMaxDevices][kInstances];
std::atomic<int> g_sms[kMaxDevices];

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      ptr = nullptr;
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// a channels-last (B, H, W, C) bf16 tensor in boxes of (box_c channels,
// box_w columns, box_h rows, one image)
bool encode_nhwc(EncodeTiled encode, CUtensorMap* map, const void* t, const Params& p, int C,
                 int box_c, int box_w, int box_h, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(p.W),
                              static_cast<cuuint64_t>(p.H), static_cast<cuuint64_t>(p.B)};
  const cuuint64_t strides[3] = {2ull * C, 2ull * C * p.W, 2ull * C * p.W * p.H};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_c), static_cast<cuuint32_t>(box_w),
                             static_cast<cuuint32_t>(box_h), 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(t), dims, strides,
                box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// x in halo boxes (16 channels, Wp columns, k + 2 rows); w as (Cout, 9 Cin)
// in boxes of (16 channels, BN rows); out and the residual in tile boxes
// (BN channels, Ws columns, k rows)
bool encode_maps(const Params& p, int BN, const void* x, const void* w, const void* res,
                 void* out, CUtensorMap* x_map, CUtensorMap* w_map, CUtensorMap* out_map,
                 CUtensorMap* res_map) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t w_dims[2] = {9ull * p.Cin, static_cast<cuuint64_t>(p.Cout)};
  const cuuint64_t w_strides[1] = {18ull * p.Cin};
  const cuuint32_t w_box[2] = {kBlockChannels, static_cast<cuuint32_t>(BN)};
  const cuuint32_t ones[2] = {1, 1};
  return encode_nhwc(encode, x_map, x, p, p.Cin, kBlockChannels, p.Wp, p.k + 2,
                     CU_TENSOR_MAP_SWIZZLE_32B) &&
         encode(w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), w_dims,
                w_strides, w_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS &&
         encode_nhwc(encode, out_map, out, p, p.Cout, BN, p.Ws, p.k,
                     CU_TENSOR_MAP_SWIZZLE_NONE) &&
         encode_nhwc(encode, res_map, res != nullptr ? res : out, p, p.Cout, BN, p.Ws, p.k,
                     CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int BN, int MW>
cudaError_t launch(int instance, const Params& p, const void* x, const void* w,
                   const float* bias, const void* res, void* out,
                   cudaStream_t stream) {
  const void* kernel = reinterpret_cast<const void*>(&conv3x3_bn_act_kernel<BN, MW>);
  const int smem = kDataOffset + 1024 + p.tile + p.tile_bytes;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidValue;
  if (!g_ready[dev][instance].load(std::memory_order_relaxed)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return e;
    g_ready[dev][instance].store(1, std::memory_order_relaxed);
  }
  int sms = g_sms[dev].load(std::memory_order_relaxed);
  if (sms == 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    g_sms[dev].store(sms, std::memory_order_relaxed);
  }
  CUtensorMap x_map, w_map, out_map, res_map;
  if (!encode_maps(p, BN, x, w, res, out, &x_map, &w_map, &out_map, &res_map))
    return cudaErrorInvalidValue;
  Params params = p;
  void* args[] = {&x_map, &w_map, &out_map, &res_map, &bias, &params};
  // one persistent CTA an SM (its shared memory allows no second)
  return cudaLaunchKernel(kernel, dim3(p.units < sms ? p.units : sms), dim3(kThreads), args,
                          smem, stream);
}

int instance_of(int Cout) {
  for (int i = 0; i < kInstances; ++i)
    if (Cout % kWidths[i] == 0) return i;
  return kInstances - 1;
}

int round_up(int n, int m) { return (n + m - 1) / m * m; }

// the tiling: k output rows a tile, as many as BM holds, then as few as
// keep the image's row blocks (fewest rows past the image); then the
// stage's slice of Cin and the ring's depth: 32 channels where Cin allows
// and three stages fit, else 16.  The weights of a single N tile stay
// resident where they fit beside three stages of halo alone.  False where
// two stages do not fit, which no shape of the contract meets: the stage
// needs only the tile's geometry, at most BM + 2 Wp + 2 rows of one
// 16-channel block and its weights, whatever Cin and H (every Cout and W of
// the contract checked).
bool plan(Params& p, int BN, int MW) {
  const int BM = kConsumers * MW * 64;
  p.slabs = (p.W + kMaxSlab - 1) / kMaxSlab;
  p.Ws = (p.W + p.slabs - 1) / p.slabs;
  p.Wp = p.Ws + 2;
  if (p.Wp > BM) return false;
  const int kmax = BM / p.Wp;
  p.blocks = (p.H + kmax - 1) / kmax;
  p.k = (p.H + p.blocks - 1) / p.blocks;
  // a block holds the box, and every pixel a tap of the tile's BM rows reads
  const int box = (p.k + 2) * p.Wp, reach = BM + 2 * p.Wp + 2;
  p.block_bytes = round_up(box > reach ? box : reach, 8) * kRowBytes;
  p.tile_tx = p.k * p.Ws * BN * 2;
  p.tile_bytes = round_up(p.tile_tx, 128);
  const int room = kSmemBytes - kDataOffset - 1024 - p.tile_bytes;
  const int all_weights = 9 * p.Cin * BN * 2;
  for (int resident = p.Cout == BN; resident >= 0; --resident) {
    for (int kc = 32; kc >= 16; kc -= 16) {
      if (p.Cin % kc) continue;
      const int nblk = kc / kBlockChannels;
      const int halo = nblk * p.block_bytes;
      const int stage = halo + (resident ? 0 : 9 * kc * BN * 2);
      int stages = (room - (resident ? all_weights : 0)) / stage;
      if (stages > kMaxStages) stages = kMaxStages;
      if (stages >= (kc == 32 || resident ? 3 : 2)) {
        p.KC = kc;
        p.nblk = nblk;
        p.chunks = p.Cin / kc;
        p.halo_bytes = halo;
        p.stage_bytes = stage;
        p.stage_tx = nblk * (p.k + 2) * p.Wp * kRowBytes + (resident ? 0 : 9 * kc * BN * 2);
        p.stages = stages;
        p.resident = resident;
        p.weights = stages * stage;
        p.weight_bytes = resident ? all_weights : 0;
        p.tile = p.weights + p.weight_bytes;
        return true;
      }
    }
  }
  return false;
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// x (B, H, W, Cin) bf16, w (Cout, 3, 3, Cin) bf16, bias (Cout) fp32, res
// null or (B, H, W, Cout) bf16, out (B, H, W, Cout) bf16, all channels-last
// and 16-byte aligned; Cin and Cout multiples of 16, Cout at most kMaxCout,
// W at most kMaxWidth, B H W max(Cin, Cout) below 2^31; act 0 none, 1
// ReLU6, 2 ReLU.  Returns a CUDA error code.
extern "C" int lp_conv3x3_bn_act(const void* x, const void* w, const float* bias,
                                 const void* res, void* out, int B, int H, int W, int Cin,
                                 int Cout, int act, void* stream) {
  if (B < 0 || H < 0 || W < 0 || W > kMaxWidth || Cin < 16 || Cin % 16 || Cout < 16 ||
      Cout % 16 || Cout > kMaxCout || act < kActNone || act > kActRelu ||
      static_cast<long long>(B) * H * W * (Cin > Cout ? Cin : Cout) >= (1LL << 31) ||
      !aligned16(x) || !aligned16(w) || !aligned16(out) || (res != nullptr && !aligned16(res)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || W == 0) return 0;
  const int inst = instance_of(Cout);
  const int BN = kWidths[inst], MW = kMws[inst];
  Params p{};
  p.B = B;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  p.act = act;
  p.residual = res != nullptr;
  if (!plan(p, BN, MW)) return static_cast<int>(cudaErrorInvalidValue);
  p.n_tiles = Cout / BN;
  p.units = B * p.slabs * p.blocks * p.n_tiles;
  p.by_wp = divmod_of(p.Wp);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (inst) {
    case 0: return static_cast<int>(launch<96, 2>(inst, p, x, w, bias, res, out, st));
    case 1: return static_cast<int>(launch<64, 4>(inst, p, x, w, bias, res, out, st));
    case 2: return static_cast<int>(launch<48, 4>(inst, p, x, w, bias, res, out, st));
    case 3: return static_cast<int>(launch<32, 4>(inst, p, x, w, bias, res, out, st));
    default: return static_cast<int>(launch<16, 4>(inst, p, x, w, bias, res, out, st));
  }
}
