// Quantized matmul kernels for Hopper (sm_90a).
//
// The four weight-only entry points compute y[M, N] = x[M, K] . deq(W)^T with bf16 x and
// y, an f32 accumulator, and deq(W)[n, k] = bf16_rn(q[n, k] * s[n, k / 128]):
// the weight is dequantized in f32 and rounded to bf16 before the product,
// exactly where the plain version (ops/quant.py) and the JAX package round
// it.  W keeps nn.Linear's [N, K] orientation:
//   q8: int8 [N, K];
//   q4: packed int8 [N, K / 2]; within each 128-wide K group of a row, byte j
//       holds group row j in its low nibble, ((b & 15) ^ 8) - 8, and group
//       row j + 64 in its high nibble, b >> 4 (arithmetic);
//   scales: f32 [N, K / 128].
// K is a multiple of 128; M and N are any size (the ragged edges are
// zero-filled in shared memory and masked in the epilogue, so x is never
// copied or padded).
//
//   q8_matmul_tile  replaces mlimgsynth_tpu/ops/q8_matmul.py q8_matmul /
//                   _q8_kernel (K5);
//   q8_matmul_ws    replaces q8_matmul_ws / _q8_ws_kernel (K6);
//   q4_matmul_tile  replaces mlimgsynth_tpu/ops/q4_matmul.py q4_matmul /
//                   _q4_kernel (K9);
//   q4_matmul_ws    replaces q4_matmul_ws / _q4_ws_kernel (K10).
//
// What bounds them on the H100.  At the SD1.5 512^2 shapes the products
// carry 2*M*N*K flops over x (2 bytes per element), W (1 or 1/2 byte) and y
// (2 bytes): from 0.3 to 13 GFLOP over 1.6 to 27 MB, so the least time is
// the tensor-core time (989 TFLOP/s bf16) for the 2048-row linears and the
// memory time (3.35 TB/s) only for the 8192 x 1280 x 320 ff.net.2; both are
// a few microseconds.  What the design has to avoid is dequantizing the same
// weight many times over: the dequantization (an int8 to f32 convert, a
// multiply and a bf16 round per weight) runs on the CUDA cores at a small
// fraction of the tensor-core rate.  The dispatch (ops/quant_matmul.py
// use_ws) sends every product with M >= 2048 to _ws, whatever its K, and
// the rest to _tile.
//   * _tile (K5, K9), for M < 2048 (CLIP and the text towers, cross-
//     attention k/v at 2 x 77 rows, the 16 x 16 and 8 x 8 UNet levels,
//     SD3's context stream at 2 x 154 rows, the embeddings and adaLN at 2
//     rows).  The weight stream and x's re-reads bound it, not the
//     tensor cores.  A first design (one 64 x 64 output tile per block,
//     mma.sync, x and the weight staged through registers with two block
//     barriers a group) dequantized each weight once per 64 rows of M; the
//     same tiles on wgmma with K6's dequantizing warpgroup (x the 64-row A
//     operand, 8 to 128 weight columns the N) were no faster: a 16-deep
//     step was an m64n16k16 or so, and the roles' barriers, not the
//     products, set the pace.  This one (qmm_tile_kernel) swaps the
//     product, y^T = deq(W) . x^T: a block takes 64 weight rows (the
//     wgmma's M) by one row range of x (its N, NT = 8 to 256 rows, the
//     launcher's tile_config: ceil(M / 256) ranges, so a weight is
//     dequantized once where M <= 256 and at most ceil(M / 256) times
//     above).  A producer warp keeps a ring of 128-deep stages full (x by
//     TMA in the 128-byte swizzle, the raw weight by TMA, the group's 64
//     scales by cp.async); one consumer warpgroup dequantizes each 64-deep
//     half of a stage straight into the registers of the wgmma's A
//     operand (bf16_rn(q * s), deq_tile's arithmetic; no dequantized tile
//     goes through shared memory, so no proxy fence) and issues four
//     m64nNTk16 with B = x from shared memory, while the products of the
//     half before run.  Each output still sums its K in order in one f32
//     accumulator on the tensor cores.  What bounds it now (PERF.md): the
//     consumer warps' own instruction stream, whose dequantization takes
//     about half of a stage and is not hidden, and each block reading all
//     of its range's x (M x K x 2 bytes) through shared memory; N / 64
//     blocks use few of the 132 SMs where N is small.
//   * _ws (weight-stationary; K6, K10), for M >= 2048: 2*M*N*K flops far
//     above the ridge (at (2048, 640, 5120) 13.4 GFLOP over 9.9 MB: 13.6 us
//     of tensor-core time against 3 us of bytes), so the bf16 tensor-core
//     rate is the bound, and only wgmma reaches it.  A first design kept a
//     full-K bf16 stripe of 64 or 32 columns in shared memory (100-182 KB:
//     one or two 4-warp blocks an SM), staged x through registers with two
//     block barriers per group, sized its grid as stripes x M ranges (1.2 to
//     2 waves) and ran mma.sync on 32 x 32 warp tiles: 10% of the bf16 peak.
//     This one (qmm_ws_kernel) keeps no stripe.  Each block is persistent
//     (one per SM) and walks 128 x BN output tiles in bands of M tiles
//     (ws_band_m: all of them where x fits the L2, else as many as keep a
//     band's x within half of it), each band N column by N column, M
//     fastest within a column, so that a weight tile is read from L2 by
//     the blocks beside it and x from device memory about once;
//     BN (80 or 160, the wgmma N) is picked per shape by the caller
//     (ops/quant_matmul.py ws_tile_n) so that the tiles fill whole waves of
//     the 132 SMs.  Four roles run side by side in their own warps, linked
//     by mbarriers: a producer warp keeps a ring of stages full (x [128, 64]
//     bf16 by TMA with the 128-byte swizzle; the raw weight tile [BN, 64]
//     bytes by TMA, where for q4 a stage spans one 128-group and its 64
//     packed bytes a row are loaded once for two product steps; the group's
//     BN scales by cp.async); a dequantizing warpgroup turns each step's raw
//     tile into a bf16 B tile in a ring of three, written in the swizzled
//     layout the wgmma descriptor names; two consumer warpgroups (64 rows
//     each) issue each step's four asynchronous wgmma m64nBNk16 (A and B
//     from shared memory, f32 accumulators in registers) with one step in
//     flight behind, and stage each finished tile as bf16 in shared memory
//     for a TMA store that runs on under the next tile's products.  So each
//     weight is dequantized once per 128-row tile (1/128 of its
//     multiply-adds) on CUDA cores that work beside the tensor cores, and
//     loads, dequantization, products and stores overlap.  The producer
//     keeps running counters (no division by a run-time value a stage),
//     and a barrier wait reads the clock only when its first test fails.
//     What bounds it (PERF.md; tools/torch_kernel_ablate.py --flux, at
//     Flux's (4096, 12288, 3072) and (4352, 3072, 21504)): not the bytes.
//     With the loads, scale copies, dequantization and products all taken
//     out, the ring of barriers and waits alone takes 0.32 and 0.59 ms,
//     the tensor-core bound of the whole product (0.31, 0.58); the
//     dequantization adds about 0.23 ms and the products 0.22 on top, with
//     little overlap, and the loads under 0.07.  The bands took x's
//     re-reads from device memory out at Flux's long K but bought only 1%
//     (q8) to 5% (q4).  Measured and not kept: the dequantization moved
//     into the two consumer warpgroups (no dequantizing warpgroup, one
//     named barrier a step, 168 registers): 10-12% slower at q8 and the SD
//     shapes, as slow at q4; its skeleton still took 0.28 ms.  A 2-block
//     cluster along M sharing the weight (each block dequantizing half of
//     a B tile into both blocks' shared memory, barriers across the
//     cluster): about twice as slow.  Later work: fewer, deeper steps (128
//     deep) and a deeper ring, which the shared memory has to make room for.
//
//   q8_matmul_ws_int8  replaces mlimgsynth_tpu/ops/q8_matmul.py
//                      q8_matmul_ws_int8 / _q8_ws_int8_kernel (K7): W8A8
//                      with per-column weight scales.  x bf16 [M, K], W
//                      int8 [N, K] quantized per output column, s_col f32
//                      [N]; for each row and each K slab of _ws_slab(K)
//                      (1024, 512 or 256 where K divides, else K), amax over
//                      the slab in f32, inv = 127 / amax (0 where amax is
//                      0), xq = rint(x * inv) (half to even); the int8 x
//                      int8 product of the slab sums exactly in int32; the
//                      slabs fold into an f32 sum in slab order as
//                      acc + float(dot) * (amax * (1/127)), with no fused
//                      multiply-add, exactly as the reference's kernel and
//                      its XLA twin round; y = bf16_rn(acc * s_col[n]).
//   q8_matmul_int8  replaces q8_matmul_int8 / _q8q8_kernel (K8), the
//                   MLIS_Q8_MODE=int8 route: W8A8 on the per-block weights of
//                   the other q8 kernels (int8 [N, K], scales f32 [N, K /
//                   128]).  x is quantized per (row, 128-deep K block) as for
//                   K7 (slab 128), and each block folds into the f32 sum in
//                   block order as acc + (float(dot) * (amax * (1/127))) *
//                   s[n, block], with no fused multiply-add: the association
//                   and order of the XLA twin (q8_matmul_int8_xla, which the
//                   reference's tests hold its Pallas kernel to; the Pallas
//                   kernel itself folds dot * ((amax / 127) * s)); y =
//                   bf16_rn(acc).
//   Two kernels run per call of either.  quant_rows: one warp per (row,
//   slab) holds the slab in registers (x read once), takes its amax and
//   writes the int8 row slab and the amax to scratch the wrapper allocates.
//   Quantizing inside the GEMM would repeat it once per BN columns (a first
//   K7 design did, at 4% of the int8 rate); fusing it into the op that
//   produces x is later work (a slab's amax must exist before its int8
//   values, and a slab spans several of that op's tiles).  qmm_i8_kernel
//   <BLOCK_SCALES, BN>, one template for both (BLOCK_SCALES: K8), is built
//   from qmm_ws_kernel's parts: a persistent block per SM walks 128 x BN
//   output tiles, M fastest within an N column; BN (32, 80 or 128, the
//   int8 wgmma N) is picked per shape by the launcher (i8_tile_n, the rule
//   of ops/quant_matmul.py i8_tile_n) so that the M >= 2048 products fill
//   whole waves and a product with M <= 128 puts many blocks on the weight
//   stream (no split-K: it would change the f32 rounding).  A producer warp
//   keeps a TMA ring of 128-deep stages (xq [128][128] and W [BN][128],
//   K-major, 128-byte swizzle: one stage is one K8 block) with the rows'
//   amax and the weight scales copied into shared memory beside the stage
//   that reads them; two consumer warpgroups (64 rows each) issue four
//   wgmma m64nBNk32 s8 products a stage into int32 sums, keep one stage in
//   flight within a slab, and at a slab's end fold with the _rn intrinsics
//   (float(dot) by __int2float_rn: exact below 2^24, i.e. for slabs up to
//   1040, and above it rounded to nearest as the twin rounds its product),
//   then stage the finished tile as bf16 for a TMA store that runs on under
//   the next tile.
//   What bounds them (PERF.md; tools/torch_kernel_ablate.py --w8a8,
//   tools/torch_kernel_trace.py).  K7's floor at the SD3 x-stream products
//   (M = 8192, K 1536 or 6144) is the int8 rate (1,979 TOP/s).  K8's at
//   (8192, 640, 5120) is the bf16 output (84 MB, 25 us of its 29 us bound),
//   and next the fold, which costs the CUDA cores about as many issue slots
//   a 128-deep block as the products cost the tensor cores.  Measured,
//   neither floor is reached.  128 x 128 tiles read xq once per 128 columns
//   and W once per 128 rows, so K7 pulls about 6 TB/s from L2 and its
//   stages wait on TMA latency that a five-stage ring cannot hide; K8's
//   consumer warpgroups spend most of a stage in the fold, both at once.
//   What the design does about its costs: no division in either role's
//   per-stage loop; no wgmma wait and no read of the int32 sums inside a
//   branch (ptxas would serialize the products); K7's column scales come through shared memory with the
//   tile's last stage, not from global memory in the epilogue; the
//   128-wide tiles stage their output in the 128-byte swizzle (a plain
//   layout is an 8-way bank conflict).  K8 converts with __int2float_rn:
//   the exact integer-add conversion (|dot| < 2^22) made the fold slower.
//   Later work: a 2-block cluster multicasting xq or W (K7's L2 bytes),
//   two stages of products in flight for K8 (a second set of int32 sums,
//   which the registers do not hold at BN 128), 256-deep stages.
//
// qmm_tile_kernel, qmm_ws_kernel and qmm_i8_kernel use TMA, wgmma and warp
// specialisation.
// The TPU artifacts (sublane-padded [g, 8, bn] scales, the VMEM/HBM cost
// model choosing a geometry, grid-carried accumulators) are not carried over.

#include "hopper.cuh"

namespace {

constexpr int kGroup = 128;          // K rows per scale group

struct Args {
  const bf16* x;      // [M, K]
  const int8_t* w;    // [N, K] (q8) or [N, K / 2] (q4)
  const float* s;     // [N, K / 128]
  bf16* y;            // [M, N]
  int m, n, k;
};

template <int MI, int NI>
__device__ __forceinline__ void zero_acc(float (&acc)[MI][NI][4]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;
}

// bf16 epilogue of one warp's tile, rows m0w.. and columns n0w.., masked
template <int MI, int NI>
__device__ __forceinline__ void store_tile(const float (&acc)[MI][NI][4], const Args& a,
                                           int m0w, int n0w) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool paired = (a.n & 1) == 0;   // then (row * n + even col) is 4-byte aligned
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0w + mi * 16 + g + 8 * r;
      if (row >= a.m) continue;
      bf16* yr = a.y + (long long)row * a.n;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int col = n0w + ni * 8 + 2 * t;
        const float v0 = acc[mi][ni][2 * r], v1 = acc[mi][ni][2 * r + 1];
        if (paired && col + 1 < a.n) {
          *reinterpret_cast<uint32_t*>(yr + col) = pack_f32(v0, v1);
        } else {
          if (col < a.n) yr[col] = __float2bfloat16(v0);
          if (col + 1 < a.n) yr[col + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K6 / K10: weight-stationary products on Hopper (TMA ring, wgmma, persistent grid)
// ---------------------------------------------------------------------------

constexpr int kWsBM = 128;                     // output rows per tile: two consumer warpgroups of 64
constexpr int kWsBK = 64;                      // K per product step: one 128-byte swizzle row of bf16
constexpr int kWsConsumers = 256;              // two warpgroups of products
constexpr int kWsDequant = 128;                // a warpgroup that dequantizes
constexpr int kWsThreads = kWsConsumers + kWsDequant + 32;   // and a producer warp
constexpr int kWsSmemMax = 232448;             // dynamic shared memory one block may use
constexpr int kXBox = kWsBM * kWsBK * 2;       // one TMA box of x: 128 rows x 128 bytes

// Shared memory of one block: a ring of three dequantized B tiles; the
// output staging, 64 x BN bf16 for each consumer warpgroup; a ring of
// stages, each an x tile (q4: two, a whole 128-group), the raw weight tile
// [BN][64] bytes and the BN scales of its 128-group; the barriers.  The
// products keep one step in flight behind the one they issue.
template <int BITS, int BN>
struct WsCfg {
  static constexpr int kSteps = BITS == 8 ? 1 : 2;   // product steps per stage
  static constexpr int kX = kSteps * kXBox;
  static constexpr int kW = BN * 64;
  static constexpr int kS = BN * 4;
  static constexpr int kStage = kX + kW + kS;
  static constexpr int kB = BN * kWsBK * 2;           // a B tile; also one warpgroup's staging
  static constexpr int kBufs = 3;
  static constexpr int kFixed = (kBufs + 2) * kB + 1024 + 512;   // + base alignment, barriers
  static constexpr int kFit = (kWsSmemMax - kFixed) / kStage;
  static constexpr int kStages = kFit > 8 ? 8 : kFit;
  static constexpr int kSmem = kFixed + kStages * kStage;
  static_assert(kStages * kSteps >= 4, "a ring of at least four product steps");
};

struct WsArgs {
  Args a;
  int tma_store;    // y stored by TMA from shared memory (N a multiple of 8)
  int m_tiles;      // 128-row tiles of M
  int band;         // M tiles a band (ws_band_m)
  int band_tiles;   // tiles a whole band: band x the N columns
  int tiles;
};

// The 128-row tile (mt) and the N column (nt) of tile t of the walk: bands
// of p.band M tiles (the last may hold fewer), each taken column by
// column, M fastest within a column of the band.  With one band (band =
// m_tiles) this is M fastest within each N column of the whole output.
__device__ __forceinline__ void ws_tile_at(const WsArgs& p, int t, int& mt, int& nt) {
  const int b = t / p.band_tiles, r = t - b * p.band_tiles;
  const int g = min(p.band, p.m_tiles - b * p.band);
  nt = r / g;
  mt = b * p.band + (r - nt * g);
}

// 4 bytes, zero-filled where !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// bar receives one arrival once this thread's earlier cp.async copies landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// keeps the compiler from moving accumulator accesses across the
// asynchronous products
template <int NB>
__device__ __forceinline__ void pin(float (&d)[1][NB][4]) {
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[0][j][e])::"memory");
}

// d[64 x N] (+)= A[64 x 16] . B[N x 16]^T, both K-major in shared memory.
// d[0][j][e] holds row 16 * warp + lane / 4 + 8 * (e / 2), column 8 * j +
// 2 * (lane % 4) + e % 2: store_tile's layout with MI = 1.
template <int N>
__device__ __forceinline__ void wgmma_tile(float (&d)[1][N / 8][4], uint64_t a, uint64_t b,
                                           int scale_d);

template <>
__device__ __forceinline__ void wgmma_tile<80>(float (&d)[1][10][4], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0][0]), "+f"(d[0][0][1]), "+f"(d[0][0][2]), "+f"(d[0][0][3]),
        "+f"(d[0][1][0]), "+f"(d[0][1][1]), "+f"(d[0][1][2]), "+f"(d[0][1][3]),
        "+f"(d[0][2][0]), "+f"(d[0][2][1]), "+f"(d[0][2][2]), "+f"(d[0][2][3]),
        "+f"(d[0][3][0]), "+f"(d[0][3][1]), "+f"(d[0][3][2]), "+f"(d[0][3][3]),
        "+f"(d[0][4][0]), "+f"(d[0][4][1]), "+f"(d[0][4][2]), "+f"(d[0][4][3]),
        "+f"(d[0][5][0]), "+f"(d[0][5][1]), "+f"(d[0][5][2]), "+f"(d[0][5][3]),
        "+f"(d[0][6][0]), "+f"(d[0][6][1]), "+f"(d[0][6][2]), "+f"(d[0][6][3]),
        "+f"(d[0][7][0]), "+f"(d[0][7][1]), "+f"(d[0][7][2]), "+f"(d[0][7][3]),
        "+f"(d[0][8][0]), "+f"(d[0][8][1]), "+f"(d[0][8][2]), "+f"(d[0][8][3]),
        "+f"(d[0][9][0]), "+f"(d[0][9][1]), "+f"(d[0][9][2]), "+f"(d[0][9][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tile<160>(float (&d)[1][20][4], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0][0]), "+f"(d[0][0][1]), "+f"(d[0][0][2]), "+f"(d[0][0][3]),
        "+f"(d[0][1][0]), "+f"(d[0][1][1]), "+f"(d[0][1][2]), "+f"(d[0][1][3]),
        "+f"(d[0][2][0]), "+f"(d[0][2][1]), "+f"(d[0][2][2]), "+f"(d[0][2][3]),
        "+f"(d[0][3][0]), "+f"(d[0][3][1]), "+f"(d[0][3][2]), "+f"(d[0][3][3]),
        "+f"(d[0][4][0]), "+f"(d[0][4][1]), "+f"(d[0][4][2]), "+f"(d[0][4][3]),
        "+f"(d[0][5][0]), "+f"(d[0][5][1]), "+f"(d[0][5][2]), "+f"(d[0][5][3]),
        "+f"(d[0][6][0]), "+f"(d[0][6][1]), "+f"(d[0][6][2]), "+f"(d[0][6][3]),
        "+f"(d[0][7][0]), "+f"(d[0][7][1]), "+f"(d[0][7][2]), "+f"(d[0][7][3]),
        "+f"(d[0][8][0]), "+f"(d[0][8][1]), "+f"(d[0][8][2]), "+f"(d[0][8][3]),
        "+f"(d[0][9][0]), "+f"(d[0][9][1]), "+f"(d[0][9][2]), "+f"(d[0][9][3]),
        "+f"(d[0][10][0]), "+f"(d[0][10][1]), "+f"(d[0][10][2]), "+f"(d[0][10][3]),
        "+f"(d[0][11][0]), "+f"(d[0][11][1]), "+f"(d[0][11][2]), "+f"(d[0][11][3]),
        "+f"(d[0][12][0]), "+f"(d[0][12][1]), "+f"(d[0][12][2]), "+f"(d[0][12][3]),
        "+f"(d[0][13][0]), "+f"(d[0][13][1]), "+f"(d[0][13][2]), "+f"(d[0][13][3]),
        "+f"(d[0][14][0]), "+f"(d[0][14][1]), "+f"(d[0][14][2]), "+f"(d[0][14][3]),
        "+f"(d[0][15][0]), "+f"(d[0][15][1]), "+f"(d[0][15][2]), "+f"(d[0][15][3]),
        "+f"(d[0][16][0]), "+f"(d[0][16][1]), "+f"(d[0][16][2]), "+f"(d[0][16][3]),
        "+f"(d[0][17][0]), "+f"(d[0][17][1]), "+f"(d[0][17][2]), "+f"(d[0][17][3]),
        "+f"(d[0][18][0]), "+f"(d[0][18][1]), "+f"(d[0][18][2]), "+f"(d[0][18][3]),
        "+f"(d[0][19][0]), "+f"(d[0][19][1]), "+f"(d[0][19][2]), "+f"(d[0][19][3])
      : "l"(a), "l"(b), "r"(scale_d));
}
// As wgmma_tile with A from registers: a holds this thread's A fragment
// (rows 16 * warp + lane / 4 and + 8, columns 2 * (lane % 4) .. + 1 and
// + 8 .. + 9, as bf16 pairs, mma.m16n8k16's A layout); the registers must
// keep their values until the products complete.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[1][N / 8][4], const uint32_t (&a)[4],
                                         uint64_t b, int scale_d);

#define QMM_ACC4(j) "+f"(d[0][j][0]), "+f"(d[0][j][1]), "+f"(d[0][j][2]), "+f"(d[0][j][3])

template <>
__device__ __forceinline__ void wgmma_rs<8>(float (&d)[1][1][4], const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : QMM_ACC4(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[1][2][4], const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : QMM_ACC4(0), QMM_ACC4(1)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[1][4][4], const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : QMM_ACC4(0), QMM_ACC4(1), QMM_ACC4(2), QMM_ACC4(3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[1][6][4], const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : QMM_ACC4(0), QMM_ACC4(1), QMM_ACC4(2), QMM_ACC4(3),
        QMM_ACC4(4), QMM_ACC4(5)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[1][8][4], const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : QMM_ACC4(0), QMM_ACC4(1), QMM_ACC4(2), QMM_ACC4(3),
        QMM_ACC4(4), QMM_ACC4(5), QMM_ACC4(6), QMM_ACC4(7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[1][10][4], const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
      : QMM_ACC4(0), QMM_ACC4(1), QMM_ACC4(2), QMM_ACC4(3),
        QMM_ACC4(4), QMM_ACC4(5), QMM_ACC4(6), QMM_ACC4(7),
        QMM_ACC4(8), QMM_ACC4(9)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[1][12][4], const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : QMM_ACC4(0), QMM_ACC4(1), QMM_ACC4(2), QMM_ACC4(3),
        QMM_ACC4(4), QMM_ACC4(5), QMM_ACC4(6), QMM_ACC4(7),
        QMM_ACC4(8), QMM_ACC4(9), QMM_ACC4(10), QMM_ACC4(11)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[1][16][4], const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : QMM_ACC4(0), QMM_ACC4(1), QMM_ACC4(2), QMM_ACC4(3),
        QMM_ACC4(4), QMM_ACC4(5), QMM_ACC4(6), QMM_ACC4(7),
        QMM_ACC4(8), QMM_ACC4(9), QMM_ACC4(10), QMM_ACC4(11),
        QMM_ACC4(12), QMM_ACC4(13), QMM_ACC4(14), QMM_ACC4(15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<160>(float (&d)[1][20][4], const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 0;\n}\n"
      : QMM_ACC4(0), QMM_ACC4(1), QMM_ACC4(2), QMM_ACC4(3),
        QMM_ACC4(4), QMM_ACC4(5), QMM_ACC4(6), QMM_ACC4(7),
        QMM_ACC4(8), QMM_ACC4(9), QMM_ACC4(10), QMM_ACC4(11),
        QMM_ACC4(12), QMM_ACC4(13), QMM_ACC4(14), QMM_ACC4(15),
        QMM_ACC4(16), QMM_ACC4(17), QMM_ACC4(18), QMM_ACC4(19)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[1][24][4], const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      : QMM_ACC4(0), QMM_ACC4(1), QMM_ACC4(2), QMM_ACC4(3),
        QMM_ACC4(4), QMM_ACC4(5), QMM_ACC4(6), QMM_ACC4(7),
        QMM_ACC4(8), QMM_ACC4(9), QMM_ACC4(10), QMM_ACC4(11),
        QMM_ACC4(12), QMM_ACC4(13), QMM_ACC4(14), QMM_ACC4(15),
        QMM_ACC4(16), QMM_ACC4(17), QMM_ACC4(18), QMM_ACC4(19),
        QMM_ACC4(20), QMM_ACC4(21), QMM_ACC4(22), QMM_ACC4(23)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[1][32][4], const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : QMM_ACC4(0), QMM_ACC4(1), QMM_ACC4(2), QMM_ACC4(3),
        QMM_ACC4(4), QMM_ACC4(5), QMM_ACC4(6), QMM_ACC4(7),
        QMM_ACC4(8), QMM_ACC4(9), QMM_ACC4(10), QMM_ACC4(11),
        QMM_ACC4(12), QMM_ACC4(13), QMM_ACC4(14), QMM_ACC4(15),
        QMM_ACC4(16), QMM_ACC4(17), QMM_ACC4(18), QMM_ACC4(19),
        QMM_ACC4(20), QMM_ACC4(21), QMM_ACC4(22), QMM_ACC4(23),
        QMM_ACC4(24), QMM_ACC4(25), QMM_ACC4(26), QMM_ACC4(27),
        QMM_ACC4(28), QMM_ACC4(29), QMM_ACC4(30), QMM_ACC4(31)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

#undef QMM_ACC4

// A consumer warp's 16 rows of the tile (d as wgmma_tile leaves it) as bf16
// into its warpgroup's staging, [64][BN] row-major, from row r0.
template <int NB>
__device__ __forceinline__ void stage_ws(const float (&d)[1][NB][4], uint8_t* staging, int r0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    uint32_t* row = reinterpret_cast<uint32_t*>(staging + (r0 + g + 8 * r) * NB * 16);
#pragma unroll
    for (int j = 0; j < NB; ++j) row[4 * j + t] = pack_f32(d[0][j][2 * r], d[0][j][2 * r + 1]);
  }
}

// One product step's B tile.  raw: [BN][64] bytes (q8: the step's 64 k; q4:
// the 128-group's packed bytes, whose low nibbles are its first 64 k and
// high nibbles its last 64, half picks which); sc: the BN scales of the
// group.  Writes bf16_rn(q * s) to b, [BN][64] bf16 in the 128-byte swizzled
// K-major layout of the wgmma descriptor: row r's 16-byte chunk j at
// r * 128 + (j ^ (r % 8)) * 16.  A byte becomes the float 2^23 + (q + bias)
// by a byte permute into 0x4B000000, minus 2^23 + bias: exact, as is
// float(q); then the f32 product and the bf16 rounding of the plain version.
template <int BITS, int BN>
__device__ __forceinline__ void deq_tile(uint8_t* __restrict__ b, const uint8_t* __restrict__ raw,
                                         const float* __restrict__ sc, int half,
                                         int tid) {   // tid: 0 .. kWsDequant - 1
  constexpr float kBias = BITS == 8 ? 8388736.f : 8388616.f;   // 2^23 + 128, 2^23 + 8
  constexpr int kUnits = (BN * 4 + kWsDequant - 1) / kWsDequant;   // 16-k chunks a thread
  // all the thread's loads first, so that their latencies overlap
  uint4 v[kUnits];
  float s[kUnits];
#pragma unroll
  for (int i = 0; i < kUnits; ++i) {
    const int u = tid + i * kWsDequant;   // row u / 4, 16-k chunk u % 4
    if (u < BN * 4) {
      v[i] = *reinterpret_cast<const uint4*>(raw + (u >> 2) * 64 + (u & 3) * 16);
      s[i] = sc[u >> 2];
    }
  }
#pragma unroll
  for (int i = 0; i < kUnits; ++i) {
    const int u = tid + i * kWsDequant, r = u >> 2, c = u & 3;
    if (u >= BN * 4) break;
    const uint32_t words[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
    uint32_t p[8];
#pragma unroll
    for (int w4 = 0; w4 < 4; ++w4) {
      const uint32_t w = BITS == 8 ? words[w4] ^ 0x80808080u
                                   : ((half ? words[w4] >> 4 : words[w4]) & 0x0F0F0F0Fu) ^ 0x08080808u;
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f[e] = __fmul_rn(__fadd_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | e)), -kBias),
                         s[i]);
      p[2 * w4] = pack_f32(f[0], f[1]);
      p[2 * w4 + 1] = pack_f32(f[2], f[3]);
    }
    uint8_t* row = b + r * 128;
    *reinterpret_cast<uint4*>(row + (((2 * c) ^ (r & 7)) << 4)) = make_uint4(p[0], p[1], p[2], p[3]);
    *reinterpret_cast<uint4*>(row + (((2 * c + 1) ^ (r & 7)) << 4)) = make_uint4(p[4], p[5], p[6], p[7]);
  }
}

// Persistent: block b takes tiles b, b + grid, ...  Four roles, each in its
// own warps and each a loop over the block's 64-deep product steps (q4:
// stages of two):
//   * warp 12, the producer, keeps the ring of stages full: x and the raw
//     weight by TMA, the scales by cp.async; a stage's full barrier counts
//     the TMA bytes and the 32 lanes' copies, its empty barrier the 12 warps
//     that read it;
//   * warps 8-11 dequantize each step's raw weight into the B ring (full
//     and empty barriers per B tile: 4 and 8 warps);
//   * warpgroups 0 and 1, rows 0-63 and 64-127 of the tile, issue each
//     step's four asynchronous m64nBNk16 products, keep kBufs - 2 steps in
//     flight, free the B tiles and stages whose products are done, and
//     after a tile's last step stage it as bf16 in shared memory and store
//     it by TMA (rows and columns past M and N are not written), which runs
//     on while the next tile's products do; where N is not a multiple of 8
//     (no tensor map of y: its rows are not 16-byte aligned), store_tile
//     stores from registers.
template <int BITS, int BN>
__global__ void __launch_bounds__(kWsThreads, 1)
    qmm_ws_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap w_map,
                  const __grid_constant__ CUtensorMap y_map, const WsArgs p) {
  using C = WsCfg<BITS, BN>;
  constexpr int S = C::kSteps, R = C::kStages, NB = C::kBufs;
  const Args& a = p.a;
  extern __shared__ unsigned char ws_smem[];
  // aligned by an offset from the array, so that the compiler knows every
  // pointer below is shared memory (shared loads and 32-bit addresses)
  uint8_t* sb = ws_smem + ((1024 - (smem_u32(ws_smem) & 1023)) & 1023);
  uint8_t* sy = sb + NB * C::kB;   // output staging
  uint8_t* sx = sy + 2 * C::kB;
  uint8_t* sw = sx + R * C::kX;
  float* ss = reinterpret_cast<float*>(sw + R * C::kW);
  uint64_t* full = reinterpret_cast<uint64_t*>(ss + R * BN);
  uint64_t* empty = full + R;
  uint64_t* bfull = empty + R;
  uint64_t* bempty = bfull + NB;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < R; ++i) {
      mbar_init(smem_u32(full + i), 1 + 32);
      mbar_init(smem_u32(empty + i), (kWsConsumers + kWsDequant) / 32);
    }
    for (int i = 0; i < NB; ++i) {
      mbar_init(smem_u32(bfull + i), kWsDequant / 32);
      mbar_init(smem_u32(bempty + i), kWsConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int ksteps = a.k / kWsBK;   // product steps per tile
  const int n_groups = a.k / kGroup;
  const int my_tiles = (p.tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int total = my_tiles * ksteps;

  if (tid >= kWsConsumers + kWsDequant) {   // the producer
    // running counters, no division by a run-time value per stage: the
    // producer is one warp and its loop sets the pace of the ring
    int slot = 0, phase = 0;
    for (int t = 0; t < my_tiles; ++t) {
      int mt, nt;
      ws_tile_at(p, blockIdx.x + t * gridDim.x, mt, nt);
      const int m0 = mt * kWsBM, n0 = nt * BN;
      for (int k0 = 0; k0 < a.k; k0 += S * kWsBK) {
        const int kg = k0 / kGroup;
        const uint32_t bar = smem_u32(full + slot);
        mbar_wait(smem_u32(empty + slot), phase ^ 1);
        if (lane == 0) {
          mbar_expect_tx(bar, C::kX + C::kW);
          for (int h = 0; h < S; ++h)
            tma_load_2d(smem_u32(sx + slot * C::kX + h * kXBox), &x_map, bar, k0 + h * kWsBK, m0);
          tma_load_2d(smem_u32(sw + slot * C::kW), &w_map, bar, k0 * BITS / 8, n0);
        }
        for (int r = lane; r < BN; r += 32) {
          const int n = min(n0 + r, a.n - 1);
          cp_async4(smem_u32(ss + slot * BN + r), &a.s[(long long)n * n_groups + kg], n0 + r < a.n);
        }
        cp_async_arrive(bar);
        if (++slot == R) slot = 0, phase ^= 1;
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  if (tid >= kWsConsumers) {   // dequantize
    for (int j = 0; j < total; ++j) {
      const int st = j / S, slot = st % R, b = j % NB;
      if (j % S == 0) mbar_wait(smem_u32(full + slot), (st / R) & 1);
      mbar_wait(smem_u32(bempty + b), ((j / NB) & 1) ^ 1);
      __syncwarp();
      deq_tile<BITS, BN>(sb + b * C::kB, sw + slot * C::kW, ss + slot * BN, j % S,
                         tid - kWsConsumers);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // visible to wgmma
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(smem_u32(bfull + b));
        if (j % S == S - 1) mbar_arrive(smem_u32(empty + slot));   // raw weight and scales read
      }
    }
    return;
  }

  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  float acc[1][BN / 8][4];
  zero_acc(acc);
  int j = 0, done = -1;   // the next step; the last step whose products completed
  // frees the B tiles and stages read by the products of steps done + 1 .. now
  auto release = [&](int now) {
    if (lane == 0)
      for (int i = done + 1; i <= now; ++i) {
        mbar_arrive(smem_u32(bempty + i % NB));
        if (i % S == S - 1) mbar_arrive(smem_u32(empty + (i / S) % R));
      }
    done = max(done, now);
    __syncwarp();
  };
  for (int t = 0; t < my_tiles; ++t) {
    for (int kk = 0; kk < ksteps; ++kk, ++j) {
      const int st = j / S;
      if (j % S == 0) mbar_wait(smem_u32(full + st % R), (st / R) & 1);   // x
      mbar_wait(smem_u32(bfull + j % NB), (j / NB) & 1);
      __syncwarp();
      const uint32_t xa = smem_u32(sx + (st % R) * C::kX + (j % S) * kXBox + wg * (kXBox / 2));
      const uint32_t ba = smem_u32(sb + (j % NB) * C::kB);
      pin(acc);
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < kWsBK / 16; ++k16)
        wgmma_tile<BN>(acc, sw128_desc(xa + k16 * 32), sw128_desc(ba + k16 * 32), kk + k16 > 0);
      wgmma_commit();
      wgmma_wait<NB - 2>();
      pin(acc);
      release(j - (NB - 2));
    }
    wgmma_wait<0>();
    pin(acc);
    release(j - 1);
    int mt, nt;
    ws_tile_at(p, blockIdx.x + t * gridDim.x, mt, nt);
    const int m0 = mt * kWsBM + wg * 64, n0 = nt * BN;
    if (p.tma_store) {   // through the staging, stored while the next tile runs
      uint8_t* stg = sy + wg * C::kB;
      if ((tid & 127) == 0) tma_store_wait<true>();   // the last tile's store has read it
      warpgroup_sync(wg);
      stage_ws(acc, stg, warp * 16);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // visible to the TMA
      warpgroup_sync(wg);
      if ((tid & 127) == 0) tma_store_2d(&y_map, smem_u32(stg), n0, m0);
    } else {
      store_tile(acc, a, m0 + warp * 16, n0);
    }
  }
  if (p.tma_store && (tid & 127) == 0) tma_store_wait<false>();
}

// ---------------------------------------------------------------------------
// K5 / K9: the products with M < 2048, swapped: y^T = deq(W) . x^T
// ---------------------------------------------------------------------------

constexpr int kTileRows = 64;                    // weight rows a block: the wgmma M
constexpr int kTileThreads = 128 + 32;           // one consumer warpgroup and a producer warp
constexpr int kTileWBox = kTileRows * 64;        // one TMA box of raw weight: 64 rows x 64 bytes

// Shared memory of one block: a ring of stages, each one 128-deep scale
// group: x [NT][128] as two [NT][64] boxes in the 128-byte swizzle (the
// wgmma B operand, K-major); the raw weight, [64][64] bytes in the 64-byte
// swizzle (q8: two boxes, the group's two 64-deep halves; q4: one, whose
// low nibbles are the first half and high nibbles the second); the
// group's 64 scales; the barriers.
template <int BITS, int NT>
struct TileCfg {
  static constexpr int kXBox = NT * kWsBK * 2;
  static constexpr int kX = 2 * kXBox;
  static constexpr int kW = (BITS == 8 ? 2 : 1) * kTileWBox;
  static constexpr int kStage = kX + kW + kTileRows * 4;
  static constexpr int kFixed = 1024 + 256;        // base alignment, barriers
  static constexpr int kFit = (kWsSmemMax - kFixed) / kStage;
  static constexpr int kStages = kFit > 6 ? 6 : kFit;
  static constexpr int kSmem = kFixed + kStages * kStage;
  static_assert(NT % 8 == 0 && NT <= 256 && kStages >= 2, "a wgmma N and a ring");
};

struct TileArgs {
  Args a;
  int ranges;   // row ranges of x, NT rows each; block b is (b % ranges, b / ranges)
};

// This thread's A fragments of one 64-deep half of a stage: rows r0 and r0
// + 8 of the block's 64 weight rows, k16 chunks c = 0..3; f[c] = (r0, 16c +
// 2t .. + 1), (r0 + 8, same), (r0, 16c + 2t + 8 .. + 9), (r0 + 8, same), each
// bf16_rn(q * s) as deq_tile computes it.  raw: [64][64] bytes in the
// 64-byte swizzle (16-byte chunk c of row r at r * 64 + (c ^ (r / 2) % 4) *
// 16: the eight rows a warp reads at once land in distinct banks); q4: the
// nibble of each byte that half picks.  The chunk's 16 bytes are loaded
// whole and the thread's four picked by byte permutes.
template <int BITS>
__device__ __forceinline__ void deq_frag(uint32_t (&f)[4][4], const uint8_t* __restrict__ raw,
                                         int r0, int t, int half, float s0, float s1) {
  constexpr float kBias = BITS == 8 ? 8388736.f : 8388616.f;   // 2^23 + 128, 2^23 + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    const float s = i ? s1 : s0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint4 v = *reinterpret_cast<const uint4*>(raw + r * 64 + ((c ^ ((r >> 1) & 3)) << 4));
      // bytes 2t, 2t + 1 (word t / 2) and 2t + 8, 2t + 9 (word 2 + t / 2)
      const uint32_t lo = (t >> 1) ? v.y : v.x, hi = (t >> 1) ? v.w : v.z;
      uint32_t w = __byte_perm(lo, hi, (t & 1) ? 0x7632 : 0x5410);
      w = BITS == 8 ? w ^ 0x80808080u : ((half ? w >> 4 : w) & 0x0F0F0F0Fu) ^ 0x08080808u;
      float q[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        q[e] = __fmul_rn(__fadd_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | e)), -kBias), s);
      f[c][i] = pack_f32(q[0], q[1]);
      f[c][2 + i] = pack_f32(q[2], q[3]);
    }
  }
}

// keeps A fragments live up to here: the asynchronous products read their
// registers until they complete, so the compiler must not reuse them sooner
__device__ __forceinline__ void pin_a(uint32_t (&f)[4][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(f[c][e])::"memory");
}

// One block per (row range, 64 weight rows): the weight is dequantized once
// per row range, and a range holds up to 256 rows, so once where M <= 256.
// The weight rows are the wgmma's 64-row A operand, dequantized by the
// consumers into registers, and x's rows (NT, up to 256) its N: a product
// step is one m64nNTk16 whatever M, and no dequantized tile goes through
// shared memory.  Two roles:
//   * warp 4, the producer, keeps the ring of stages full: x and the raw
//     weight by TMA, the scales by cp.async; a stage's full barrier counts
//     the TMA bytes and the 32 lanes' copies, its empty barrier the four
//     consumer warps;
//   * warpgroup 0 takes each stage in two 64-deep halves: it waits for the
//     products of the last stage's same half (wgmma_wait<1>: the other half
//     stays in flight), dequantizes the half's A fragments into their
//     registers, issues its four products and commits them; after the
//     second half's wait the last stage is free.  So the dequantization of
//     one half runs while the products of the other do.  Then y^T's tile
//     is stored from registers, masked (y[m, n] for the tile's x row m and
//     weight row n).
template <int BITS, int NT>
__global__ void __launch_bounds__(kTileThreads, 1)
    qmm_tile_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap w_map, const TileArgs p) {
  using C = TileCfg<BITS, NT>;
  constexpr int R = C::kStages;
  const Args& a = p.a;
  extern __shared__ unsigned char tile_smem[];
  uint8_t* sx = tile_smem + ((1024 - (smem_u32(tile_smem) & 1023)) & 1023);   // as in qmm_ws_kernel
  uint8_t* sw = sx + R * C::kX;
  float* ss = reinterpret_cast<float*>(sw + R * C::kW);
  uint64_t* full = reinterpret_cast<uint64_t*>(ss + R * kTileRows);
  uint64_t* empty = full + R;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < R; ++i) {
      mbar_init(smem_u32(full + i), 1 + 32);
      mbar_init(smem_u32(empty + i), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n_groups = a.k / kGroup;
  const int m0 = (blockIdx.x % p.ranges) * NT, n0 = (blockIdx.x / p.ranges) * kTileRows;

  if (tid >= 128) {   // the producer
    int slot = 0, phase = 0;
    for (int kg = 0; kg < n_groups; ++kg) {
      const uint32_t bar = smem_u32(full + slot);
      mbar_wait_cpp(smem_u32(empty + slot), phase ^ 1);
      if (lane == 0) {
        mbar_expect_tx(bar, C::kX + C::kW);
        for (int h = 0; h < 2; ++h)
          tma_load_2d(smem_u32(sx + slot * C::kX + h * C::kXBox), &x_map, bar,
                      kg * kGroup + h * kWsBK, m0);
        for (int h = 0; h < C::kW / kTileWBox; ++h)
          tma_load_2d(smem_u32(sw + slot * C::kW + h * kTileWBox), &w_map, bar,
                      kg * (kGroup * BITS / 8) + h * 64, n0);
      }
      for (int r = lane; r < kTileRows; r += 32) {
        const int n = min(n0 + r, a.n - 1);
        cp_async4(smem_u32(ss + slot * kTileRows + r), &a.s[(long long)n * n_groups + kg],
                  n0 + r < a.n);
      }
      cp_async_arrive(bar);
      if (++slot == R) slot = 0, phase ^= 1;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  const int warp = tid >> 5, t = lane & 3;
  const int r0 = warp * 16 + (lane >> 2);   // this thread's weight rows r0, r0 + 8
  float acc[1][NT / 8][4];
  zero_acc(acc);
  uint32_t af[2][4][4];   // A fragments of a stage's two halves
  int slot = 0, phase = 0;
  for (int kg = 0; kg < n_groups; ++kg) {
    mbar_wait_cpp(smem_u32(full + slot), phase);
    const float s0 = ss[slot * kTileRows + r0], s1 = ss[slot * kTileRows + r0 + 8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      wgmma_wait<1>();   // the last stage's half h is done: af[h] is free
      pin(acc);
      pin_a(af[h]);
      if (h == 1 && kg > 0 && lane == 0)   // and so is the last stage
        mbar_arrive(smem_u32(empty + (slot == 0 ? R - 1 : slot - 1)));
      deq_frag<BITS>(af[h], sw + slot * C::kW + (BITS == 8 ? h * kTileWBox : 0), r0, t,
                     BITS == 8 ? 0 : h, s0, s1);
      const uint32_t xb = smem_u32(sx + slot * C::kX + h * C::kXBox);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < 4; ++c)
        wgmma_rs<NT>(acc, af[h][c], sw128_desc(xb + c * 32), kg + h + c > 0);
      wgmma_commit();
    }
    if (++slot == R) slot = 0, phase ^= 1;
  }
  wgmma_wait<0>();
  pin(acc);
  // d[0][j][e] is y^T[r0 + 8 * (e / 2), 8 * j + 2 * t + e % 2] of the tile
#pragma unroll
  for (int jj = 0; jj < NT / 8; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + 8 * jj + 2 * t + (e & 1), n = n0 + r0 + 8 * (e >> 1);
      if (m < a.m && n < a.n) a.y[(long long)m * a.n + n] = __float2bfloat16(acc[0][jj][e]);
    }
}

Args make_args(const void* x, const void* w, const void* s, void* y, int m, int n, int k) {
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.s = static_cast<const float*>(s);
  a.y = static_cast<bf16*>(y);
  a.m = m;
  a.n = n;
  a.k = k;
  return a;
}

bool bad_shape(int m, int n, int k) {
  return m <= 0 || n <= 0 || k <= 0 || k % kGroup != 0;
}

// M tiles a band of the ws walk, the rule of ops/quant_matmul.py
// ws_band_m: all of them where x fits the L2, else as many as keep a
// band's x rows (128 x K bf16 a tile) within half of it, spread evenly
// over the bands that takes.
constexpr long long kWsL2Bytes = 50ll << 20;   // the H100's L2

int ws_band_m(int m, int k) {
  const int m_tiles = (m + kWsBM - 1) / kWsBM;
  if ((long long)m * k * 2 <= kWsL2Bytes) return m_tiles;
  long long g = kWsL2Bytes / 2 / ((long long)kWsBM * k * 2);
  if (g < 1) g = 1;
  if (g > m_tiles) g = m_tiles;
  const int bands = (int)((m_tiles + g - 1) / g);
  return (m_tiles + bands - 1) / bands;
}

template <int BITS, int BN>
int launch_ws_bn(const Args& a, cudaStream_t stream) {
  using C = WsCfg<BITS, BN>;
  static bool smem_set[64] = {};   // per device
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && !smem_set[dev]) {
    err = cudaFuncSetAttribute(qmm_ws_kernel<BITS, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  CUtensorMap x_map, w_map, y_map;
  WsArgs p;
  p.a = a;
  p.tma_store = a.n % 8 == 0;
  if (!tensor_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.x, a.k, a.m, 2, kWsBK, kWsBM,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.w, a.k * BITS / 8, a.n, 1, 64, BN,
                  CU_TENSOR_MAP_SWIZZLE_NONE) ||
      (p.tma_store && !tensor_map(&y_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.y, a.n, a.m, 2, BN,
                                  64, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return (int)cudaErrorInvalidValue;
  p.m_tiles = (a.m + kWsBM - 1) / kWsBM;
  const long long tiles = (long long)p.m_tiles * ((a.n + BN - 1) / BN);
  p.band = ws_band_m(a.m, a.k);
  const long long band_tiles = (long long)p.band * ((a.n + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  p.band_tiles = (int)band_tiles;
  const int grid = p.tiles < sms ? p.tiles : sms;
  qmm_ws_kernel<BITS, BN><<<grid, kWsThreads, C::kSmem, stream>>>(x_map, w_map, y_map, p);
  return (int)cudaGetLastError();
}

template <int BITS>
int launch_ws(const Args& a, int bn, cudaStream_t stream) {
  if (bad_shape(a.m, a.n, a.k)) return (int)cudaErrorInvalidValue;
  if (bn == 80) return launch_ws_bn<BITS, 80>(a, stream);
  if (bn == 160) return launch_ws_bn<BITS, 160>(a, stream);
  return (int)cudaErrorInvalidValue;
}

// The tiled kernel's geometry for a product of m rows, the rule of
// ops/quant_matmul.py tile_config: x's rows go to ceil(m / 256) row ranges
// of equal size, so that a weight is dequantized once where M <= 256 and at
// most ceil(M / 256) times above, and each range to the least width of
// kTileNT (the wgmma N) that holds it.  Returns (ranges << 16) | width.
constexpr int kTileNT[11] = {8, 16, 32, 48, 64, 80, 96, 128, 160, 192, 256};

int tile_config(int m) {
  const int ranges = (m + 255) / 256, rows = (m + ranges - 1) / ranges;
  int nt = 256;
  for (int w : kTileNT)
    if (w >= rows) {
      nt = w;
      break;
    }
  return (ranges << 16) | nt;
}

template <int BITS, int NT>
int launch_tile_nt(const Args& a, int ranges, cudaStream_t stream) {
  using C = TileCfg<BITS, NT>;
  static bool smem_set[64] = {};   // per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && !smem_set[dev]) {
    err = cudaFuncSetAttribute(qmm_tile_kernel<BITS, NT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  CUtensorMap x_map, w_map;
  TileArgs p;
  p.a = a;
  p.ranges = ranges;
  if (!tensor_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.x, a.k, a.m, 2, kWsBK, NT,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.w, a.k * BITS / 8, a.n, 1, 64,
                  kTileRows, CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)ranges * ((a.n + kTileRows - 1) / kTileRows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  qmm_tile_kernel<BITS, NT><<<(unsigned)blocks, kTileThreads, C::kSmem, stream>>>(x_map, w_map, p);
  return (int)cudaGetLastError();
}

template <int BITS>
int launch_tile(const Args& a, cudaStream_t stream) {
  if (bad_shape(a.m, a.n, a.k)) return (int)cudaErrorInvalidValue;
  const int cfg = tile_config(a.m), ranges = cfg >> 16;
  switch (cfg & 0xffff) {
    case 8: return launch_tile_nt<BITS, 8>(a, ranges, stream);
    case 16: return launch_tile_nt<BITS, 16>(a, ranges, stream);
    case 32: return launch_tile_nt<BITS, 32>(a, ranges, stream);
    case 48: return launch_tile_nt<BITS, 48>(a, ranges, stream);
    case 64: return launch_tile_nt<BITS, 64>(a, ranges, stream);
    case 80: return launch_tile_nt<BITS, 80>(a, ranges, stream);
    case 96: return launch_tile_nt<BITS, 96>(a, ranges, stream);
    case 128: return launch_tile_nt<BITS, 128>(a, ranges, stream);
    case 160: return launch_tile_nt<BITS, 160>(a, ranges, stream);
    case 192: return launch_tile_nt<BITS, 192>(a, ranges, stream);
    default: return launch_tile_nt<BITS, 256>(a, ranges, stream);
  }
}

// ---------------------------------------------------------------------------
// K7 / K8: W8A8 products on Hopper (int8 wgmma on a TMA ring, persistent grid)
// ---------------------------------------------------------------------------

// the two bf16 of a 32-bit word as f32
__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// Pass 1.  xq[m, k] = rint(x[m, k] * (127 / amax)) and amax[m, k / slab],
// one warp per (row, slab).  Lane l holds the slab's 8-value vectors l,
// l + 32, ... (V of them, V * 256 >= slab) in registers, so x is read once.
constexpr int kQuantWarps = 8;

template <int V>
__global__ void __launch_bounds__(32 * kQuantWarps)
quant_rows_kernel(const bf16* __restrict__ x, int8_t* __restrict__ xq,
                  float* __restrict__ amax, int m, int k, int slab) {
  const int n_slab = k / slab;
  const long long job = (long long)blockIdx.x * kQuantWarps + (threadIdx.x >> 5);
  if (job >= (long long)m * n_slab) return;   // whole warps
  const int lane = threadIdx.x & 31;
  const long long off = (job / n_slab) * k + (job % n_slab) * slab;
  const bf16* xr = x + off;
  uint4 v[V];
#pragma unroll
  for (int i = 0; i < V; ++i)
    v[i] = lane * 8 + i * 256 < slab ? *reinterpret_cast<const uint4*>(xr + lane * 8 + i * 256)
                                     : make_uint4(0u, 0u, 0u, 0u);
  float mx = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const uint32_t words[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mx = fmaxf(mx, fmaxf(fabsf(bf_lo(words[e])), fabsf(bf_hi(words[e]))));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  const float inv = mx > 0.f ? __fdiv_rn(127.f, mx) : 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = lane * 8 + i * 256;
    if (c >= slab) break;
    const uint32_t words[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t wd = words[e >> 1];
      const float f = (e & 1) ? bf_hi(wd) : bf_lo(wd);
      const int q = __float2int_rn(__fmul_rn(f, inv));
      packed[e >> 2] |= (static_cast<uint32_t>(q) & 0xffu) << (8 * (e & 3));
    }
    *reinterpret_cast<uint2*>(xq + off + c) = make_uint2(packed[0], packed[1]);
  }
  if (lane == 0) amax[job] = mx;
}

// Pass 2: the int8 product with the slab fold.
constexpr int kI8BM = 128;                 // output rows per tile: two consumer warpgroups of 64
constexpr int kI8BK = 128;                 // K per stage: one 128-byte swizzle row of int8, one K8 block
constexpr int kI8Consumers = 256;
constexpr int kI8Threads = kI8Consumers + 32;    // and a producer warp
constexpr int kI8X = kI8BM * kI8BK;        // one stage's xq tile, bytes

struct I8Args {
  const int8_t* xq;    // [M, K]
  const float* amax;   // [M, K / slab]
  const int8_t* w;     // [N, K]
  const float* s;      // [N] (per column, K7) or [N, K / slab] (per block, K8)
  bf16* y;             // [M, N]
  int m, n, k, slab;
};

struct I8Params {
  I8Args a;
  int tma_store;   // y stored by TMA from shared memory (N a multiple of 8)
  int m_tiles;     // tile t is (t % m_tiles, t / m_tiles): M fastest
  int tiles;
};

// Shared memory of one block: the output staging, 64 x BN bf16 for each
// consumer warpgroup; a ring of stages, each an xq tile [128][128] and a
// weight tile [BN][128] (both K-major with the 128-byte swizzle), the
// amax of the tile's 128 rows and the BN block scales (K8) or column
// scales (K7, on a tile's last stage); the barriers.
template <int BN>
struct I8Cfg {
  static constexpr int kY = 2 * 64 * BN * 2;
  static constexpr int kW = BN * kI8BK;
  static constexpr int kF = (kI8BM + BN) * 4;
  static constexpr int kStage = kI8X + kW + kF;
  static constexpr int kFixed = kY + 1024 + 256;   // + base alignment, barriers
  static constexpr int kFit = (kWsSmemMax - kFixed) / kStage;
  static constexpr int kStages = kFit > 8 ? 8 : kFit;
  static constexpr int kSmem = kFixed + kStages * kStage;
  static_assert(kY % 1024 == 0 && kW % 1024 == 0, "1024-byte aligned swizzled tiles");
  static_assert(kStages >= 4, "a ring of at least four stages");
};

// d[64 x N] (+)= A[64 x 32] . B[N x 32]^T in int32, both int8 K-major in
// shared memory (scale_d 0: d = A . B).  d[j][e] holds row 16 * warp +
// lane / 4 + 8 * (e / 2), column 8 * j + 2 * (lane % 4) + e % 2.
template <int N>
__device__ __forceinline__ void wgmma_i8(int (&d)[N / 8][4], uint64_t a, uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_i8<32>(int (&d)[4][4], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_i8<80>(int (&d)[10][4], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_i8<128>(int (&d)[16][4], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
        "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
        "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
        "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
        "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
        "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int NB>
__device__ __forceinline__ void pin_i(int (&d)[NB][4]) {
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[j][e])::"memory");
}

// Fold a slab's int32 sums into the f32 accumulator, in slab order:
// acc + float(dot) * (amax * (1/127)), and for K8 times the column's block
// scale, with no fused multiply-add.  row: this thread's first row in the
// tile; am: the tile's 128 amax; sc: the tile's BN block scales (K8).
template <bool BLOCK_SCALES, int NB>
__device__ __forceinline__ void i8_fold(float (&acc)[1][NB][4], const int (&d)[NB][4],
                                        const float* am, const float* sc, int row) {
  const int t = threadIdx.x & 3;
  const float sa[2] = {__fmul_rn(am[row], 1.f / 127.f), __fmul_rn(am[row + 8], 1.f / 127.f)};
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const float2 ws = BLOCK_SCALES ? *reinterpret_cast<const float2*>(sc + 8 * j + 2 * t)
                                   : make_float2(0.f, 0.f);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float part = __fmul_rn(__int2float_rn(d[j][e]), sa[e >> 1]);
      if (BLOCK_SCALES) part = __fmul_rn(part, (e & 1) ? ws.y : ws.x);
      acc[0][j][e] = __fadd_rn(acc[0][j][e], part);
    }
  }
}

// A consumer warp's 16 rows of a 64 x BN tile (BN a multiple of 64) as
// bf16 into its warpgroup's staging: BN / 64 boxes of [64][64], each in the
// 128-byte swizzle the y tensor map names (16-byte chunk c of row r at
// (c ^ r % 8) * 16), so that a warp's stores hit 32 distinct banks (a
// plain [64][128] layout puts the warp's 8 rows in the same banks).
template <int NB>
__device__ __forceinline__ void stage_sw128(const float (&d)[1][NB][4], uint8_t* staging, int r0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
#pragma unroll
    for (int j = 0; j < NB; ++j)
      *reinterpret_cast<uint32_t*>(staging + (j >> 3) * 8192 + row * 128 +
                                   (((j & 7) ^ (row & 7)) << 4) + 4 * t) =
          pack_f32(d[0][j][2 * r], d[0][j][2 * r + 1]);
  }
}

// Persistent: block b takes tiles b, b + grid, ...  Three roles:
//   * warp 8, the producer, keeps the ring full: xq and W by TMA; on the
//     last stage of a slab the rows' amax, on every K8 stage the columns'
//     block scales and on a K7 tile's last stage its column scales, by
//     cp.async; a stage's full barrier counts the TMA bytes and the 32
//     lanes' copies, its empty barrier the 8 consumer warps;
//   * warpgroups 0 and 1, rows 0-63 and 64-127 of the tile, issue each
//     stage's four asynchronous m64nBNk32 products into their int32 sums
//     (the first of a slab overwrites them), keep one stage in flight
//     within a slab, and at a slab's end wait for their products, fold the
//     sums into the f32 accumulator (K7, at a tile's last slab: times the
//     column scales) and free the stage;
//   * after a tile's last fold each consumer warpgroup stages its rows as
//     bf16 (in the 128-byte swizzle where BN is 128) and stores them by
//     TMA, which runs on under the next tile (rows and columns past M and N
//     are not written); where N is not a multiple of 8, store_tile stores
//     from registers.
template <bool BLOCK_SCALES, int BN>
__global__ void __launch_bounds__(kI8Threads, 1)
    qmm_i8_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap w_map,
                  const __grid_constant__ CUtensorMap y_map, const I8Params p) {
  using C = I8Cfg<BN>;
  constexpr int R = C::kStages, NB = BN / 8;
  const I8Args& a = p.a;
  extern __shared__ unsigned char i8_smem[];
  uint8_t* sy = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(i8_smem) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sx = sy + C::kY;
  uint8_t* sw = sx + R * kI8X;
  float* sa = reinterpret_cast<float*>(sw + R * C::kW);
  float* ss = sa + R * kI8BM;
  uint64_t* full = reinterpret_cast<uint64_t*>(ss + R * BN);
  uint64_t* empty = full + R;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < R; ++i) {
      mbar_init(smem_u32(full + i), 1 + 32);
      mbar_init(smem_u32(empty + i), kI8Consumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_kb = a.k / kI8BK;            // stages per tile
  const int per_slab = a.slab / kI8BK;     // stages per slab
  const int n_slab = a.k / a.slab;
  const int my_tiles = (p.tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;

  if (tid >= kI8Consumers) {   // the producer
    // running counters, no division per stage: the producer is one warp
    // and its loop sets the pace of the ring
    int slot = 0, phase = 0;
    for (int t = 0; t < my_tiles; ++t) {
      const int tile = blockIdx.x + t * gridDim.x;
      const int m0 = (tile % p.m_tiles) * kI8BM, n0 = (tile / p.m_tiles) * BN;
      for (int kb = 0, ks = 0, sb = 0; kb < n_kb; ++kb) {   // ks: stage within slab sb
        const uint32_t bar = smem_u32(full + slot);
        mbar_wait(smem_u32(empty + slot), phase ^ 1);
        if (lane == 0) {
          mbar_expect_tx(bar, kI8X + C::kW);
          tma_load_2d(smem_u32(sx + slot * kI8X), &x_map, bar, kb * kI8BK, m0);
          tma_load_2d(smem_u32(sw + slot * C::kW), &w_map, bar, kb * kI8BK, n0);
        }
        if (ks == per_slab - 1) {   // the slab's fold reads them with this stage
          for (int r = lane; r < kI8BM; r += 32) {
            const float* arow = a.amax + (long long)min(m0 + r, a.m - 1) * n_slab;
            cp_async4(smem_u32(sa + slot * kI8BM + r), arow + sb, m0 + r < a.m);
          }
          // K8: the block scales; K7: on the tile's last stage, the column scales
          if (BLOCK_SCALES || kb == n_kb - 1)
            for (int c = lane; c < BN; c += 32) {
              const int n = min(n0 + c, a.n - 1);
              cp_async4(smem_u32(ss + slot * BN + c),
                        BLOCK_SCALES ? a.s + (long long)n * n_slab + kb : a.s + n, n0 + c < a.n);
            }
        }
        cp_async_arrive(bar);
        if (++ks == per_slab) ks = 0, ++sb;
        if (++slot == R) slot = 0, phase ^= 1;
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }
  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  const int row = wg * 64 + warp * 16 + (lane >> 2);   // this thread's first row in the tile
  float acc[1][NB][4];
  int dot[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j) dot[j][0] = dot[j][1] = dot[j][2] = dot[j][3] = 0;
  int slot = 0, phase = 0, held = -1;   // held: a stage read by products still in flight
  // stage s is free once the products that read it completed (and, on a
  // slab's last stage, the fold read its amax and scales)
  auto free_stage = [&](int s) {
    if (lane == 0 && s >= 0) mbar_arrive(smem_u32(empty + s));
    __syncwarp();
  };
  // No wgmma wait and no read of the int32 sums sits in a branch: ptxas
  // would serialize the products.
  for (int t = 0; t < my_tiles; ++t) {
    zero_acc(acc);
    for (int sb = 0; sb < n_slab; ++sb) {
      for (int ks = 0; ks < per_slab; ++ks) {
        mbar_wait(smem_u32(full + slot), phase);
        __syncwarp();
        const uint32_t xa = smem_u32(sx + slot * kI8X + wg * (kI8X / 2));
        const uint32_t wa = smem_u32(sw + slot * C::kW);
        pin_i(dot);
        wgmma_fence();
#pragma unroll
        for (int k32 = 0; k32 < kI8BK / 32; ++k32)   // the slab's first stage overwrites the sums
          wgmma_i8<BN>(dot, sw128_desc(xa + k32 * 32), sw128_desc(wa + k32 * 32),
                       k32 > 0 || ks > 0);
        wgmma_commit();
        wgmma_wait<1>();
        pin_i(dot);
        free_stage(held);
        held = slot;
        if (++slot == R) slot = 0, phase ^= 1;
      }
      wgmma_wait<0>();   // the slab's end: fold
      pin_i(dot);
      i8_fold<BLOCK_SCALES>(acc, dot, sa + held * kI8BM, ss + held * BN, row);
      if (!BLOCK_SCALES && sb == n_slab - 1) {   // y = bf16_rn(acc * s_col)
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const float2 sc = *reinterpret_cast<const float2*>(ss + held * BN + 8 * j + 2 * (lane & 3));
          acc[0][j][0] = __fmul_rn(acc[0][j][0], sc.x);
          acc[0][j][1] = __fmul_rn(acc[0][j][1], sc.y);
          acc[0][j][2] = __fmul_rn(acc[0][j][2], sc.x);
          acc[0][j][3] = __fmul_rn(acc[0][j][3], sc.y);
        }
      }
      free_stage(held);
      held = -1;
    }
    const int tile = blockIdx.x + t * gridDim.x;
    const int m0 = (tile % p.m_tiles) * kI8BM + wg * 64, n0 = (tile / p.m_tiles) * BN;
    if (p.tma_store) {   // through the staging, stored while the next tile runs
      uint8_t* stg = sy + wg * (C::kY / 2);
      if ((tid & 127) == 0) tma_store_wait<true>();   // the last tile's store has read it
      warpgroup_sync(wg);
      if constexpr (BN % 64 == 0)
        stage_sw128(acc, stg, warp * 16);
      else
        stage_ws(acc, stg, warp * 16);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // visible to the TMA
      warpgroup_sync(wg);
      if ((tid & 127) == 0) {
        if constexpr (BN % 64 == 0) {
          for (int h = 0; h < BN / 64 && n0 + 64 * h < a.n; ++h)
            tma_store_2d(&y_map, smem_u32(stg + h * 8192), n0 + 64 * h, m0);
        } else {
          tma_store_2d(&y_map, smem_u32(stg), n0, m0);
        }
      }
    } else {
      const Args ya = {nullptr, nullptr, nullptr, a.y, a.m, a.n, a.k};
      store_tile(acc, ya, m0 + warp * 16, n0);
    }
  }
  if (p.tma_store && (tid & 127) == 0) tma_store_wait<false>();
}

// The tile width of the W8A8 kernels for an [m, n] output on sms SMs, the
// rule of ops/quant_matmul.py i8_tile_n: the width of kI8TileN with the
// least (waves x (width + 32)), a wave being one tile on every SM and 32
// columns standing for a tile's fixed cost; ties go to the narrower tile.
constexpr int kI8TileN[3] = {32, 80, 128};

int i8_tile_n(int m, int n, int sms) {
  int best = 0;
  long long best_cost = 0;
  for (int bn : kI8TileN) {
    const long long tiles = (long long)((m + kI8BM - 1) / kI8BM) * ((n + bn - 1) / bn);
    const long long cost = (tiles + sms - 1) / sms * (bn + 32);
    if (best == 0 || cost < best_cost) best = bn, best_cost = cost;
  }
  return best;
}

template <bool BLOCK_SCALES, int BN>
int launch_i8_bn(const I8Args& a, int sms, cudaStream_t stream) {
  using C = I8Cfg<BN>;
  static bool smem_set[64] = {};   // per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && !smem_set[dev]) {
    err = cudaFuncSetAttribute(qmm_i8_kernel<BLOCK_SCALES, BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  CUtensorMap x_map, w_map, y_map;
  I8Params p;
  p.a = a;
  p.tma_store = a.n % 8 == 0;
  if (!tensor_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.xq, a.k, a.m, 1, kI8BK, kI8BM,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.w, a.k, a.n, 1, kI8BK, BN,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      (p.tma_store && !tensor_map(&y_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.y, a.n, a.m, 2,
                                  BN % 64 == 0 ? 64 : BN, 64,
                                  BN % 64 == 0 ? CU_TENSOR_MAP_SWIZZLE_128B
                                               : CU_TENSOR_MAP_SWIZZLE_NONE)))
    return (int)cudaErrorInvalidValue;
  p.m_tiles = (a.m + kI8BM - 1) / kI8BM;
  const long long tiles = (long long)p.m_tiles * ((a.n + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  const int grid = p.tiles < sms ? p.tiles : sms;
  qmm_i8_kernel<BLOCK_SCALES, BN><<<grid, kI8Threads, C::kSmem, stream>>>(x_map, w_map, y_map, p);
  return (int)cudaGetLastError();
}

template <int V>
void launch_quant(const bf16* x, const I8Args& a, unsigned blocks, cudaStream_t stream) {
  quant_rows_kernel<V><<<blocks, 32 * kQuantWarps, 0, stream>>>(
      x, const_cast<int8_t*>(a.xq), const_cast<float*>(a.amax), a.m, a.k, a.slab);
}

template <bool BLOCK_SCALES>
int launch_i8(const bf16* x, const I8Args& a, cudaStream_t stream) {
  if (bad_shape(a.m, a.n, a.k) || a.slab <= 0 || a.slab % kGroup != 0 || a.k % a.slab != 0 ||
      a.slab > 4096)
    return (int)cudaErrorInvalidValue;
  const long long jobs = (long long)a.m * (a.k / a.slab);
  const long long q_blocks = (jobs + kQuantWarps - 1) / kQuantWarps;
  if (q_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned qb = (unsigned)q_blocks;
  if (a.slab <= 256) launch_quant<1>(x, a, qb, stream);
  else if (a.slab <= 512) launch_quant<2>(x, a, qb, stream);
  else if (a.slab <= 1024) launch_quant<4>(x, a, qb, stream);
  else if (a.slab <= 2048) launch_quant<8>(x, a, qb, stream);
  else launch_quant<16>(x, a, qb, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  switch (i8_tile_n(a.m, a.n, sms)) {
    case 32: return launch_i8_bn<BLOCK_SCALES, 32>(a, sms, stream);
    case 80: return launch_i8_bn<BLOCK_SCALES, 80>(a, sms, stream);
    default: return launch_i8_bn<BLOCK_SCALES, 128>(a, sms, stream);
  }
}

}  // namespace

// x [M, K] bf16, w int8 ([N, K] q8 / [N, K / 2] q4), s [N, K / 128] f32,
// y [M, N] bf16, all contiguous with 16-byte aligned bases.  Each returns the
// cudaError_t of the launch (0 on success); the ws entry points take the
// tile width bn (80 or 160) and refuse any other.
extern "C" int q8_matmul_tile(const void* x, const void* w, const void* s, void* y, int m,
                              int n, int k, void* stream) {
  return launch_tile<8>(make_args(x, w, s, y, m, n, k), static_cast<cudaStream_t>(stream));
}

extern "C" int q4_matmul_tile(const void* x, const void* w, const void* s, void* y, int m,
                              int n, int k, void* stream) {
  return launch_tile<4>(make_args(x, w, s, y, m, n, k), static_cast<cudaStream_t>(stream));
}

extern "C" int q8_matmul_ws(const void* x, const void* w, const void* s, void* y, int m,
                            int n, int k, int bn, void* stream) {
  return launch_ws<8>(make_args(x, w, s, y, m, n, k), bn, static_cast<cudaStream_t>(stream));
}

extern "C" int q4_matmul_ws(const void* x, const void* w, const void* s, void* y, int m,
                            int n, int k, int bn, void* stream) {
  return launch_ws<4>(make_args(x, w, s, y, m, n, k), bn, static_cast<cudaStream_t>(stream));
}

// x [M, K] bf16, w int8 [N, K] (per-column quantized), s f32 [N], y [M, N]
// bf16, all contiguous with 16-byte aligned bases; scratch the caller
// allocates: xq int8 [M, K] and amax f32 [M, K / slab]; slab = _ws_slab(K),
// a multiple of 128 that divides K.  Returns the cudaError_t of the
// launches.
extern "C" int q8_matmul_ws_int8(const void* x, const void* w, const void* s, void* y, void* xq,
                                 void* amax, int m, int n, int k, int slab, void* stream) {
  I8Args a;
  a.xq = static_cast<const int8_t*>(xq);
  a.amax = static_cast<const float*>(amax);
  a.w = static_cast<const int8_t*>(w);
  a.s = static_cast<const float*>(s);
  a.y = static_cast<bf16*>(y);
  a.m = m;
  a.n = n;
  a.k = k;
  a.slab = slab;
  return launch_i8<false>(static_cast<const bf16*>(x), a, static_cast<cudaStream_t>(stream));
}

// x [M, K] bf16, w int8 [N, K], s f32 [N, K / 128] (per block, as the other
// q8 entry points), y [M, N] bf16, all contiguous with 16-byte aligned bases;
// scratch the caller allocates: xq int8 [M, K] and amax f32 [M, K / 128].
// Returns the cudaError_t of the launches.
extern "C" int q8_matmul_int8(const void* x, const void* w, const void* s, void* y, void* xq,
                              void* amax, int m, int n, int k, void* stream) {
  I8Args a;
  a.xq = static_cast<const int8_t*>(xq);
  a.amax = static_cast<const float*>(amax);
  a.w = static_cast<const int8_t*>(w);
  a.s = static_cast<const float*>(s);
  a.y = static_cast<bf16*>(y);
  a.m = m;
  a.n = n;
  a.k = k;
  a.slab = kGroup;
  return launch_i8<true>(static_cast<const bf16*>(x), a, static_cast<cudaStream_t>(stream));
}

// The tile width the two W8A8 entry points take for an [m, n] output on sms
// SMs (ops/quant_matmul.py i8_tile_n is the same rule).
extern "C" int q8_int8_tile_n(int m, int n, int sms) { return i8_tile_n(m, n, sms); }

// The tiled entry points' geometry for a product of m rows: (row ranges
// << 16) | x rows a range (ops/quant_matmul.py tile_config is the same
// rule).
extern "C" int qmm_tile_config(int m) { return tile_config(m); }

// The M tiles a band of the ws entry points' walk for a product of m rows
// and depth k (ops/quant_matmul.py ws_band_m is the same rule).
extern "C" int qmm_ws_band_m(int m, int k) { return ws_band_m(m, k); }
