// Flash-attention forward kernels for Hopper (sm_90a), bf16 in / bf16 out.
//
// All three entry points compute o = softmax(q k^T * scale) v per (batch,
// head): logits in f32 from bf16 q . k^T on the tensor cores, a base-2
// softmax with scale * log2(e), an f32 running max and sum, the
// probabilities rounded to bf16 before the product with v, the output
// accumulated in f32, divided by the row sum at the end and rounded to
// bf16.  They read the natural [B, H, S, D] layout (any batch/head/seq
// strides that are multiples of 8 elements, unit stride on D, D a multiple
// of 8, 16-byte aligned bases), so the UNet's [N, S, H * D] projections
// viewed as [N, H, S, D] and the MMDiT's contiguous [B, H, S, D] are read
// in place, and write o in q's layout.
//
//   flash_attn_fwd       replaces mlimgsynth_tpu/ops/flash_attention.py
//                        flash_attention_t / _flash_kernel_t (K1: UNet
//                        self-attention; d_head 40 and 80 at SD1 512^2,
//                        64 for SDXL, 160 at SD1's level 2 at 1024^2,
//                        which the JAX package gives flash_attention).
//                        D <= 160.
//   flash_attn_joint     replaces mlimgsynth_tpu/ops/stock_flash.py
//                        stock_flash (K3, JAX's TPU flash kernel) and
//                        ops/splash_flash.py splash_flash (K4, the same
//                        function with the kv pad blocks skipped): the
//                        MMDiT joint attention, [2, 24, 4250, 64] for
//                        SD3-medium at 1024^2.  D <= 128.  The TPU kernels
//                        pad kv to a multiple of 512 and mask (K3) or skip
//                        (K4) the pad; here no pad is ever read.
//   flash_attn_fwd_wide  replaces mlimgsynth_tpu/ops/flash_attention.py
//                        flash_attention / _flash_kernel (K2: the VAE
//                        mid-block's single head, D = 512).  128 < D <= 512
//                        (the wrapper sends it D > 160).
//
// What bounds K1 and K3 on the H100.  Per (q row, kv row) pair: 4 D flops
// on the tensor cores (QK^T and PV), and one exp2 on the MUFU, whose 16
// lanes an SM (4.2e12 a second at 132 SMs and 1.98 GHz) make the
// exponentials as slow as the products at D = 64 (K3: 8.7e8 of them, 0.21
// ms, against 0.22 ms of bf16 tensor-core time) and slower at D = 40; the
// bytes are small (q, k, v, o once: 0.14 GB for K3).  So the design keeps
// both units busy at once: the tensor cores must never wait on the
// softmax, nor the softmax on the products.
//
// attn_hopper_kernel<DV, BN> (K1 and K3/K4; DV = 40, 64, 80, 128 or 160,
// the P V width that holds D; BN the kv rows of a tile) is one block of 128
// q rows and three roles:
//   * a producer warp issues every load by TMA from 4-D tensor maps (D, S,
//     H, B) encoded on the host from the tensors' own strides and passed
//     as __grid_constant__: the q tile once, then k and v tiles into a ring
//     of three stages each, with full and empty mbarriers per stage (k and
//     v apart, since v is read one step after k).  Boxes are 64 columns
//     wide in the 128-byte swizzle (ceil(DV / 64): one to three); TMA
//     zero-fills rows past S and columns past D, so the ragged kv tail and
//     the depth up to the box are zeros in shared memory and never read
//     from memory;
//   * two consumer warpgroups, 64 q rows each (the wgmma M).  Each step:
//     S = Q K^T as wgmma.m64nBNk16 with both operands in shared memory (k
//     in its natural [kv, d] layout is the K-major B operand), ceil(D / 16)
//     depth steps (D = 40 reads 48 of the box's 64 columns, D = 80 reads
//     80); the softmax in registers; O += P V as wgmma.m64nDVk16 with P in
//     registers as the A operand (the RS form: the S accumulator's layout
//     is the A fragment's) and v in its natural [kv, d] layout as the
//     MN-major B operand (the descriptor's transpose bit; no transposed
//     copy of v);
//   * the overlap: each warpgroup issues the next tile's Q K^T together
//     with the last tile's P V, then runs the softmax of the new logits
//     while P V is in flight, and the two warpgroups take turns to issue
//     (ping-pong on two mbarriers, which trap on a fault where a named
//     barrier would hang), so that one's exponentials run while the
//     other's products do.  The row maxima and sums run in four chains a
//     row (one chain is BN / 4 dependent instructions deep);
//   * the kv tiles are taken last tile first: that tile alone holds
//     columns >= Sk, so the mask sits in the first step, outside the loop
//     (a branch around the accumulators there would make ptxas serialise
//     the wgmma);
//   * the finished tile is divided by the row sums, staged as bf16 in the
//     warpgroup's own rows of the q tile (free by then, same swizzle) and
//     written by one TMA store that clips at Sq and D.
// Registers set the tile: ptxas counts a block's warps in whole
// warpgroups (the producer warp costs as much as a warpgroup), so a
// thread gets 168.  A producer warpgroup handing its registers to the
// consumers with setmaxnreg did not raise that (CUDA 12.9's ptxas kept the
// consumers at 168 and spilled), and a design with no producer (the later
// warpgroup refilling the stages it frees; 255 registers, BN 176 without
// spills) measured 10-20% slower.  So BN = 128 (64 at D = 128, 48 at D =
// 160), which fits in 168 registers with no spill: at D = 160 the output
// is 80 f32 a thread, and S at BN 64 (32 more) spilled; q (48 KB) and
// three stages of k and v (18 KB each) take 157 KB.  D = 160 once ran on K2's kernel at D = 512 (TMA
// zero-filled the 352 columns past 160, and the products still ran over
// them: 3.2 times the Q K^T depth and P V width, on 64 q rows a block,
// with the warpgroups' exchange every step); here Q K^T runs ten depth
// steps of 16 and P V one m64n160k16 a step: [2, 8, 1024, 160] 0.026 ms
// against 0.091 there, about cuDNN's time (PERF.md).  What bounds it (PERF.md,
// tools/torch_kernel_ablate.py --flash): at D = 64 the products alone and
// the softmax alone each take about two thirds of the kernel's time and
// overlap only in part; at D = 40 the loads.  The mbarrier, TMA and wgmma
// helpers are shared with quant_matmul.cu through hopper.cuh.
//
// attn_wide_kernel (K2; 128 < D <= 512, one instantiation at 512: TMA
// zero-fills the columns past D) holds all of D in one block of 64 q rows,
// so Q K^T is computed once a tile.  The 64 x 512 f32 output is 128
// registers a thread over two warpgroups, so each warpgroup owns 256
// columns of q, k, v and o, and each step:
//   * S_w = Q[:, w] K[:, w]^T, its half of the depth, as wgmma.m64n64k16
//     from shared memory;
//   * the two halves meet in shared memory: each thread writes its partial
//     as float4s and adds its peer's (thread t of either warpgroup holds
//     the same elements), on two mbarriers a warp (written, read: warp j
//     of either warpgroup holds the same 16 rows, so only those two wait
//     for each other), which trap on a fault where a named barrier would
//     hang;
//   * both warpgroups run the same softmax on the full S (K1's helpers; the
//     exponentials are 1/2048 of the products' flops at D = 512);
//   * O[:, w] += P V[:, w] as two wgmma.m64n128k16, P from registers, v
//     MN-major, issued after the next tile's S (the v tile is waited for
//     between the two, so its load runs while S does) so that the
//     exchange and the softmax run while it does.
// No producer warp: it would cap a thread at 168 registers (above), and O
// alone takes 128.  Each warpgroup's thread 0 loads its own 256 columns
// of every tile by TMA once its warpgroup has read the last (a warpgroup
// barrier, then the loads predicated on the thread, with no branch), so
// the warpgroups share nothing but the exchange.  The k and v tiles are
// 64 x 512, one stage each: q 64 KB + k + v + the exchange's 32 KB fill
// the 227 KB.  What bounds it (PERF.md, tools/torch_kernel_ablate.py
// --flash): the k and v loads, which every block takes whole for its 64 q
// rows (2 KB a kv row into each SM), and the exchange.  Measured and not
// kept: 32-row kv tiles in two stages (the 32-wide Q K^T reads q from
// shared memory twice as often: 1.3x slower), and a 2-block cluster
// multicasting each k and v tile (half the L2 reads, no faster: each SM
// still takes in every tile).  The ragged kv tile goes first, and the
// result is staged in the q tile and written by TMA stores, as in K1.
// The TPU artifacts (transposed v, ones-row denominator, static max,
// split-k, scoped-VMEM planning, kv padding with segment ids) are not
// carried over.

#include <math.h>

#include "hopper.cuh"

namespace {

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int n_head, sq, sk, d;
  // element strides: [tensor][batch, head, seq] for q, k, v, o
  long long st[4][3];
  float scale_log2;   // scale * log2(e)
};

Args make_args(const void* q, const void* k, const void* v, void* o, int n_head,
               int sq, int sk, int d, const long long* strides, float scale) {
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<bf16*>(o);
  a.n_head = n_head;
  a.sq = sq;
  a.sk = sk;
  a.d = d;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 3; ++j) a.st[i][j] = strides[3 * i + j];
  a.scale_log2 = scale * 1.4426950408889634f;
  return a;
}

// ---------------------------------------------------------------------------
// K1 and K3/K4: TMA ring, wgmma, two consumer warpgroups in ping-pong
// ---------------------------------------------------------------------------

constexpr int kHM = 128;                       // q rows a block: two warpgroups of 64
constexpr int kHConsumers = 256;               // the two consumer warpgroups
constexpr int kHThreads = kHConsumers + 32;    // and a producer warp
constexpr int kQBox = kHM * 128;               // one 64-column box of the q tile (128-byte rows)

// DV: the P V width (the output columns that hold D); BN: kv rows a tile,
// the Q K^T wgmma N
template <int DV, int BN>
struct HCfg {
  static constexpr int kBoxes = (DV + 63) / 64;        // 64-column boxes that hold D
  static constexpr int kKSteps = (DV + 15) / 16;        // Q K^T depth steps of 16
  static constexpr int kKVBox = BN * 128;               // one box of a k or v tile
  static constexpr int kQ = kQBox * kBoxes;             // q tile bytes
  static constexpr int kKV = kKVBox * kBoxes;           // one k or v tile
  static constexpr int kStages = 3;
  static constexpr int kSmem = 1024 + kQ + 2 * kStages * kKV + 256;   // + alignment, barriers
  static_assert(BN % 16 == 0 && kSmem <= 232448, "a wgmma N and the shared memory of one block");
};

struct HArgs {
  int sk;
  int n_tiles;        // kv tiles: ceil(sk / BN)
  float scale_log2;   // |scale| * log2(e)
  int neg;            // scale < 0: q is negated in shared memory
};

#define FA_ACC4(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])

// d[64 x N] (+)= A[64 x 16] . B[N x 16]^T, both K-major in shared memory.
// d[j][e] holds row 16 * warp + lane / 4 + 8 * (e / 2), column 8 * j + 2 *
// (lane % 4) + e % 2 of the warpgroup's 64 rows.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4], uint64_t a, uint64_t b, int scale_d);

// d[64 x N] (+)= A[64 x 16] . B[16 x N], A from registers (a: this thread's
// fragment, rows 16 * warp + lane / 4 and + 8, columns 2 * (lane % 4) .. + 1
// and + 8 .. + 9, as bf16 pairs), B MN-major in shared memory (the transpose
// bit).  The registers of a must keep their values until the product
// completes.
template <int N>
__device__ __forceinline__ void wgmma_rs_t(float (&d)[N / 8][4], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<48>(float (&d)[6][4], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : FA_ACC4(0), FA_ACC4(1), FA_ACC4(2), FA_ACC4(3),
        FA_ACC4(4), FA_ACC4(5)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[8][4], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FA_ACC4(0), FA_ACC4(1), FA_ACC4(2), FA_ACC4(3),
        FA_ACC4(4), FA_ACC4(5), FA_ACC4(6), FA_ACC4(7)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[16][4], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : FA_ACC4(0), FA_ACC4(1), FA_ACC4(2), FA_ACC4(3),
        FA_ACC4(4), FA_ACC4(5), FA_ACC4(6), FA_ACC4(7),
        FA_ACC4(8), FA_ACC4(9), FA_ACC4(10), FA_ACC4(11),
        FA_ACC4(12), FA_ACC4(13), FA_ACC4(14), FA_ACC4(15)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_t<40>(float (&d)[5][4], const uint32_t (&a)[4], uint64_t b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19"
      "}, {%20, %21, %22, %23}, %24, p, 1, 1, 1;\n}\n"
      : FA_ACC4(0), FA_ACC4(1), FA_ACC4(2), FA_ACC4(3),
        FA_ACC4(4)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_t<64>(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_ACC4(0), FA_ACC4(1), FA_ACC4(2), FA_ACC4(3),
        FA_ACC4(4), FA_ACC4(5), FA_ACC4(6), FA_ACC4(7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_t<80>(float (&d)[10][4], const uint32_t (&a)[4], uint64_t b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : FA_ACC4(0), FA_ACC4(1), FA_ACC4(2), FA_ACC4(3),
        FA_ACC4(4), FA_ACC4(5), FA_ACC4(6), FA_ACC4(7),
        FA_ACC4(8), FA_ACC4(9)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_t<128>(float (&d)[16][4], const uint32_t (&a)[4], uint64_t b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FA_ACC4(0), FA_ACC4(1), FA_ACC4(2), FA_ACC4(3),
        FA_ACC4(4), FA_ACC4(5), FA_ACC4(6), FA_ACC4(7),
        FA_ACC4(8), FA_ACC4(9), FA_ACC4(10), FA_ACC4(11),
        FA_ACC4(12), FA_ACC4(13), FA_ACC4(14), FA_ACC4(15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_t<160>(float (&d)[20][4], const uint32_t (&a)[4], uint64_t b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : FA_ACC4(0), FA_ACC4(1), FA_ACC4(2), FA_ACC4(3),
        FA_ACC4(4), FA_ACC4(5), FA_ACC4(6), FA_ACC4(7),
        FA_ACC4(8), FA_ACC4(9), FA_ACC4(10), FA_ACC4(11),
        FA_ACC4(12), FA_ACC4(13), FA_ACC4(14), FA_ACC4(15),
        FA_ACC4(16), FA_ACC4(17), FA_ACC4(18), FA_ACC4(19)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}


#undef FA_ACC4

// wgmma operand descriptor of an MN-major tile with 128-byte swizzle: rows of
// 128 bytes (64 bf16 along N) for consecutive K, 8-row groups 1024 bytes
// apart, the next 64 columns of N lbo bytes on; the tile 1024-byte aligned
__device__ __forceinline__ uint64_t mn128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (64ull << 32) | (1ull << 62);
}

// keep the compiler from moving accesses of wgmma operands across the
// asynchronous products
template <int NJ>
__device__ __forceinline__ void pin(float (&d)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}
template <int NJ>
__device__ __forceinline__ void pin(uint32_t (&d)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[j][e])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) asm volatile("" : "+f"(d[j])::"memory");
}

// one arrival on bar from lane 0 of the calling warp, with no branch
__device__ __forceinline__ void warp_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 l;\nmov.u32 l, %%laneid;\nsetp.eq.u32 p, l, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T for this warpgroup's 64 rows: qa its q rows, ka the k tile
template <int KS, int BN>
__device__ __forceinline__ void qk_product(float (&s)[BN / 8][4], uint32_t qa, uint32_t ka) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_ss<BN>(s, sw128_desc(qa + (kk >> 2) * kQBox + (kk & 3) * 32),
                 sw128_desc(ka + (kk >> 2) * (BN * 128) + (kk & 3) * 32), kk > 0);
  wgmma_commit();
}

// O += P V: pf the bf16 probabilities (A fragments), va the v tile
template <int DV, int BN>
__device__ __forceinline__ void pv_product(float (&o)[DV / 8][4], const uint32_t (&pf)[BN / 16][4],
                                           uint32_t va) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs_t<DV>(o, pf[kk], mn128_desc(va + kk * 2048, BN * 128), 1);
  wgmma_commit();
}

// The online softmax of one kv tile for this thread's two rows (e / 2 = 0:
// row lane / 4 of its warp's 16, 1: that row + 8).  s: the tile's raw
// logits, replaced by p = exp2(s * sl - m_new * sl); m: the running max of
// the raw logits (sl >= 0, so it is the max of the scaled ones too), l:
// this thread's partial row sums; alpha = exp2((m_old - m_new) * sl).
// FIRST: the first tile of the order, whose columns >= lim are left out
// (p = 0; the max over the others).  The maxima and sums run in four
// chains a row: one chain would be BN / 4 dependent instructions deep.
template <int BN, bool FIRST>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 8][4], float sl, int lim, float (&m)[2],
                                             float (&l)[2], float (&alpha)[2]) {
  const int t2 = 2 * (threadIdx.x & 3);
  float mx[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) mx[r][c] = FIRST || c ? -INFINITY : m[r];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = !FIRST || 8 * j + t2 + (e & 1) < lim;
      float& c = mx[e >> 1][(j & 1) * 2 + (e & 1)];
      c = fmaxf(c, in ? s[j][e] : -INFINITY);
    }
  float mb[2], rs[2][4] = {};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    // the four threads of a row group hold its columns; every row has a
    // column < Sk in the first tile, so the max is finite
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    alpha[r] = FIRST ? 0.f : ex2((m[r] - x) * sl);
    m[r] = x;
    mb[r] = x * sl;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = ex2(fmaf(s[j][e], sl, -mb[e >> 1]));
      if (FIRST) x = 8 * j + t2 + (e & 1) < lim ? x : 0.f;
      s[j][e] = x;
      rs[e >> 1][(j & 1) * 2 + (e & 1)] += x;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = (rs[r][0] + rs[r][1]) + (rs[r][2] + rs[r][3]);
    l[r] = FIRST ? sum : l[r] * alpha[r] + sum;
  }
}

// the probabilities as bf16 A fragments of the P V product (k16 step kk:
// columns 16 kk .. 16 kk + 15)
template <int BN>
__device__ __forceinline__ void pack_p(uint32_t (&pf)[BN / 16][4], const float (&s)[BN / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    pf[kk][0] = pack_f32(s[2 * kk][0], s[2 * kk][1]);
    pf[kk][1] = pack_f32(s[2 * kk][2], s[2 * kk][3]);
    pf[kk][2] = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pf[kk][3] = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// the output sums rescaled to the new running max
template <int NJ>
__device__ __forceinline__ void rescale(float (&o)[NJ][4], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    o[j][0] *= alpha[0];
    o[j][1] *= alpha[0];
    o[j][2] *= alpha[1];
    o[j][3] *= alpha[1];
  }
}

// advance a ring position (slot, parity) with no branch
template <int ST>
__device__ __forceinline__ void advance(int& slot, uint32_t& phase) {
  slot = slot + 1 == ST ? 0 : slot + 1;
  phase ^= slot == 0;
}

// 1 / the row sums of a thread's two rows (the four threads of a row
// group hold parts of each)
__device__ __forceinline__ void row_inv(float (&inv)[2], float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
}

// o * inv as bf16 into a warpgroup's 64 rows of the 64-column boxes from
// dst (BOX bytes apart; 8 columns a j), in the 128-byte swizzle of the
// store's boxes: row r's 16-byte chunk c at r * 128 + (c ^ (r % 8)) * 16
template <int NJ, int BOX>
__device__ __forceinline__ void stage_rows(const float (&o)[NJ][4], const float (&inv)[2],
                                           uint8_t* dst) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      *reinterpret_cast<uint32_t*>(dst + (j >> 3) * BOX + row * 128 + (((j & 7) ^ (row & 7)) << 4) +
                                   t * 4) = pack_f32(o[j][2 * r] * inv[r], o[j][2 * r + 1] * inv[r]);
  }
}

// the warpgroup's staged rows (nb boxes from src, box bytes apart) made
// visible to the TMA, then written by its thread 0 from column col, row m0
// (the store clips at S and D)
__device__ __forceinline__ void store_rows(const CUtensorMap* map, const uint8_t* src, int box, int nb,
                                           int col, int m0, int h, int b, int wg) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  warpgroup_sync(wg);
  if ((threadIdx.x & 127) == 0) {
    for (int c = 0; c < nb; ++c) tma_store_4d(map, smem_u32(src + c * box), col + 64 * c, m0, h, b);
    tma_store_wait<true>();   // the stores have read the staging before the block ends
  }
}

// One block: q rows [128 * blockIdx.x, + 128) of head blockIdx.y of batch
// blockIdx.z.  Warps 0-7: two consumer warpgroups (rows 0-63 and 64-127);
// warp 8 lane 0, the producer, issues every load.  The kv tiles go in the
// order n - 1, 0, 1, .., n - 2 (the ragged one first); k tile i+1 is loaded
// before v tile i, the order the consumers read them in.
template <int DV, int BN>
__global__ void __launch_bounds__(kHThreads, 1)
    attn_hopper_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap o_map, const HArgs p) {
  using C = HCfg<DV, BN>;
  constexpr int ST = C::kStages, NB = C::kBoxes;
  extern __shared__ unsigned char h_smem[];
  // aligned by an offset from the array, so that the compiler knows every
  // pointer below is shared memory
  uint8_t* sq = h_smem + ((1024 - (smem_u32(h_smem) & 1023)) & 1023);
  uint8_t* sk = sq + C::kQ;
  uint8_t* sv = sk + ST * C::kKV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sv + ST * C::kKV);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + ST;
  uint64_t* k_empty = v_full + ST;
  uint64_t* v_empty = k_empty + ST;
  uint64_t* turn = v_empty + ST;   // [wg]: the other warpgroup's 4 warps passed warpgroup wg the turn
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(smem_u32(q_full), 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(smem_u32(k_full + i), 1);
      mbar_init(smem_u32(v_full + i), 1);
      mbar_init(smem_u32(k_empty + i), kHConsumers / 32);
      mbar_init(smem_u32(v_empty + i), kHConsumers / 32);
    }
    mbar_init(smem_u32(turn), 4);
    mbar_init(smem_u32(turn + 1), 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int m0 = blockIdx.x * kHM, h = blockIdx.y, b = blockIdx.z;
  const int n = p.n_tiles;
  const int wg = tid >> 7;   // 2: the producer warp

  if (wg == 2) {   // the producer warp
    if (tid == kHConsumers) {
      mbar_expect_tx(smem_u32(q_full), C::kQ);
      for (int c = 0; c < NB; ++c) tma_load_4d(smem_u32(sq + c * kQBox), &q_map, smem_u32(q_full), c * 64, m0, h, b);
      int ks = 0, vs = 0;
      uint32_t kph = 0, vph = 0;
      for (int i = 0; i <= n; ++i) {
        if (i < n) {   // k of tile i of the order
          const int n0 = (i == 0 ? n - 1 : i - 1) * BN;
          const uint32_t bar = smem_u32(k_full + ks);
          mbar_wait(smem_u32(k_empty + ks), kph ^ 1);
          mbar_expect_tx(bar, C::kKV);
          for (int c = 0; c < NB; ++c)
            tma_load_4d(smem_u32(sk + ks * C::kKV + c * C::kKVBox), &k_map, bar, c * 64, n0, h, b);
          advance<ST>(ks, kph);
        }
        if (i > 0) {   // v of tile i - 1
          const int n0 = (i == 1 ? n - 1 : i - 2) * BN;
          const uint32_t bar = smem_u32(v_full + vs);
          mbar_wait(smem_u32(v_empty + vs), vph ^ 1);
          mbar_expect_tx(bar, C::kKV);
          for (int c = 0; c < NB; ++c)
            tma_load_4d(smem_u32(sv + vs * C::kKV + c * C::kKVBox), &v_map, bar, c * 64, n0, h, b);
          advance<ST>(vs, vph);
        }
      }
    }
    return;
  }

  uint8_t* const sqw = sq + wg * (kQBox / 2);   // this warpgroup's 64 q rows in each box
  const uint32_t qa = smem_u32(sqw);
  const uint32_t ka = smem_u32(sk), va = smem_u32(sv);
  const float sl = p.scale_log2;
  float s[BN / 8][4];
  float o[DV / 8][4];
  uint32_t pf[BN / 16][4];
  float m[2], l[2], alpha[2];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  int ks = 0, vs = 0;
  uint32_t kph = 0, vph = 0, tph = 0;
  // The two warpgroups take turns to issue their products, warpgroup 0
  // first: a turn waits for the other's pass (mbarrier phases, so that a
  // fault traps instead of hanging), and can be at most one phase ahead.
  const uint32_t my_turn = smem_u32(turn + wg), other_turn = smem_u32(turn + (wg ^ 1));
  auto turn_wait = [&] {
    mbar_wait(my_turn, tph);
    tph ^= 1;
  };
  if (wg == 1) warp_arrive(other_turn);
  mbar_wait(smem_u32(q_full), 0);
  if (p.neg) {   // softmax(s * scale) = softmax((-s) * |scale|): negate the q rows (exact)
    for (int i = tid & 127; i < NB * kQBox / 32; i += 128) {
      uint4* v = reinterpret_cast<uint4*>(sqw + (i >> 9) * kQBox) + (i & 511);
      v->x ^= 0x80008000u, v->y ^= 0x80008000u, v->z ^= 0x80008000u, v->w ^= 0x80008000u;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // visible to wgmma
    warpgroup_sync(wg);
  }

  // the first tile of the order, the last of kv: columns >= Sk left out
  mbar_wait(smem_u32(k_full + ks), kph);
  turn_wait();
  wgmma_fence();
  qk_product<C::kKSteps, BN>(s, qa, ka + ks * C::kKV);
  warp_arrive(other_turn);
  wgmma_wait<0>();
  pin(s);
  warp_arrive(smem_u32(k_empty + ks));
  advance<ST>(ks, kph);
  softmax_tile<BN, true>(s, sl, p.sk - (n - 1) * BN, m, l, alpha);
  pack_p<BN>(pf, s);

  // each step: S of the next tile and P V of the last, then the softmax of
  // the new S while P V runs
  for (int i = 1; i < n; ++i) {
    mbar_wait(smem_u32(k_full + ks), kph);
    mbar_wait(smem_u32(v_full + vs), vph);
    turn_wait();
    wgmma_fence();
    qk_product<C::kKSteps, BN>(s, qa, ka + ks * C::kKV);
    pv_product<DV, BN>(o, pf, va + vs * C::kKV);
    warp_arrive(other_turn);
    wgmma_wait<1>();
    pin(s);
    warp_arrive(smem_u32(k_empty + ks));
    advance<ST>(ks, kph);
    softmax_tile<BN, false>(s, sl, 0, m, l, alpha);
    pin(s);   // the softmax is issued before the wait for P V, not after
    pin(l);
    wgmma_wait<0>();
    pin(o);
    pin(pf);
    warp_arrive(smem_u32(v_empty + vs));
    advance<ST>(vs, vph);
    rescale(o, alpha);
    pack_p<BN>(pf, s);
  }
  mbar_wait(smem_u32(v_full + vs), vph);
  turn_wait();
  wgmma_fence();
  pv_product<DV, BN>(o, pf, va + vs * C::kKV);
  warp_arrive(other_turn);
  wgmma_wait<0>();
  pin(o);
  pin(pf);

  // o / l as bf16 into this warpgroup's rows of the q tile (free by now)
  float inv[2];
  row_inv(inv, l);
  stage_rows<DV / 8, kQBox>(o, inv, sqw);
  store_rows(&o_map, sqw, kQBox, NB, 0, m0 + wg * 64, h, b, wg);
}

// a [B, H, S, D] bf16 tensor (unit stride on D, element strides st: batch,
// head, seq): boxes of 64 columns by `rows` rows of one head in the 128-byte
// swizzle; what lies past S or D reads as zero and is not written
bool attn_map(CUtensorMap* map, const void* base, int d, int s, int n_head, int batch,
              const long long* st, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)n_head, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2, (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

typedef void (*AttnKernel)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, HArgs);

// Launches kernel over blocks of q_rows q rows of one head (grid
// (ceil(Sq / q_rows), H, B)) with threads threads and smem bytes of shared
// memory (set once per device in smem_set): q read in boxes of q_rows rows,
// k and v in tiles of bn rows, o written in boxes of o_rows rows.
int launch_attn(AttnKernel kernel, bool (&smem_set)[64], int smem, int threads, int q_rows, int bn,
                int o_rows, const Args& a, int batch, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && !smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  CUtensorMap q_map, k_map, v_map, o_map;
  if (!attn_map(&q_map, a.q, a.d, a.sq, a.n_head, batch, a.st[0], q_rows) ||
      !attn_map(&k_map, a.k, a.d, a.sk, a.n_head, batch, a.st[1], bn) ||
      !attn_map(&v_map, a.v, a.d, a.sk, a.n_head, batch, a.st[2], bn) ||
      !attn_map(&o_map, a.o, a.d, a.sq, a.n_head, batch, a.st[3], o_rows))
    return (int)cudaErrorInvalidValue;
  HArgs p;
  p.sk = a.sk;
  p.n_tiles = (a.sk + bn - 1) / bn;
  p.scale_log2 = fabsf(a.scale_log2);
  p.neg = a.scale_log2 < 0.f;
  const dim3 grid((a.sq + q_rows - 1) / q_rows, a.n_head, batch);
  kernel<<<grid, threads, smem, stream>>>(q_map, k_map, v_map, o_map, p);
  return (int)cudaGetLastError();
}

template <int DV, int BN>
int launch_hopper(const Args& a, int batch, cudaStream_t stream) {
  static bool smem_set[64] = {};   // per device
  return launch_attn(attn_hopper_kernel<DV, BN>, smem_set, HCfg<DV, BN>::kSmem, kHThreads, kHM, BN,
                     kHM / 2, a, batch, stream);
}

// K1 and K3/K4: the template whose P V width holds d
int launch_flash(const Args& a, int batch, cudaStream_t stream) {
  if (a.d <= 40) return launch_hopper<40, 128>(a, batch, stream);
  if (a.d <= 64) return launch_hopper<64, 128>(a, batch, stream);
  if (a.d <= 80) return launch_hopper<80, 128>(a, batch, stream);
  if (a.d <= 128) return launch_hopper<128, 64>(a, batch, stream);
  if (a.d <= 160) return launch_hopper<160, 48>(a, batch, stream);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// K2: all of D in one block, split between two warpgroups
// ---------------------------------------------------------------------------

constexpr int kWM = 64;                   // q rows a block (the wgmma M)
constexpr int kWBN = 64;                  // kv rows a tile (the Q K^T wgmma N)
constexpr int kWThreads = 256;            // two warpgroups, 256 columns each
constexpr int kWQBox = kWM * 128;         // one 64-column box of the q tile
constexpr int kWKVBox = kWBN * 128;       // one box of a k or v tile
constexpr int kWTile = 8 * kWKVBox;       // a k or v tile, 512 columns
constexpr int kWX = kWM * kWBN * 4;       // one warpgroup's partial logits (f32)
constexpr int kWBars = 11;                // mbarriers a warpgroup
constexpr int kWSmem = 1024 + 8 * kWQBox + 2 * kWTile + 2 * kWX + 2 * kWBars * 8;
static_assert(kWSmem <= 232448, "the shared memory of one block");

// A shared-memory address the compiler cannot see through: the operand
// descriptors built from it are not hoisted out of the kv loop (with one
// k and one v stage they are all loop-invariant, and hoisted they spilled).
__device__ __forceinline__ uint32_t opaque(uint32_t a) {
  asm volatile("" : "+r"(a));
  return a;
}

// this warpgroup's partial logits: its 256 columns of q (qa) against the
// same columns of the k tile (ka)
__device__ __forceinline__ void wide_qk(float (&s)[kWBN / 8][4], uint32_t qa, uint32_t ka) {
  qa = opaque(qa);
  ka = opaque(ka);
#pragma unroll
  for (int kk = 0; kk < 16; ++kk)
    wgmma_ss<kWBN>(s, sw128_desc(qa + (kk >> 2) * kWQBox + (kk & 3) * 32),
                   sw128_desc(ka + (kk >> 2) * kWKVBox + (kk & 3) * 32), kk > 0);
  wgmma_commit();
}

// O[:, this warpgroup's 256 columns] += P V: two products 128 wide, v
// MN-major (four 64-column boxes from va)
__device__ __forceinline__ void wide_pv(float (&o)[2][16][4], const uint32_t (&pf)[kWBN / 16][4],
                                        uint32_t va) {
  va = opaque(va);
#pragma unroll
  for (int kk = 0; kk < kWBN / 16; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      wgmma_rs_t<128>(o[half], pf[kk], mn128_desc(va + half * 2 * kWKVBox + kk * 2048, kWKVBox), 1);
  wgmma_commit();
}

// the warpgroup's four 64-column boxes (from column col) of kv rows [n0,
// n0 + kWBN) of a k or v tile into dst, completing on bar; issued where p
// holds (thread 0 of the warpgroup), with no branch
__device__ __forceinline__ void wide_load(bool p, const CUtensorMap* map, uint32_t dst, uint32_t bar,
                                          int col, int n0, int h, int b) {
  mbar_expect_tx_if(p, bar, 4 * kWKVBox);
#pragma unroll
  for (int c = 0; c < 4; ++c) tma_load_4d_if(p, dst + c * kWKVBox, map, bar, col + 64 * c, n0, h, b);
}

// The full logits: this warpgroup's partial s plus its peer's.  Thread t of
// either warpgroup holds the same (row, column) elements, so each writes
// its own to its slot (x_mine, 16 bytes a float4, the 128 threads side by
// side) and adds its peer's.  bars (of this warp, one arrival a phase):
// this warp's partial written and read by the peer warp, the peer's
// written and read (by this one); ph: the exchanges so far, mod 2.
__device__ __forceinline__ void wide_exchange(float (&s)[kWBN / 8][4], float4* x_mine,
                                              const float4* x_peer, const uint32_t (&bars)[4],
                                              uint32_t& ph) {
  mbar_wait(bars[1], ph ^ 1);   // the peer has read the last partial
#pragma unroll
  for (int j = 0; j < kWBN / 8; ++j) x_mine[j * 128] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
  __syncwarp();
  warp_arrive(bars[0]);
  mbar_wait(bars[2], ph);
#pragma unroll
  for (int j = 0; j < kWBN / 8; ++j) {
    const float4 t = x_peer[j * 128];
    s[j][0] += t.x, s[j][1] += t.y, s[j][2] += t.z, s[j][3] += t.w;
  }
  __syncwarp();
  warp_arrive(bars[3]);
  ph ^= 1;
}

// One block: q rows [64 * blockIdx.x, + 64) of head blockIdx.y of batch
// blockIdx.z, all of D.  Warpgroup wg owns columns [256 wg, + 256) of q, k,
// v and o: its thread 0 loads them by TMA (a k or v tile once the
// warpgroup has read the last), the warpgroup computes its partial logits
// over those columns, hands them to the other warpgroup through shared
// memory and adds the other's, runs the softmax on the full logits (both
// warpgroups alike) and accumulates its 256 output columns.  The kv tiles
// go in the order n - 1, 0, 1, .., n - 2 (the ragged one first).
__global__ void __launch_bounds__(kWThreads, 1)
    attn_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap o_map, const HArgs arg) {
  extern __shared__ unsigned char w_smem[];
  uint8_t* sq = w_smem + ((1024 - (smem_u32(w_smem) & 1023)) & 1023);
  uint8_t* sk = sq + 8 * kWQBox;
  uint8_t* sv = sk + kWTile;
  float4* sx = reinterpret_cast<float4*>(sv + kWTile);   // [wg][kWBN / 8][128]
  // a warpgroup's barriers: q, k and v loaded; a warp's partial logits
  // written and read by the peer warp, four each
  uint64_t* bars = reinterpret_cast<uint64_t*>(sv + kWTile + 2 * kWX);
  enum { kQFull, kKFull, kVFull, kXFull, kXEmpty = kXFull + 4 };
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < 2 * kWBars; ++i) mbar_init(smem_u32(bars + i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int m0 = blockIdx.x * kWM, h = blockIdx.y, b = blockIdx.z;
  const int n = arg.n_tiles;
  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  const bool leader = (tid & 127) == 0;
  const int col = 256 * wg;   // the warpgroup's first column
  uint64_t* const mine = bars + wg * kWBars;
  uint64_t* const peer = bars + (wg ^ 1) * kWBars;
  const uint32_t q_full = smem_u32(mine + kQFull), k_full = smem_u32(mine + kKFull),
                 v_full = smem_u32(mine + kVFull);
  uint8_t* const sqw = sq + 4 * wg * kWQBox;
  const uint32_t qa = smem_u32(sqw);
  const uint32_t ka = smem_u32(sk + 4 * wg * kWKVBox), va = smem_u32(sv + 4 * wg * kWKVBox);
  // the first kv row of tile j of the order
  auto row = [n](int j) { return (j == 0 ? n - 1 : j - 1) * kWBN; };

  if (leader) {
    mbar_expect_tx(q_full, 4 * kWQBox);
    for (int c = 0; c < 4; ++c)
      tma_load_4d(smem_u32(sqw + c * kWQBox), &q_map, q_full, col + 64 * c, m0, h, b);
  }
  wide_load(leader, &k_map, ka, k_full, col, row(0), h, b);
  wide_load(leader, &v_map, va, v_full, col, row(0), h, b);

  const float sl = arg.scale_log2;
  float s[kWBN / 8][4];
  float o[2][16][4];
  uint32_t pf[kWBN / 16][4];
  float m[2], l[2], alpha[2];
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int j = 0; j < 16; ++j) o[half][j][0] = o[half][j][1] = o[half][j][2] = o[half][j][3] = 0.f;
  // thread t's slot in this warpgroup's and its peer's partial logits
  float4* const x_mine = sx + wg * (kWBN / 8) * 128 + (tid & 127);
  const float4* const x_peer = sx + (wg ^ 1) * (kWBN / 8) * 128 + (tid & 127);
  const uint32_t x_bars[4] = {smem_u32(mine + kXFull + warp), smem_u32(mine + kXEmpty + warp),
                              smem_u32(peer + kXFull + warp), smem_u32(peer + kXEmpty + warp)};
  uint32_t xph = 0;

  mbar_wait(q_full, 0);
  if (arg.neg) {   // softmax(s * scale) = softmax((-s) * |scale|): negate the q columns (exact)
    for (int i = tid & 127; i < 4 * kWQBox / 16; i += 128) {
      uint4* x = reinterpret_cast<uint4*>(sqw) + i;
      x->x ^= 0x80008000u, x->y ^= 0x80008000u, x->z ^= 0x80008000u, x->w ^= 0x80008000u;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // visible to wgmma
    warpgroup_sync(wg);
  }

  // the first tile of the order, the last of kv: columns >= Sk left out
  mbar_wait(k_full, 0);
  wgmma_fence();
  wide_qk(s, qa, ka);
  wgmma_wait<0>();
  pin(s);
  warpgroup_sync(wg);   // the warpgroup is done with the k tile: the next one in
  wide_load(leader && n > 1, &k_map, ka, k_full, col, row(1), h, b);
  wide_exchange(s, x_mine, x_peer, x_bars, xph);
  const int tail = arg.sk - (n - 1) * kWBN;
  softmax_tile<kWBN, true>(s, sl, tail, m, l, alpha);
  pack_p<kWBN>(pf, s);

  // each step: S of tile i, then P V of tile i - 1 once its v tile is in
  // (loaded while S runs); the exchange and the softmax of the new S while
  // P V runs.  The wgmma_fence after the wait keeps ptxas from placing one
  // of its own inside the wait's loop, around which it would serialise the
  // products.
  for (int i = 1; i < n; ++i) {
    mbar_wait(k_full, i & 1);
    wgmma_fence();
    wide_qk(s, qa, ka);
    mbar_wait(v_full, (i - 1) & 1);
    wgmma_fence();
    wide_pv(o, pf, va);
    wgmma_wait<1>();
    pin(s);
    warpgroup_sync(wg);
    wide_load(leader && i + 1 < n, &k_map, ka, k_full, col, row(i + 1), h, b);
    wide_exchange(s, x_mine, x_peer, x_bars, xph);
    softmax_tile<kWBN, false>(s, sl, 0, m, l, alpha);
    pin(s);   // the softmax is issued before the wait for P V, not after
    pin(l);
    wgmma_wait<0>();
    pin(o[0]);
    pin(o[1]);
    pin(pf);
    warpgroup_sync(wg);   // done with the v tile: tile i in
    wide_load(leader, &v_map, va, v_full, col, row(i), h, b);
    rescale(o[0], alpha);
    rescale(o[1], alpha);
    pack_p<kWBN>(pf, s);
  }
  mbar_wait(v_full, (n - 1) & 1);
  wgmma_fence();
  wide_pv(o, pf, va);
  wgmma_wait<0>();
  pin(o[0]);
  pin(o[1]);
  pin(pf);

  // o / l as bf16 into the warpgroup's q boxes (its last Q K^T is done)
  float inv[2];
  row_inv(inv, l);
  stage_rows<16, kWQBox>(o[0], inv, sqw);
  stage_rows<16, kWQBox>(o[1], inv, sqw + 2 * kWQBox);
  store_rows(&o_map, sqw, kWQBox, 4, col, m0, h, b, wg);
}

int launch_wide(const Args& a, int batch, cudaStream_t stream) {
  static bool smem_set[64] = {};   // per device
  return launch_attn(attn_wide_kernel, smem_set, kWSmem, kWThreads, kWM, kWBN, kWM, a, batch, stream);
}

}  // namespace

// strides: 12 element strides, (batch, head, seq) for q, k, v, o in turn.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                              int batch, int n_head, int sq, int sk, int d,
                              const long long* strides, float scale,
                              void* stream) {
  const Args a = make_args(q, k, v, o, n_head, sq, sk, d, strides, scale);
  return launch_flash(a, batch, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attn_fwd_wide(const void* q, const void* k, const void* v, void* o,
                                   int batch, int n_head, int sq, int sk, int d,
                                   const long long* strides, float scale,
                                   void* stream) {
  if (d <= 128 || d > 512) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, o, n_head, sq, sk, d, strides, scale);
  return launch_wide(a, batch, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attn_joint(const void* q, const void* k, const void* v, void* o,
                                int batch, int n_head, int sq, int sk, int d,
                                const long long* strides, float scale,
                                void* stream) {
  const Args a = make_args(q, k, v, o, n_head, sq, sk, d, strides, scale);
  return launch_flash(a, batch, static_cast<cudaStream_t>(stream));
}
