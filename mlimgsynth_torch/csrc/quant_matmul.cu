// Weight-only quantized matmul kernels for Hopper (sm_90a).
//
// All four entry points compute y[M, N] = x[M, K] . deq(W)^T with bf16 x and
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
// fraction of the tensor-core rate.
//   * _tile: one block per 64 x 64 output tile, 4 warps of 32 x 32; a loop
//     over K in 128-deep groups stages the x group (16-byte loads) and the
//     dequantized weight group in shared memory, then mma.sync.m16n8k16
//     (bf16 in, f32 accumulate) on fragments read with ldmatrix.  The next
//     group's loads start into registers before the products of the
//     current one, so their latency overlaps the tensor-core work.  Each
//     block dequantizes its 64 weight rows once per M tile: cheap where M
//     is small (CLIP, the 16 x 16 level, cross-attention k/v, the time
//     embedding), which is where it runs.
//   * _ws (weight-stationary): one block owns a stripe of BN output columns,
//     dequantizes its full-K stripe once into dynamic shared memory as bf16
//     (BN = 64 up to K = 1280, 32 above), then sweeps a range of 64-row
//     M tiles through it, staging only x.  The grid is stripes x M ranges,
//     sized to fill the card once (the stripe count alone is 5 to 80 at
//     these shapes); each weight is dequantized once per M range instead of
//     once per M tile.  The x loads of the next (tile, group) step overlap
//     the products of the current one, as in _tile.
// No TMA/wgmma pipeline, no double-buffered shared memory and no
// warp specialisation yet.
// The TPU artifacts (sublane-padded [g, 8, bn] scales, the VMEM/HBM cost
// model choosing a geometry, grid-carried accumulators) are not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kGroup = 128;          // K rows per scale group
constexpr int kThreads = 128;        // 4 warps
constexpr int kBM = 64;              // output rows per M tile
constexpr int kPad = 8;              // shared-memory row padding (bf16): no bank conflicts
constexpr int kLX = kGroup + kPad;   // row stride of the staged x group

struct Args {
  const bf16* x;      // [M, K]
  const int8_t* w;    // [N, K] (q8) or [N, K / 2] (q4)
  const float* s;     // [N, K / 128]
  bf16* y;            // [M, N]
  int m, n, k;
};

__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// signed byte i (0..3, little-endian) of a 32-bit word
__device__ __forceinline__ int sbyte(uint32_t w, int i) {
  return static_cast<int>(w << (24 - 8 * i)) >> 24;
}

// 16 quantized values -> bf16_rn(q * sc) -> 32 bytes of shared memory
__device__ __forceinline__ void deq_store16(bf16* dst, const int (&q)[16], float sc) {
  uint32_t p[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    p[i] = pack_f32(static_cast<float>(q[2 * i]) * sc, static_cast<float>(q[2 * i + 1]) * sc);
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(p[0], p[1], p[2], p[3]);
  d[1] = make_uint4(p[4], p[5], p[6], p[7]);
}

// One thread's share of a weight group: ROWS rows x 128 K of q8 (8 vectors
// of 16 bytes a row) or q4 (4 vectors a row), with each vector's scale.
template <int BITS, int ROWS>
struct WFetch {
  static constexpr int kPerRow = BITS == 8 ? 8 : 4;
  static constexpr int kN = ROWS * kPerRow / kThreads;
  uint4 v[kN];
  float sc[kN];
};

// Start the loads of weight rows [n0, n0 + ROWS) x K group kg; rows at or
// past N read as zero (with a zero scale).
template <int BITS, int ROWS>
__device__ __forceinline__ void fetch_w(WFetch<BITS, ROWS>& f, const Args& a, int n0, int kg) {
  constexpr int P = WFetch<BITS, ROWS>::kPerRow;
  const int n_groups = a.k / kGroup;
  const long long row_bytes = BITS == 8 ? a.k : a.k / 2;
#pragma unroll
  for (int j = 0; j < WFetch<BITS, ROWS>::kN; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / P, c = (i % P) * 16, n = n0 + r;
    f.v[j] = make_uint4(0u, 0u, 0u, 0u);
    f.sc[j] = 0.f;
    if (n < a.n) {
      f.v[j] = *reinterpret_cast<const uint4*>(a.w + n * row_bytes + kg * (kGroup * BITS / 8) + c);
      f.sc[j] = a.s[(long long)n * n_groups + kg];
    }
  }
}

// Dequantize a fetched group into shared memory: row r at dst + r * ld, the
// group's 128 values from column col0.  q4: bytes j..j+15 of a row's group
// hold group rows j..j+15 (low nibbles) and j+64..j+79 (high nibbles).
template <int BITS, int ROWS>
__device__ __forceinline__ void store_w(bf16* dst, int ld, const WFetch<BITS, ROWS>& f, int col0) {
  constexpr int P = WFetch<BITS, ROWS>::kPerRow;
#pragma unroll
  for (int j = 0; j < WFetch<BITS, ROWS>::kN; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / P, c = (i % P) * 16;
    bf16* d = dst + r * ld + col0;
    const uint32_t words[4] = {f.v[j].x, f.v[j].y, f.v[j].z, f.v[j].w};
    if (BITS == 8) {
      int q[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) q[e] = sbyte(words[e >> 2], e & 3);
      deq_store16(d + c, q, f.sc[j]);
    } else {
      int lo[16], hi[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int b = sbyte(words[e >> 2], e & 3);
        hi[e] = b >> 4;
        lo[e] = ((b & 15) ^ 8) - 8;
      }
      deq_store16(d + c, lo, f.sc[j]);
      deq_store16(d + 64 + c, hi, f.sc[j]);
    }
  }
}

// One thread's share of an x group: kBM rows x 128 K, 16 vectors a row.
struct XFetch {
  static constexpr int kN = kBM * 16 / kThreads;
  uint4 v[kN];
};

// Start the loads of x rows [m0, m0 + kBM) x K group kg; rows at or past M
// read as zero.
__device__ __forceinline__ void fetch_x(XFetch& f, const Args& a, int m0, int kg) {
#pragma unroll
  for (int j = 0; j < XFetch::kN; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i >> 4, c = (i & 15) * 8, m = m0 + r;
    f.v[j] = make_uint4(0u, 0u, 0u, 0u);
    if (m < a.m)
      f.v[j] = *reinterpret_cast<const uint4*>(a.x + (long long)m * a.k + kg * kGroup + c);
  }
}

// Stage a fetched x group in shared memory (row stride kLX).
__device__ __forceinline__ void store_x(bf16* dst, const XFetch& f) {
#pragma unroll
  for (int j = 0; j < XFetch::kN; ++j) {
    const int i = threadIdx.x + j * kThreads;
    *reinterpret_cast<uint4*>(dst + (i >> 4) * kLX + (i & 15) * 8) = f.v[j];
  }
}

// Four 8 x 8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// acc[MI x 16 rows][NI x 8 cols] += sx[wm0.., 128] . sw[wn0.., 128]^T.
// The A fragments of a 16 x 16 step are the four 8 x 8 quarters of its x
// tile (rows, then the upper 8 columns); the B fragments of two 8-column
// tiles are the quarters of a 16 x 16 weight tile (k halves, then rows).
template <int MI, int NI>
__device__ __forceinline__ void mma_group(float (&acc)[MI][NI][4], const bf16* sx,
                                          const bf16* sw, int ldw, int wm0, int wn0) {
  const int lane = threadIdx.x & 31;
  const bf16* pa = sx + (wm0 + (lane & 15)) * kLX + (lane >> 4) * 8;
  const bf16* pb = sw + (wn0 + ((lane >> 4) << 3) + (lane & 7)) * ldw + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < kGroup / 16; ++kk) {
    uint32_t af[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) ldsm_x4(af[mi], pa + mi * 16 * kLX + kk * 16);
#pragma unroll
    for (int ni = 0; ni < NI; ni += 2) {
      uint32_t b[4];
      ldsm_x4(b, pb + ni * 8 * ldw + kk * 16);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        mma16816(acc[mi][ni], af[mi][0], af[mi][1], af[mi][2], af[mi][3], b[0], b[1]);
        mma16816(acc[mi][ni + 1], af[mi][0], af[mi][1], af[mi][2], af[mi][3], b[2], b[3]);
      }
    }
  }
}

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

// One 64 x 64 output tile per block; warps 2 x 2 of 32 x 32.  The loads of
// K group kg + 1 are in flight while the products of group kg run.
template <int BITS>
__global__ void __launch_bounds__(kThreads) qmm_tile_kernel(const Args a) {
  constexpr int BN = 64;
  __shared__ __align__(16) bf16 sx[kBM * kLX];
  __shared__ __align__(16) bf16 sw[BN * kLX];
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5;
  const int wm0 = (warp >> 1) * 32, wn0 = (warp & 1) * 32;
  const int n_groups = a.k / kGroup;
  float acc[2][4][4];
  zero_acc(acc);
  XFetch xf;
  WFetch<BITS, BN> wf;
  fetch_x(xf, a, m0, 0);
  fetch_w(wf, a, n0, 0);
  for (int kg = 0; kg < n_groups; ++kg) {
    __syncthreads();   // the previous group is consumed
    store_x(sx, xf);
    store_w(sw, kLX, wf, 0);
    __syncthreads();
    if (kg + 1 < n_groups) {
      fetch_x(xf, a, m0, kg + 1);
      fetch_w(wf, a, n0, kg + 1);
    }
    mma_group(acc, sx, sw, kLX, wm0, wn0);
  }
  store_tile(acc, a, m0 + wm0, n0 + wn0);
}

// Weight-stationary: the block's full-K stripe of BN columns dequantized once
// into shared memory ([BN][K + 8] bf16, then the [64][136] x group), then
// M tiles [t0, t0 + tiles) swept through it, one (tile, K group) step at a
// time with the next step's x loads in flight.  Warps: BN = 64, 2 x 2 of
// 32 x 32; BN = 32, 4 x 1 of 16 x 32.
template <int BITS, int BN>
__global__ void __launch_bounds__(kThreads) qmm_ws_kernel(const Args a, int tiles) {
  constexpr int WN = BN / 32;
  constexpr int WM = 4 / WN;
  constexpr int MI = kBM / WM / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldw = a.k + kPad;
  bf16* sw = reinterpret_cast<bf16*>(smem_raw);
  bf16* sx = sw + BN * ldw;
  const int n0 = blockIdx.x * BN;
  const int n_groups = a.k / kGroup;
  {
    WFetch<BITS, BN> wf;
    fetch_w(wf, a, n0, 0);
    for (int kg = 0; kg < n_groups; ++kg) {
      const WFetch<BITS, BN> cur = wf;
      if (kg + 1 < n_groups) fetch_w(wf, a, n0, kg + 1);
      store_w(sw, ldw, cur, kg * kGroup);
    }
  }

  const int warp = threadIdx.x >> 5;
  const int wm0 = (warp / WN) * (kBM / WM), wn0 = (warp % WN) * 32;
  const int n_tiles = (a.m + kBM - 1) / kBM;
  const int t0 = blockIdx.y * tiles;
  const int steps = (min(n_tiles, t0 + tiles) - t0) * n_groups;
  float acc[MI][4][4];
  zero_acc(acc);
  XFetch xf;
  fetch_x(xf, a, t0 * kBM, 0);
  for (int st = 0; st < steps; ++st) {
    const int mt = t0 + st / n_groups, kg = st % n_groups;
    __syncthreads();   // stripe written (first step) / previous x group consumed
    store_x(sx, xf);
    __syncthreads();
    if (st + 1 < steps)
      fetch_x(xf, a, (t0 + (st + 1) / n_groups) * kBM, (st + 1) % n_groups);
    mma_group(acc, sx, sw + kg * kGroup, ldw, wm0, wn0);
    if (kg == n_groups - 1) {
      store_tile(acc, a, mt * kBM + wm0, n0 + wn0);
      zero_acc(acc);
    }
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

template <int BITS>
int launch_tile(const Args& a, cudaStream_t stream) {
  if (bad_shape(a.m, a.n, a.k)) return (int)cudaErrorInvalidValue;
  dim3 grid((a.m + kBM - 1) / kBM, (a.n + 63) / 64);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  qmm_tile_kernel<BITS><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int BITS, int BN>
int launch_ws_bn(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * ((size_t)BN * (a.k + kPad) + (size_t)kBM * kLX);
  cudaError_t err = cudaFuncSetAttribute(qmm_ws_kernel<BITS, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qmm_ws_kernel<BITS, BN>,
                                                           kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // one wave: M ranges per stripe so that stripes x ranges ~ blocks in flight
  const int stripes = (a.n + BN - 1) / BN;
  const int n_tiles = (a.m + kBM - 1) / kBM;
  int ranges = (per_sm * sms + stripes - 1) / stripes;
  ranges = ranges < 1 ? 1 : (ranges > n_tiles ? n_tiles : ranges);
  const int tiles = (n_tiles + ranges - 1) / ranges;
  ranges = (n_tiles + tiles - 1) / tiles;
  if (ranges > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(stripes, ranges);
  qmm_ws_kernel<BITS, BN><<<grid, kThreads, smem, stream>>>(a, tiles);
  return (int)cudaGetLastError();
}

template <int BITS>
int launch_ws(const Args& a, int bn, cudaStream_t stream) {
  if (bad_shape(a.m, a.n, a.k)) return (int)cudaErrorInvalidValue;
  if (bn == 64) return launch_ws_bn<BITS, 64>(a, stream);
  if (bn == 32) return launch_ws_bn<BITS, 32>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x [M, K] bf16, w int8 ([N, K] q8 / [N, K / 2] q4), s [N, K / 128] f32,
// y [M, N] bf16, all contiguous with 16-byte aligned bases.  Each returns the
// cudaError_t of the launch (0 on success); the ws entry points take the
// stripe width bn (64 or 32) and refuse a stripe that does not fit in
// shared memory.
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
