// Flash-attention forward kernels for Hopper (sm_90a), bf16 in / bf16 out.
//
// All three entry points compute o = softmax(q k^T * scale) v per (batch,
// head) with an f32 running max, f32 running sum and f32 accumulator, on the
// natural [B, H, S, D] layout (any batch/head/seq strides that are multiples
// of 8 elements, unit stride on D, D a multiple of 8, 16-byte aligned base
// pointers: every tile row loads as 16-byte vectors).
//
//   flash_attn_fwd       replaces mlimgsynth_tpu/ops/flash_attention.py
//                        flash_attention_t / _flash_kernel_t (K1: UNet
//                        self-attention; d_head 40 and 80 at SD1 512^2,
//                        64 for SDXL).  Serves D <= 128, 64-row q tiles.
//   flash_attn_fwd_wide  replaces mlimgsynth_tpu/ops/flash_attention.py
//                        flash_attention / _flash_kernel (K2: the VAE
//                        mid-block's single head, D = 512).  Serves
//                        128 < D <= 512 (all of it padded to 512 in shared
//                        memory).
//   flash_attn_joint     replaces mlimgsynth_tpu/ops/stock_flash.py
//                        stock_flash (K3, JAX's TPU flash kernel) and
//                        ops/splash_flash.py splash_flash (K4, the same
//                        function with the kv pad blocks skipped): the
//                        MMDiT joint attention, [2, 24, 4250, 64] for
//                        SD3-medium at 1024^2.  Serves D <= 128 with
//                        128-row q tiles (8 warps share each kv tile).
//                        The TPU kernels pad kv to a multiple of 512 and
//                        mask (K3) or skip (K4) the pad; here the loop over
//                        kv tiles ends at Sk and the last tile's ragged
//                        rows are zero-filled in shared memory and masked,
//                        so no pad is ever loaded or computed.
//
// What bounds it on the H100.  Per (q row, kv row) pair the kernel does
// 4*D flops of QK^T and PV on the tensor cores but also one exp2, a max and
// a sum in logits space on the CUDA cores; at D = 40 the logits-space work
// is the larger part (the same balance that made the TPU kernel VPU-bound),
// while bytes are small: q, k, v, o are read/written once per q tile, so the
// kernel is far above the H100's ridge point and never memory-bound at these
// shapes (the SD3 joint attention: 2.2e11 flop against 0.14 GB).  The simple
// design:
//   * one block = WARPS warps = 16 * WARPS q rows (16 per warp), the q tile
//     staged once in shared memory; a loop over 64-row k/v tiles staged in
//     shared memory replaces the TPU kernel's sequential k grid axis; the
//     joint kernel's 8 warps halve the k/v loads per q row against the 4 of
//     the others;
//   * both products run on mma.sync.m16n8k16 (bf16 in, f32 accumulate) on
//     fragments read with ldmatrix (.trans for v, which is the B operand of
//     PV in its natural layout); the probabilities go from the QK^T
//     accumulator registers straight into the A operand of the PV product,
//     so logits never touch shared memory; up to D = 128 each warp keeps its
//     q fragments in registers for the whole kv loop;
//   * the k/v tiles arrive by cp.async into two shared-memory stages, the
//     next tile's copy in flight during the products of the current one
//     (one stage for the wide kernel, whose 512-deep tiles fit only once);
//   * softmax in base 2 with scale*log2(e) applied to the f32 logits; the
//     ragged Sk tail is masked to -inf in the last tile;
//   * D is zero-padded to the MMA depth (40 -> 48) in shared memory only;
//     device-memory tensors keep their true width;
//   * the wide kernel cannot hold a 64 x 512 f32 accumulator in registers,
//     so the output's D is split across blocks (128 columns each, grid.y):
//     every block recomputes the full-depth logits, row max and row sum of
//     its q tile and accumulates only its own 128 output columns.
// A first version read the fragments with 16- and 32-bit shared loads and
// staged the tiles with synchronous copies; the joint kernel ran at 14% of
// the bf16 rate at the SD3 shape (PERF.md).  No TMA/wgmma pipeline yet.  The
// TPU artifacts (transposed v, ones-row denominator, static max, split-k,
// scoped-VMEM planning, kv padding with segment ids) are not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBlockN = 64;   // kv rows per shared-memory tile
constexpr int kPad = 8;       // shared-memory row padding (bf16): no bank conflicts

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

// Four 8 x 8 bf16 matrices from shared memory (lane l gives the address of
// row l % 8 of matrix l / 8), plain or transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// 16 bytes from device to shared memory, asynchronously; zero-filled (and
// read from nowhere) where !valid, with gmem then any valid address.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying rows [row0, row0 + ROWS) x columns [col0, col0 + WIDTH) of
// one head's [S, D] slice (row stride rs) into shared memory with row stride
// WIDTH + kPad, zero-filling rows >= n_rows and columns >= d, in 16-byte
// copies (d, rs and col0 are multiples of 8 and the base is aligned).
template <int ROWS, int WIDTH, int THREADS>
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* g, long long rs,
                                          int row0, int n_rows, int col0, int d) {
  constexpr int LD = WIDTH + kPad;
  constexpr int VPR = WIDTH / 8;
  for (int i = threadIdx.x; i < ROWS * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const int gr = row0 + r, gc = col0 + c;
    const bool ok = gr < n_rows && gc < d;
    cp_async16(sm + r * LD + c, ok ? g + (long long)gr * rs + gc : g, ok);
  }
}

// k/v tile stages in shared memory at QK^T depth dqk
__host__ __device__ constexpr int stages(int dqk) { return dqk <= 128 ? 2 : 1; }

// DQK:   QK^T depth (D zero-padded to a multiple of 16).
// DV:    output columns per block (grid.y walks D in DV-wide chunks).
// WARPS: warps per block, 16 q rows each.
template <int DQK, int DV, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
attn_fwd_kernel(const Args a) {
  constexpr int kBlockM = 16 * WARPS;
  constexpr int kThreads = 32 * WARPS;
  constexpr int LQ = DQK + kPad;
  constexpr int LV = DV + kPad;
  constexpr int NT = kBlockN / 8;    // 8-wide logits tiles per kv tile
  constexpr int OT = DV / 8;         // 8-wide output tiles per warp
  constexpr int STAGES = stages(DQK);
  constexpr bool QREG = DQK <= 128;  // q fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);
  bf16* s_k = s_q + kBlockM * LQ;
  bf16* s_v = s_k + STAGES * kBlockN * LQ;

  const int m0 = blockIdx.x * kBlockM;
  const int dv0 = blockIdx.y * DV;
  const int b = blockIdx.z / a.n_head, h = blockIdx.z % a.n_head;
  const bf16* q = a.q + b * a.st[0][0] + h * a.st[0][1];
  const bf16* k = a.k + b * a.st[1][0] + h * a.st[1][1];
  const bf16* v = a.v + b * a.st[2][0] + h * a.st[2][1];
  bf16* o = a.o + b * a.st[3][0] + h * a.st[3][1];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;   // mma fragment row group / column pair
  // ldmatrix row addresses: the A tile (q, 16 x 16), the B tiles of k (two
  // 8-row kv tiles x 16 deep) and of v (16 kv rows x two 8-column tiles)
  const bf16* q_w = s_q + (warp * 16 + (lane & 15)) * LQ + (lane >> 4) * 8;
  const int k_off = (((lane >> 4) << 3) + (lane & 7)) * LQ + ((lane >> 3) & 1) * 8;
  const int v_off = (lane & 15) * LV + (lane >> 4) * 8;

  load_tile<kBlockM, DQK, kThreads>(s_q, q, a.st[0][2], m0, a.sq, 0, a.d);
  if (STAGES == 2) {
    load_tile<kBlockN, DQK, kThreads>(s_k, k, a.st[1][2], 0, a.sk, 0, a.d);
    load_tile<kBlockN, DV, kThreads>(s_v, v, a.st[2][2], 0, a.sk, dv0, a.d);
  }
  cp_async_commit();

  uint32_t qf[QREG ? DQK / 16 : 1][4];
  float acc[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // rows g and g + 8 of this warp's 16: running max (base 2) and partial sum
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int n0 = 0; n0 < a.sk; n0 += kBlockN) {
    const int stage = STAGES == 2 ? (n0 / kBlockN) & 1 : 0;
    bf16* sk = s_k + stage * kBlockN * LQ;
    bf16* sv = s_v + stage * kBlockN * LV;
    if (STAGES == 2) {
      // the next tile into the other stage, which the previous pass freed
      if (n0 + kBlockN < a.sk) {
        load_tile<kBlockN, DQK, kThreads>(s_k + (stage ^ 1) * kBlockN * LQ, k, a.st[1][2],
                                          n0 + kBlockN, a.sk, 0, a.d);
        load_tile<kBlockN, DV, kThreads>(s_v + (stage ^ 1) * kBlockN * LV, v, a.st[2][2],
                                         n0 + kBlockN, a.sk, dv0, a.d);
      }
      cp_async_commit();
      cp_async_wait<1>();   // this tile (and q) landed
    } else {
      load_tile<kBlockN, DQK, kThreads>(sk, k, a.st[1][2], n0, a.sk, 0, a.d);
      load_tile<kBlockN, DV, kThreads>(sv, v, a.st[2][2], n0, a.sk, dv0, a.d);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (QREG) {
      if (n0 == 0) {
#pragma unroll
        for (int kk = 0; kk < DQK / 16; ++kk) ldsm_x4(qf[kk], q_w + kk * 16);
      }
    }

    // logits s[16 x 64] = q_w[16 x DQK] k_tile^T
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
      uint32_t af[4];
      if constexpr (QREG) {
        af[0] = qf[kk][0], af[1] = qf[kk][1], af[2] = qf[kk][2], af[3] = qf[kk][3];
      } else {
        ldsm_x4(af, q_w + kk * 16);
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bk[4];
        ldsm_x4(bk, sk + j * 8 * LQ + k_off + kk * 16);
        mma16816(s[j], af[0], af[1], af[2], af[3], bk[0], bk[1]);
        mma16816(s[j + 1], af[0], af[1], af[2], af[3], bk[2], bk[3]);
      }
    }

    // online softmax: scale to base 2, mask the ragged tail, new row max
    float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + j * 8 + 2 * t + (e & 1);
        const float x = col < a.sk ? s[j][e] * a.scale_log2 : -INFINITY;
        s[j][e] = x;
        m_new[e >> 1] = fmaxf(m_new[e >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
    }
    // every tile holds at least one unmasked column, so m_new is finite
    const float alpha[2] = {exp2f(m_run[0] - m_new[0]), exp2f(m_run[1] - m_new[1])};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = exp2f(s[j][e] - m_new[e >> 1]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) rs += s[j][2 * r] + s[j][2 * r + 1];
      l_run[r] = l_run[r] * alpha[r] + rs;
      m_run[r] = m_new[r];
    }
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // acc[16 x DV] += p[16 x 64] v_tile[64 x DV]; the logits accumulator
    // layout is the A-operand layout, so p never leaves registers
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t a0 = pack_f32(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_f32(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < OT; j += 2) {
        uint32_t bv[4];
        ldsm_x4_t(bv, sv + kk * 16 * LV + v_off + j * 8);
        mma16816(acc[j], a0, a1, a2, a3, bv[0], bv[1]);
        mma16816(acc[j + 1], a0, a1, a2, a3, bv[2], bv[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage
  }
  cp_async_wait<0>();   // no copy outlives the block (only empty groups remain)

  // the four threads of a row group hold disjoint partial row sums
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float inv[2] = {1.f / l_run[0], 1.f / l_run[1]};
  const long long os = a.st[3][2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + warp * 16 + g + 8 * r;
    if (row >= a.sq) continue;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = dv0 + j * 8 + 2 * t + e;
        if (col < a.d)
          o[(long long)row * os + col] = __float2bfloat16(acc[j][2 * r + e] * inv[r]);
      }
    }
  }
}

template <int DQK, int DV, int WARPS = 4>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  constexpr int kBlockM = 16 * WARPS;
  const size_t smem =
      sizeof(bf16) * ((size_t)kBlockM * (DQK + kPad) +
                      (size_t)stages(DQK) * kBlockN * (DQK + kPad + DV + kPad));
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<DQK, DV, WARPS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.sq + kBlockM - 1) / kBlockM, (a.d + DV - 1) / DV, batch * a.n_head);
  attn_fwd_kernel<DQK, DV, WARPS><<<grid, 32 * WARPS, smem, stream>>>(a);
  return cudaGetLastError();
}

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

}  // namespace

// strides: 12 element strides, (batch, head, seq) for q, k, v, o in turn.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                              int batch, int n_head, int sq, int sk, int d,
                              const long long* strides, float scale,
                              void* stream) {
  const Args a = make_args(q, k, v, o, n_head, sq, sk, d, strides, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 48) return (int)launch<48, 48>(a, batch, st);
  if (d <= 64) return (int)launch<64, 64>(a, batch, st);
  if (d <= 80) return (int)launch<80, 80>(a, batch, st);
  if (d <= 128) return (int)launch<128, 128>(a, batch, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attn_fwd_wide(const void* q, const void* k, const void* v, void* o,
                                   int batch, int n_head, int sq, int sk, int d,
                                   const long long* strides, float scale,
                                   void* stream) {
  const Args a = make_args(q, k, v, o, n_head, sq, sk, d, strides, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 128 || d > 512) return (int)cudaErrorInvalidValue;
  return (int)launch<512, 128>(a, batch, st);
}

extern "C" int flash_attn_joint(const void* q, const void* k, const void* v, void* o,
                                int batch, int n_head, int sq, int sk, int d,
                                const long long* strides, float scale,
                                void* stream) {
  const Args a = make_args(q, k, v, o, n_head, sq, sk, d, strides, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 64) return (int)launch<64, 64, 8>(a, batch, st);
  if (d <= 128) return (int)launch<128, 128, 8>(a, batch, st);
  return (int)cudaErrorInvalidValue;
}
