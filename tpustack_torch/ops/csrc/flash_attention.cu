// Flash attention forward for Hopper (sm_90a), bf16 in and out.
//
// Replaces the Pallas TPU kernels in tpustack/ops/pallas/flash_attention.py:
// _attn_kernel (the "panel" kernel, whole K/V per head in VMEM) and
// _attn_kernel_stream (k-streaming with an online-softmax carry, q_offset and
// kv_len scalars).  Both split on the TPU only because of VMEM size and the
// sequential grid; here one loop over K/V tiles serves both.
//
// Function: o[b,i,h,:] = sum_j softmax_j(q[b,i,h,:].k[b,j,h/g,:] * scale) v[b,j,h/g,:]
// over keys j < kv_len and, when causal, j <= q_offset + i.  BSHD layout in
// and out, GQA with g = H / Hkv (K/V never expanded).  A row with no valid key
// gets 0, as the TPU kernel's acc / max(l, 1e-30) does.
//
// Design: one CUDA block of 4 warps per (b*h, 64-row q tile); each warp owns 16
// q rows.  The block walks K/V in 64-key tiles staged in shared memory.  Each
// warp keeps its Q fragments, its 16x64 score tile S and its 16xD f32
// accumulator O in registers: S = Q.K^T and O += P.V are mma.sync m16n8k16
// (bf16 in, f32 accumulate) fed by ldmatrix, and the S accumulator layout is
// reused directly as the A operand of P.V, so probabilities never touch
// shared memory.  The running max and denominator (online softmax, log2
// domain) live in registers, per row; nothing carries between blocks.  D is
// zero-padded in shared memory to DP, the next multiple of 16 (40 -> 48,
// 80 -> 80); shared rows are DP + 8 wide so ldmatrix rows hit distinct banks.
// K/V tiles are double-buffered: cp.async copies tile t+1 into shared memory
// while the tensor cores work on tile t.  Tiles at or past kv_len, and
// (causal) tiles wholly above the block's last row, are skipped; the mask is
// evaluated only on tiles that cross kv_len or the diagonal.
//
// What bounds it on an H100 SXM: at the SD1.5 shape [2,4096,8,40] the work is
// 4*B*H*Sq*Sk*D = 42.9 GFLOP against ~21 MB of q/k/v/o, so it is compute bound:
// 43 us at 989 TFLOP/s bf16.  What this design leaves on the table: mma.sync
// instead of wgmma (Hopper's full tensor-core rate needs warpgroup MMA),
// cp.async with per-thread address arithmetic instead of TMA, 20% padding
// waste at D=40, and a 64-row q tile that re-reads K/V once per 64 rows (a
// 128-row tile measured no better with this register budget).  Those are a
// later change's work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;        // each warp owns 16 q rows
constexpr int BQ = 16 * WARPS;  // q rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = WARPS * 32;
constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16x16, row) . b (16x8, col); f32 accumulate
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16-byte global->shared copy that bypasses registers; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async_16(bf16* dst, const bf16* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Copy `rows` rows of D bf16 values (row r at src + r*row_stride elements)
// into a [nrows][LD] shared tile with cp.async, zero-filling rows >= rows and
// columns in [D, DP).  D is a multiple of 8, so each 16-byte chunk is wholly
// in or out.  The caller commits and waits.
template <int DP, int LD>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int nrows, int rows,
                                                long long row_stride, int D) {
  constexpr int CH = DP / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < nrows * CH; idx += THREADS) {
    const int r = idx / CH;
    const int c = (idx - r * CH) * 8;
    const bool in = r < rows && c < D;
    cp_async_16(dst + r * LD + c, in ? src + r * row_stride + c : src, in ? 16 : 0);
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       int Sq, int Sk, int H, int Hkv, int D,
                       int causal, int q_offset, int kv_len, float scale_log2) {
  constexpr int LD = DP + 8;        // shared row stride (elements)
  constexpr int KSTEPS = DP / 16;   // k-steps of Q.K^T
  constexpr int NT_S = BK / 8;      // 8-key n-tiles of S
  constexpr int NT_O = DP / 8;      // 8-wide n-tiles of O (even: DP % 16 == 0)
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk_buf = sq + BQ * LD;               // [2][BK][LD], double-buffered
  bf16* sv_buf = sk_buf + 2 * BK * LD;       // [2][BK][LD]

  const int bh = blockIdx.x;          // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / (H / Hkv);       // GQA: the K/V head this q head reads
  const int q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;            // accumulator row within the 8-row half
  const int tq = lane & 3;            // accumulator column pair

  const long long q_row_stride = (long long)H * D;
  const long long kv_row_stride = (long long)Hkv * D;
  const bf16* qb = q + ((long long)b * Sq + q0) * q_row_stride + (long long)h * D;
  const bf16* kb = k + (long long)b * Sk * kv_row_stride + (long long)hk * D;
  const bf16* vb = v + (long long)b * Sk * kv_row_stride + (long long)hk * D;

  const int q_rows = min(BQ, Sq - q0);
  load_tile_async<DP, LD>(sq, qb, BQ, q_rows, q_row_stride, D);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int wrow = warp * 16;                 // the warp's first row in the block
  uint32_t qf[KSTEPS][4];
  #pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    ldmatrix_x4(qf[kk], sq + (wrow + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
  }

  // keys this block can need: below kv_len and, causal, up to its last row
  int limit = min(kv_len, Sk);
  if (causal) limit = min(limit, q_offset + q0 + q_rows);
  const int n_tiles = limit > 0 ? (limit + BK - 1) / BK : 0;

  const int pos0 = q_offset + q0 + wrow + g;  // global position of row g; row g+8 is +8
  const int pos1 = pos0 + 8;
  float acc[NT_O][4];
  #pragma unroll
  for (int n = 0; n < NT_O; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {NEG_BIG, NEG_BIG};
  float l_run[2] = {0.f, 0.f};  // this thread's columns only; quad-summed at the end

  if (n_tiles > 0) {
    load_tile_async<DP, LD>(sk_buf, kb, BK, min(BK, Sk), kv_row_stride, D);
    load_tile_async<DP, LD>(sv_buf, vb, BK, min(BK, Sk), kv_row_stride, D);
  }
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * BK;
    // prefetch tile t+1 into the other buffer while tile t is computed; the
    // __syncthreads at the end of the previous iteration freed that buffer
    const bf16* sk = sk_buf + (t & 1) * BK * LD;
    const bf16* sv = sv_buf + (t & 1) * BK * LD;
    if (t + 1 < n_tiles) {
      const int nxt = kv0 + BK;
      bf16* dk = sk_buf + ((t + 1) & 1) * BK * LD;
      bf16* dv = sv_buf + ((t + 1) & 1) * BK * LD;
      load_tile_async<DP, LD>(dk, kb + nxt * kv_row_stride, BK, min(BK, Sk - nxt), kv_row_stride, D);
      load_tile_async<DP, LD>(dv, vb + nxt * kv_row_stride, BK, min(BK, Sk - nxt), kv_row_stride, D);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: tile t has landed
    __syncthreads();

    // S[16][64] = Q_w . K^T
    float s[NT_S][4];
    #pragma unroll
    for (int j = 0; j < NT_S; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    #pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      #pragma unroll
      for (int j = 0; j < NT_S; j += 2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, sk + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD
                            + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_16816(s[j], qf[kk], bk[0], bk[1]);
        mma_16816(s[j + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // online softmax (log2 domain); the mask only where the tile crosses
    // kv_len or, causal, the diagonal of the warp's first row
    const bool masked_tile = kv0 + BK > kv_len || (causal && kv0 + BK - 1 > pos0 - g);
    float mx0 = NEG_BIG, mx1 = NEG_BIG;
    #pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      #pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v0 = s[j][e] * scale_log2;
        float v1 = s[j][2 + e] * scale_log2;
        if (masked_tile) {
          const int col = kv0 + j * 8 + tq * 2 + e;
          if (col >= kv_len || (causal && col > pos0)) v0 = NEG_BIG;
          if (col >= kv_len || (causal && col > pos1)) v1 = NEG_BIG;
        }
        s[j][e] = v0;
        s[j][2 + e] = v1;
        mx0 = fmaxf(mx0, v0);
        mx1 = fmaxf(mx1, v1);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float m0 = fmaxf(m_run[0], mx0);
    const float m1 = fmaxf(m_run[1], mx1);
    const float alpha0 = exp2f(m_run[0] - m0);
    const float alpha1 = exp2f(m_run[1] - m1);
    m_run[0] = m0;
    m_run[1] = m1;
    float sum0 = 0.f, sum1 = 0.f;
    #pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      #pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = s[j][e] > 0.5f * NEG_BIG ? exp2f(s[j][e] - m0) : 0.f;
        const float p1 = s[j][2 + e] > 0.5f * NEG_BIG ? exp2f(s[j][2 + e] - m1) : 0.f;
        s[j][e] = p0;
        s[j][2 + e] = p1;
        sum0 += p0;
        sum1 += p1;
      }
    }
    l_run[0] = l_run[0] * alpha0 + sum0;
    l_run[1] = l_run[1] * alpha1 + sum1;
    #pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }

    // O += P . V, P straight from the S accumulators (bf16)
    #pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      #pragma unroll
      for (int n = 0; n < NT_O; n += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, sv + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD
                                  + n * 8 + (lane >> 4) * 8);
        mma_16816(acc[n], pa, bv[0], bv[1]);
        mma_16816(acc[n + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer t & 1 before it refills
  }

  // normalise and write rows g and g+8 of the warp's 16
  float l0 = l_run[0], l1 = l_run[1];
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int r0 = wrow + g;
  #pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + hh * 8;
    if (r >= q_rows) continue;
    const float inv = hh ? inv1 : inv0;
    bf16* orow = o + ((long long)b * Sq + q0 + r) * q_row_stride + (long long)h * D;
    #pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      const int d = n * 8 + tq * 2;
      if (d < D) {
        *reinterpret_cast<__nv_bfloat162*>(orow + d) =
            __floats2bfloat162_rn(acc[n][2 * hh] * inv, acc[n][2 * hh + 1] * inv);
      }
    }
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int Hkv, int D, int causal,
                   int q_offset, int kv_len, float scale, cudaStream_t stream) {
  constexpr int bytes = (BQ + 4 * BK) * (DP + 8) * 2;  // Q + 2 x (K, V)
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_attention_kernel<DP><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      Sq, Sk, H, Hkv, D, causal, q_offset, kv_len, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes.  Returns a cudaError_t (0 = launched).  Launches
// on `stream` and allocates nothing; the caller owns every buffer.
extern "C" int tpst_flash_attention_bf16(const void* q, const void* k, const void* v,
                                         void* o, int B, int Sq, int Sk, int H,
                                         int Hkv, int D, int causal, int q_offset,
                                         int kv_len, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      D <= 0 || D > 128 || D % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (kv_len > Sk) kv_len = Sk;  // keys past Sk do not exist
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((D + 15) / 16 * 16) {
    case 16: err = launch<16>(q, k, v, o, B, Sq, Sk, H, Hkv, D, causal, q_offset, kv_len, scale, s); break;
    case 32: err = launch<32>(q, k, v, o, B, Sq, Sk, H, Hkv, D, causal, q_offset, kv_len, scale, s); break;
    case 48: err = launch<48>(q, k, v, o, B, Sq, Sk, H, Hkv, D, causal, q_offset, kv_len, scale, s); break;
    case 64: err = launch<64>(q, k, v, o, B, Sq, Sk, H, Hkv, D, causal, q_offset, kv_len, scale, s); break;
    case 80: err = launch<80>(q, k, v, o, B, Sq, Sk, H, Hkv, D, causal, q_offset, kv_len, scale, s); break;
    case 96: err = launch<96>(q, k, v, o, B, Sq, Sk, H, Hkv, D, causal, q_offset, kv_len, scale, s); break;
    case 112: err = launch<112>(q, k, v, o, B, Sq, Sk, H, Hkv, D, causal, q_offset, kv_len, scale, s); break;
    case 128: err = launch<128>(q, k, v, o, B, Sq, Sk, H, Hkv, D, causal, q_offset, kv_len, scale, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
