// Paged decode / verify attention for Hopper (sm_90a): the online-softmax
// partial over a KV pool read in place through per-row block tables.
//
// Replaces the Pallas TPU kernel in tpustack/ops/pallas/flash_attention.py:
// _paged_attn_kernel (entry paged_attention_partial).  Function, per batch
// row b, query row i and head h (kv head hk = h / g):
//   logits[j] = q[b,i,h,:].K[j,hk,:] (* k_scale[j]) * scale      for j < len[b]
//   m = max_j logits, l = sum_j exp(logits[j] - m),
//   acc = sum_j bf16(exp(logits[j] - m) (* v_scale[j])) V[j,hk,:]
// where position j lives at pool block bt[b, j / blk], offset j % blk.  The
// outputs stay unnormalised (acc f32 [B,S,H,D], m and l f32 [B,S,H]) so the
// caller merges them with the chunk-buffer partial; a row with len == 0
// writes m = -1e30, l = 0, acc = 0.  int8 pools are converted to bf16 in
// shared memory (exact), k_scale goes on the scores and v_scale on p after
// p went into l, the order of the Pallas kernel.
//
// Design.  One CUDA block of 4 warps per (b, kv head, key split).  Its query
// rows are the S positions x the g heads of the group, R = S*g (7 at a
// Qwen2.5 decode step, 35 at a 4-token verify), padded to RT m16 tiles.  The
// block walks 64-position key tiles [t0, t1) of its split; each tile's 64
// K and V rows are copied with cp.async from wherever the block table puts
// them (row stride Hkv*D), double-buffered, zero-filled at and past len[b]
// and wherever the table says block 0 (where idle entries point), so
// nothing past the frontier and nothing of block 0 is read.  Warps split the tile: RT row
// tiles x WK key slices (RT=1: 4 slices of 16 keys; RT=2: 2 of 32; RT=3,4:
// one row tile each over all 64 keys).  Each warp keeps its S and O tiles
// and its running (m, l) in registers: S = Q.K^T and O += P.V are mma.sync
// m16n8k16 (bf16 in, f32 accumulate) fed by ldmatrix, the S accumulators
// reused as the A operand of P.V, as in flash_attention.cu.  At the end the
// warps' partials merge through shared memory.  The mask is applied on the
// row's last tile only.
//
// Split.  B*Hkv is 32 blocks at the served shape (8 slots x 4 kv heads), a
// quarter of the H100's 132 SMs, so the wrapper splits each row's table over
// nsplit blocks (8 at ctx 4096: 256 blocks of up to 512 keys).  Each writes
// its partial to a workspace and paged_merge_kernel (below, the arithmetic of
// merge_attention_partials) combines them into the output layout; with one
// split the first kernel writes the output directly.  Splits past a row's
// length write the empty partial and exit.
//
// What bounds it on an H100 SXM: bytes.  A decode step at the served shape
// reads each valid position's K and V once (512 bytes at D=128 bf16) against
// 4*D*R flops per position and kv head: 7 flops/byte at decode, 35 at
// verify, both under the ~295 where bf16 tensor cores would bind.  What the
// design leaves on the table: mma.sync instead of wgmma, per-row cp.async
// address arithmetic instead of TMA, padding rows to m16 (7 -> 16 at
// decode), and the merge pass's workspace round trip.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;
constexpr int TK = 64;  // key positions per tile
constexpr float NEG_INF = -1e30f;
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
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
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

struct Params {
  const bf16* q;          // [B, S, H, D]
  const void* pk;         // [N, blk, Hkv, D] bf16 or int8
  const void* pv;
  const float* ks;        // [N, blk, Hkv] (int8 only)
  const float* vs;
  const int* bt;          // [B, nb]
  const int* lens;        // [B]
  float* acc;             // output [B, S, H, D] or workspace [B*Hkv, nsplit, RP, D]
  float* m;               // output [B, S, H] or workspace [B*Hkv, nsplit, RP]
  float* l;
  int S, H, Hkv, D, blk, nb, n_pool, tiles_per_split, nsplit, direct;
  float scale;
};

// Pool row address of key position p of batch row b (p < len, checked by the
// caller), or -1 when the table entry is the reserved block 0 or out of the
// pool: such rows load as zeros, so block 0 is never read at all (a row whose
// length runs past its allocation, a retiring slot's overshoot, reads zeros).
__device__ __forceinline__ long long pool_row(const Params& P, int b, int kvh, int p) {
  const int bid = P.bt[(long long)b * P.nb + p / P.blk];
  if (bid <= 0 || bid >= P.n_pool) return -1;
  return ((long long)bid * P.blk + p % P.blk) * P.Hkv + kvh;
}

// Write the rows' partial (unnormalised acc, m, l) of query row r, column d.
// `direct`: into the output layout [B,S,H(,D)]; else into the workspace.
__device__ __forceinline__ void store_partial(const Params& P, int b, int kvh, int split,
                                              int RP, int r, int d, float a, float mv,
                                              float lv) {
  const int g = P.H / P.Hkv;
  if (P.direct) {
    const int s = r / g, h = kvh * g + r % g;
    const long long row = ((long long)b * P.S + s) * P.H + h;
    P.acc[row * P.D + d] = a;
    if (d == 0) {
      P.m[row] = mv;
      P.l[row] = lv;
    }
  } else {
    const long long row = ((long long)(b * P.Hkv + kvh) * P.nsplit + split) * RP + r;
    P.acc[row * P.D + d] = a;
    if (d == 0) {
      P.m[row] = mv;
      P.l[row] = lv;
    }
  }
}

// DP: head dim padded to 64 or 128; RT: m16 row tiles; QUANT: int8 pool
template <int DP, int RT, bool QUANT>
__global__ void __launch_bounds__(THREADS)
paged_partial_kernel(const Params P) {
  constexpr int RP = RT * 16;
  constexpr int LD = DP + 8;            // bf16 shared row stride (elements)
  constexpr int WK = RT == 1 ? 4 : (RT == 2 ? 2 : 1);  // key slices per tile
  constexpr int NW = RT * WK;           // warps that compute (3 when RT == 3)
  constexpr int KW = TK / WK;           // keys per warp per tile: 16, 32, 64
  constexpr int KSTEPS = DP / 16;
  constexpr int NT_S = KW / 8;
  constexpr int NT_O = DP / 8;
  constexpr int NBUF = QUANT ? 1 : 2;   // bf16 K/V tiles (int8 stages twice instead)

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);                   // [RP][LD]
  bf16* sk_buf = sq + RP * LD;                                // [NBUF][TK][LD]
  bf16* sv_buf = sk_buf + NBUF * TK * LD;                     // [NBUF][TK][LD]
  unsigned char* tail = reinterpret_cast<unsigned char*>(sv_buf + NBUF * TK * LD);
  int8_t* st_k = reinterpret_cast<int8_t*>(tail);             // int8: [2][TK][DP]
  int8_t* st_v = st_k + 2 * TK * DP;
  float* ks_s = reinterpret_cast<float*>(st_v + 2 * TK * DP);  // int8: [TK]
  float* vs_s = ks_s + TK;
  // after the key loop the K/V tiles are reused for the warps' partials
  float* red_m = reinterpret_cast<float*>(sk_buf);            // [NW][16]
  float* red_l = red_m + NW * 16;                             // [NW][16]
  float* red_acc = red_l + NW * 16;                           // [NW][16][DP]

  const int bh = blockIdx.x;
  const int b = bh / P.Hkv;
  const int kvh = bh - b * P.Hkv;
  const int split = blockIdx.y;
  const int g = P.H / P.Hkv;
  const int R = P.S * g;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;  // accumulator row within the 8-row half
  const int tq = lane & 3;   // accumulator column pair

  const int len = min(P.lens[b], P.nb * P.blk);
  const int n_tiles = len > 0 ? (len + TK - 1) / TK : 0;
  const int t0 = split * P.tiles_per_split;
  const int t1 = min(t0 + P.tiles_per_split, n_tiles);
  if (t0 >= t1) {  // no key of this row falls in this split: the empty partial
    for (int idx = threadIdx.x; idx < R * P.D; idx += THREADS) {
      store_partial(P, b, kvh, split, RP, idx / P.D, idx % P.D, 0.f, NEG_INF, 0.f);
    }
    return;
  }

  // Q rows: row r is position r / g of head kvh*g + r % g; padding rows zero
  {
    constexpr int CH = DP / 8;
    for (int idx = threadIdx.x; idx < RP * CH; idx += THREADS) {
      const int r = idx / CH;
      const int c = (idx - r * CH) * 8;
      const bool in = r < R && c < P.D;
      const bf16* src = P.q;
      if (in) {
        const int s = r / g, h = kvh * g + r % g;
        src = P.q + (((long long)b * P.S + s) * P.H + h) * P.D + c;
      }
      cp_async_16(sq + r * LD + c, src, in ? 16 : 0);
    }
    cp_async_commit();
  }

  // one tile's K/V rows into shared memory (bf16 tiles, or the int8 stage)
  auto load_tile = [&](int t, int buf) {
    const int p0 = t * TK;
    if constexpr (QUANT) {
      constexpr int CH = DP / 16;  // 16 int8 per chunk
      for (int idx = threadIdx.x; idx < TK * CH; idx += THREADS) {
        const int r = idx / CH;
        const int c = (idx - r * CH) * 16;
        const int p = p0 + r;
        long long row = (p < len && c < P.D) ? pool_row(P, b, kvh, p) : -1;
        const int8_t* kb = static_cast<const int8_t*>(P.pk);
        const int8_t* vb = static_cast<const int8_t*>(P.pv);
        const bool in = row >= 0;
        cp_async_16(st_k + (buf * TK + r) * DP + c, in ? kb + row * P.D + c : kb, in ? 16 : 0);
        cp_async_16(st_v + (buf * TK + r) * DP + c, in ? vb + row * P.D + c : vb, in ? 16 : 0);
      }
    } else {
      constexpr int CH = DP / 8;  // 8 bf16 per chunk
      bf16* dk = sk_buf + buf * TK * LD;
      bf16* dv = sv_buf + buf * TK * LD;
      const bf16* kb = static_cast<const bf16*>(P.pk);
      const bf16* vb = static_cast<const bf16*>(P.pv);
      for (int idx = threadIdx.x; idx < TK * CH; idx += THREADS) {
        const int r = idx / CH;
        const int c = (idx - r * CH) * 8;
        const int p = p0 + r;
        long long row = (p < len && c < P.D) ? pool_row(P, b, kvh, p) : -1;
        const bool in = row >= 0;
        cp_async_16(dk + r * LD + c, in ? kb + row * P.D + c : kb, in ? 16 : 0);
        cp_async_16(dv + r * LD + c, in ? vb + row * P.D + c : vb, in ? 16 : 0);
      }
    }
  };

  load_tile(t0, 0);
  cp_async_commit();

  const bool computes = warp < NW;
  const int rt = warp / WK;             // this warp's row tile
  const int kb0 = (warp - rt * WK) * KW;  // its first key within a tile
  uint32_t qf[KSTEPS][4];
  float acc[NT_O][4];
  #pragma unroll
  for (int n = 0; n < NT_O; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};  // this thread's columns only; quad-summed at the end
  bool q_loaded = false;

  for (int t = t0; t < t1; ++t) {
    const int it = t - t0;
    if (t + 1 < t1) load_tile(t + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: Q and tile t have landed
    __syncthreads();

    const bf16* sk;
    const bf16* sv;
    if constexpr (QUANT) {
      // int8 -> bf16 (exact) into the single tile, plus this tile's scales
      const int8_t* ck = st_k + (it & 1) * TK * DP;
      const int8_t* cv = st_v + (it & 1) * TK * DP;
      for (int idx = threadIdx.x; idx < TK * DP / 4; idx += THREADS) {
        const int r = idx / (DP / 4);
        const int c = (idx - r * (DP / 4)) * 4;
        const char4 k4 = *reinterpret_cast<const char4*>(ck + r * DP + c);
        const char4 v4 = *reinterpret_cast<const char4*>(cv + r * DP + c);
        __nv_bfloat162* dk = reinterpret_cast<__nv_bfloat162*>(sk_buf + r * LD + c);
        __nv_bfloat162* dv = reinterpret_cast<__nv_bfloat162*>(sv_buf + r * LD + c);
        dk[0] = __floats2bfloat162_rn((float)k4.x, (float)k4.y);
        dk[1] = __floats2bfloat162_rn((float)k4.z, (float)k4.w);
        dv[0] = __floats2bfloat162_rn((float)v4.x, (float)v4.y);
        dv[1] = __floats2bfloat162_rn((float)v4.z, (float)v4.w);
      }
      if (threadIdx.x < 2 * TK) {
        const int r = threadIdx.x % TK;
        const int p = t * TK + r;
        const long long row = p < len ? pool_row(P, b, kvh, p) : -1;
        if (threadIdx.x < TK) ks_s[r] = row >= 0 ? P.ks[row] : 0.f;
        else vs_s[r] = row >= 0 ? P.vs[row] : 0.f;
      }
      __syncthreads();
      sk = sk_buf;
      sv = sv_buf;
    } else {
      sk = sk_buf + (it & 1) * TK * LD;
      sv = sv_buf + (it & 1) * TK * LD;
    }

    if (computes) {
      if (!q_loaded) {
        #pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          ldmatrix_x4(qf[kk], sq + (rt * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
        }
        q_loaded = true;
      }
      // S[16][KW] = Q_rt . K[kb0 : kb0 + KW]^T
      float s[NT_S][4];
      #pragma unroll
      for (int j = 0; j < NT_S; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      #pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        #pragma unroll
        for (int j = 0; j < NT_S; j += 2) {
          uint32_t bk[4];
          ldmatrix_x4(bk, sk + (kb0 + j * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD
                              + kk * 16 + ((lane >> 3) & 1) * 8);
          mma_16816(s[j], qf[kk], bk[0], bk[1]);
          mma_16816(s[j + 1], qf[kk], bk[2], bk[3]);
        }
      }

      // scores (natural units), the length mask on the row's last tile only
      const int kv0 = t * TK;
      const bool last = kv0 + TK > len;
      float mx0 = NEG_INF, mx1 = NEG_INF;
      #pragma unroll
      for (int j = 0; j < NT_S; ++j) {
        #pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = kb0 + j * 8 + tq * 2 + e;  // column within the tile
          float v0 = s[j][e], v1 = s[j][2 + e];
          if constexpr (QUANT) {
            v0 *= ks_s[cl];
            v1 *= ks_s[cl];
          }
          v0 *= P.scale;
          v1 *= P.scale;
          if (last && kv0 + cl >= len) v0 = v1 = NEG_INF;
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
      const float alpha0 = exp2f((m_run[0] - m0) * LOG2E);
      const float alpha1 = exp2f((m_run[1] - m1) * LOG2E);
      m_run[0] = m0;
      m_run[1] = m1;
      float sum0 = 0.f, sum1 = 0.f;
      #pragma unroll
      for (int j = 0; j < NT_S; ++j) {
        #pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p0 = s[j][e] > 0.5f * NEG_INF ? exp2f((s[j][e] - m0) * LOG2E) : 0.f;
          float p1 = s[j][2 + e] > 0.5f * NEG_INF ? exp2f((s[j][2 + e] - m1) * LOG2E) : 0.f;
          sum0 += p0;
          sum1 += p1;
          if constexpr (QUANT) {  // v_scale rides p after p went into l
            const float vsc = vs_s[kb0 + j * 8 + tq * 2 + e];
            p0 *= vsc;
            p1 *= vsc;
          }
          s[j][e] = p0;
          s[j][2 + e] = p1;
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
      // O += P . V[kb0 : kb0 + KW], P straight from the S accumulators (bf16)
      #pragma unroll
      for (int kk = 0; kk < KW / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        #pragma unroll
        for (int n = 0; n < NT_O; n += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, sv + (kb0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD
                                    + n * 8 + (lane >> 4) * 8);
          mma_16816(acc[n], pa, bv[0], bv[1]);
          mma_16816(acc[n + 1], pa, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this tile before it refills
  }
  cp_async_wait<0>();
  __syncthreads();

  // each computing warp's partial into shared memory (the K/V tiles are free)
  if (computes) {
    float l0 = l_run[0], l1 = l_run[1];
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    if (tq == 0) {
      red_m[warp * 16 + gr] = m_run[0];
      red_m[warp * 16 + gr + 8] = m_run[1];
      red_l[warp * 16 + gr] = l0;
      red_l[warp * 16 + gr + 8] = l1;
    }
    float* ra = red_acc + warp * 16 * DP;
    #pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      const int d = n * 8 + tq * 2;
      ra[gr * DP + d] = acc[n][0];
      ra[gr * DP + d + 1] = acc[n][1];
      ra[(gr + 8) * DP + d] = acc[n][2];
      ra[(gr + 8) * DP + d + 1] = acc[n][3];
    }
  }
  __syncthreads();

  // merge the key slices of each row tile (merge_attention_partials' arithmetic)
  for (int idx = threadIdx.x; idx < R * P.D; idx += THREADS) {
    const int r = idx / P.D;
    const int d = idx - r * P.D;
    const int rtile = r >> 4, rl = r & 15;
    float mx = NEG_INF;
    #pragma unroll
    for (int w = 0; w < WK; ++w) mx = fmaxf(mx, red_m[(rtile * WK + w) * 16 + rl]);
    float a = 0.f, lsum = 0.f;
    #pragma unroll
    for (int w = 0; w < WK; ++w) {
      const int ww = rtile * WK + w;
      const float wt = exp2f((red_m[ww * 16 + rl] - mx) * LOG2E);
      a += red_acc[(ww * 16 + rl) * DP + d] * wt;
      lsum += red_l[ww * 16 + rl] * wt;
    }
    store_partial(P, b, kvh, split, RP, r, d, a, mx, lsum);
  }
}

// Combine the nsplit partials of each (b, kv head) into the output layout.
__global__ void __launch_bounds__(THREADS)
paged_merge_kernel(const float* __restrict__ ws_acc, const float* __restrict__ ws_m,
                   const float* __restrict__ ws_l, float* __restrict__ acc,
                   float* __restrict__ m, float* __restrict__ l, int nsplit, int RP,
                   int S, int H, int Hkv, int D) {
  const int bh = blockIdx.x;
  const int b = bh / Hkv;
  const int kvh = bh - b * Hkv;
  const int g = H / Hkv;
  const int R = S * g;
  const long long base = (long long)bh * nsplit * RP;
  for (int idx = threadIdx.x; idx < R * D; idx += THREADS) {
    const int r = idx / D;
    const int d = idx - r * D;
    float mx = NEG_INF;
    for (int sp = 0; sp < nsplit; ++sp) mx = fmaxf(mx, ws_m[base + (long long)sp * RP + r]);
    float a = 0.f, lsum = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) {
      const long long row = base + (long long)sp * RP + r;
      const float wt = exp2f((ws_m[row] - mx) * LOG2E);
      a += ws_acc[row * D + d] * wt;
      lsum += ws_l[row] * wt;
    }
    const int s = r / g, h = kvh * g + r % g;
    const long long orow = ((long long)b * S + s) * H + h;
    acc[orow * D + d] = a;
    if (d == 0) {
      m[orow] = mx;
      l[orow] = lsum;
    }
  }
}

template <int DP, int RT, bool QUANT>
cudaError_t launch(const Params& P, int B, cudaStream_t stream) {
  constexpr int RP = RT * 16;
  constexpr int LD = DP + 8;
  constexpr int NBUF = QUANT ? 1 : 2;
  // Q + K/V tiles, and for int8 the two stages and the tile's scales
  constexpr int bytes = (RP + 2 * NBUF * TK) * LD * 2 + (QUANT ? 4 * TK * DP + 2 * TK * 4 : 0);
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(paged_partial_kernel<DP, RT, QUANT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  dim3 grid(B * P.Hkv, P.nsplit);
  paged_partial_kernel<DP, RT, QUANT><<<grid, THREADS, bytes, stream>>>(P);
  return cudaGetLastError();
}

template <int DP, bool QUANT>
cudaError_t launch_rt(const Params& P, int B, int RT, cudaStream_t stream) {
  switch (RT) {
    case 1: return launch<DP, 1, QUANT>(P, B, stream);
    case 2: return launch<DP, 2, QUANT>(P, B, stream);
    case 3: return launch<DP, 3, QUANT>(P, B, stream);
    case 4: return launch<DP, 4, QUANT>(P, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry, bound with ctypes.  Returns a cudaError_t (0 = launched).  Launches
// on `stream` and allocates nothing: with nsplit > 1 the caller passes the
// workspace (ws_acc [B*Hkv*nsplit*RP*D], ws_m and ws_l [B*Hkv*nsplit*RP] f32,
// RP = 16 * ceil(S*H/Hkv / 16)); with nsplit == 1 they may be null.
extern "C" int tpst_paged_attention(const void* q, const void* pk, const void* pv,
                                    const void* ks, const void* vs, const void* bt,
                                    const void* lens, void* acc, void* m, void* l,
                                    void* ws_acc, void* ws_m, void* ws_l, int B, int S,
                                    int H, int Hkv, int D, int blk, int nb, int n_pool,
                                    int quant, int tiles_per_split, int nsplit, float scale,
                                    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 || D > 128 ||
      D % 16 != 0 || blk <= 0 || nb <= 0 || n_pool <= 0 || nsplit <= 0 ||
      tiles_per_split <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int R = S * (H / Hkv);
  const int RT = (R + 15) / 16;
  if (RT > 4) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params P;
  P.q = static_cast<const bf16*>(q);
  P.pk = pk;
  P.pv = pv;
  P.ks = static_cast<const float*>(ks);
  P.vs = static_cast<const float*>(vs);
  P.bt = static_cast<const int*>(bt);
  P.lens = static_cast<const int*>(lens);
  P.S = S;
  P.H = H;
  P.Hkv = Hkv;
  P.D = D;
  P.blk = blk;
  P.nb = nb;
  P.n_pool = n_pool;
  P.tiles_per_split = tiles_per_split;
  P.nsplit = nsplit;
  P.scale = scale;
  P.direct = nsplit == 1;
  if (P.direct) {
    P.acc = static_cast<float*>(acc);
    P.m = static_cast<float*>(m);
    P.l = static_cast<float*>(l);
  } else {
    P.acc = static_cast<float*>(ws_acc);
    P.m = static_cast<float*>(ws_m);
    P.l = static_cast<float*>(ws_l);
  }
  cudaError_t err;
  if (D <= 64) {
    err = quant ? launch_rt<64, true>(P, B, RT, st) : launch_rt<64, false>(P, B, RT, st);
  } else {
    err = quant ? launch_rt<128, true>(P, B, RT, st) : launch_rt<128, false>(P, B, RT, st);
  }
  if (err != cudaSuccess || P.direct) return static_cast<int>(err);
  paged_merge_kernel<<<B * Hkv, THREADS, 0, st>>>(
      static_cast<const float*>(ws_acc), static_cast<const float*>(ws_m),
      static_cast<const float*>(ws_l), static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), nsplit, RT * 16, S, H, Hkv, D);
  return static_cast<int>(cudaGetLastError());
}
