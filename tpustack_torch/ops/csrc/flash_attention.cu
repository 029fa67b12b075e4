// Flash attention forward for Hopper (sm_90a), bf16 in and out.
//
// Replaces the Pallas TPU kernels in tpustack/ops/pallas/flash_attention.py:
// _attn_kernel (:38, the "panel" kernel, whole K/V per head in VMEM) and
// _attn_kernel_stream (:88, k-streaming with an online-softmax carry,
// q_offset and kv_len scalars).  Both split on the TPU only because of VMEM
// size and the sequential grid; here one loop over K/V tiles serves both.
//
// Function: o[b,i,h,:] = sum_j softmax_j(q[b,i,h,:].k[b,j,h/g,:] * scale) v[b,j,h/g,:]
// over keys j < kv_len and, when causal, j <= q_offset + i.  BSHD layout in
// and out, GQA with g = H / Hkv (K/V never expanded).  A row with no valid key
// gets 0, as the TPU kernel's acc / max(l, 1e-30) does.
//
// What bounds it on an H100 SXM.  Per valid (row, key) pair and head the
// work is 4*D tensor-core flops and one exponential.  The tensor cores give
// 989 TFLOP/s in bf16; the special-function units 16 exp2 per clock per SM,
// about 4.2e12 a second at 132 SMs and 1.98 GHz.  So at D <= 64 (SD1.5's
// D=40: 160 flops per exponential) the exponentials set the floor, and at
// D=80 and D=128 (SD1.5 level 1, the LLM prefill) the tensor cores do.  On
// the way there two more things bind: K/V re-read from L2 once per q tile,
// and the latency of each tile's chain (load, S, softmax, P.V) when too few
// warps overlap it.
//
// Design: a persistent CTA per SM walks work tiles of (b, h, BQ q rows).
// - Warpgroup 0 is the producer: after setmaxnreg hands its registers to the
//   consumers, one thread issues TMA loads.  The tensor maps are 4-D
//   (D, H, S, B) with the real D and S, so TMA zero-fills D up to the
//   64-wide box (40 -> 64) and the ragged Sq/Sk edges: no per-thread address
//   arithmetic and no HBM bytes for padding.  Q has two slots, so the next
//   work tile's Q lands while this one's is in use; K and V run through a
//   ring of STAGES slots with full/empty mbarriers, K and V on separate
//   barriers so Q.K^T starts before V has landed, and the ring carries on
//   from one work tile to the next.
// - Consumer warpgroups (three of 64 q rows at D <= 64, two at D > 64,
//   where O needs more registers) share each K/V tile, so K/V are read once
//   per 192 or 128 q rows.  S = Q.K^T is wgmma m64n128k16 with both operands
//   in shared memory (128B swizzle, k16 steps over D padded to 16).  The
//   online softmax runs in registers on the accumulator layout, in the log2
//   domain with the scale folded into one FFMA per exponential; the mask is
//   built only on tiles that cross kv_len or the diagonal, and tiles past
//   kv_len or wholly above the work tile's last row are never loaded.
//   O += P.V is wgmma with P from registers (converted to bf16 straight from
//   the S accumulator layout) and V as a transposed (MN-major) operand in
//   shared memory, with N = D: D=40 runs P.V at N=40.
// - The exponentials overlap the tensor cores in two ways: the consumer
//   warpgroups take turns issuing their products (named barriers), so one's
//   softmax runs under the others' products; and within a warpgroup S(t) is
//   issued with P.V of tile t-1, and the softmax of t runs while that P.V is
//   on the tensor cores.  The wgmma pipeline is written out straight (first
//   tile, steady loop, last P.V) and waits on mbarriers stay inside one asm
//   block: ptxas serialises every wgmma of a kernel whose pipeline it cannot
//   follow.
// - The output is normalised into the work tile's Q slot (128B-swizzled)
//   and stored with TMA, which drops rows past Sq and columns past D.
// - Work tiles go to CTAs in snake order (c, then G-1-c on the next pass);
//   causal tiles come longest first, so the CTAs' loads even out.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int BK = 128;            // keys per K/V tile
constexpr int BOX = 64;            // D elements per TMA box: one 128-byte swizzled row
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
  // consumer warpgroups of 64 q rows each; at D <= 64 three fit in the
  // registers (S, P and O take ~120 a thread), which cuts K/V reads by 1.5x
  static constexpr int WGS = D <= 64 ? 3 : 2;
  static constexpr int BQ = 64 * WGS;                    // q rows per CTA
  static constexpr int THREADS = 128 * (1 + WGS);        // + the producer warpgroup
  // setmaxnreg: the producer keeps few registers, the consumers take the rest
  static constexpr int PRODUCER_REGS = WGS == 3 ? 32 : 40;
  static constexpr int CONSUMER_REGS = WGS == 3 ? 160 : 232;
  static constexpr int NBOX = (D + BOX - 1) / BOX;       // 64-wide boxes covering D
  static constexpr int KSTEPS = (D + 15) / 16;           // k16 steps of Q.K^T
  static constexpr int STAGES = NBOX == 1 ? 3 : 2;       // K/V ring depth
  static constexpr int Q_BOX = BQ * BOX * 2;             // bytes of one Q box
  static constexpr int KV_BOX = BK * BOX * 2;            // bytes of one K or V box
  static constexpr int Q_BYTES = NBOX * Q_BOX;
  static constexpr int KV_BYTES = NBOX * KV_BOX;         // one K (or V) tile
  static constexpr int BAR_BYTES = 8 * (4 + 4 * STAGES);
  // Q twice (the next work tile's Q lands while this one's is in use), the
  // K/V ring, the barriers, and slack to align to 1024 bytes
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES + BAR_BYTES;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_o,
                       int Sq, int H, int Hkv, int n_bh, int causal, int q_offset, int kv_len,
                       float scale_log2) {
  using C = Cfg<D>;
  constexpr int STAGES = C::STAGES;
  constexpr int BQ = C::BQ;
  constexpr int WGS = C::WGS;
  extern __shared__ unsigned char smem_raw[];
  // 128B-swizzled tiles must start on 1024-byte boundaries
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;  // [2][NBOX][BQ][64]
  const uint32_t sk = sq + 2 * C::Q_BYTES;             // [STAGES][NBOX][BK][64]
  const uint32_t sv = sk + STAGES * C::KV_BYTES;       // [STAGES][NBOX][BK][64]
  const uint32_t bar = sv + STAGES * C::KV_BYTES;
  const uint32_t q_full = bar;                         // + 8 * Q slot
  const uint32_t q_empty = bar + 16;
  const uint32_t k_full = bar + 32;                    // + 8 * stage
  const uint32_t v_full = k_full + 8 * STAGES;
  const uint32_t k_empty = k_full + 16 * STAGES;
  const uint32_t v_empty = k_full + 24 * STAGES;

  // Pass r over the work gives CTA c work tile r * G + c, or r * G + G-1-c
  // on odd passes, so that causal tiles, longest first, spread evenly.
  // Without a mask, q tiles vary fastest, so the tiles in flight share few
  // (b, K/V head) pairs and K/V stay in L2; causal, the heads vary fastest
  // and the longest q tiles (the last) come first.
  const int n_q = (Sq + BQ - 1) / BQ;
  const int n_work = n_bh * n_q;
  struct Work {
    int b, h, hk, q0, n_tiles;
  };
  const int G = gridDim.x;
  auto work_index = [&](int r) {
    return r * G + ((r & 1) ? G - 1 - (int)blockIdx.x : (int)blockIdx.x);
  };
  auto work_at = [&](int idx) {
    Work wk;
    const int bh = causal ? idx % n_bh : idx / n_q;  // b * H + h
    const int qt = causal ? n_q - 1 - idx / n_bh : idx % n_q;
    wk.b = bh / H;
    wk.h = bh - wk.b * H;
    wk.hk = wk.h / (H / Hkv);
    wk.q0 = qt * BQ;
    int limit = kv_len;  // keys the tile can need
    if (causal) limit = min(limit, q_offset + min(wk.q0 + BQ, Sq));
    wk.n_tiles = limit > 0 ? (limit + BK - 1) / BK : 0;
    return wk;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(q_empty + 8 * s, WGS);  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 4 * WGS);  // one arrival per consumer warp
      mbar_init(v_empty + 8 * s, 4 * WGS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup's role, broadcast so that the compiler sees it is uniform
  // across the warpgroup (wgmma in a path it thinks divergent is serialised)
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int kv = 0;     // K/V tiles loaded so far: the ring slot and its pass
      int taken = 0;  // work tiles taken so far
      for (int r = 0; r * G < n_work; ++r) {
        const int idx = work_index(r);
        if (idx >= n_work) continue;
        const Work wk = work_at(idx);
        // Q slot taken % 2: the consumers have stored the output of the
        // work tile taken two before this one from its space
        const int qs = taken & 1;
        mbar_wait(q_empty + 8 * qs, ((taken >> 1) & 1) ^ 1);
        mbar_expect_tx(q_full + 8 * qs, C::Q_BYTES);
        for (int x = 0; x < C::NBOX; ++x) {
          tma_load_4d(sq + qs * C::Q_BYTES + x * C::Q_BOX, &tm_q, q_full + 8 * qs, x * BOX,
                      wk.h, wk.q0, wk.b);
        }
        ++taken;
        for (int t = 0; t < wk.n_tiles; ++t, ++kv) {
          const int s = kv % STAGES;
          // the ring's first pass does not wait
          const uint32_t free_par = ((kv / STAGES) & 1) ^ 1;
          mbar_wait(k_empty + 8 * s, free_par);
          mbar_expect_tx(k_full + 8 * s, C::KV_BYTES);
          for (int x = 0; x < C::NBOX; ++x) {
            tma_load_4d(sk + s * C::KV_BYTES + x * C::KV_BOX, &tm_k, k_full + 8 * s, x * BOX,
                        wk.hk, t * BK, wk.b);
          }
          mbar_wait(v_empty + 8 * s, free_par);
          mbar_expect_tx(v_full + 8 * s, C::KV_BYTES);
          for (int x = 0; x < C::NBOX; ++x) {
            tma_load_4d(sv + s * C::KV_BYTES + x * C::KV_BOX, &tm_v, v_full + 8 * s, x * BOX,
                        wk.hk, t * BK, wk.b);
          }
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    setmaxnreg_inc<C::CONSUMER_REGS>();
    const int wg = role - 1;         // rows wg*64 .. wg*64+63 of the q tile
    const int w = (threadIdx.x >> 5) & 3;  // the warp's 16 rows within them
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;         // accumulator row within the 8-row half
    const int tq = lane & 3;         // accumulator column pair
    const int row0 = wg * 64 + w * 16 + g;  // this thread's rows: row0, row0 + 8
    uint32_t qa;  // the warpgroup's 64 rows of Q in this work tile's slot
    // With a positive scale, scores stay raw: the max is taken on them and
    // the scale folds into one FFMA per exponential.  Otherwise they are
    // scaled first and cm is 1.
    const bool prescale = !(scale_log2 > 0.f);
    const float cm = prescale ? 1.f : scale_log2;

    float acc[D / 2];
    float m_run[2] = {0.f, 0.f};  // running max (log2 units)
    float l_run[2] = {0.f, 0.f};  // this thread's part of the row sums
    float sc[BK / 2];          // S tile: 8-column block j at sc[4j .. 4j+3]
    uint32_t pa[BK / 16][4];   // P (bf16 pairs) in the A-fragment layout
    float alpha0, alpha1;
    int kv0_ring = 0;          // the ring index of the work tile's first K/V tile
    int pos0, pos1, wg_first;  // the rows' global positions (causal)

    auto release = [&](uint32_t empty) {  // this warp is done with a K or V slot
      __syncwarp();
      if (lane == 0) mbar_arrive(empty);
    };
    // The warpgroups take turns issuing their products, in order (named
    // barrier 1 + wg is warpgroup wg's turn), so one's softmax runs under
    // the others' products.  Warpgroup 0's first turn is granted up front,
    // and the last warpgroup skips its very last arrival to match.
    auto turn_begin = [&]() { named_sync(1 + wg, 256); };
    auto turn_end = [&](bool last) {
      if (wg != WGS - 1 || !last) named_arrive(1 + (wg + 1) % WGS, 256);
    };
    // S(t) = Q.K(t)^T into sc: k16 steps over D padded to 16, 32 bytes apart
    // inside a 64-wide box
    auto issue_s = [&](int t) {
      const int r = kv0_ring + t;
      const int s = r % STAGES;
      mbar_wait(k_full + 8 * s, (r / STAGES) & 1);
      const uint32_t kb = sk + s * C::KV_BYTES;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < C::KSTEPS; ++ks) {
        const uint32_t qoff = (ks / 4) * C::Q_BOX + (ks % 4) * 32;
        const uint32_t koff = (ks / 4) * C::KV_BOX + (ks % 4) * 32;
        WgmmaSS<BK>::mma(sc, desc_sw128(qa + qoff, 16, 1024), desc_sw128(kb + koff, 16, 1024),
                         ks > 0);
      }
      wgmma_commit();
    };
    // O += P(t).V(t), V transposed in shared memory: k16 steps of 16 keys
    // (2048 bytes), 64-wide column blocks KV_BOX bytes apart
    auto issue_pv = [&](int t) {
      const int r = kv0_ring + t;
      const int s = r % STAGES;
      mbar_wait(v_full + 8 * s, (r / STAGES) & 1);
      const uint32_t vb = sv + s * C::KV_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        WgmmaRS<D>::mma(acc, pa[kk], desc_sw128(vb + kk * 16 * 128, C::KV_BOX, 1024));
      }
      wgmma_commit();
    };
    // online softmax of S(t) in the log2 domain: sc becomes P(t) (float),
    // m and l advance, and alpha rescales what O holds so far
    auto softmax = [&](int t) {
      if (prescale) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] *= scale_log2;
      }
      // the mask only where the tile crosses kv_len or, causal, the
      // diagonal of the warpgroup's first row
      const int kv0 = t * BK;
      if (kv0 + BK > kv_len || (causal && kv0 + BK - 1 > wg_first)) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = kv0 + j * 8 + tq * 2 + e;
            if (col >= kv_len || (causal && col > pos0)) sc[4 * j + e] = -INFINITY;
            if (col >= kv_len || (causal && col > pos1)) sc[4 * j + 2 + e] = -INFINITY;
          }
        }
      }
      // row maxima over 4 independent chains per row, then the quad
      float mx0[4], mx1[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mx0[j] = fmaxf(sc[4 * j], sc[4 * j + 1]);
        mx1[j] = fmaxf(sc[4 * j + 2], sc[4 * j + 3]);
      }
#pragma unroll
      for (int j = 4; j < BK / 8; ++j) {
        mx0[j % 4] = fmaxf(mx0[j % 4], fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1[j % 4] = fmaxf(mx1[j % 4], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      float m0 = fmaxf(fmaxf(mx0[0], mx0[1]), fmaxf(mx0[2], mx0[3]));
      float m1 = fmaxf(fmaxf(mx1[0], mx1[1]), fmaxf(mx1[2], mx1[3]));
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
      m0 = fmaxf(m_run[0], m0 * cm);
      m1 = fmaxf(m_run[1], m1 * cm);
      // a row with no valid key so far keeps m = -inf; subtract 0 instead
      // so its exponentials are exactly 0, not NaN
      const float mu0 = m0 == -INFINITY ? 0.f : m0;
      const float mu1 = m1 == -INFINITY ? 0.f : m1;
      alpha0 = ex2(m_run[0] - mu0);
      alpha1 = ex2(m_run[1] - mu1);
      m_run[0] = m0;
      m_run[1] = m1;
      float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p0 = ex2(fmaf(sc[4 * j + e], cm, -mu0));
          const float p1 = ex2(fmaf(sc[4 * j + 2 + e], cm, -mu1));
          sc[4 * j + e] = p0;
          sc[4 * j + 2 + e] = p1;
          s0[j % 4] += p0;
          s1[j % 4] += p1;
        }
      }
      l_run[0] = l_run[0] * alpha0 + ((s0[0] + s0[1]) + (s0[2] + s0[3]));
      l_run[1] = l_run[1] * alpha1 + ((s1[0] + s1[1]) + (s1[2] + s1[3]));
    };
    // O *= alpha, then P(t) to bf16 in the A-fragment layout, straight from
    // the S accumulator layout
    auto rescale_and_pack = [&]() {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j + 0] *= alpha0;
        acc[4 * j + 1] *= alpha0;
        acc[4 * j + 2] *= alpha1;
        acc[4 * j + 3] *= alpha1;
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };

    // the last work tile of this CTA that has products: its last turn is
    // the very last (nothing follows it on the turn barriers)
    int last_busy = -1;
    for (int r = 0; r * G < n_work; ++r) {
      const int idx = work_index(r);
      if (idx < n_work && work_at(idx).n_tiles > 0) last_busy = idx;
    }
    if (last_busy >= 0 && wg == WGS - 1) named_arrive(1, 256);  // warpgroup 0 goes first

    int taken = 0;  // work tiles taken so far
    for (int r = 0; r * G < n_work; ++r) {
      const int idx = work_index(r);
      if (idx >= n_work) continue;
      const Work wk = work_at(idx);
      const int n_tiles = wk.n_tiles;
      pos0 = q_offset + wk.q0 + row0;
      pos1 = pos0 + 8;
      wg_first = q_offset + wk.q0 + wg * 64;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      m_run[0] = m_run[1] = -INFINITY;
      l_run[0] = l_run[1] = 0.f;
      qa = sq + (taken & 1) * C::Q_BYTES + wg * 64 * 128;
      mbar_wait(q_full + 8 * (taken & 1), (taken >> 1) & 1);

      // The wgmma pipeline, static so that the compiler keeps it
      // asynchronous: tile 0's S alone; then per tile t, S(t) and P.V of
      // tile t-1 issued together, the wait for S(t) only, the softmax of
      // tile t while P.V of t-1 is still on the tensor cores, the wait for
      // P.V, the rescale; last, P.V of the final tile.
      if (n_tiles > 0) {
        turn_begin();
        issue_s(0);
        turn_end(false);
        wgmma_wait<0>();
        fence_regs(sc);
        release(k_empty + 8 * (kv0_ring % STAGES));
        softmax(0);
        rescale_and_pack();
        for (int t = 1; t < n_tiles; ++t) {
          turn_begin();
          issue_s(t);
          issue_pv(t - 1);
          turn_end(false);
          wgmma_wait<1>();  // S(t) has landed; P.V of tile t-1 may still run
          fence_regs(sc);
          release(k_empty + 8 * ((kv0_ring + t) % STAGES));
          softmax(t);
          wgmma_wait<0>();
          fence_regs(acc);
          fence_regs(pa);
          release(v_empty + 8 * ((kv0_ring + t - 1) % STAGES));
          rescale_and_pack();
        }
        turn_begin();
        issue_pv(n_tiles - 1);
        turn_end(idx == last_busy);
        wgmma_wait<0>();
        fence_regs(acc);
        release(v_empty + 8 * ((kv0_ring + n_tiles - 1) % STAGES));
        kv0_ring += n_tiles;
      }

      // normalise into the warpgroup's rows of the Q tile (its products are
      // done), 128B-swizzled as the O tensor map expects, and store them
      // with TMA, which drops rows past Sq and columns past D
      float l0 = l_run[0], l1 = l_run[1];
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = 1.f / fmaxf(l0, 1e-30f);
      const float inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = w * 16 + g + hh * 8;
          const float inv = hh ? inv1 : inv0;
          const uint32_t addr = qa + (j / 8) * C::Q_BOX + r * 128 +
                                (((j % 8) ^ (r & 7)) << 4) + tq * 4;
          st_shared_b32(addr,
                        pack_bf16(acc[4 * j + 2 * hh] * inv, acc[4 * j + 2 * hh + 1] * inv));
        }
      }
      fence_proxy_async();
      named_sync(1 + WGS + wg, 128);
      if (threadIdx.x % 128 == 0) {
        if (wk.q0 + wg * 64 < Sq) {
          for (int x = 0; x < C::NBOX; ++x) {
            tma_store_4d(&tm_o, qa + x * C::Q_BOX, x * BOX, wk.h, wk.q0 + wg * 64, wk.b);
          }
          tma_store_commit();
          tma_store_wait_read();
        }
        mbar_arrive(q_empty + 8 * (taken & 1));  // the Q slot is free again
      }
      ++taken;
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime so that
// the library links without -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// a [B, S, heads, D] bf16 tensor as TMA sees it: dims (D, heads, S, B),
// boxes of 64 x 1 x rows x 1, 128-byte swizzle, zeros outside the tensor
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int D, int rows) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {BOX, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                   int H, int Hkv, int causal, int q_offset, int kv_len, float scale,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  constexpr int BQ = Cfg<D>::BQ;
  if (!tensor_map(&tq, q, B, Sq, H, D, BQ) || !tensor_map(&tk, k, B, Sk, Hkv, D, BK) ||
      !tensor_map(&tv, v, B, Sk, Hkv, D, BK) || !tensor_map(&to, o, B, Sq, H, D, 64)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::SMEM);
  if (err != cudaSuccess) return err;
  // persistent: one CTA per SM, or fewer when there is less work
  const long long work = (long long)B * H * ((Sq + BQ - 1) / BQ);
  if (work > 0x7fffffff) return cudaErrorInvalidConfiguration;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
    return err;
  }
  const int grid = (int)(work < sms ? work : sms);
  flash_attention_kernel<D><<<grid, Cfg<D>::THREADS, Cfg<D>::SMEM, stream>>>(
      tq, tk, tv, to, Sq, H, Hkv, B * H, causal, q_offset, kv_len, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes.  Returns a cudaError_t (0 = launched).  Launches
// on `stream` and allocates nothing; the caller owns every buffer, which must
// be contiguous and 16-byte aligned.
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
  switch (D) {
#define TPST_FLASH_CASE(d)                                                               \
    case d:                                                                              \
      err = launch<d>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, q_offset, kv_len, scale, s); \
      break;
    TPST_FLASH_CASE(8) TPST_FLASH_CASE(16) TPST_FLASH_CASE(24) TPST_FLASH_CASE(32)
    TPST_FLASH_CASE(40) TPST_FLASH_CASE(48) TPST_FLASH_CASE(56) TPST_FLASH_CASE(64)
    TPST_FLASH_CASE(72) TPST_FLASH_CASE(80) TPST_FLASH_CASE(88) TPST_FLASH_CASE(96)
    TPST_FLASH_CASE(104) TPST_FLASH_CASE(112) TPST_FLASH_CASE(120) TPST_FLASH_CASE(128)
#undef TPST_FLASH_CASE
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
