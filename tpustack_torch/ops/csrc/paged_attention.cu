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
// p went into l, the order of the Pallas kernel.  A table entry that is 0
// (the reserved block) or outside the pool reads as zeros.
//
// What bounds it on an H100 SXM: bytes.  Each valid position's K and V are
// read once (512 bytes per kv head at D=128 bf16) against 4*D*R flops, R =
// S*H/Hkv query rows per kv head: 7 flops/byte at a Qwen2.5 decode step, 35
// at a 4-token verify, far under the ~295 where the tensor cores would bind.
// So the design is about keeping every SM's share of the bytes in flight:
//
// - Work split by valid keys, on the device.  A unit of work is one (row b,
//   kv head, 64-key tile) with tile < ceil(len[b] / 64).  A persistent grid
//   of one CTA per SM reads `lens`, takes the prefix sums of the units in
//   shared memory and walks an equal contiguous range of the U units
//   (stream-K): CTA c takes [c*q + min(c, r), (c+1)*q + min(c+1, r)), q =
//   U / G, r = U % G.  Nothing about the lengths is decided on the host, so
//   a launch can be captured in a CUDA graph and replayed with new lengths.
// - A TMA ring of K/V tiles.  One producer warp issues TMA loads into a ring
//   of STAGES slots with full and empty mbarriers.  The pool is a 3-D tensor
//   map over [N*blk, Hkv, D]; a 64-key tile of one kv head is 64/BR boxes of
//   BR = gcd(blk, 64) rows at row bt[b, p/blk]*blk + p%blk.  A box wholly at
//   or past len, or whose table entry is invalid, gets a row coordinate past
//   N*blk and TMA fills it with zeros.  Q comes in by TMA as well, one box
//   (64, g, S) per 64 columns of D, whose rows are exactly the R query rows.
// - Rows on the tensor cores as one warpgroup tile.  R <= 64 rows fit one
//   wgmma M = 64 tile, so decode (R = 7) and verify (R = 35) run the same
//   code at the same time per tile.  S = Q.K^T is m64n64k16 with both
//   operands in shared memory (128B swizzle); O += P.V takes P from
//   registers and V as the MN-major operand at N = D padded to 64 or 128.
//   int8 tiles land unswizzled and the consumers convert them to bf16 into
//   a swizzled tile; the producer copies each tile's scales with cp.async.
// - The merge folded in.  A CTA whose range holds a whole (b, kv head) pair
//   writes that pair's output directly.  A pair split over CTAs: each piece
//   goes to a workspace slot (2 per CTA: its range's first and last pair),
//   the CTA fences and adds one to the pair's counter, and the CTA that
//   brings it to the number of pieces merges them in piece (key) order, so
//   the result is bitwise deterministic, writes the output and sets the
//   counter back to 0.  The counters are one zeroed buffer that every
//   launch leaves zeroed; launches that share it must not run concurrently.
//   Pairs with no keys get the empty partial from CTA (pair % G).
//
// What it leaves on the table (measured on an H100 SXM, PERF.md): the merge
// is one CTA's work after the last piece lands, reading np * R * D floats
// from L2 (at a 4-token verify ~10 us of a ~23 us call); a launch that has
// nothing to do still costs ~3 us (the lengths' round trip and the grid);
// the first tile of each CTA waits three round trips (lengths, table, TMA).

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TK = 64;                  // keys per tile: one unit of work
constexpr int STAGES = 4;               // K/V ring depth
constexpr int MAX_B = 1024;             // batch rows one launch takes
constexpr int CONSUMERS = 128;          // one warpgroup
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int MERGE_CHUNK = 32;         // pieces whose weights the merge holds at once
constexpr int MERGE_LOADS = 16;         // pieces a merging thread reads at once
constexpr int MERGE_V = 2;              // for this many 4-column groups
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// DP: head dim padded to 64 or 128; QUANT: int8 pool
template <int DP, bool QUANT>
struct Cfg {
  static constexpr int NBOX = DP / 64;                 // 64-wide swizzled column blocks
  static constexpr int KSTEPS = DP / 16;
  static constexpr int BOX = 64 * 128;                 // one 64-row swizzled box (bytes)
  static constexpr int Q_BYTES = NBOX * BOX;           // one Q slot: 64 rows
  static constexpr int TILE_BYTES = NBOX * BOX;        // one bf16 K or V tile
  static constexpr int STAGE_BYTES = QUANT ? TK * DP : TILE_BYTES;  // one K or V stage
  static constexpr int SCALE_BYTES = QUANT ? STAGES * 2 * TK * 4 : 0;
  static constexpr int CVT_BYTES = QUANT ? 2 * TILE_BYTES : 0;  // the converted K and V
  static constexpr int BAR_BYTES = 8 * (4 + 3 * STAGES);
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + 2 * STAGES * STAGE_BYTES + CVT_BYTES +
                              SCALE_BYTES + BAR_BYTES;
};

struct Params {
  const int* bt;      // [B, nb]
  const int* lens;    // [B]
  const float* ks;    // [N, blk, Hkv] (int8 only)
  const float* vs;
  float* acc;         // [B, S, H, D]
  float* m;           // [B, S, H]
  float* l;
  float* ws;          // [2 * G] slots of R * (D + 2) f32, padded to 4: pieces of split pairs
  int* counters;      // [B * Hkv], zero between launches
  int B, S, H, Hkv, D, blk, nb, n_pool, box_rows;
  float scale;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

// 4-byte global->shared copy; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// one arrival on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(bar) : "memory");
}

// The unit walk, the same in every thread of every CTA.  Units are ordered
// (b, kv head, tile); pair p = b * Hkv + kvh holds units [s_p, s_p + nt[b]).
struct Split {
  int q, r;  // U = q * G + r
  __device__ int start(int c) const { return c * q + min(c, r); }
  __device__ int owner(int u) const {  // the CTA whose range holds unit u
    const int big = r * (q + 1);
    return u < big ? u / (q + 1) : r + (u - big) / q;
  }
};

struct Seg {
  int b, kvh, s_p, e_p, t0, t1;  // pair's units [s_p, e_p); this CTA's tiles [t0, t1)
};

// the row b whose units hold u (pre[b] <= u < pre[b + 1])
__device__ __forceinline__ int row_of(const int* pre, int B, int u) {
  int lo = 0, hi = B - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (pre[mid] <= u) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ Seg segment(const int* pre, const int* nt, int Hkv, int b, int u,
                                       int end) {
  Seg sg;
  while (pre[b + 1] <= u) ++b;
  const int n = nt[b];
  sg.b = b;
  sg.kvh = (u - pre[b]) / n;
  sg.s_p = pre[b] + sg.kvh * n;
  sg.e_p = sg.s_p + n;
  sg.t0 = u - sg.s_p;
  sg.t1 = min(end, sg.e_p) - sg.s_p;
  return sg;
}

template <int DP, bool QUANT>
__global__ void __launch_bounds__(THREADS, 1)
paged_attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const Params P) {
  using C = Cfg<DP, QUANT>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int s_nt[MAX_B];       // tiles of each row
  __shared__ int s_len[MAX_B];      // each row's length, clamped to its table
  __shared__ int s_pre[MAX_B + 1];  // units before each row
  __shared__ int s_last;            // this CTA brought a pair's counter to its end
  // the merge: each row's max and sum over the pieces, and for MERGE_CHUNK
  // pieces at a time their rows' m (then weight) and l (then weighted l)
  __shared__ float s_mx[64], s_ls[64];
  __shared__ float s_mk[MERGE_CHUNK][64], s_lk[MERGE_CHUNK][64];

  // 128B-swizzled tiles must start on 1024-byte boundaries
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;  // [2][NBOX][64][64] bf16
  const uint32_t sk = sq + 2 * C::Q_BYTES;                   // [STAGES] K stages
  const uint32_t sv = sk + STAGES * C::STAGE_BYTES;          // [STAGES] V stages
  const uint32_t cvt = sv + STAGES * C::STAGE_BYTES;         // int8: converted K, V
  const uint32_t ssc = cvt + C::CVT_BYTES;                   // int8: [STAGES][2][TK] f32
  const uint32_t bar = ssc + C::SCALE_BYTES;
  const uint32_t q_full = bar;                               // + 8 * Q slot
  const uint32_t q_empty = bar + 16;
  const uint32_t k_full = bar + 32;                          // + 8 * stage
  const uint32_t v_full = k_full + 8 * STAGES;
  const uint32_t empty = k_full + 16 * STAGES;
  const float* sc_base = reinterpret_cast<const float*>(
      smem_raw + (ssc - smem_u32(smem_raw)));

  const int tid = threadIdx.x;
  const int B = P.B, Hkv = P.Hkv;
  const int g = P.H / Hkv;
  const int R = P.S * g;
  const int G = gridDim.x;
  const int c = blockIdx.x;

  // lengths -> tiles per row -> the units' prefix over rows
  for (int i = tid; i < B; i += THREADS) {
    const int len = min(max(P.lens[i], 0), P.nb * P.blk);
    s_len[i] = len;
    s_nt[i] = (len + TK - 1) / TK;
  }
  // the Q slots' rows past R stay zero: TMA writes only rows < R
  for (uint32_t off = tid * 16; off < 2 * C::Q_BYTES; off += THREADS * 16) {
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" :: "r"(sq + off), "r"(0) : "memory");
  }
  fence_proxy_async();
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(q_empty + 8 * s, 4);  // one arrival per consumer warp
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, QUANT ? 1 + 32 : 1);  // int8: + the scale copies' lanes
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid < 32) {  // warp 0: inclusive scan of Hkv * tiles, 32 rows at a time
    int carry = 0;
    if (tid == 0) s_pre[0] = 0;
    for (int base = 0; base < B; base += 32) {
      const int i = base + tid;
      int v = i < B ? s_nt[i] * Hkv : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, v, o);
        if (tid >= o) v += y;
      }
      if (i < B) s_pre[i + 1] = carry + v;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();

  const int U = s_pre[B];
  Split sp;
  sp.q = U / G;
  sp.r = U - sp.q * G;
  const int u_begin = sp.start(c), u_end = sp.start(c + 1);

  // the warp's role, broadcast so that the compiler sees it is uniform
  const int role = __shfl_sync(0xffffffffu, tid / CONSUMERS, 0);
  if (role == 1) {
    // ------------------------------------------------------------ producer
    const int lane = tid & 31;
    const int nsub = TK / P.box_rows;
    const int oob = P.n_pool * P.blk;  // a row coordinate TMA fills with zeros
    int kv = 0, seg = 0;
    int b = u_begin < u_end ? row_of(s_pre, B, u_begin) : 0;
    for (int u = u_begin; u < u_end; ++seg) {
      const Seg sg = segment(s_pre, s_nt, Hkv, b, u, u_end);
      b = sg.b;
      const int len = s_len[b];
      const int qs = seg & 1;
      if (lane == 0) {
        mbar_wait(q_empty + 8 * qs, ((seg >> 1) & 1) ^ 1);
        mbar_expect_tx(q_full + 8 * qs, C::NBOX * R * 128);
        for (int x = 0; x < C::NBOX; ++x) {
          tma_load_4d(sq + qs * C::Q_BYTES + x * C::BOX, &tm_q, q_full + 8 * qs, x * 64,
                      sg.kvh * g, 0, b);
        }
      }
      // The table entries of up to 32 boxes are read at once, one box a
      // lane, and handed out by shuffle: a read per tile would put one
      // round trip to memory before every TMA issue.
      int myrow = oob;   // this lane's box: its pool row, or past the pool
      for (int t = sg.t0; t < sg.t1; ++t, ++kv) {
        const int s = kv % STAGES;
        const int j = (t - sg.t0) % (32 / nsub);  // the tile within its batch
        if (j == 0) {
          const int tt = t + lane / nsub;
          const int p = tt * TK + (lane % nsub) * P.box_rows;
          myrow = oob;
          if (tt < sg.t1 && p < len) {
            const int bid = P.bt[(long long)b * P.nb + p / P.blk];
            if (bid > 0 && bid < P.n_pool) myrow = bid * P.blk + p % P.blk;
          }
        }
        const int row = __shfl_sync(0xffffffffu, myrow, j * nsub + lane % nsub);
        long long si[2] = {-1, -1};  // int8: the scale index of keys lane, lane + 32
        if constexpr (QUANT) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int key = lane + 32 * hh;
            const int rs = __shfl_sync(0xffffffffu, myrow, j * nsub + key / P.box_rows);
            if (rs != oob && t * TK + key < len) {
              si[hh] = ((long long)rs + key % P.box_rows) * Hkv + sg.kvh;
            }
          }
        }
        mbar_wait(empty + 8 * s, ((kv / STAGES) & 1) ^ 1);  // the ring's first pass does not wait
        if (lane == 0) {
          mbar_expect_tx(k_full + 8 * s, C::STAGE_BYTES);
          mbar_expect_tx(v_full + 8 * s, C::STAGE_BYTES);
        }
        __syncwarp();
        if (lane < nsub) {
          if constexpr (QUANT) {
            const uint32_t off = lane * P.box_rows * DP;
            tma_load_3d(sk + s * C::STAGE_BYTES + off, &tm_k, k_full + 8 * s, 0, sg.kvh, row);
            tma_load_3d(sv + s * C::STAGE_BYTES + off, &tm_v, v_full + 8 * s, 0, sg.kvh, row);
          } else {
            const uint32_t off = lane * P.box_rows * 128;
            for (int x = 0; x < C::NBOX; ++x) {
              tma_load_3d(sk + s * C::STAGE_BYTES + x * C::BOX + off, &tm_k, k_full + 8 * s,
                          x * 64, sg.kvh, row);
              tma_load_3d(sv + s * C::STAGE_BYTES + x * C::BOX + off, &tm_v, v_full + 8 * s,
                          x * 64, sg.kvh, row);
            }
          }
        }
        if constexpr (QUANT) {
          const uint32_t dst = ssc + s * 2 * TK * 4;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int key = lane + 32 * hh;
            cp_async_4(dst + key * 4, si[hh] >= 0 ? P.ks + si[hh] : P.ks, si[hh] >= 0 ? 4 : 0);
            cp_async_4(dst + (TK + key) * 4, si[hh] >= 0 ? P.vs + si[hh] : P.vs,
                       si[hh] >= 0 ? 4 : 0);
          }
          cp_async_mbar_arrive(k_full + 8 * s);
        }
      }
      u = sg.s_p + sg.t1;
    }
    if constexpr (QUANT) asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // -------------------------------------------------------------- consumers
  const int w = tid >> 5;      // rows 16w .. 16w + 15 of the 64-row tile
  const int lane = tid & 31;
  const int gr = lane >> 2;    // accumulator row within the 8-row half
  const int tq = lane & 3;     // accumulator column pair
  const int D = P.D;
  // a workspace slot: acc [R][D], m [R], l [R], padded to 16 bytes
  const long long slot_floats = ((long long)R * (D + 2) + 3) / 4 * 4;

  // the output row of query row r of pair (b, kvh)
  auto out_row = [&](int b, int kvh, int r) {
    return ((long long)b * P.S + r / g) * P.H + kvh * g + r % g;
  };

  // pairs with no keys: the empty partial, from a fixed CTA
  for (int p = c; p < B * Hkv; p += G) {
    const int b = p / Hkv;
    if (s_nt[b] != 0) continue;
    for (int idx = tid; idx < R * D; idx += CONSUMERS) {
      const long long orow = out_row(b, p - b * Hkv, idx / D);
      P.acc[orow * D + idx % D] = 0.f;
      if (idx % D == 0) {
        P.m[orow] = NEG_INF;
        P.l[orow] = 0.f;
      }
    }
  }

  float acc[DP / 2];
  float sc[TK / 2];          // S tile: 8-column block j at sc[4j .. 4j+3]
  uint32_t pa[TK / 16][4];   // P (bf16 pairs) in the A-fragment layout
  const float scale = P.scale;
  const uint32_t ck = QUANT ? cvt : 0;
  const uint32_t cv = QUANT ? cvt + C::TILE_BYTES : 0;

  // int8 stage s -> bf16 tiles in the layout TMA gives bf16 (128B swizzle)
  auto convert = [&](int s) {
    const uint32_t srck = sk + s * C::STAGE_BYTES, srcv = sv + s * C::STAGE_BYTES;
    for (int idx = tid; idx < TK * DP / 8; idx += CONSUMERS) {
      const int r = idx / (DP / 8);
      const int c8 = idx - r * (DP / 8);  // 8-column chunk
      const uint32_t dst = (c8 / 8) * C::BOX + r * 128 + (((c8 % 8) ^ (r & 7)) << 4);
#pragma unroll
      for (int kvsel = 0; kvsel < 2; ++kvsel) {
        uint32_t lo, hi;
        asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                     : "=r"(lo), "=r"(hi) : "r"((kvsel ? srcv : srck) + r * DP + c8 * 8));
        const char4 a = *reinterpret_cast<const char4*>(&lo);
        const char4 bb = *reinterpret_cast<const char4*>(&hi);
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                     :: "r"((kvsel ? cv : ck) + dst), "r"(pack_bf16(a.x, a.y)),
                        "r"(pack_bf16(a.z, a.w)), "r"(pack_bf16(bb.x, bb.y)),
                        "r"(pack_bf16(bb.z, bb.w))
                     : "memory");
      }
    }
  };

  int kv = 0, seg = 0;
  int b = u_begin < u_end ? row_of(s_pre, B, u_begin) : 0;
  for (int u = u_begin; u < u_end; ++seg) {
    const Seg sg = segment(s_pre, s_nt, Hkv, b, u, u_end);
    b = sg.b;
    const int len = s_len[b];
    const int kvh = sg.kvh;
    const int qs = seg & 1;
    const uint32_t qa = sq + qs * C::Q_BYTES;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};  // running max (natural units)
    float l_run[2] = {0.f, 0.f};              // this thread's part of the row sums
    mbar_wait(q_full + 8 * qs, (seg >> 1) & 1);

    for (int t = sg.t0; t < sg.t1; ++t, ++kv) {
      const int s = kv % STAGES;
      const uint32_t par = (kv / STAGES) & 1;
      uint32_t kb, vb;
      const float* sks = sc_base + s * 2 * TK;  // int8: this tile's k and v scales
      const float* svs = sks + TK;
      mbar_wait(k_full + 8 * s, par);
      if constexpr (QUANT) {
        mbar_wait(v_full + 8 * s, par);
        named_sync(1, CONSUMERS);  // every warp is done with the last converted tiles
        convert(s);
        fence_proxy_async();
        named_sync(1, CONSUMERS);
        kb = ck;
        vb = cv;
      } else {
        kb = sk + s * C::STAGE_BYTES;
        vb = sv + s * C::STAGE_BYTES;
      }
      // S = Q.K^T: k16 steps over D, 32 bytes apart inside a 64-wide box
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < C::KSTEPS; ++ks) {
        const uint32_t off = (ks / 4) * C::BOX + (ks % 4) * 32;
        WgmmaSS<TK>::mma(sc, desc_sw128(qa + off, 16, 1024), desc_sw128(kb + off, 16, 1024),
                         ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // online softmax in natural units, the length mask on the row's last tile
      const int kv0 = t * TK;
      const bool last = kv0 + TK > len;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < TK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = j * 8 + tq * 2 + e;
          float v0 = sc[4 * j + e], v1 = sc[4 * j + 2 + e];
          if constexpr (QUANT) {
            const float ksc = sks[col];
            v0 *= ksc;
            v1 *= ksc;
          }
          v0 *= scale;
          v1 *= scale;
          if (last && kv0 + col >= len) v0 = v1 = -INFINITY;
          sc[4 * j + e] = v0;
          sc[4 * j + 2 + e] = v1;
          mx0 = fmaxf(mx0, v0);
          mx1 = fmaxf(mx1, v1);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // every tile holds a valid key (its first), so the new max is finite
      const float m0 = fmaxf(m_run[0], mx0);
      const float m1 = fmaxf(m_run[1], mx1);
      const float alpha0 = ex2((m_run[0] - m0) * LOG2E);
      const float alpha1 = ex2((m_run[1] - m1) * LOG2E);
      m_run[0] = m0;
      m_run[1] = m1;
      const float mb0 = m0 * LOG2E, mb1 = m1 * LOG2E;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < TK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p0 = ex2(fmaf(sc[4 * j + e], LOG2E, -mb0));
          float p1 = ex2(fmaf(sc[4 * j + 2 + e], LOG2E, -mb1));
          sum0 += p0;
          sum1 += p1;
          if constexpr (QUANT) {  // v_scale rides p after p went into l
            const float vsc = svs[j * 8 + tq * 2 + e];
            p0 *= vsc;
            p1 *= vsc;
          }
          sc[4 * j + e] = p0;
          sc[4 * j + 2 + e] = p1;
        }
      }
      l_run[0] = l_run[0] * alpha0 + sum0;
      l_run[1] = l_run[1] * alpha1 + sum1;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        acc[4 * j + 0] *= alpha0;
        acc[4 * j + 1] *= alpha0;
        acc[4 * j + 2] *= alpha1;
        acc[4 * j + 3] *= alpha1;
      }
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }

      // O += P.V, V transposed in shared memory: k16 steps of 16 keys (2048
      // bytes), 64-wide column blocks BOX bytes apart
      if constexpr (!QUANT) mbar_wait(v_full + 8 * s, par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        WgmmaRS<DP>::mma(acc, pa[kk], desc_sw128(vb + kk * 16 * 128, C::BOX, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);  // P's registers stay P's until the product has read them
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with the stage
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(q_empty + 8 * qs);  // and with the Q slot

    // the segment's partial: straight into the output when this CTA holds
    // the whole pair, else into its workspace slot
    float lsum[2] = {l_run[0], l_run[1]};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      lsum[hh] += __shfl_xor_sync(0xffffffffu, lsum[hh], 1);
      lsum[hh] += __shfl_xor_sync(0xffffffffu, lsum[hh], 2);
    }
    const bool whole = sg.t0 == 0 && sg.e_p <= u_end;
    const int slot = 2 * c + (sg.s_p > u_begin ? 1 : 0);
    float* piece = P.ws + slot * slot_floats;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = w * 16 + gr + 8 * hh;
      if (r < R) {
        float *pa_, *pm, *pl;
        if (whole) {
          const long long orow = out_row(b, kvh, r);
          pa_ = P.acc + orow * D;
          pm = P.m + orow;
          pl = P.l + orow;
        } else {
          pa_ = piece + (long long)r * D;
          pm = piece + (long long)R * D + r;
          pl = pm + R;
        }
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          const int col = j * 8 + tq * 2;
          if (col < D) {
            *reinterpret_cast<float2*>(pa_ + col) = make_float2(acc[4 * j + 2 * hh],
                                                                acc[4 * j + 2 * hh + 1]);
          }
        }
        if (tq == 0) {
          *pm = m_run[hh];
          *pl = lsum[hh];
        }
      }
    }
    if (!whole) {
      // count this piece; the CTA that brings the count to the number of
      // pieces merges them, in key order, and leaves the counter at 0
      const int pair = b * Hkv + kvh;
      const int c0 = sp.owner(sg.s_p), c1 = sp.owner(sg.e_p - 1);
      __threadfence();
      named_sync(1, CONSUMERS);
      if (tid == 0) s_last = atomicAdd(P.counters + pair, 1) == c1 - c0;
      named_sync(1, CONSUMERS);
      if (s_last) {
        __threadfence();
        const int np = c1 - c0 + 1;
        auto piece_of = [&](int k) {  // piece k's workspace slot: CTA c0 + k's
          const int cc = c0 + k;
          return P.ws + (2 * cc + (sg.s_p > sp.start(cc) ? 1 : 0)) * slot_floats;
        };
        // The pieces' m and l are read in parallel, MERGE_CHUNK pieces at a
        // time, and reduced from shared memory; the sums run in piece order.
        auto load_ml = [&](int k0, int kn, bool with_l) {
          for (int i = tid; i < kn * R; i += CONSUMERS) {
            const int k = i / R, r = i - k * R;
            const float* pm = piece_of(k0 + k) + (long long)R * D;
            s_mk[k][r] = __ldcg(pm + r);
            if (with_l) s_lk[k][r] = __ldcg(pm + R + r);
          }
          named_sync(1, CONSUMERS);
        };
        const bool one_chunk = np <= MERGE_CHUNK;  // then one read of m and l serves
        for (int k0 = 0; k0 < np; k0 += MERGE_CHUNK) {  // the rows' maxima
          const int kn = min(MERGE_CHUNK, np - k0);
          load_ml(k0, kn, one_chunk);
          for (int r = tid; r < R; r += CONSUMERS) {
            float mx = k0 == 0 ? -INFINITY : s_mx[r];
            for (int k = 0; k < kn; ++k) mx = fmaxf(mx, s_mk[k][r]);
            s_mx[r] = mx;
            if (k0 == 0) s_ls[r] = 0.f;
          }
          named_sync(1, CONSUMERS);
        }
        // acc = sum_k acc_k * exp(m_k - mx), 4 columns a thread at a time,
        // the loads of MERGE_V column groups x MERGE_LOADS pieces issued
        // together before they are summed (a load and its use under one
        // condition would each wait a round trip); the output holds the sum
        // between chunks of pieces
        const int nvec = R * D / 4;
        for (int k0 = 0; k0 < np; k0 += MERGE_CHUNK) {
          const int kn = min(MERGE_CHUNK, np - k0);
          if (!one_chunk) load_ml(k0, kn, true);
          for (int i = tid; i < kn * R; i += CONSUMERS) {
            const int k = i / R, r = i - k * R;
            const float wt = exp2f((s_mk[k][r] - s_mx[r]) * LOG2E);
            s_mk[k][r] = wt;
            s_lk[k][r] *= wt;
          }
          named_sync(1, CONSUMERS);
          for (int r = tid; r < R; r += CONSUMERS) {
            float ls = s_ls[r];
            for (int k = 0; k < kn; ++k) ls += s_lk[k][r];
            s_ls[r] = ls;
          }
          for (int v0 = tid; v0 < nvec; v0 += MERGE_V * CONSUMERS) {
            float4 a[MERGE_V];
            float4* out[MERGE_V];
            int row[MERGE_V];
#pragma unroll
            for (int e = 0; e < MERGE_V; ++e) {
              const int v = min(v0 + e * CONSUMERS, nvec - 1);  // past the end: a repeat, not stored
              row[e] = v * 4 / D;
              out[e] = reinterpret_cast<float4*>(P.acc + out_row(b, kvh, row[e]) * D +
                                                 (v * 4 - row[e] * D));
              a[e] = k0 == 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : *out[e];
            }
            for (int k = 0; k < kn; k += MERGE_LOADS) {
              float4 x[MERGE_V][MERGE_LOADS];
#pragma unroll
              for (int e = 0; e < MERGE_V; ++e) {
                const int v = min(v0 + e * CONSUMERS, nvec - 1);
#pragma unroll
                for (int j = 0; j < MERGE_LOADS; ++j) {
                  x[e][j] = k + j < kn
                                ? __ldcg(reinterpret_cast<const float4*>(piece_of(k0 + k + j)) + v)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
                }
              }
#pragma unroll
              for (int e = 0; e < MERGE_V; ++e) {
#pragma unroll
                for (int j = 0; j < MERGE_LOADS; ++j) {
                  const float wt = k + j < kn ? s_mk[k + j][row[e]] : 0.f;
                  a[e].x += x[e][j].x * wt;
                  a[e].y += x[e][j].y * wt;
                  a[e].z += x[e][j].z * wt;
                  a[e].w += x[e][j].w * wt;
                }
              }
            }
#pragma unroll
            for (int e = 0; e < MERGE_V; ++e) {
              if (v0 + e * CONSUMERS < nvec) *out[e] = a[e];
            }
          }
          named_sync(1, CONSUMERS);  // the chunk's weights are used
        }
        for (int r = tid; r < R; r += CONSUMERS) {
          const long long orow = out_row(b, kvh, r);
          P.m[orow] = s_mx[r];
          P.l[orow] = s_ls[r];
        }
        if (tid == 0) P.counters[pair] = 0;
      }
    }
    u = sg.s_p + sg.t1;
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

// Tensor maps, cached: a map depends only on what the key holds, and the
// pools live as long as the server, so a call encodes nothing once warm.
struct MapKey {
  const void* ptr;
  int dtype, rank, swizzle;
  cuuint64_t dims[4];
  cuuint32_t box[4];
};

struct MapCache {
  static constexpr int N = 64;
  MapKey keys[N];
  CUtensorMap maps[N];
  int used = 0, next = 0;
  std::mutex mu;
};

bool tensor_map(CUtensorMap* out, const void* ptr, CUtensorMapDataType dtype, int esize,
                int rank, const cuuint64_t* dims, const cuuint32_t* box,
                CUtensorMapSwizzle swizzle) {
  static MapCache cache;
  MapKey key;
  memset(&key, 0, sizeof key);
  key.ptr = ptr;
  key.dtype = static_cast<int>(dtype);
  key.rank = rank;
  key.swizzle = static_cast<int>(swizzle);
  for (int i = 0; i < rank; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
  }
  std::lock_guard<std::mutex> lock(cache.mu);
  for (int i = 0; i < cache.used; ++i) {
    if (memcmp(&cache.keys[i], &key, sizeof key) == 0) {
      *out = cache.maps[i];
      return true;
    }
  }
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  cuuint64_t strides[3];
  cuuint64_t stride = (cuuint64_t)esize;
  for (int i = 0; i + 1 < rank; ++i) {
    stride *= dims[i];
    strides[i] = stride;
  }
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  if (enc(out, dtype, rank, const_cast<void*>(ptr), dims, strides, box, elem,
          CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return false;
  }
  const int i = cache.used < MapCache::N ? cache.used++ : (cache.next++ % MapCache::N);
  memcpy(&cache.keys[i], &key, sizeof key);
  cache.maps[i] = *out;
  return true;
}

template <int DP, bool QUANT>
cudaError_t launch(const void* q, const void* pk, const void* pv, const Params& P, int grid,
                   cudaStream_t stream) {
  using C = Cfg<DP, QUANT>;
  const int g = P.H / P.Hkv;
  CUtensorMap tq, tk, tv;
  // q [B, S, H, D] as (D, H, S, B): one box is the pair's R rows of 64 columns
  const cuuint64_t qd[4] = {(cuuint64_t)P.D, (cuuint64_t)P.H, (cuuint64_t)P.S, (cuuint64_t)P.B};
  const cuuint32_t qb[4] = {64, (cuuint32_t)g, (cuuint32_t)P.S, 1};
  // the pool [N, blk, Hkv, D] as (D, Hkv, N * blk): boxes of box_rows positions
  const cuuint64_t pd[3] = {(cuuint64_t)P.D, (cuuint64_t)P.Hkv,
                            (cuuint64_t)P.n_pool * P.blk};
  const cuuint32_t pb[3] = {QUANT ? (cuuint32_t)DP : 64u, 1, (cuuint32_t)P.box_rows};
  const auto pool_type = QUANT ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto pool_swizzle = QUANT ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B;
  if (!tensor_map(&tq, q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 4, qd, qb,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&tk, pk, pool_type, QUANT ? 1 : 2, 3, pd, pb, pool_swizzle) ||
      !tensor_map(&tv, pv, pool_type, QUANT ? 1 : 2, 3, pd, pb, pool_swizzle)) {
    return cudaErrorInvalidValue;
  }
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(paged_attention_kernel<DP, QUANT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  paged_attention_kernel<DP, QUANT><<<grid, THREADS, C::SMEM, stream>>>(tq, tk, tv, P);
  return cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes.  Returns a cudaError_t (0 = launched).  Launches
// once on `stream` and allocates nothing: the caller passes the workspace ws
// (2 * grid slots of R * (D + 2) f32 rounded up to a multiple of 4, R =
// S*H/Hkv) and the counters (B * Hkv int32, zero, and left zero by the
// launch).  grid: one CTA per SM.
extern "C" int tpst_paged_attention(const void* q, const void* pk, const void* pv,
                                    const void* ks, const void* vs, const void* bt,
                                    const void* lens, void* acc, void* m, void* l, void* ws,
                                    void* counters, int B, int S, int H, int Hkv, int D,
                                    int blk, int nb, int n_pool, int quant, int grid,
                                    float scale, void* stream) {
  if (B <= 0 || B > MAX_B || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 ||
      D > 128 || D % 16 != 0 || blk <= 0 || blk % 16 != 0 || nb <= 0 || n_pool <= 0 ||
      grid <= 0 || (long long)n_pool * blk + TK >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (S * (H / Hkv) > 64) return static_cast<int>(cudaErrorInvalidValue);
  Params P;
  P.bt = static_cast<const int*>(bt);
  P.lens = static_cast<const int*>(lens);
  P.ks = static_cast<const float*>(ks);
  P.vs = static_cast<const float*>(vs);
  P.acc = static_cast<float*>(acc);
  P.m = static_cast<float*>(m);
  P.l = static_cast<float*>(l);
  P.ws = static_cast<float*>(ws);
  P.counters = static_cast<int*>(counters);
  P.B = B;
  P.S = S;
  P.H = H;
  P.Hkv = Hkv;
  P.D = D;
  P.blk = blk;
  P.nb = nb;
  P.n_pool = n_pool;
  P.box_rows = blk % 64 == 0 ? 64 : (blk % 32 == 0 ? 32 : 16);  // gcd(blk, 64)
  P.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D <= 64) {
    err = quant ? launch<64, true>(q, pk, pv, P, grid, st) : launch<64, false>(q, pk, pv, P, grid, st);
  } else {
    err = quant ? launch<128, true>(q, pk, pv, P, grid, st)
                : launch<128, false>(q, pk, pv, P, grid, st);
  }
  return static_cast<int>(err);
}
