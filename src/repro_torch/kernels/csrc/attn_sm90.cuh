// Hopper (sm_90a) flash-attention forward for bfloat16: the tile of
// flash_refresh.cu (the padded prefill) and flash_varlen.cu (the packed
// Refresh and Reuse). packed_flash_attention.cu stays on attn_tile.cuh.
//
// One CTA owns 128 query rows of one stream against one window [lo, hi) of
// that stream's keys: two consumer warpgroups of 64 rows each and one
// producer warp (288 threads). Above head_dim 128 (gemma-2b's 256) a CTA
// computes the whole S = Q·Kᵀ but the P·V of 128 of V's columns only, and
// the grid holds one CTA for each 128 columns (Job::col0): the O
// accumulator stays at the 64 registers a thread of dh 128, at the cost of
// computing the scores once for each column half.
//  * Loads: the producer issues the CTA's Q tile, then finds the window
//    (the problem's, e.g. a search of the stream's segments) while Q flies,
//    and publishes it through Q's barrier. It then brings K and V tiles of
//    BK = 64 keys, starting at key lo (any offset: TMA coordinates need no
//    alignment), into a ring of ST stages (4; 3 above dh 128) with TMA
//    (cp.async.bulk.tensor, 128-byte swizzle, columns in atoms of 64; rows
//    past the stream's end and columns past dh come in as zeros). Each
//    stage is guarded by a "full" mbarrier (the TMA's bytes and the
//    producer lanes' arrivals) and an "empty" one (one arrival per consumer
//    warp). Beside the stage the producer lanes write each key's additive
//    bias (0 valid, -1e30 invalid, -inf at or past hi) and its datum; their
//    loads for the next tile are in flight while they wait for a stage and
//    issue its TMA, so only the TMA is on the ring's critical path.
//  * Scores: S = Q·Kᵀ by wgmma m64n64k16 (both operands from shared
//    memory, K-major), accumulated in registers. The scale, the key's bias,
//    the optional softcap and the problem's row-key mask functor are
//    applied in registers, in log2 units; the online (max, Σp) of a row is
//    reduced across the four threads of its quad with shuffles. No score or
//    probability tile touches shared memory.
//  * P·V: P is rounded to bfloat16 in registers and fed as the register A
//    operand of wgmma m64n{64,128}k16 against V read N-major from shared
//    memory (the CTA's 64 or 128 columns of V); O is a float32 register
//    accumulator, rescaled in registers.
//    The P·V of tile j is issued right after the scores of tile j + 1, so
//    it runs on the tensor cores while the softmax of tile j + 1 runs on
//    the other units. Every wgmma is issued and retired on every path, and
//    no register a wgmma in flight reads or writes is touched, so ptxas
//    never serialises them.
//  * Epilogue: the rows normalised once, by max(Σp, 1e-30), or, for one
//    split of a split-KV grid, the unnormalised rows and their (max, Σp),
//    which the caller folds. An empty window (hi <= lo) runs neither role's
//    loop: its rows are 0 (normalised) or the partial (0, -inf, 0).
//  * Why BK = 64: a CTA of nine warps puts three on one of the SM's four
//    register files, so a thread gets at most 168 registers; a 128-key
//    tile (64 + 32 + 64 accumulator and operand registers) spills there.
// A problem (the Prob parameter) supplies the key window, a key's datum and
// validity, a row's datum and a row-key mask functor; with the TMA maps'
// row strides and a Job (the stream, the rows, the output) that is all
// another attention kernel needs.
#pragma once

#include "sm90.cuh"

namespace repro {
namespace sm90 {

// ---------------------------------------------------------------------------
// The attention tile
// ---------------------------------------------------------------------------

constexpr int BM = 128;            // query rows per CTA (two consumer warpgroups)
constexpr int BK = 64;             // keys per KV tile
constexpr int NTHREADS = 288;      // two consumer warpgroups + a producer warp
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG2 = -1e30f * LOG2E;   // a masked logit, -1e30, in log2 units

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory of one CTA: Q (atoms of 128 rows x 64 columns), the K and V
// rings (atoms of BK keys x 64 columns; V's only of the CTA's columns), each
// ring key's bias and datum (KD: the problem's key datum), the barriers. At
// dh 256: 64 KB of Q and three stages of 32 KB of K and 16 KB of V, 211 KB
// in all (four stages would pass the 227 KB a block can use).
template <int DH, class KD>
struct Smem {
  static constexpr int NA = (DH + 63) / 64;        // 64-column atoms of Q, K
  static constexpr int NAV = NA < 2 ? NA : 2;      // of V, a CTA
  static constexpr int NPV = NAV * 64;             // P·V width (dh padded)
  static constexpr int DSPLIT = NA / NAV;          // CTAs across V's columns
  static constexpr int ST = DH > 128 ? 3 : 4;      // stages of the K/V ring
  static constexpr int Q_ATOM = BM * 128;
  static constexpr int KV_ATOM = BK * 128;
  static constexpr int K_STAGE = NA * KV_ATOM;
  static constexpr int V_STAGE = NAV * KV_ATOM;
  static constexpr int q = 0;
  static constexpr int k = q + NA * Q_ATOM;
  static constexpr int v = k + ST * K_STAGE;
  static constexpr int bias = v + ST * V_STAGE;
  static constexpr int kdat = bias + ST * BK * 4;
  static constexpr int bars = kdat + ST * BK * (int)sizeof(KD);
  static constexpr int win = bars + (2 * ST + 1) * 8;   // the key window
  static constexpr int total = win + 8 + 1024;          // + alignment
  static_assert(NA % NAV == 0, "V's columns split evenly across CTAs");
  static_assert(total <= 232448, "a block's shared memory is 227 KB");
};

// What one CTA computes: query rows [row0, row0 + BM) of stream bh against
// the problem's key window of them, in output columns [col0, col0 + NPV)
// (col0 = 0 unless Smem::DSPLIT > 1). Rows at or past `rows` are computed
// on TMA's zeros and not written. With ml == nullptr the rows are
// normalised into o (the stream's [rows][DH]); otherwise o takes them
// unnormalised and ml (the stream's [rows][2]) their (max in log2 units,
// Σp): one split's partial, written by the col0 = 0 CTA.
struct Job {
  int bh, row0, rows, col0;
  float* o;
  float* ml;
};

// Two neighbouring keys' data, read in one shared-memory access.
template <class KD>
struct alignas(2 * sizeof(KD)) KeyPair {
  KD a, b;
};

// The body of one CTA. tq, tk, tv are 3-d TMA maps (dh, rows or keys,
// stream) with boxes (64, BM or BK, 1).
// Prob: float scale, softcap; types Key (a key's datum), Row (a row's);
//   int2 key_window(job, lane)  (the keys [lo, hi) of the job's rows,
//                            found by the producer warp's 32 lanes together;
//                            every lane returns it)
//   Key key_datum(bh, key), bool key_valid(bh, key)   (lo <= key < hi. An
//                            invalid key's logit is -1e30; a key at or past
//                            hi gets -inf)
//   Row row_info(bh, row)    (any row, also past `rows`)
//   bool row_mask()          (whether keep() applies at all)
//   bool keep(Row, Key)      (the row-key mask functor: false caps the
//                             logit at -1e30)
template <int DH, class Prob>
__device__ __forceinline__ void attention_cta(const CUtensorMap* tq,
                                              const CUtensorMap* tk,
                                              const CUtensorMap* tv,
                                              const Prob& p, const Job& job) {
  using Key = typename Prob::Key;
  using Row = typename Prob::Row;
  using L = Smem<DH, Key>;
  constexpr int NA = L::NA, NAV = L::NAV, NPV = L::NPV, ST = L::ST;
  constexpr int NCOL = DH < NPV ? DH : NPV;   // output columns a CTA writes
  constexpr int NJ = BK / 8;         // n8 blocks of a score tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sQ = base + L::q, sK = base + L::k, sV = base + L::v;
  float* bias = reinterpret_cast<float*>(smem + L::bias);
  Key* kdat = reinterpret_cast<Key*>(smem + L::kdat);
  const uint32_t bars = base + L::bars;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (ST + s); };
  const uint32_t qbar = bars + 8u * (2 * ST);
  int2* win = reinterpret_cast<int2*>(smem + L::win);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = job.bh;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 33);       // TMA issue + the 32 metadata lanes
      mbar_init(empty(s), 8);       // one arrival per consumer warp
    }
    mbar_init(qbar, 2);             // Q's bytes + the window's publication
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {
    // ---- the producer warp ----
    if (lane == 0) {
      mbar_arrive_tx(qbar, NA * L::Q_ATOM);
      for (int a = 0; a < NA; ++a)
        tma_load_3d(sQ + a * L::Q_ATOM, tq, qbar, a * 64, job.row0, bh);
    }
    const int2 w = p.key_window(job, lane);
    const int lo = w.x, hi = w.y;
    if (lane == 0) {
      *win = w;
      mbar_arrive(qbar);            // release: the consumers read *win
    }
    const int nkv = hi > lo ? (hi - lo + BK - 1) / BK : 0;
    // a tile's key metadata, loaded into registers (keys at or past hi read
    // key hi - 1) while the ring waits; the bias (0 valid, NEG2 invalid,
    // -inf at or past hi) is formed when the stage is written
    int mv[BK / 32];
    Key md[BK / 32];
    auto fetch = [&](int it) {
#pragma unroll
      for (int x = 0; x < BK / 32; ++x) {
        const int key = min(lo + it * BK + lane + 32 * x, hi - 1);
        md[x] = p.key_datum(bh, key);
        mv[x] = p.key_valid(bh, key);
      }
    };
    if (nkv > 0) fetch(0);
    for (int it = 0; it < nkv; ++it) {
      const int s = it % ST;
      mbar_wait(empty(s), ((it / ST) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_tx(full(s), L::K_STAGE + L::V_STAGE);
        for (int a = 0; a < NA; ++a)
          tma_load_3d(sK + s * L::K_STAGE + a * L::KV_ATOM, tk, full(s),
                      a * 64, lo + it * BK, bh);
        for (int a = 0; a < NAV; ++a)
          tma_load_3d(sV + s * L::V_STAGE + a * L::KV_ATOM, tv, full(s),
                      job.col0 + a * 64, lo + it * BK, bh);
      }
#pragma unroll
      for (int x = 0; x < BK / 32; ++x) {
        const bool in = lo + it * BK + lane + 32 * x < hi;
        bias[s * BK + lane + 32 * x] = in ? (mv[x] ? 0.f : NEG2) : -INFINITY;
        kdat[s * BK + lane + 32 * x] = md[x];
      }
      mbar_arrive(full(s));
      if (it + 1 < nkv) fetch(it + 1);
    }
  } else {
    // ---- consumer warpgroups: 64 rows each, 16 a warp, 2 a thread ----
    const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, q4 = lane & 3;
    const int ra = job.row0 + wg * 64 + wl * 16 + g, rb = ra + 8;
    float o[NPV / 2];
#pragma unroll
    for (int i = 0; i < NPV / 2; ++i) o[i] = 0.f;
    float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f;  // log2 units
    const Row ia = p.row_info(bh, ra), ib = p.row_info(bh, rb);
    mbar_wait(qbar, 0);             // Q is in, the window published
    const int2 w = *win;
    const int nkv = w.y > w.x ? (w.y - w.x + BK - 1) / BK : 0;
    if (nkv > 0) {
      uint32_t pp[BK / 16][4];  // the previous tile's P: A operand of its P·V
      const uint32_t q_wg = sQ + wg * 64 * 128;
      const float c2 = p.scale * LOG2E;
      const bool row_mask = p.row_mask();

      // S = Q · Kᵀ of stage s into sc: dh / 16 steps of k16, 32 B apart
      // inside a 64-column atom (issued and committed, not waited for)
      auto issue_scores = [&](int s, float* sc) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) { sc[i] = 0.f; fence_reg(sc[i]); }
        wgmma_fence();
        const uint32_t ks = sK + s * L::K_STAGE;
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          const uint32_t off = (kk & 3) * 32;
          wgmma_ss<BK, 0>(
              sc, make_desc(q_wg + (kk >> 2) * L::Q_ATOM + off, 16, 1024),
              make_desc(ks + (kk >> 2) * L::KV_ATOM + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
      };
      // O += P · V of stage s: V N-major, 16 keys (2048 B) a k16 step, the
      // two 64-column atoms BK·128 B apart
      auto issue_pv = [&](int s) {
        const uint32_t vs = sV + s * L::V_STAGE;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t dv = make_desc(vs + kk * 2048, L::KV_ATOM, 1024);
          if constexpr (NPV == 128) wgmma_m64n128k16_rs(o, pp[kk], dv);
          else wgmma_m64n64k16_rs(o, pp[kk], dv);
        }
        wgmma_commit();
      };
      auto release = [&](int s) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(s));
      };
      // The online softmax of stage s's scores, in place: z = s·scale·log2e
      // + the key's bias, a row-key mask capping it at NEG2 (-inf stays
      // -inf); the new row max, Σp, and P in float32. Returns the rescale
      // factors of O through aa, ab.
      const bool plain_mask = p.softcap == 0.f && !row_mask;
      auto softmax = [&](int s, float* zs, float& aa, float& ab) {
        const float* bs = bias + s * BK;
        const Key* kds = kdat + s * BK;
        float xa = -INFINITY, xb = -INFINITY;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float2 kb =
              *reinterpret_cast<const float2*>(bs + 8 * j + 2 * q4);
          const KeyPair<Key> kd =
              *reinterpret_cast<const KeyPair<Key>*>(kds + 8 * j + 2 * q4);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float s0 = zs[4 * j + e], s1 = zs[4 * j + 2 + e];
            const float bias_e = e ? kb.y : kb.x;
            float za, zb;
            if (plain_mask || p.softcap == 0.f) {
              za = fmaf(s0, c2, bias_e);
              zb = fmaf(s1, c2, bias_e);
            } else {
              za = fmaf(p.softcap * tanhf(s0 * p.scale / p.softcap), LOG2E,
                        bias_e);
              zb = fmaf(p.softcap * tanhf(s1 * p.scale / p.softcap), LOG2E,
                        bias_e);
            }
            if (!plain_mask && row_mask) {
              const Key k_e = e ? kd.b : kd.a;
              if (!p.keep(ia, k_e)) za = fminf(za, NEG2);
              if (!p.keep(ib, k_e)) zb = fminf(zb, NEG2);
            }
            zs[4 * j + e] = za;
            zs[4 * j + 2 + e] = zb;
            xa = fmaxf(xa, za);
            xb = fmaxf(xb, zb);
          }
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          xa = fmaxf(xa, __shfl_xor_sync(0xffffffffu, xa, off));
          xb = fmaxf(xb, __shfl_xor_sync(0xffffffffu, xb, off));
        }
        // The window's first tile holds key lo < hi, whose logit is finite
        // (-1e30 at worst), so the max is finite from the first tile on and
        // ma - na is never -inf - -inf.
        const float na = fmaxf(ma, xa), nb = fmaxf(mb, xb);
        aa = ex2(ma - na);
        ab = ex2(mb - nb);
        ma = na;
        mb = nb;
        float sa = 0.f, sb = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          zs[4 * j] = ex2(zs[4 * j] - na);
          zs[4 * j + 1] = ex2(zs[4 * j + 1] - na);
          zs[4 * j + 2] = ex2(zs[4 * j + 2] - nb);
          zs[4 * j + 3] = ex2(zs[4 * j + 3] - nb);
          sa += zs[4 * j] + zs[4 * j + 1];
          sb += zs[4 * j + 2] + zs[4 * j + 3];
        }
        la = la * aa + sa;
        lb = lb * ab + sb;
      };
      // P in bfloat16 as the A fragments of the four k16 steps of P·V; only
      // when no wgmma is in flight (they are its input registers)
      auto pack = [&](const float* zs) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          pp[j >> 1][2 * (j & 1)] = pack_bf16(zs[4 * j], zs[4 * j + 1]);
          pp[j >> 1][2 * (j & 1) + 1] = pack_bf16(zs[4 * j + 2], zs[4 * j + 3]);
        }
      };
      // tile 0: scores and softmax only (O is zero)
      float sc[BK / 2];
      float aa, ab;
      mbar_wait(full(0), 0);
      issue_scores(0, sc);
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) fence_reg(sc[i]);
      softmax(0, sc, aa, ab);
      pack(sc);

      // tile it: its scores, then the P·V of tile it - 1, which runs on the
      // tensor cores while this tile's softmax runs; every wgmma is issued
      // and retired on every path
      for (int it = 1; it < nkv; ++it) {
        const int s = it % ST, sp = (it - 1) % ST;
        mbar_wait(full(s), (it / ST) & 1);
        issue_scores(s, sc);
        issue_pv(sp);
        wgmma_wait<1>();              // the scores are in; P·V may still run
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) fence_reg(sc[i]);
        softmax(s, sc, aa, ab);
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < NPV / 2; ++i) fence_reg(o[i]);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) fence_reg(pp[kk][x]);
        release(sp);
#pragma unroll
        for (int jb = 0; jb < NPV / 8; ++jb) {
          o[4 * jb] *= aa;
          o[4 * jb + 1] *= aa;
          o[4 * jb + 2] *= ab;
          o[4 * jb + 3] *= ab;
        }
        pack(sc);
      }
      // the last tile's P·V
#pragma unroll
      for (int i = 0; i < NPV / 2; ++i) fence_reg(o[i]);
      wgmma_fence();
      issue_pv((nkv - 1) % ST);
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < NPV / 2; ++i) fence_reg(o[i]);
    }

    // Σp over the quad; float32 rows of DH columns, normalised once or, for
    // a split's partial, as they are with the rows' (max, Σp)
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      la += __shfl_xor_sync(0xffffffffu, la, off);
      lb += __shfl_xor_sync(0xffffffffu, lb, off);
    }
    float sa = 1.f, sb = 1.f;
    if (job.ml == nullptr) {
      sa = 1.f / fmaxf(la, 1e-30f);
      sb = 1.f / fmaxf(lb, 1e-30f);
    } else if (q4 == 0 && job.col0 == 0) {
      if (ra < job.rows)
        *reinterpret_cast<float2*>(job.ml + 2 * ra) = make_float2(ma, la);
      if (rb < job.rows)
        *reinterpret_cast<float2*>(job.ml + 2 * rb) = make_float2(mb, lb);
    }
    float* oa = job.o + (size_t)ra * DH + job.col0;
    float* ob = oa + 8 * DH;
#pragma unroll
    for (int jb = 0; jb < NCOL / 8; ++jb) {
      const int c = 8 * jb + 2 * q4;
      if (ra < job.rows)
        *reinterpret_cast<float2*>(oa + c) =
            make_float2(o[4 * jb] * sa, o[4 * jb + 1] * sa);
      if (rb < job.rows)
        *reinterpret_cast<float2*>(ob + c) =
            make_float2(o[4 * jb + 2] * sb, o[4 * jb + 3] * sb);
    }
  }
}

}  // namespace sm90
}  // namespace repro
