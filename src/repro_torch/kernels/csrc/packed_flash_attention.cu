// Padded Reuse attention over head-major packed KV with an explicit mask,
// returning the raw flash statistics.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// packed_flash_attention_call (_kernel):
//   q    [B, K, R, dh]   R = Sb·G query rows per KV head (row = sb·G + g)
//   k, v [B, K, T, dh]   the packed retained cache of each request
//   mask [B, K, Sm, T]   bool; row r reads mask row r / (R / Sm) (Sm = Sb,
//                        or 1 for a mask shared by the block's rows)
//   out  o [B, K, R, dh] float32, UNNORMALISED; m, s [B, K, R] float32
// Masked logits are -1e30, as in the Pallas kernel, so a row whose keys are
// all masked comes out with m = -1e30, s = T and o = Σ v: the exact split
// merge of the padded Reuse (transformer.reuse_attention_layer) gives such a
// side the weight exp(-1e30 - m) = 0. Keys past T take the logit -inf, not
// -1e30, so they never enter s.
//
// What bounds it on an H100: at llada-8b's padded Reuse (B = 16 requests,
// K = 32, R = Sb = 8 rows, T = 128 to 248 retained keys, dh = 128) the work
// is 4·B·K·R·T·dh ~ 0.5 GFLOP against ~65 MB of bf16 K/V: ~8 operations
// per byte, so the bytes bound it (~20 us at 3.35 TB/s).
//
// bfloat16 design (packed_attention_kernel_sm90): a few query rows per
// (request, KV head) sit on the narrow side of warp-level tensor-core
// products, and every warp streams its own K/V with bytes in flight.
//  * One warp owns one (request, KV head, group of RW = 8 or 16 rows) and
//    walks all T keys; four warps a CTA take four independent groups, so no
//    CTA barrier and no merge: the B·K = 512 groups of the serving shape
//    are 128 CTAs, one wave of one CTA an SM.
//  * S^T[16 keys x RW rows] = K·Q^T by mma.sync m16n8k16 (swap-AB: keys on
//    the 16-row M side, the rows as N = 8), Q^T in registers for the whole
//    walk, K fragments by ldmatrix. Nothing is padded to 64 rows.
//  * Scale, softcap, mask and the online softmax stay in registers (a row's
//    keys across the 8 lanes of one t = lane % 4, three shuffles). P goes
//    to bf16 and movmatrix transposes it, in registers, into the B operand
//    of O^T[dh x RW] += V^T·P^T (V^T fragments by ldmatrix.trans).
//  * Each warp keeps a 4-stage cp.async ring of 16-key K/V tiles (rows
//    padded by 16 bytes, so ldmatrix reads every bank once), 3 tiles ahead
//    of its math: ~100 KB in flight an SM. Keys past T are zero-filled.
//  * Above dh 128 (gemma-2b's 256) a warp owns RW = 8 rows, so Q^T (32
//    registers) and the O^T tile (64) take what RW = 16 takes at dh 128,
//    and the ring has 3 stages (4 would need 264 KB a CTA; 3 take 198 KB).
//  * The mask bytes of a tile are read before its wait, beside the copies.
// float32 inputs (the reduced checks) keep the first tile (attn_tile.cuh),
// by explicit dtype dispatch.

#include "attn_tile.cuh"
#include "sm90.cuh"

using repro::bf16;
using namespace repro::attn;
namespace H = repro::sm90;

namespace {

struct Params {
  const void* q;                // [B·K, R, dh]
  const void* k;                // [B·K, T, dh]
  const void* v;                // [B·K, T, dh]
  const uint8_t* mask;          // [B·K, Sm, T]
  float* o;                     // [B·K, R, dh]
  float* m;                     // [B·K, R]
  float* s;                     // [B·K, R]
  int R, T, Sm, G;              // G = R / Sm rows per mask row
  float scale, softcap;
};

// ---------------------------------------------------------------------------
// float32: the first tile, one CTA per (request, KV head, 64 query rows)
// ---------------------------------------------------------------------------

template <typename T, int DH>
__global__ void __launch_bounds__(NTHREADS)
packed_attention_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tile<T, DH> t(smem);
  constexpr int BK = kv_tile<DH>();
  int* row_mask = t.row_i0;                // the row's mask row, -1 past R

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t bk = blockIdx.y;            // request · K + KV head
  const int row0 = blockIdx.x * BQ;
  const int nrows = min(BQ, p.R - row0);
  const T* q = static_cast<const T*>(p.q) + (bk * p.R + row0) * DH;
  const T* k = static_cast<const T*>(p.k) + bk * p.T * DH;
  const T* v = static_cast<const T*>(p.v) + bk * p.T * DH;
  const uint8_t* mask = p.mask + bk * p.Sm * p.T;

  for (int i = tid; i < BQ; i += NTHREADS)
    row_mask[i] = i < nrows ? (row0 + i) / p.G : -1;
  init_rows<T, DH>(t, q, nrows, tid);
  __syncthreads();

  for (int kv0 = 0; kv0 < p.T; kv0 += BK) {
    const int nk = min(BK, p.T - kv0);
    load_kv<T, DH>(t, k, v, kv0, nk, tid);
    __syncthreads();
    scores<T, DH>(t.Qs, t.Ks, t.Ss, tid);
    __syncthreads();
    softmax_tile<BK>(t.Ss, t.Ps, t.row_m, t.row_l, t.row_a, p.scale, p.softcap,
                    warp, lane, [&](int r, int c, float zz) {
      if (c >= nk) return -INFINITY;
      const int mr = row_mask[r];
      if (mr < 0) return -1e30f;            // padding row: never written
      return mask[(size_t)mr * p.T + kv0 + c] ? zz : -1e30f;
    });
    __syncthreads();
    accumulate_pv<T, DH>(t.Ps, t.Vs, t.Os, t.row_a, tid);
    __syncthreads();
  }

  float* o = p.o + (bk * p.R + row0) * DH;
  for (int i = tid; i < nrows * DH; i += NTHREADS) o[i] = t.Os[i];
  for (int i = tid; i < nrows; i += NTHREADS) {
    p.m[bk * p.R + row0 + i] = t.row_m[i];
    p.s[bk * p.R + row0 + i] = t.row_l[i];
  }
}

template <typename T, int DH>
struct Launch {
  static cudaError_t run(const Params& p, int BK_, cudaStream_t s) {
    return launch_tile<T, DH>(packed_attention_kernel<T, DH>,
                              dim3((p.R + BQ - 1) / BQ, BK_), p, s);
  }
};

// ---------------------------------------------------------------------------
// bfloat16: a warp per (request, KV head, row group), mma.sync, cp.async
// ---------------------------------------------------------------------------

constexpr int KT = 16;          // keys a tile: the M side of the products
constexpr int NWARPS = 4;       // warps a CTA, each on its own row group

template <int DH>
struct Ring {
  static constexpr int NST = DH > 128 ? 3 : 4; // stages of a warp's K/V ring
  static constexpr int LD = DH + 8;            // row stride (bf16)
  static constexpr int TILE = KT * LD;         // one K or V tile (bf16)
  static constexpr int WARP = NST * 2 * TILE;  // a warp's ring (bf16)
  static constexpr int BYTES = NWARPS * WARP * 2;
  static_assert(BYTES <= 232448, "a block's shared memory is 227 KB");
};

template <int DH, int RW>
__global__ void __launch_bounds__(NWARPS * 32)
packed_attention_kernel_sm90(Params p, int n_groups, int n_work) {
  constexpr int NT = RW / 8;     // row tiles of 8 (the N side)
  constexpr int KS = DH / 16;    // dh steps of S = dh tiles of O^T
  constexpr int LD = Ring<DH>::LD, CH = DH / 8, NST = Ring<DH>::NST;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int work = blockIdx.x * NWARPS + warp;
  if (work >= n_work) return;              // no CTA barrier below
  const size_t bk = work / n_groups;
  const int row0 = (work % n_groups) * RW;
  const int T = p.T;
  const bf16* q = static_cast<const bf16*>(p.q) + bk * p.R * DH;
  const bf16* k = static_cast<const bf16*>(p.k) + bk * T * DH;
  const bf16* v = static_cast<const bf16*>(p.v) + bk * T * DH;
  bf16* ring = reinterpret_cast<bf16*>(smem) + warp * Ring<DH>::WARP;

  // Q^T as the B operand of S^T = K·Q^T: rows past R are zero
  uint32_t qf[KS][NT][2];
  const uint8_t* mrow[NT][2];              // each thread's two rows' masks
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int row = row0 + 8 * j + g;
#pragma unroll
    for (int st = 0; st < KS; ++st) {
      const bf16* src = q + (size_t)row * DH + 16 * st + 2 * t;
      qf[st][j][0] = row < p.R ? *reinterpret_cast<const uint32_t*>(src) : 0u;
      qf[st][j][1] =
          row < p.R ? *reinterpret_cast<const uint32_t*>(src + 8) : 0u;
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = min(row0 + 8 * j + 2 * t + rr, p.R - 1);
      mrow[j][rr] = p.mask + (bk * p.Sm + r / p.G) * T;
    }
  }

  const int n_tiles = (T + KT - 1) / KT;
  auto fetch = [&](int i) {
    if (i < n_tiles) {
      bf16* ks = ring + (i % NST) * 2 * Ring<DH>::TILE;
      bf16* vs = ks + Ring<DH>::TILE;
      for (int c = lane; c < KT * CH; c += 32) {
        const int r = c / CH, ch = c % CH, key = i * KT + r;
        const size_t off = (size_t)min(key, T - 1) * DH + ch * 8;
        const int n = key < T ? 16 : 0;
        H::cp_async16(ks + r * LD + ch * 8, k + off, n);
        H::cp_async16(vs + r * LD + ch * 8, v + off, n);
      }
    }
    H::cp_async_commit();                  // a group a tile, empty or not
  };
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) fetch(i);

  float m[NT][2], l[NT][2], o[KS][NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    m[j][0] = m[j][1] = -INFINITY;
    l[j][0] = l[j][1] = 0.f;
#pragma unroll
    for (int st = 0; st < KS; ++st)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[st][j][e] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    fetch(i + NST - 1);
    // this thread's keys (g, g + 8) and rows (2t, 2t + 1) of each row tile
    const int ka = i * KT + g, kb = ka + 8;
    bool keep[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = e < 2 ? ka : kb;
        keep[j][e] = key < T && mrow[j][e & 1][key];
      }
    H::cp_async_wait<NST - 1>();
    __syncwarp();
    const bf16* ks = ring + (i % NST) * 2 * Ring<DH>::TILE;
    const bf16* vs = ks + Ring<DH>::TILE;

    // S^T = K·Q^T, two accumulator chains over the dh steps
    float s[NT][4], s2[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = s2[j][e] = 0.f;
#pragma unroll
    for (int st = 0; st < KS; ++st) {
      uint32_t a[4];
      H::ldmatrix_x4(a, ks + (lane & 15) * LD + 16 * st + 8 * (lane >> 4));
#pragma unroll
      for (int j = 0; j < NT; ++j)
        H::mma_bf16_16816(st & 1 ? s2[j] : s[j], a, qf[st][j]);
    }

    uint32_t pb[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float z = (s[j][e] + s2[j][e]) * p.scale;
        if (p.softcap != 0.f) z = p.softcap * tanhf(z / p.softcap);
        const int key = e < 2 ? ka : kb;
        s[j][e] = key >= T ? -INFINITY : (keep[j][e] ? z : -1e30f);
      }
      // online softmax of rows 2t (e = 0, 2) and 2t + 1 (e = 1, 3): a
      // row's 16 keys lie in the 8 lanes of this t
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = fmaxf(s[j][rr], s[j][rr + 2]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float mnew = fmaxf(m[j][rr], mx);   // finite: key i·KT < T
        const float alpha = __expf(m[j][rr] - mnew);
        m[j][rr] = mnew;
        const float p0 = __expf(s[j][rr] - mnew);
        const float p1 = __expf(s[j][rr + 2] - mnew);
        l[j][rr] = l[j][rr] * alpha + p0 + p1;
        s[j][rr] = p0;
        s[j][rr + 2] = p1;
#pragma unroll
        for (int st = 0; st < KS; ++st) {
          o[st][j][rr] *= alpha;
          o[st][j][rr + 2] *= alpha;
        }
      }
      // P^T[keys x rows] as the B operand: the transposes of the two 8x8
      // halves (keys 0-7, 8-15) this thread holds as C fragments
      pb[j][0] = H::movmatrix_trans(H::pack_bf16(s[j][0], s[j][1]));
      pb[j][1] = H::movmatrix_trans(H::pack_bf16(s[j][2], s[j][3]));
    }

    // O^T[dh x rows] += V^T·P^T
#pragma unroll
    for (int st = 0; st < KS; ++st) {
      uint32_t a[4];
      H::ldmatrix_x4_trans(a, vs + ((lane & 7) + 8 * (lane >> 4)) * LD +
                                  16 * st + 8 * ((lane >> 3) & 1));
#pragma unroll
      for (int j = 0; j < NT; ++j) H::mma_bf16_16816(o[st][j], a, pb[j]);
    }
    __syncwarp();                          // the stage is free for a copy
  }

#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float sum = l[j][rr];
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      sum += __shfl_xor_sync(0xffffffffu, sum, 8);
      sum += __shfl_xor_sync(0xffffffffu, sum, 16);
      const int row = row0 + 8 * j + 2 * t + rr;
      if (row >= p.R) continue;
      const size_t r = bk * p.R + row;
      if (g == 0) {
        p.m[r] = m[j][rr];
        p.s[r] = sum;
      }
#pragma unroll
      for (int st = 0; st < KS; ++st) {
        p.o[r * DH + 16 * st + g] = o[st][j][rr];
        p.o[r * DH + 16 * st + g + 8] = o[st][j][rr + 2];
      }
    }
  }
}

template <int DH, int RW>
cudaError_t launch_sm90(const Params& p, int BK_, cudaStream_t s) {
  const int groups = (p.R + RW - 1) / RW;
  const int n_work = BK_ * groups;
  auto kern = packed_attention_kernel_sm90<DH, RW>;
  static unsigned smem_set = 0;
  cudaError_t e = H::allow_dynamic_smem(kern, Ring<DH>::BYTES, &smem_set);
  if (e != cudaSuccess) return e;
  kern<<<(n_work + NWARPS - 1) / NWARPS, NWARPS * 32, Ring<DH>::BYTES, s>>>(
      p, groups, n_work);
  return cudaGetLastError();
}

template <typename T, int DH>
struct LaunchSm90 {
  static cudaError_t run(const Params& p, int BK_, cudaStream_t s) {
    if constexpr (DH > 128) return launch_sm90<DH, 8>(p, BK_, s);
    else
      return p.R >= 16 ? launch_sm90<DH, 16>(p, BK_, s)
                       : launch_sm90<DH, 8>(p, BK_, s);
  }
};

}  // namespace

extern "C" int repro_packed_flash_attention(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    void* m, void* s_out, int B, int K, int R, int T, int Sm, int dh,
    int dtype, float scale, float softcap, void* stream) {
  if (Sm <= 0 || R % Sm != 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.mask = static_cast<const uint8_t*>(mask);
  p.o = static_cast<float*>(o);
  p.m = static_cast<float*>(m);
  p.s = static_cast<float*>(s_out);
  p.R = R; p.T = T; p.Sm = Sm; p.G = R / Sm;
  p.scale = scale; p.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == repro::kBF16)
    e = dispatch_dh<LaunchSm90, bf16>(dh, p, B * K, st);
  else if (dtype == repro::kF32)
    e = dispatch_dh<Launch, float>(dh, p, B * K, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
