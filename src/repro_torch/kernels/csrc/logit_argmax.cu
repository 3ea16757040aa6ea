// Fused logit -> (argmax, max, Σexp) over the vocabulary (paper C1).
//
// Replaces the Pallas TPU kernel src/repro/kernels/logit_argmax.py
// fused_logit_argmax_call (_kernel): z = h·W tiled over the vocabulary
// with an online max, argmax (strict >, the lowest index wins ties) and
// Σ exp(z - max), an optional final softcap, and a skip of T tiles that
// hold no valid row. The [T, V] logits never reach device memory.
//
// What bounds it on an H100: every call streams the whole head W once
// (llada-8b: 4096 x 126,464 bf16 = 1.04 GB, >= 0.31 ms at 3.35 TB/s)
// against 2·T·D·V operations; at T <= 128 rows that is <= 128 op/byte,
// below the ~295 where the tensor cores would be the limit: bound by bytes.
//
// bfloat16 (logit_partial_kernel_mma):
//  * a persistent grid of one CTA an SM (x the T tiles past 128 rows); each
//    CTA owns a contiguous run of whole 128-column vocabulary tiles (the
//    splits of kernels/logit_argmax.py::vocab_split). A producer warp
//    streams its W and h chunks (128 x 64 and BT x 64) with TMA through a
//    ring of 5-8 stages, so 64-112 KB of W is in flight on every SM, and
//    eight consumer warps (two warpgroups) multiply and fold;
//  * "swap-AB": the vocabulary is the M dimension of wgmma m64nNk16 (64
//    rows a warpgroup, 128 a CTA) and the T rows its N, N = BT = 8, 16, 32,
//    64 or 128 (the power of two covering T), so a small serving bucket
//    costs only its own columns. wgmma rather than mma.sync: the tensor
//    cores are not the limit at <= 128 op/byte, but wgmma reads both
//    operands straight from the swizzled ring, where mma.sync needs every
//    fragment brought through registers with ldmatrix, several warps
//    reading the same h chunk;
//  * h is read again from L2 for every vocabulary tile: T·D·2 bytes per
//    128·D·2 of W, at most W's own traffic (equal at T = 128);
//  * the (max, argmax, Σexp(z - max)) of every row is folded from the
//    accumulator fragments in registers and carried across the CTA's whole
//    run, one copy a column in one of the eight lanes that share it; a
//    fragment holds interleaved columns, so every merge (within a thread,
//    across shuffles, across warps, across splits) compares (value, index)
//    and the lowest index wins ties;
//  * shared rows of 128 bytes in 1024-byte aligned tiles, 16-byte chunks
//    XOR-swizzled by the row (wgmma's 128-byte swizzle); the [D, V] layout
//    is read as an M-major A operand, the tied [V, D] one and h K-major;
//  * a shape whose rows are not 16-byte aligned (V not a multiple of 8 in
//    the [D, V] layout, D not a multiple of 8, or a misaligned pointer)
//    cannot use TMA: the producer warp fills the same ring with plain
//    loads (and a proxy fence, as wgmma reads through the async proxy).
// The first version of this kernel lost its time in staging W and h one
// element at a time with nothing in flight during the products (now the
// TMA ring), a fixed 128-row T tile (now N = BT), and a 64 KB float32
// logit tile in shared memory folded row by row (now registers); h is
// still read once a vocabulary tile, now from L2 at the cost stated above.
// float32 (a parity path: reduced configs, TF32 off) stays on the CUDA
// cores (logit_partial_kernel): a 128 x 128 tile of logits in shared
// memory, folded by rows.
// Each split writes its partial (m, idx, s); a second small kernel merges
// them by the law of the reference's vocab-sharded path
// (src/repro/kernels/ops.py::_sharded_logit_argmax): m = max mᵢ, idx from
// the lowest split reaching m, s = Σ sᵢ·exp(mᵢ - m).

#include <string.h>

#include "sm90.cuh"

using repro::bf16;

namespace {

// ---------------------------------------------------------------------------
// bfloat16: the swap-AB tensor-core kernel
// ---------------------------------------------------------------------------

namespace mma {

using namespace repro::sm90;

// (m, i, s) <- the merge of (m, i, s) and (m2, i2, s2): the larger max, the
// lowest index among equal maxima, Σexp rescaled to the new max
__device__ __forceinline__ void merge_max(float& m, int& i, float& s, float m2,
                                          int i2, float s2) {
  const float mn = fmaxf(m, m2);
  float sn = 0.f;
  if (mn > -INFINITY) {
    if (m > -INFINITY) sn += s * expf(m - mn);
    if (m2 > -INFINITY) sn += s2 * expf(m2 - mn);
  }
  if (m2 > m || (m2 == m && i2 < i)) i = i2;
  m = mn;
  s = sn;
}

constexpr int BV = 128;         // vocabulary rows (MMA M) per tile
constexpr int BD = 64;          // model-dim chunk per stage (128-byte rows)
constexpr int WARPS = 8;        // consumers: 16 vocabulary rows a warp
constexpr int NTHREADS = WARPS * 32 + 32;   // + one producer warp

template <int NT>               // NT n8 tiles: BT = 8·NT rows of T
struct Geo {
  static constexpr int BT = 8 * NT;                        // the MMA's N
  static constexpr int ST = NT >= 16 ? 5 : NT >= 8 ? 6 : 8;  // ring stages
  static constexpr int W_BYTES = BV * BD * 2;
  static constexpr int H_BYTES = BT * BD * 2;
  static constexpr int STAGE = W_BYTES + H_BYTES;          // 1024-aligned
  static constexpr int RED = ST * STAGE;                   // merge scratch
  static constexpr int BARS = RED + WARPS * BT * 12;
  static constexpr int SMEM = BARS + 2 * ST * 8 + 1024;    // + alignment
};

// byte offset of 16-byte chunk c of row r in a tile of 128-byte rows: the
// 128-byte swizzle of TMA and wgmma (tiles 1024-byte aligned)
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// The plain-load path's 16-byte chunk: n (0..8) contiguous elements from
// src, zeros after, stored at dst
__device__ __forceinline__ void plain_chunk(uint32_t dst, const bf16* src,
                                            int n) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = 2 * i < n ? s[2 * i] : 0u;
    const uint32_t hi = 2 * i + 1 < n ? s[2 * i + 1] : 0u;
    w[i] = lo | (hi << 16);
  }
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3]) : "memory");
}

// Partial (m, idx, s) of T tile blockIdx.y over the vocabulary split
// blockIdx.x. VD: W is the tied [V, D] table, else [D, V]. tw / th: TMA
// maps of W (boxes of 64 x 64 for [D, V], 64 x 128 for [V, D]) and h (64 x
// BT), used when `aligned`.
template <int NT, bool VD>
__global__ void __launch_bounds__(NTHREADS, 1)
logit_partial_kernel_mma(const __grid_constant__ CUtensorMap tw,
                         const __grid_constant__ CUtensorMap th,
                         const bf16* __restrict__ h, const bf16* __restrict__ w,
                         const uint8_t* __restrict__ valid, float* part_m,
                         int* part_i, float* part_s, int Tn, int D, int V,
                         int v_split, int aligned, float softcap) {
  using G = Geo<NT>;
  constexpr int BT = G::BT, ST = G::ST;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int any_valid;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  float* red_m = reinterpret_cast<float*>(smem_raw + (sbase - raw) + G::RED);
  int* red_i = reinterpret_cast<int*>(red_m + WARPS * BT);
  float* red_s = reinterpret_cast<float*>(red_i + WARPS * BT);
  auto full = [&](int s) { return sbase + G::BARS + 8u * s; };
  auto empty = [&](int s) { return sbase + G::BARS + 8u * (ST + s); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, t0 = blockIdx.y * BT;
  const int nt = min(BT, Tn - t0);
  const int v_begin = split * v_split;
  const int v_end = min(V, v_begin + v_split);
  float* out_m = part_m + (size_t)split * Tn + t0;
  int* out_i = part_i + (size_t)split * Tn + t0;
  float* out_s = part_s + (size_t)split * Tn + t0;

  if (tid == 0) {
    any_valid = 0;
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 32);       // the producer warp's lanes (+ TMA bytes)
      mbar_init(empty(s), WARPS);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  for (int i = tid; i < nt; i += NTHREADS)
    if (valid[t0 + i]) any_valid = 1;
  __syncthreads();
  if (!any_valid) {             // an all-padding T tile: skip its V loop
    for (int i = tid; i < nt; i += NTHREADS) {
      out_m[i] = -INFINITY;
      out_i[i] = 0;
      out_s[i] = 0.f;
    }
    return;
  }

  const int nD = (D + BD - 1) / BD;
  const int total = (v_end - v_begin + BV - 1) / BV * nD;

  if (warp == WARPS) {
    // ---- producer warp: stage `it` = W rows [v0, v0 + 128) x D [d0, d0 +
    // 64) and h rows [t0, t0 + BT) x the same D chunk ----
    for (int it = 0; it < total; ++it) {
      const int s = it % ST;
      mbar_wait(empty(s), ((it / ST) & 1) ^ 1);
      const int vt = it / nD, d0 = (it - vt * nD) * BD;
      const int v0 = v_begin + vt * BV;
      const uint32_t sw = sbase + s * G::STAGE, sh = sw + G::W_BYTES;
      if (aligned) {
        if (lane == 0) {
          mbar_arrive_tx(full(s), G::STAGE);
          if (VD) {
            tma_load_3d(sw, &tw, full(s), d0, v0, 0);
          } else {
            tma_load_3d(sw, &tw, full(s), v0, d0, 0);
            tma_load_3d(sw + 8192, &tw, full(s), v0 + 64, d0, 0);
          }
          tma_load_3d(sh, &th, full(s), d0, t0, 0);
        }
      } else {
        // rows not 16-byte aligned: the same tiles by plain loads
        for (int e = lane; e < BV * 8; e += 32) {
          if (VD) {             // [V, D]: rows v, chunks along d
            const int r = e >> 3, c = e & 7, v = v0 + r, d = d0 + 8 * c;
            plain_chunk(sw + swz(r, c), w + (size_t)v * D + d,
                        v < V ? max(0, min(8, D - d)) : 0);
          } else {              // [D, V]: two 64-column halves of rows d
            const int half = e >> 9, k = (e >> 3) & 63, c = e & 7;
            const int d = d0 + k, v = v0 + 64 * half + 8 * c;
            plain_chunk(sw + half * 8192 + swz(k, c), w + (size_t)d * V + v,
                        d < D ? max(0, min(8, V - v)) : 0);
          }
        }
        for (int e = lane; e < BT * 8; e += 32) {
          const int r = e >> 3, c = e & 7, t = t0 + r, d = d0 + 8 * c;
          plain_chunk(sh + swz(r, c), h + (size_t)t * D + d,
                      t < Tn ? max(0, min(8, D - d)) : 0);
        }
        fence_proxy_async();    // generic stores, read by wgmma
      }
      if (!(aligned && lane == 0)) mbar_arrive(full(s));
    }
    return;
  }

  // ---- consumers: warp `warp` owns vocabulary rows 16·warp + g (+8) of a
  // tile and every column 8j + 2q (+1): acc[4j + 2·hh + e] ----
  const int wg = warp >> 2, g = lane >> 2, q = lane & 3;
  float acc[BT / 2];
  // the running (m, idx, s) of column 8j + 2q + e lives in the lane with
  // g = j % 8 of the eight that share the column: rm[j / 8][e]
  constexpr int NS = NT >= 8 ? NT / 8 : 1;
  float rm[NS][2], rs[NS][2];
  int ri[NS][2];
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      rm[j][e] = -INFINITY;
      rs[j][e] = 0.f;
      ri[j][e] = 0;
    }

  for (int it = 0; it < total; ++it) {
    const int s = it % ST;
    const int vt = it / nD, dc = it - vt * nD;
    if (dc == 0) {
#pragma unroll
      for (int i = 0; i < BT / 2; ++i) acc[i] = 0.f;
    }
    mbar_wait(full(s), (it / ST) & 1);
    // acc[64 x BT] += W[this warpgroup's 64 rows] · hᵀ over a 64-wide D
    // chunk: W K-major ([V, D]) or M-major ([D, V]: this warpgroup's rows
    // are the stage's half `wg`), h K-major
    const uint32_t sw = sbase + s * G::STAGE, sh = sw + G::W_BYTES;
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) fence_reg(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BD / 16; ++kk) {
      const uint64_t da =
          VD ? make_desc(sw + wg * 8192 + kk * 32, 16, 1024)
             : make_desc(sw + wg * 8192 + kk * 2048, 8192, 1024);
      wgmma_ss<BT, VD ? 0 : 1>(acc, da, make_desc(sh + kk * 32, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) fence_reg(acc[i]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));

    if (dc == nD - 1) {
      // fold the finished vocabulary tile: (max, lowest argmax) of a column
      // over this thread's two rows, then over the eight lanes of the
      // column (shuffles); Σexp against that max likewise; the owning lane
      // merges it into the running state (earlier tiles hold lower ids)
      const int vb = v_begin + vt * BV + 16 * warp + g;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float z0 = acc[4 * j + e], z1 = acc[4 * j + 2 + e];
          if (softcap != 0.f) {
            z0 = softcap * tanhf(z0 / softcap);
            z1 = softcap * tanhf(z1 / softcap);
          }
          if (vb >= v_end) z0 = -INFINITY;
          if (vb + 8 >= v_end) z1 = -INFINITY;
          float lm = z0;
          int li = vb;
          if (z1 > z0) { lm = z1; li = vb + 8; }
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            const float om = __shfl_xor_sync(0xffffffffu, lm, off);
            const int oi = __shfl_xor_sync(0xffffffffu, li, off);
            if (om > lm || (om == lm && oi < li)) { lm = om; li = oi; }
          }
          float se = lm > -INFINITY ? expf(z0 - lm) + expf(z1 - lm) : 0.f;
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            se += __shfl_xor_sync(0xffffffffu, se, off);
          if ((j & 7) == g)
            merge_max(rm[j >> 3][e], ri[j >> 3][e], rs[j >> 3][e], lm, li,
                      se);
        }
    }
  }

  // the owning lanes' states, then the eight warps
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if ((j & 7) == g) {
        const int col = 8 * j + 2 * q + e;
        red_m[warp * BT + col] = rm[j >> 3][e];
        red_i[warp * BT + col] = ri[j >> 3][e];
        red_s[warp * BT + col] = rs[j >> 3][e];
      }
  named_sync(1, WARPS * 32);    // the consumers only: the producer has left
  for (int c = tid; c < nt; c += WARPS * 32) {
    float m = red_m[c], s = red_s[c];
    int i = red_i[c];
    for (int x = 1; x < WARPS; ++x)
      merge_max(m, i, s, red_m[x * BT + c], red_i[x * BT + c],
                red_s[x * BT + c]);
    out_m[c] = m;
    out_i[c] = i;
    out_s[c] = s;
  }
}

template <int NT, bool VD>
cudaError_t launch(const void* h, const void* w, const uint8_t* valid,
                   float* pm, int* pi, float* ps, int Tn, int D, int V,
                   int v_split, int n_splits, int aligned, float softcap,
                   cudaStream_t s) {
  using G = Geo<NT>;
  CUtensorMap tw, th;
  memset(&tw, 0, sizeof(tw));
  memset(&th, 0, sizeof(th));
  if (aligned) {
    cudaError_t e = VD ? tma_map_3d(&tw, w, D, V, 1, BV)
                       : tma_map_3d(&tw, w, V, D, 1, BD);
    if (e == cudaSuccess) e = tma_map_3d(&th, h, D, Tn, 1, G::BT);
    if (e != cudaSuccess) return e;
  }
  auto kern = logit_partial_kernel_mma<NT, VD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid(n_splits, (Tn + G::BT - 1) / G::BT);
  kern<<<grid, NTHREADS, G::SMEM, s>>>(
      tw, th, static_cast<const bf16*>(h), static_cast<const bf16*>(w), valid,
      pm, pi, ps, Tn, D, V, v_split, aligned, softcap);
  return cudaGetLastError();
}

template <bool VD>
cudaError_t launch_bf16(const void* h, const void* w, const uint8_t* valid,
                        float* pm, int* pi, float* ps, int Tn, int D, int V,
                        int v_split, int n_splits, float softcap,
                        cudaStream_t s) {
  const auto a16 = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int aligned = a16(h) && a16(w) && D % 8 == 0 && (VD || V % 8 == 0);
  const int tt = min(Tn, 128);
#define REPRO_LOGIT_NT(N)                                                   \
  return launch<N, VD>(h, w, valid, pm, pi, ps, Tn, D, V, v_split,          \
                       n_splits, aligned, softcap, s)
  if (tt <= 8) REPRO_LOGIT_NT(1);
  if (tt <= 16) REPRO_LOGIT_NT(2);
  if (tt <= 32) REPRO_LOGIT_NT(4);
  if (tt <= 64) REPRO_LOGIT_NT(8);
  REPRO_LOGIT_NT(16);
#undef REPRO_LOGIT_NT
}

}  // namespace mma

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int BT = 128;         // rows per CTA
constexpr int BV = 128;         // vocabulary columns per tile
constexpr int BD = 64;          // model-dim chunk staged in shared memory
constexpr int NWARP = 8;        // each warp folds 16 rows
constexpr int NTHREADS = NWARP * 32;

struct Layout {
  static constexpr size_t h = 0;
  static constexpr size_t w = repro::align128(h + BT * BD * sizeof(float));
  static constexpr size_t z = repro::align128(w + BD * BV * sizeof(float));
  static constexpr size_t m = repro::align128(z + BT * BV * sizeof(float));
  static constexpr size_t s = repro::align128(m + BT * sizeof(float));
  static constexpr size_t i = repro::align128(s + BT * sizeof(float));
  static constexpr size_t total = repro::align128(i + BT * sizeof(int));
};

// Zs[BT][BV] = h[t0 : t0+BT, :] · W[:, v0 : v0+BV] (rows >= nt and columns
// >= nv read as zero). VD: W is the tied [V, D] table.
template <bool VD>
__device__ __forceinline__ void logits_tile(const float* h, const float* w,
                                            float* Hs, float* Ws, float* Zs,
                                            int t0, int nt, int v0, int nv,
                                            int D, int V, int tid) {
  // 16 x 16 threads, each 8 rows (ty + 16·i) x 8 columns (tx + 16·j)
  const int ty = tid / 16, tx = tid % 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int d0 = 0; d0 < D; d0 += BD) {
    const int nd = min(BD, D - d0);
    for (int i = tid; i < BT * BD; i += NTHREADS) {
      const int r = i / BD, c = i % BD;
      Hs[i] = (r < nt && c < nd) ? h[(size_t)(t0 + r) * D + d0 + c] : 0.f;
    }
    for (int i = tid; i < BD * BV; i += NTHREADS) {
      const int d = i / BV, c = i % BV;   // Ws is [BD][BV] for both layouts
      const bool in = c < nv && d < nd;
      Ws[i] = !in ? 0.f
                  : VD ? w[(size_t)(v0 + c) * D + d0 + d]
                       : w[(size_t)(d0 + d) * V + v0 + c];
    }
    __syncthreads();
    for (int d = 0; d < BD; ++d) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = Hs[(ty + 16 * i) * BD + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Ws[d * BV + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      Zs[(ty + 16 * i) * BV + tx + 16 * j] = acc[i][j];
}

template <bool VD>
__global__ void __launch_bounds__(NTHREADS)
logit_partial_kernel(const float* __restrict__ h, const float* __restrict__ w,
                     const uint8_t* __restrict__ valid, float* part_m,
                     int* part_i, float* part_s, int Tn, int D, int V,
                     int v_split, float softcap) {
  using Lay = Layout;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int any_valid;
  float* Hs = reinterpret_cast<float*>(smem + Lay::h);
  float* Ws = reinterpret_cast<float*>(smem + Lay::w);
  float* Zs = reinterpret_cast<float*>(smem + Lay::z);
  float* run_m = reinterpret_cast<float*>(smem + Lay::m);
  float* run_s = reinterpret_cast<float*>(smem + Lay::s);
  int* run_i = reinterpret_cast<int*>(smem + Lay::i);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, t0 = blockIdx.y * BT;
  const int nt = min(BT, Tn - t0);
  const int v_begin = split * v_split;
  const int v_end = min(V, v_begin + v_split);
  float* out_m = part_m + (size_t)split * Tn + t0;
  int* out_i = part_i + (size_t)split * Tn + t0;
  float* out_s = part_s + (size_t)split * Tn + t0;

  if (tid == 0) any_valid = 0;
  __syncthreads();
  for (int i = tid; i < nt; i += NTHREADS)
    if (valid[t0 + i]) any_valid = 1;
  __syncthreads();
  if (!any_valid) {             // an all-padding T tile: skip its V loop
    for (int i = tid; i < nt; i += NTHREADS) {
      out_m[i] = -INFINITY;
      out_i[i] = 0;
      out_s[i] = 0.f;
    }
    return;
  }
  for (int i = tid; i < BT; i += NTHREADS) {
    run_m[i] = -INFINITY;
    run_s[i] = 0.f;
    run_i[i] = 0;
  }
  for (int v0 = v_begin; v0 < v_end; v0 += BV) {
    const int nv = min(BV, v_end - v0);
    logits_tile<VD>(h, w, Hs, Ws, Zs, t0, nt, v0, nv, D, V, tid);
    __syncthreads();
    // warp w folds rows [16w, 16w + 16); lane l holds columns l + 32·j
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      float z[BV / 32];
      float lm = -INFINITY;
      int li = 0;
#pragma unroll
      for (int j = 0; j < BV / 32; ++j) {
        const int c = lane + 32 * j;
        float zz = Zs[r * BV + c];
        if (softcap != 0.f) zz = softcap * tanhf(zz / softcap);
        if (c >= nv) zz = -INFINITY;
        z[j] = zz;
        if (zz > lm) { lm = zz; li = c; }     // ascending c: lowest wins
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float om = __shfl_xor_sync(0xffffffffu, lm, off);
        const int oi = __shfl_xor_sync(0xffffffffu, li, off);
        if (om > lm || (om == lm && oi < li)) { lm = om; li = oi; }
      }
      const float m_old = run_m[r];
      const float m_new = fmaxf(m_old, lm);
      float se = 0.f;
#pragma unroll
      for (int j = 0; j < BV / 32; ++j) se += expf(z[j] - m_new);
      se = repro::warp_sum(se);
      if (lane == 0) {
        run_s[r] = run_s[r] * expf(m_old - m_new) + se;
        if (lm > m_old) run_i[r] = v0 + li;
        run_m[r] = m_new;
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < nt; i += NTHREADS) {
    out_m[i] = run_m[i];
    out_i[i] = run_i[i];
    out_s[i] = run_s[i];
  }
}

template <bool VD>
cudaError_t launch(const void* h, const void* w, const uint8_t* valid,
                   float* pm, int* pi, float* ps, int Tn, int D, int V,
                   int v_split, int n_splits, float softcap, cudaStream_t s) {
  const size_t smem = Layout::total;
  auto kern = logit_partial_kernel<VD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(n_splits, (Tn + BT - 1) / BT);
  kern<<<grid, NTHREADS, smem, s>>>(static_cast<const float*>(h),
                                    static_cast<const float*>(w), valid, pm,
                                    pi, ps, Tn, D, V, v_split, softcap);
  return cudaGetLastError();
}

}  // namespace f32

__global__ void logit_merge_kernel(const float* __restrict__ part_m,
                                   const int* __restrict__ part_i,
                                   const float* __restrict__ part_s,
                                   int* idx, float* m, float* s, int Tn,
                                   int n_splits) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Tn) return;
  float best = -INFINITY;
  int bi = 0;
  for (int i = 0; i < n_splits; ++i) {
    const float mi = part_m[(size_t)i * Tn + t];
    if (mi > best) { best = mi; bi = part_i[(size_t)i * Tn + t]; }
  }
  float acc = 0.f;
  if (best > -INFINITY) {
    for (int i = 0; i < n_splits; ++i) {
      const float mi = part_m[(size_t)i * Tn + t];
      if (mi > -INFINITY) acc += part_s[(size_t)i * Tn + t] * expf(mi - best);
    }
  }
  idx[t] = bi;
  m[t] = best;
  s[t] = acc;
}

}  // namespace

extern "C" int repro_logit_argmax(const void* h, const void* w,
                                  const void* valid, void* part_m,
                                  void* part_i, void* part_s, void* idx,
                                  void* m, void* s, int Tn, int D, int V,
                                  int v_split, int n_splits, int w_layout_vd,
                                  int dtype, float softcap, void* stream) {
  const uint8_t* vd = static_cast<const uint8_t*>(valid);
  float* pm = static_cast<float*>(part_m);
  int* pi = static_cast<int*>(part_i);
  float* ps = static_cast<float*>(part_s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == repro::kBF16)
    e = w_layout_vd ? mma::launch_bf16<true>(h, w, vd, pm, pi, ps, Tn, D, V, v_split, n_splits, softcap, st)
                    : mma::launch_bf16<false>(h, w, vd, pm, pi, ps, Tn, D, V, v_split, n_splits, softcap, st);
  else if (dtype == repro::kF32)
    e = w_layout_vd ? f32::launch<true>(h, w, vd, pm, pi, ps, Tn, D, V, v_split, n_splits, softcap, st)
                    : f32::launch<false>(h, w, vd, pm, pi, ps, Tn, D, V, v_split, n_splits, softcap, st);
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  logit_merge_kernel<<<(Tn + 255) / 256, 256, 0, st>>>(
      pm, pi, ps, static_cast<int*>(idx), static_cast<float*>(m),
      static_cast<float*>(s), Tn, n_splits);
  return (int)cudaGetLastError();
}
