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
// side the weight exp(-1e30 - m) = 0.
//
// What bounds it on an H100: at llada-8b's padded Reuse (B = 16 requests,
// K = 32, R = Sb = 8 rows, T = 128 to 248 retained keys, dh = 128) the work
// is 4·B·K·R·T·dh ~ 0.5 GFLOP against ~65 MB of bf16 K/V: ~8 operations
// per byte, memory-bound. Design: one CTA per (request, KV head,
// tile of 64 query rows) of attn_tile.cuh's tile; the KV loop runs inside
// the CTA (the Pallas kernel's sequential grid axis) and its last tile is
// ragged, so T need not divide 64. Keys past T take the logit -inf, not
// -1e30, so they never enter s. Each lane reads its mask bytes straight
// from device memory (32 neighbouring bytes a warp). A first, simple
// kernel: with R = 8 rows, 56 of the tile's 64 rows are zero padding.

#include "attn_tile.cuh"

using repro::bf16;
using namespace repro::attn;

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

template <typename T, int DH>
__global__ void __launch_bounds__(NTHREADS)
packed_attention_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tile<T, DH> t(smem);
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
    scores<T, DH>(t.Qs, t.Ks, t.Ss, warp, tid);
    __syncthreads();
    softmax_tile<T>(t.Ss, t.Ps, t.row_m, t.row_l, t.row_a, p.scale, p.softcap,
                    warp, lane, [&](int r, int c, float zz) {
      if (c >= nk) return -INFINITY;
      const int mr = row_mask[r];
      if (mr < 0) return -1e30f;            // padding row: never written
      return mask[(size_t)mr * p.T + kv0 + c] ? zz : -1e30f;
    });
    __syncthreads();
    accumulate_pv<T, DH>(t.Ps, t.Vs, t.Os, t.row_a, t.scratch, warp, lane,
                         tid);
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
  if (dtype == repro::kBF16) e = dispatch_dh<Launch, bf16>(dh, p, B * K, st);
  else if (dtype == repro::kF32) e = dispatch_dh<Launch, float>(dh, p, B * K, st);
  else e = cudaErrorInvalidValue;
  return (int)e;
}
