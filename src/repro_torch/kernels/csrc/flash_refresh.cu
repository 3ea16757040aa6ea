// Padded full-sequence flash attention (the Refresh phase's prefill).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_refresh.py
// flash_refresh_call (_kernel):
//   q      [B, K, Sq·G, dh]  token-major GQA rows (row = t·G + g)
//   k, v   [B, K, S, dh]
//   q_pos  [B, Sq], kv_pos [B, S] int32; kv_valid [B, S] bool
//   out    [B, K, Sq·G, dh] float32, normalised by max(Σp, 1e-30)
// A query attends to a key iff the key is valid and the optional causal
// (q_pos >= kv_pos) and window (|q_pos - kv_pos| <= window on is_local
// layers) tests pass; masked logits are -1e30, so a row with no valid key
// averages V, as the Pallas kernel and the jnp layers.attention do.
//
// What bounds it on an H100: at a padded llada-8b prefill (B = 2, S = 2048,
// K = H = 32, dh = 128) the work is 4·B·H·S²·dh ~ 137 GFLOP against
// ~168 MB of bf16 q/k/v and float32 o: ~800 operations per byte, above the
// ~295 where the tensor cores become the limit — bound by operations
// (0.14 ms at 989 TFLOP/s). Design: one CTA per (request, KV head, tile of 64 query rows)
// of attn_tile.cuh's tile, the online softmax carried across the KV tiles
// inside the CTA and the output normalised once at the end; keys past S
// take the logit -inf so a ragged last tile never enters Σp. A first,
// simple kernel: WMMA tiles, no TMA, wgmma or double buffering, and no
// causal tile skip (positions are data, not known to ascend).

#include "attn_tile.cuh"

using repro::bf16;
using namespace repro::attn;

namespace {

struct Params {
  const void* q;                // [B, K, RG, dh]
  const void* k;                // [B, K, S, dh]
  const void* v;                // [B, K, S, dh]
  float* o;                     // [B, K, RG, dh]
  const int* q_pos;             // [B, Sq]
  const int* kv_pos;            // [B, S]
  const uint8_t* kv_valid;      // [B, S]
  int K, RG, G, Sq, S;
  float scale, softcap;
  int causal, window, is_local;
};

template <typename T, int DH>
__global__ void __launch_bounds__(NTHREADS)
refresh_attention_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tile<T, DH> t(smem);
  int* row_pos = t.row_i0;
  int* key_pos = t.key_i0;
  int* key_ok = t.key_i1;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, head = blockIdx.y;
  const int row0 = blockIdx.x * BQ;
  const int nrows = min(BQ, p.RG - row0);
  const size_t bh = (size_t)b * p.K + head;
  const T* q = static_cast<const T*>(p.q) + (bh * p.RG + row0) * DH;
  const T* k = static_cast<const T*>(p.k) + bh * p.S * DH;
  const T* v = static_cast<const T*>(p.v) + bh * p.S * DH;
  const int* q_pos = p.q_pos + (size_t)b * p.Sq;
  const int* kv_pos = p.kv_pos + (size_t)b * p.S;
  const uint8_t* kv_valid = p.kv_valid + (size_t)b * p.S;

  for (int i = tid; i < BQ; i += NTHREADS)
    row_pos[i] = i < nrows ? q_pos[(row0 + i) / p.G] : 0;
  init_rows<T, DH>(t, q, nrows, tid);
  __syncthreads();

  for (int kv0 = 0; kv0 < p.S; kv0 += BK) {
    const int nk = min(BK, p.S - kv0);
    load_kv<T, DH>(t, k, v, kv0, nk, tid);
    for (int j = tid; j < BK; j += NTHREADS) {
      const bool in = j < nk;
      key_pos[j] = in ? kv_pos[kv0 + j] : 0;
      key_ok[j] = in ? (int)kv_valid[kv0 + j] : 0;
    }
    __syncthreads();
    scores<T, DH>(t.Qs, t.Ks, t.Ss, warp, tid);
    __syncthreads();
    softmax_tile<T>(t.Ss, t.Ps, t.row_m, t.row_l, t.row_a, p.scale, p.softcap,
                    warp, lane, [&](int r, int c, float zz) {
      if (c >= nk) return -INFINITY;
      bool ok = key_ok[c];
      if (p.causal) ok = ok && row_pos[r] >= key_pos[c];
      if (p.window && p.is_local)
        ok = ok && abs(row_pos[r] - key_pos[c]) <= p.window;
      return ok ? zz : -1e30f;
    });
    __syncthreads();
    accumulate_pv<T, DH>(t.Ps, t.Vs, t.Os, t.row_a, t.scratch, warp, lane,
                         tid);
    __syncthreads();
  }

  float* o = p.o + (bh * p.RG + row0) * DH;
  for (int i = tid; i < nrows * DH; i += NTHREADS)
    o[i] = t.Os[i] / fmaxf(t.row_l[i / DH], 1e-30f);
}

template <typename T, int DH>
struct Launch {
  static cudaError_t run(const Params& p, int B, cudaStream_t s) {
    return launch_tile<T, DH>(refresh_attention_kernel<T, DH>,
                              dim3((p.RG + BQ - 1) / BQ, p.K, B), p, s);
  }
};

}  // namespace

extern "C" int repro_flash_refresh(
    const void* q, const void* k, const void* v, void* o, const void* q_pos,
    const void* kv_pos, const void* kv_valid, int B, int K, int RG, int Sq,
    int S, int dh, int dtype, float scale, float softcap, int causal,
    int window, int is_local, void* stream) {
  if (Sq <= 0 || RG % Sq != 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = static_cast<float*>(o);
  p.q_pos = static_cast<const int*>(q_pos);
  p.kv_pos = static_cast<const int*>(kv_pos);
  p.kv_valid = static_cast<const uint8_t*>(kv_valid);
  p.K = K; p.RG = RG; p.G = RG / Sq; p.Sq = Sq; p.S = S;
  p.scale = scale; p.softcap = softcap;
  p.causal = causal; p.window = window; p.is_local = is_local;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == repro::kBF16) e = dispatch_dh<Launch, bf16>(dh, p, B, st);
  else if (dtype == repro::kF32) e = dispatch_dh<Launch, float>(dh, p, B, st);
  else e = cudaErrorInvalidValue;
  return (int)e;
}
