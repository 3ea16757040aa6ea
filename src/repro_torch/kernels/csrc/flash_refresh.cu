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
// (0.14 ms at 989 TFLOP/s), which only wgmma reaches.
//
// bfloat16 runs on the Hopper tile of attn_sm90.cuh: one CTA per (request,
// KV head, 128 query rows), a producer warp streaming K and V through a
// four-stage TMA/mbarrier ring, two consumer warpgroups computing Q·Kᵀ and
// P·V with wgmma, the scores, the mask and the online softmax in registers,
// the P·V of one KV tile overlapping the softmax of the next.
// The first version of this kernel (WMMA 16x16x16 on a 64-row tile) lost
// its time in two places, and the design removes both: K and V were staged
// element by element with no second buffer (now TMA into a ring, so the
// next tiles load while this one computes), and every score, probability
// and output element went through shared memory with a row-serial softmax
// (now register fragments, quad shuffles and one normalisation).
// float32 inputs (a parity path on the card: reduced configs, TF32 off)
// stay on attn_tile.cuh's tile, dispatched by dtype below.
// Every CTA's key window is the whole stream, [0, S): keys past S take the
// logit -inf, so a ragged last tile never enters Σp; no KV tile is skipped
// (positions are data, not known to ascend).

#include "attn_sm90.cuh"
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
  constexpr int BK = kv_tile<DH>();
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
    scores<T, DH>(t.Qs, t.Ks, t.Ss, tid);
    __syncthreads();
    softmax_tile<BK>(t.Ss, t.Ps, t.row_m, t.row_l, t.row_a, p.scale, p.softcap,
                    warp, lane, [&](int r, int c, float zz) {
      if (c >= nk) return -INFINITY;
      bool ok = key_ok[c];
      if (p.causal) ok = ok && row_pos[r] >= key_pos[c];
      if (p.window && p.is_local)
        ok = ok && abs(row_pos[r] - key_pos[c]) <= p.window;
      return ok ? zz : -1e30f;
    });
    __syncthreads();
    accumulate_pv<T, DH>(t.Ps, t.Vs, t.Os, t.row_a, tid);
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

// ---- bfloat16: the Hopper tile ----

// The problem of attn_sm90.cuh: stream bh = b·K + head; a key's datum is
// its position, its validity kv_valid; a row's datum its token's position.
struct RefreshProb {
  using Key = int;
  using Row = int;
  float scale, softcap;
  int rows, keys;               // RG, S
  const int* q_pos;             // [B, Sq]
  const int* kv_pos;            // [B, S]
  const uint8_t* kv_valid;      // [B, S]
  int K, G, Sq, causal, window, is_local;

  __device__ int2 key_window(const repro::sm90::Job&, int) const {
    return make_int2(0, keys);
  }
  __device__ int key_datum(int bh, int key) const {
    return kv_pos[(size_t)(bh / K) * keys + key];
  }
  __device__ bool key_valid(int bh, int key) const {
    return kv_valid[(size_t)(bh / K) * keys + key];
  }
  __device__ int row_info(int bh, int row) const {
    return row < rows ? q_pos[(size_t)(bh / K) * Sq + row / G] : 0;
  }
  __device__ bool row_mask() const { return causal || (window && is_local); }
  __device__ bool keep(int pos, int key_pos) const {
    bool ok = !causal || pos >= key_pos;
    if (window && is_local) ok = ok && abs(pos - key_pos) <= window;
    return ok;
  }
};

// One CTA: 128 rows of stream (b, head) against all S keys, normalised, in
// output columns [128·(x % DS), + 128) (DS = 2 at dh 256, else 1).
template <int DH>
__global__ void __launch_bounds__(repro::sm90::NTHREADS, 1)
refresh_attention_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const RefreshProb p, float* o) {
  using L = repro::sm90::Smem<DH, RefreshProb::Key>;
  repro::sm90::Job job;
  job.bh = blockIdx.z * p.K + blockIdx.y;
  job.row0 = blockIdx.x / L::DSPLIT * repro::sm90::BM;
  job.col0 = blockIdx.x % L::DSPLIT * L::NPV;
  job.rows = p.rows;
  job.o = o + (size_t)job.bh * p.rows * DH;
  job.ml = nullptr;
  repro::sm90::attention_cta<DH>(&tq, &tk, &tv, p, job);
}

template <typename T, int DH>
struct LaunchSm90 {
  static cudaError_t run(const Params& p, int B, cudaStream_t s) {
    namespace H = repro::sm90;
    CUtensorMap tq, tk, tv;
    cudaError_t e = H::tma_map_3d(&tq, p.q, DH, p.RG, B * p.K, H::BM);
    if (e == cudaSuccess) e = H::tma_map_3d(&tk, p.k, DH, p.S, B * p.K, H::BK);
    if (e == cudaSuccess) e = H::tma_map_3d(&tv, p.v, DH, p.S, B * p.K, H::BK);
    if (e != cudaSuccess) return e;
    RefreshProb r;
    r.rows = p.RG; r.keys = p.S; r.scale = p.scale; r.softcap = p.softcap;
    r.q_pos = p.q_pos; r.kv_pos = p.kv_pos;
    r.kv_valid = p.kv_valid; r.K = p.K; r.G = p.G; r.Sq = p.Sq;
    r.causal = p.causal; r.window = p.window; r.is_local = p.is_local;
    using L = H::Smem<DH, RefreshProb::Key>;
    auto kern = refresh_attention_kernel_sm90<DH>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::total);
    if (e != cudaSuccess) return e;
    kern<<<dim3((p.RG + H::BM - 1) / H::BM * L::DSPLIT, p.K, B), H::NTHREADS,
           L::total, s>>>(tq, tk, tv, r, p.o);
    return cudaGetLastError();
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
  if (dtype == repro::kBF16) e = dispatch_dh<LaunchSm90, bf16>(dh, p, B, st);
  else if (dtype == repro::kF32) e = dispatch_dh<Launch, float>(dh, p, B, st);
  else e = cudaErrorInvalidValue;
  return (int)e;
}
