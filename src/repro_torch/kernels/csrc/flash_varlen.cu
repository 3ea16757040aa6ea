// Segment-masked varlen flash attention over token-packed streams.
//
// Replaces the Pallas TPU kernels src/repro/kernels/flash_varlen.py
// flash_varlen_call (_kernel) and flash_varlen_cross_call (_cross_kernel).
// One kernel serves both: self-attention is the cross case whose KV stream
// is the query stream, with kv_head_stride = 0 so every KV head reads the
// same positions and validity.
//
// What bounds it on an H100: at the serving shapes (llada-8b: K = H = 32,
// dh = 128, a few segments of a few hundred tokens per stream) the work is
// 4·Σ Sᵢ²·H·dh operations against the q/k/v/o bytes, a few operations per
// byte — memory-bound, far below the ~295 op/byte where the tensor cores
// become the limit. What a kernel must do is read K and V once, with every
// SM busy. Design:
//  * bfloat16 runs on the Hopper tile of attn_sm90.cuh (a producer warp
//    streaming K and V through a four-stage TMA/mbarrier ring, Q·Kᵀ and P·V
//    by wgmma, the mask and the online softmax in registers): one CTA per
//    (tile of 128 query rows, KV head, split). The rows are token-major GQA
//    rows (row = t·G + g), so a tile holds 128/G tokens of the G query heads
//    of one KV head and each K/V tile is read once for all of them;
//  * streams are segment-ascending, so the producer warp of a CTA searches
//    kv_seg for the first key of its first row's segment and the end of its
//    last row's (a half warp each, 16 probes a round, while Q loads) and
//    the tile visits only that window:
//    attention work follows Σ Sᵢ², not T². A key carries its segment
//    beside its validity, a row its segment (-2 past the rows, a segment
//    no key has), and the mask is valid ∧ same segment: one compare a
//    score. With a causal or window mask both also carry their position;
//    each mask is its own instantiation, so no score tests a flag;
//  * split-KV: where row tiles × K leave the card under-filled (the packed
//    Reuse: R·Sb·G rows, one row tile whose window spans every request's
//    keys), the host asks for `splits` CTAs per row tile; split s takes its
//    even share of the window's BK-key tiles and writes the unnormalised
//    partial (o, max, Σp) to a float32 workspace, and varlen_merge_kernel
//    folds the splits by the (max, rescaled Σ) law. An empty share (or an
//    empty window: a tile of padding rows in a cross stream with no PAD_SEG
//    keys) gives the partial (0, -inf, 0); a row whose every split is empty
//    merges to 0, as one split's 0 / max(0, 1e-30);
//  * masked logits are -1e30 (never -inf) and the output is divided by
//    max(Σp, 1e-30), as in the Pallas kernel; ragged edges are masked here,
//    so neither stream length needs to divide a tile.
// float32 inputs (a parity path on the card: reduced configs, TF32 off) run
// on attn_tile.cuh's tile (products on the CUDA cores in float32, one CTA
// per 64 rows, no split), dispatched by dtype in repro_flash_varlen.
//
// repro_flash_varlen_pool is the packed Reuse's cross attention read in
// place: the same function as the cross kernel over the stream [pool row
// slots[r] ; block r] of each segment r, with no such stream built. Its
// keys come from two tensors as they lie: layer l's slot pool (k/v [S1, K,
// Cr, dh], pos/valid [S1, K, Cr]) at the segment's row, and the live
// block's K/V as the projection wrote them, token-major [R·Sb, K, dh]
// (segment r is tokens [r·Sb, (r+1)·Sb), valid, at the queries' positions).
// Each segment is a fixed run of tiles, ceil(Cr / BK) of its pool row and
// then ceil(Sb / BK) of its block, so no tile straddles two sources: a row
// tile's window is the tile runs of its first through its last segment,
// with no search, and split-KV cuts that tile list evenly. On the Hopper
// tile pool tiles load through a 3-d map (dh, Cr, S1·K) at (slot·K + head)
// and block tiles through a 3-d map (dh, K, R·Sb) over the strided heads;
// the producer warp reads the slot index and the keys' positions and
// validity beside the TMA. Keys past a tile's source (Cr or Sb) get a
// -inf bias, so the ragged ends need no alignment. The maps hold the
// pool's fixed addresses, which a captured graph replays.

#include "attn_sm90.cuh"
#include "attn_tile.cuh"

using repro::bf16;
using namespace repro::attn;

namespace {

struct Params {
  const void* q;                // [K, RG, dh]
  const void* k;                // [K, Tkv, dh]
  const void* v;                // [K, Tkv, dh]
  float* o;                     // [K, RG, dh]
  const int* q_pos;             // [Tq]
  const int* q_seg;             // [Tq]
  const int* kv_pos;            // [K, Tkv] (head stride kv_head_stride)
  const int* kv_seg;            // [Tkv]
  const uint8_t* kv_valid;      // [K, Tkv] (head stride kv_head_stride)
  int RG, G, Tq, Tkv, kv_head_stride;
  float scale, softcap;
  int causal, window, is_local;
};

// ---- float32: attn_tile.cuh ----

template <typename T, int DH>
__global__ void __launch_bounds__(NTHREADS)
varlen_attention_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tile<T, DH> t(smem);
  constexpr int BK = kv_tile<DH>();
  int* row_pos = t.row_i0;
  int* row_seg = t.row_i1;
  int* key_pos = t.key_i0;
  int* key_seg = t.key_i1;
  int* key_ok = t.key_i2;
  int* range = t.extra;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int head = blockIdx.y;
  const int row0 = blockIdx.x * BQ;
  const int nrows = min(BQ, p.RG - row0);
  const T* q = static_cast<const T*>(p.q) + ((size_t)head * p.RG + row0) * DH;
  const T* k = static_cast<const T*>(p.k) + (size_t)head * p.Tkv * DH;
  const T* v = static_cast<const T*>(p.v) + (size_t)head * p.Tkv * DH;
  const int* kv_pos = p.kv_pos + (size_t)head * p.kv_head_stride;
  const uint8_t* kv_valid = p.kv_valid + (size_t)head * p.kv_head_stride;

  for (int i = tid; i < BQ; i += NTHREADS) {
    if (i < nrows) {
      const int tq = (row0 + i) / p.G;
      row_pos[i] = p.q_pos[tq];
      row_seg[i] = p.q_seg[tq];
    } else {
      row_pos[i] = 0;
      row_seg[i] = -2;          // matches no key (keys carry >= -1)
    }
  }
  init_rows<T, DH>(t, q, nrows, tid);
  if (tid == 0) {
    // segment-ascending streams: only keys whose segment lies in this
    // tile's segment range can be unmasked for any of its rows
    const int s_lo = p.q_seg[row0 / p.G];
    const int s_hi = p.q_seg[(row0 + nrows - 1) / p.G];
    range[0] = repro::lower_bound_i32(p.kv_seg, p.Tkv, s_lo);
    range[1] = repro::upper_bound_i32(p.kv_seg, p.Tkv, s_hi);
  }
  __syncthreads();
  const int kv_lo = range[0], kv_hi = range[1];

  for (int kv0 = kv_lo; kv0 < kv_hi; kv0 += BK) {
    const int nk = min(BK, kv_hi - kv0);
    load_kv<T, DH>(t, k, v, kv0, nk, tid);
    for (int j = tid; j < BK; j += NTHREADS) {
      const bool in = j < nk;
      key_pos[j] = in ? kv_pos[kv0 + j] : 0;
      key_seg[j] = in ? p.kv_seg[kv0 + j] : -1;
      key_ok[j] = in ? (int)kv_valid[kv0 + j] : 0;
    }
    __syncthreads();
    scores<T, DH>(t.Qs, t.Ks, t.Ss, tid);
    __syncthreads();
    softmax_tile<BK>(t.Ss, t.Ps, t.row_m, t.row_l, t.row_a, p.scale, p.softcap,
                    warp, lane, [&](int r, int c, float zz) {
      bool ok = key_ok[c] && key_seg[c] == row_seg[r];
      if (p.causal) ok = ok && row_pos[r] >= key_pos[c];
      if (p.window && p.is_local)
        ok = ok && abs(row_pos[r] - key_pos[c]) <= p.window;
      return ok ? zz : -1e30f;
    });
    __syncthreads();
    accumulate_pv<T, DH>(t.Ps, t.Vs, t.Os, t.row_a, tid);
    __syncthreads();
  }

  float* o = p.o + ((size_t)head * p.RG + row0) * DH;
  for (int i = tid; i < nrows * DH; i += NTHREADS)
    o[i] = t.Os[i] / fmaxf(t.row_l[i / DH], 1e-30f);
}

template <typename T, int DH>
struct Launch {
  static cudaError_t run(const Params& p, int K, int, float*, cudaStream_t s) {
    return launch_tile<T, DH>(varlen_attention_kernel<T, DH>,
                              dim3((p.RG + BQ - 1) / BQ, K), p, s);
  }
};

// ---- bfloat16: the Hopper tile ----

// In each half of a warp, the first i in [0, n) with a[i] >= x (lanes
// 0-15: lower bound) or a[i] > x (lanes 16-31: upper bound), a ascending;
// n if none. 16 probes a round, each half on its own x; every lane returns
// its half's answer.
__device__ int half_warp_bounds(const int* a, int n, int x, int lane) {
  const bool upper = lane >= 16;
  const unsigned mask = upper ? 0xffff0000u : 0x0000ffffu;
  int lo = 0, hi = n;           // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 15) / 16;
    const int i = lo + (lane & 15) * step;
    bool t = i >= hi;
    if (!t) t = upper ? a[i] > x : a[i] >= x;
    const unsigned b = (__ballot_sync(mask, t) >> (lane & 16)) & 0xffffu;
    if (b == 0) {
      lo += 15 * step + 1;
    } else {
      const int f = __ffs(b) - 1;
      hi = f == 0 ? lo : min(hi, lo + f * step);
      if (f > 0) lo += (f - 1) * step + 1;
    }
  }
  return lo;
}

// The mask's terms, fixed at compile time: SEG (valid ∧ same segment),
// CAUSAL (∧ q_pos >= kv_pos), ANY (the causal and window terms as the
// runtime flags ask).
enum { SEG = 0, CAUSAL = 1, ANY = 2 };

// The problem of attn_sm90.cuh: stream = KV head; a key's datum is its
// segment, a row's its token's segment, and the SEG mask is one compare a
// score; otherwise both carry (segment, position).
template <int MASK>
struct VarlenProb {
  static constexpr bool POS = MASK != SEG;
  using Key = typename std::conditional<POS, int2, int>::type;
  using Row = Key;
  float scale, softcap;
  const int* q_pos;
  const int* q_seg;
  const int* kv_pos;
  const int* kv_seg;
  const uint8_t* kv_valid;
  int RG, G, Tkv, kv_head_stride, causal, window, is_local, splits;

  // Segment-ascending streams: the keys of the segments from the tile's
  // first row's to its last's, then split blockIdx.z's even share of that
  // window's BK-key tiles.
  __device__ int2 key_window(const repro::sm90::Job& job, int lane) const {
    namespace H = repro::sm90;
    const int last = min(job.row0 + H::BM, RG) - 1;
    const int e = half_warp_bounds(
        kv_seg, Tkv, q_seg[(lane < 16 ? job.row0 : last) / G], lane);
    const int lo = __shfl_sync(0xffffffffu, e, 0);
    const int hi = __shfl_sync(0xffffffffu, e, 16);
    const int nt = hi > lo ? (hi - lo + H::BK - 1) / H::BK : 0;
    const int z = blockIdx.z;
    const int t0 = z * nt / splits, t1 = (z + 1) * nt / splits;
    return make_int2(lo + t0 * H::BK, min(hi, lo + t1 * H::BK));
  }

  __device__ Key key_datum(int head, int key) const {
    if constexpr (POS)
      return make_int2(kv_seg[key],
                       kv_pos[(size_t)head * kv_head_stride + key]);
    else
      return kv_seg[key];
  }
  __device__ bool key_valid(int head, int key) const {
    return kv_valid[(size_t)head * kv_head_stride + key];
  }
  __device__ Row row_info(int, int row) const {
    Row r{};
    if constexpr (POS) {
      r = make_int2(-2, 0);         // past the rows: a segment no key has
      if (row < RG) r = make_int2(q_seg[row / G], q_pos[row / G]);
    } else {
      r = row < RG ? q_seg[row / G] : -2;
    }
    return r;
  }
  __device__ bool row_mask() const { return true; }
  __device__ bool keep(Row r, Key k) const {
    if constexpr (MASK == SEG) {
      return r == k;
    } else if constexpr (MASK == CAUSAL) {
      return r.x == k.x && r.y >= k.y;
    } else {
      bool ok = r.x == k.x;
      if (causal) ok = ok && r.y >= k.y;
      if (window && is_local) ok = ok && abs(r.y - k.y) <= window;
      return ok;
    }
  }
};

// One CTA: rows [128·(x / DS), + 128) of KV head y, output columns
// [128·(x % DS), + 128) (DS = 2 at dh 256, else 1), split z of p.splits.
template <int DH, int MASK>
__global__ void __launch_bounds__(repro::sm90::NTHREADS, 1)
varlen_attention_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const VarlenProb<MASK> p, float* o,
                             float* part) {
  using L = repro::sm90::Smem<DH, typename VarlenProb<MASK>::Key>;
  repro::sm90::Job job;
  job.bh = blockIdx.y;
  job.row0 = blockIdx.x / L::DSPLIT * repro::sm90::BM;
  job.col0 = blockIdx.x % L::DSPLIT * L::NPV;
  job.rows = p.RG;
  const size_t stream = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  if (p.splits == 1) {
    job.o = o + stream * p.RG * DH;
    job.ml = nullptr;
  } else {
    job.o = part + stream * p.RG * DH;
    job.ml = part + (size_t)p.splits * gridDim.y * p.RG * DH +
             stream * p.RG * 2;
  }
  repro::sm90::attention_cta<DH>(&tq, &tk, &tv, p, job);
}

// Fold the splits' partials of each of `rows` (head, row) pairs: with
// M = max of the splits' maxima (log2 units), o = Σ oₛ·2^(mₛ−M) /
// max(Σ Σpₛ·2^(mₛ−M), 1e-30); M = -inf (every split empty) gives 0. One
// warp a row, lanes over the columns (dh <= 256).
__global__ void __launch_bounds__(256)
varlen_merge_kernel(const float* part, float* o, int rows, int dh,
                    int splits) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float2* ml =
      reinterpret_cast<const float2*>(part + (size_t)splits * rows * dh);
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, ml[(size_t)s * rows + row].x);
  float acc[8] = {}, den = 0.f;
  if (m != -INFINITY) {
    for (int s = 0; s < splits; ++s) {
      const float2 x = ml[(size_t)s * rows + row];
      const float w = exp2f(x.x - m);
      den += x.y * w;
      const float* ps = part + ((size_t)s * rows + row) * dh;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (lane + 32 * c < dh) acc[c] += w * ps[lane + 32 * c];
    }
  }
  const float inv = 1.f / fmaxf(den, 1e-30f);
#pragma unroll
  for (int c = 0; c < 8; ++c)
    if (lane + 32 * c < dh) o[(size_t)row * dh + lane + 32 * c] = acc[c] * inv;
}

template <int DH, int MASK>
cudaError_t launch_sm90(const Params& p, int K, int splits, float* ws,
                        cudaStream_t s) {
  namespace H = repro::sm90;
  CUtensorMap tq, tk, tv;
  cudaError_t e = H::tma_map_3d(&tq, p.q, DH, p.RG, K, H::BM);
  if (e == cudaSuccess) e = H::tma_map_3d(&tk, p.k, DH, p.Tkv, K, H::BK);
  if (e == cudaSuccess) e = H::tma_map_3d(&tv, p.v, DH, p.Tkv, K, H::BK);
  if (e != cudaSuccess) return e;
  VarlenProb<MASK> r;
  r.scale = p.scale; r.softcap = p.softcap;
  r.q_pos = p.q_pos; r.q_seg = p.q_seg; r.kv_pos = p.kv_pos;
  r.kv_seg = p.kv_seg; r.kv_valid = p.kv_valid;
  r.RG = p.RG; r.G = p.G; r.Tkv = p.Tkv;
  r.kv_head_stride = p.kv_head_stride; r.splits = splits;
  r.causal = p.causal; r.window = p.window; r.is_local = p.is_local;
  using L = H::Smem<DH, typename VarlenProb<MASK>::Key>;
  auto kern = varlen_attention_kernel_sm90<DH, MASK>;
  static unsigned smem_set = 0;
  e = H::allow_dynamic_smem(kern, L::total, &smem_set);
  if (e != cudaSuccess) return e;
  kern<<<dim3((p.RG + H::BM - 1) / H::BM * L::DSPLIT, K, splits),
         H::NTHREADS, L::total, s>>>(tq, tk, tv, r, p.o, ws);
  return cudaGetLastError();
}

template <typename T, int DH>
struct LaunchSm90 {
  static cudaError_t run(const Params& p, int K, int splits, float* ws,
                         cudaStream_t s) {
    const bool win = p.window && p.is_local;
    cudaError_t e =
        win ? launch_sm90<DH, ANY>(p, K, splits, ws, s)
        : p.causal ? launch_sm90<DH, CAUSAL>(p, K, splits, ws, s)
                   : launch_sm90<DH, SEG>(p, K, splits, ws, s);
    if (e != cudaSuccess) return e;
    if (splits > 1) {
      const int rows = K * p.RG;
      varlen_merge_kernel<<<(rows + 7) / 8, 256, 0, s>>>(ws, p.o, rows, DH,
                                                         splits);
    }
    return cudaGetLastError();
  }
};

// ---- the in-place Reuse: keys from the slot pool and the live block ----

struct PoolParams {
  const void* q;                // [K, RG, dh]
  const void* kb;               // [R·Sb, K, dh] the live blocks' keys
  const void* vb;
  const void* kp;               // [S1, K, Cr, dh] layer l's slot pool
  const void* vp;
  float* o;                     // [K, RG, dh]
  const int* q_pos;             // [R·Sb]
  const int* q_seg;             // [R·Sb], constant over each segment
  const int* pool_pos;          // [S1, K, Cr]
  const uint8_t* pool_valid;    // [S1, K, Cr]
  const long long* slots;       // [R] the pool row of each segment
  int RG, G, K, Sb, Cr, S1;
  float scale, softcap;
  int causal, window, is_local;
};

// float32: one CTA of 64 rows walks the tile runs of its rows' segments.
template <typename T, int DH>
__global__ void __launch_bounds__(NTHREADS)
pool_attention_kernel(PoolParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tile<T, DH> t(smem);
  constexpr int BK = kv_tile<DH>();
  int* row_pos = t.row_i0;
  int* row_seg = t.row_i1;
  int* key_pos = t.key_i0;
  int* key_seg = t.key_i1;
  int* key_ok = t.key_i2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int head = blockIdx.y;
  const int row0 = blockIdx.x * BQ;
  const int nrows = min(BQ, p.RG - row0);
  const T* q = static_cast<const T*>(p.q) + ((size_t)head * p.RG + row0) * DH;
  for (int i = tid; i < BQ; i += NTHREADS) {
    if (i < nrows) {
      const int tq = (row0 + i) / p.G;
      row_pos[i] = p.q_pos[tq];
      row_seg[i] = p.q_seg[tq];
    } else {
      row_pos[i] = 0;
      row_seg[i] = -2;          // matches no key (keys carry >= -1)
    }
  }
  init_rows<T, DH>(t, q, nrows, tid);
  __syncthreads();

  const int ntc = (p.Cr + BK - 1) / BK, nt = ntc + (p.Sb + BK - 1) / BK;
  const int r0 = row0 / p.G / p.Sb, r1 = (row0 + nrows - 1) / p.G / p.Sb;
  for (int u = r0 * nt; u < (r1 + 1) * nt; ++u) {
    const int r = u / nt, j = u - r * nt;
    const int seg = p.q_seg[r * p.Sb];
    const T *k, *v;
    const int* kpos;
    const uint8_t* kok = nullptr;   // the block's keys are all valid
    size_t stride;
    int nk;
    if (j < ntc) {
      const size_t at = ((size_t)p.slots[r] * p.K + head) * p.Cr +
                        (size_t)j * BK;
      k = static_cast<const T*>(p.kp) + at * DH;
      v = static_cast<const T*>(p.vp) + at * DH;
      stride = DH;
      nk = min(BK, p.Cr - j * BK);
      kpos = p.pool_pos + at;
      kok = p.pool_valid + at;
    } else {
      const int t0 = r * p.Sb + (j - ntc) * BK;
      const size_t at = ((size_t)t0 * p.K + head) * DH;
      k = static_cast<const T*>(p.kb) + at;
      v = static_cast<const T*>(p.vb) + at;
      stride = (size_t)p.K * DH;
      nk = min(BK, p.Sb - (j - ntc) * BK);
      kpos = p.q_pos + t0;
    }
    load_kv_rows<T, DH>(t, k, v, stride, nk, tid);
    for (int c = tid; c < BK; c += NTHREADS) {
      const bool in = c < nk;
      key_pos[c] = in ? kpos[c] : 0;
      key_seg[c] = in ? seg : -1;
      key_ok[c] = in ? (kok ? (int)kok[c] : 1) : 0;
    }
    __syncthreads();
    scores<T, DH>(t.Qs, t.Ks, t.Ss, tid);
    __syncthreads();
    softmax_tile<BK>(t.Ss, t.Ps, t.row_m, t.row_l, t.row_a, p.scale, p.softcap,
                    warp, lane, [&](int rr, int c, float zz) {
      bool ok = key_ok[c] && key_seg[c] == row_seg[rr];
      if (p.causal) ok = ok && row_pos[rr] >= key_pos[c];
      if (p.window && p.is_local)
        ok = ok && abs(row_pos[rr] - key_pos[c]) <= p.window;
      return ok ? zz : -1e30f;
    });
    __syncthreads();
    accumulate_pv<T, DH>(t.Ps, t.Vs, t.Os, t.row_a, tid);
    __syncthreads();
  }

  float* o = p.o + ((size_t)head * p.RG + row0) * DH;
  for (int i = tid; i < nrows * DH; i += NTHREADS)
    o[i] = t.Os[i] / fmaxf(t.row_l[i / DH], 1e-30f);
}

template <typename T, int DH>
struct LaunchPool {
  static cudaError_t run(const PoolParams& p, int, float*, cudaStream_t s) {
    return launch_tile<T, DH>(pool_attention_kernel<T, DH>,
                              dim3((p.RG + BQ - 1) / BQ, p.K), p, s);
  }
};

// The Hopper problem: VarlenProb's rows and mask, keys by tile. Segment r
// is tiles [r·nt, (r+1)·nt): nt_c of pool row slots[r], then the block's.
template <int MASK>
struct PoolProb : VarlenProb<MASK> {
  static constexpr bool TILED = true;
  using Key = typename VarlenProb<MASK>::Key;
  const int* pool_pos;
  const uint8_t* pool_valid;
  const long long* slots;
  int K, Sb, Cr, nt_c, nt;

  // the tile runs of the segments from the tile's first row's to its
  // last's, then split blockIdx.z's even share of them
  __device__ int2 key_window(const repro::sm90::Job& job, int) const {
    const int last = min(job.row0 + repro::sm90::BM, this->RG) - 1;
    const int r0 = job.row0 / this->G / Sb, r1 = last / this->G / Sb;
    const int n = (r1 - r0 + 1) * nt, z = blockIdx.z;
    return make_int2(r0 * nt + z * n / this->splits,
                     r0 * nt + (z + 1) * n / this->splits);
  }
  // map 0 (the pool: key, slot·K + head) or 1 (the block: head, token)
  __device__ int3 tile_at(int head, int u) const {
    const int r = u / nt, j = u - r * nt;
    if (j < nt_c)
      return make_int3(0, j * repro::sm90::BK, (int)slots[r] * K + head);
    return make_int3(1, head, r * Sb + (j - nt_c) * repro::sm90::BK);
  }
  __device__ void key_meta(int head, int u, int i, Key& d, int& valid,
                           bool& in) const {
    const int r = u / nt, j = u - r * nt;
    int pos;
    if (j < nt_c) {
      const int c = j * repro::sm90::BK + i;
      in = c < Cr;
      const size_t at = ((size_t)slots[r] * K + head) * Cr + min(c, Cr - 1);
      pos = pool_pos[at];
      valid = pool_valid[at];
    } else {
      const int c = (j - nt_c) * repro::sm90::BK + i;
      in = c < Sb;
      pos = this->q_pos[r * Sb + min(c, Sb - 1)];
      valid = 1;
    }
    const int seg = this->q_seg[r * Sb];
    if constexpr (VarlenProb<MASK>::POS) d = make_int2(seg, pos);
    else d = seg;
  }
};

// K's and V's two maps each: [0] the pool's, [1] the block's
struct PoolMaps {
  CUtensorMap k[2], v[2];
};

template <int DH, int MASK>
__global__ void __launch_bounds__(repro::sm90::NTHREADS, 1)
pool_attention_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ PoolMaps kv,
                           const PoolProb<MASK> p, float* o, float* part) {
  using L = repro::sm90::Smem<DH, typename PoolProb<MASK>::Key>;
  repro::sm90::Job job;
  job.bh = blockIdx.y;
  job.row0 = blockIdx.x / L::DSPLIT * repro::sm90::BM;
  job.col0 = blockIdx.x % L::DSPLIT * L::NPV;
  job.rows = p.RG;
  const size_t stream = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  if (p.splits == 1) {
    job.o = o + stream * p.RG * DH;
    job.ml = nullptr;
  } else {
    job.o = part + stream * p.RG * DH;
    job.ml = part + (size_t)p.splits * gridDim.y * p.RG * DH +
             stream * p.RG * 2;
  }
  repro::sm90::attention_cta<DH>(&tq, kv.k, kv.v, p, job);
}

template <int DH, int MASK>
cudaError_t launch_pool_sm90(const PoolParams& p, int splits, float* ws,
                             cudaStream_t s) {
  namespace H = repro::sm90;
  const int R = p.RG / p.G / p.Sb;
  CUtensorMap tq;
  PoolMaps kv;
  cudaError_t e = H::tma_map_3d(&tq, p.q, DH, p.RG, p.K, H::BM);
  if (e == cudaSuccess)
    e = H::tma_map_3d(&kv.k[0], p.kp, DH, p.Cr, p.S1 * p.K, H::BK);
  if (e == cudaSuccess)
    e = H::tma_map_3d(&kv.v[0], p.vp, DH, p.Cr, p.S1 * p.K, H::BK);
  // the block's [R·Sb, K, dh] keys as boxes of one head and BK tokens:
  // coordinates (column, head, token)
  if (e == cudaSuccess)
    e = H::tma_map(&kv.k[1], p.kb, DH, p.K, R * p.Sb, DH, (size_t)p.K * DH,
                   1, H::BK);
  if (e == cudaSuccess)
    e = H::tma_map(&kv.v[1], p.vb, DH, p.K, R * p.Sb, DH, (size_t)p.K * DH,
                   1, H::BK);
  if (e != cudaSuccess) return e;
  PoolProb<MASK> r;
  r.scale = p.scale; r.softcap = p.softcap;
  r.q_pos = p.q_pos; r.q_seg = p.q_seg;
  r.kv_pos = nullptr; r.kv_seg = nullptr; r.kv_valid = nullptr;
  r.RG = p.RG; r.G = p.G; r.Tkv = 0; r.kv_head_stride = 0;
  r.splits = splits;
  r.causal = p.causal; r.window = p.window; r.is_local = p.is_local;
  r.pool_pos = p.pool_pos; r.pool_valid = p.pool_valid; r.slots = p.slots;
  r.K = p.K; r.Sb = p.Sb; r.Cr = p.Cr;
  r.nt_c = (p.Cr + H::BK - 1) / H::BK;
  r.nt = r.nt_c + (p.Sb + H::BK - 1) / H::BK;
  using L = H::Smem<DH, typename PoolProb<MASK>::Key>;
  auto kern = pool_attention_kernel_sm90<DH, MASK>;
  static unsigned smem_set = 0;
  e = H::allow_dynamic_smem(kern, L::total, &smem_set);
  if (e != cudaSuccess) return e;
  kern<<<dim3((p.RG + H::BM - 1) / H::BM * L::DSPLIT, p.K, splits),
         H::NTHREADS, L::total, s>>>(tq, kv, r, p.o, ws);
  return cudaGetLastError();
}

template <typename T, int DH>
struct LaunchPoolSm90 {
  static cudaError_t run(const PoolParams& p, int splits, float* ws,
                         cudaStream_t s) {
    const bool win = p.window && p.is_local;
    cudaError_t e =
        win ? launch_pool_sm90<DH, ANY>(p, splits, ws, s)
        : p.causal ? launch_pool_sm90<DH, CAUSAL>(p, splits, ws, s)
                   : launch_pool_sm90<DH, SEG>(p, splits, ws, s);
    if (e != cudaSuccess) return e;
    if (splits > 1) {
      const int rows = p.K * p.RG;
      varlen_merge_kernel<<<(rows + 7) / 8, 256, 0, s>>>(ws, p.o, rows, DH,
                                                         splits);
    }
    return cudaGetLastError();
  }
};

}  // namespace

// splits: CTAs per row tile along the keys (bfloat16 only; 1 for float32);
// ws: the float32 workspace of splits·K·RG·(dh + 2) values when splits > 1.
extern "C" int repro_flash_varlen(
    const void* q, const void* k, const void* v, void* o, const void* q_pos,
    const void* q_seg, const void* kv_pos, const void* kv_seg,
    const void* kv_valid, void* ws, int K, int RG, int G, int Tq, int Tkv,
    int kv_head_stride, int dh, int dtype, float scale, float softcap,
    int causal, int window, int is_local, int splits, void* stream) {
  if (splits < 1 || (splits > 1 && (dtype != repro::kBF16 || ws == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = static_cast<float*>(o);
  p.q_pos = static_cast<const int*>(q_pos);
  p.q_seg = static_cast<const int*>(q_seg);
  p.kv_pos = static_cast<const int*>(kv_pos);
  p.kv_seg = static_cast<const int*>(kv_seg);
  p.kv_valid = static_cast<const uint8_t*>(kv_valid);
  p.RG = RG; p.G = G; p.Tq = Tq; p.Tkv = Tkv;
  p.kv_head_stride = kv_head_stride;
  p.scale = scale; p.softcap = softcap;
  p.causal = causal; p.window = window; p.is_local = is_local;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  cudaError_t e;
  if (dtype == repro::kBF16)
    e = dispatch_dh<LaunchSm90, bf16>(dh, p, K, splits, w, s);
  else if (dtype == repro::kF32)
    e = dispatch_dh<Launch, float>(dh, p, K, splits, w, s);
  else e = cudaErrorInvalidValue;
  return (int)e;
}

// The packed Reuse's cross attention read in place (the header's second
// part): q [K, RG, dh]; kb/vb [Tq, K, dh] (Tq = R·Sb); kp/vp [S1, K, Cr,
// dh] and pool_pos/pool_valid [S1, K, Cr] of one layer; slots [R] int64.
// splits and ws as for repro_flash_varlen.
extern "C" int repro_flash_varlen_pool(
    const void* q, const void* kb, const void* vb, const void* kp,
    const void* vp, void* o, const void* q_pos, const void* q_seg,
    const void* pool_pos, const void* pool_valid, const void* slots,
    void* ws, int K, int RG, int G, int Tq, int Sb, int Cr, int S1, int dh,
    int dtype, float scale, float softcap, int causal, int window,
    int is_local, int splits, void* stream) {
  if (splits < 1 || (splits > 1 && (dtype != repro::kBF16 || ws == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (Sb < 1 || Cr < 1 || Tq % Sb || RG != Tq * G)
    return (int)cudaErrorInvalidValue;
  PoolParams p;
  p.q = q; p.kb = kb; p.vb = vb; p.kp = kp; p.vp = vp;
  p.o = static_cast<float*>(o);
  p.q_pos = static_cast<const int*>(q_pos);
  p.q_seg = static_cast<const int*>(q_seg);
  p.pool_pos = static_cast<const int*>(pool_pos);
  p.pool_valid = static_cast<const uint8_t*>(pool_valid);
  p.slots = static_cast<const long long*>(slots);
  p.RG = RG; p.G = G; p.K = K; p.Sb = Sb; p.Cr = Cr; p.S1 = S1;
  p.scale = scale; p.softcap = softcap;
  p.causal = causal; p.window = window; p.is_local = is_local;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  cudaError_t e;
  if (dtype == repro::kBF16)
    e = dispatch_dh<LaunchPoolSm90, bf16>(dh, p, splits, w, s);
  else if (dtype == repro::kF32)
    e = dispatch_dh<LaunchPool, float>(dh, p, splits, w, s);
  else e = cudaErrorInvalidValue;
  return (int)e;
}
