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
// become the limit. Design:
//  * one CTA per (KV head, tile of 64 query rows); the rows are token-major
//    GQA rows (row = t·G + g), so a tile holds 64/G tokens of the G query
//    heads of one KV head and each K/V tile is read once for all of them;
//  * the KV loop runs inside the CTA with an online softmax in float32 (the
//    Pallas kernel's sequential grid axis; CTAs run in no order on the GPU);
//  * streams are segment-ascending, so the CTA binary-searches the first
//    and last key whose segment lies in its rows' segment range and visits
//    only those keys: attention work follows Σ Sᵢ², not T²;
//  * bf16 products run on the tensor cores (WMMA 16x16x16, float32
//    accumulators), float32 inputs on the CUDA cores in full precision;
//  * masked logits are -1e30 (never -inf) and the output is divided by
//    max(Σp, 1e-30), as in the Pallas kernel; ragged edges are masked here,
//    so neither stream length needs to divide a tile.
// The tile itself (scores, online softmax, P·V) is attn_tile.cuh's. A first,
// simple kernel: no TMA, no wgmma, no double buffering yet.

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

template <typename T, int DH>
__global__ void __launch_bounds__(NTHREADS)
varlen_attention_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tile<T, DH> t(smem);
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
    scores<T, DH>(t.Qs, t.Ks, t.Ss, warp, tid);
    __syncthreads();
    softmax_tile<T>(t.Ss, t.Ps, t.row_m, t.row_l, t.row_a, p.scale, p.softcap,
                    warp, lane, [&](int r, int c, float zz) {
      bool ok = key_ok[c] && key_seg[c] == row_seg[r];
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

  float* o = p.o + ((size_t)head * p.RG + row0) * DH;
  for (int i = tid; i < nrows * DH; i += NTHREADS)
    o[i] = t.Os[i] / fmaxf(t.row_l[i / DH], 1e-30f);
}

template <typename T, int DH>
struct Launch {
  static cudaError_t run(const Params& p, int K, cudaStream_t s) {
    return launch_tile<T, DH>(varlen_attention_kernel<T, DH>,
                              dim3((p.RG + BQ - 1) / BQ, K), p, s);
  }
};

}  // namespace

extern "C" int repro_flash_varlen(
    const void* q, const void* k, const void* v, void* o, const void* q_pos,
    const void* q_seg, const void* kv_pos, const void* kv_seg,
    const void* kv_valid, int K, int RG, int G, int Tq, int Tkv,
    int kv_head_stride, int dh, int dtype, float scale, float softcap,
    int causal, int window, int is_local, void* stream) {
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
  cudaError_t e;
  if (dtype == repro::kBF16) e = dispatch_dh<Launch, bf16>(dh, p, K, s);
  else if (dtype == repro::kF32) e = dispatch_dh<Launch, float>(dh, p, K, s);
  else e = cudaErrorInvalidValue;
  return (int)e;
}
