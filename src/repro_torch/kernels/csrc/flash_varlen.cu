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
// A first, simple kernel: no TMA, no wgmma, no double buffering yet.

#include "common.cuh"

using namespace nvcuda;
using repro::bf16;

namespace {

constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 64;          // keys per KV tile
constexpr int NWARP = 4;        // each warp owns 16 query rows
constexpr int NTHREADS = NWARP * 32;

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
struct Layout {
  static constexpr size_t q = 0;
  static constexpr size_t k = repro::align128(q + BQ * DH * sizeof(T));
  static constexpr size_t v = repro::align128(k + BK * DH * sizeof(T));
  static constexpr size_t s = repro::align128(v + BK * DH * sizeof(T));
  static constexpr size_t p = repro::align128(s + BQ * BK * sizeof(float));
  static constexpr size_t o = repro::align128(p + BQ * BK * sizeof(T));
  static constexpr size_t w = repro::align128(o + BQ * DH * sizeof(float));
  static constexpr size_t rowf = repro::align128(w + NWARP * 256 * sizeof(float));
  static constexpr size_t rowi = repro::align128(rowf + 3 * BQ * sizeof(float));
  static constexpr size_t key = repro::align128(rowi + 2 * BQ * sizeof(int));
  static constexpr size_t total = repro::align128(key + (3 * BK + 2) * sizeof(int));
};

// S[BQ][BK] = Q[BQ][DH] · K[BK][DH]^T, unscaled
template <typename T, int DH>
__device__ __forceinline__ void scores(const T* Qs, const T* Ks, float* Ss,
                                       int warp, int tid) {
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, Qs + warp * 16 * DH + kk * 16, DH);
        wmma::load_matrix_sync(b, Ks + n * 16 * DH + kk * 16, DH);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(Ss + warp * 16 * BK + n * 16, acc, BK,
                              wmma::mem_row_major);
    }
  } else {
    for (int e = tid; e < BQ * BK; e += NTHREADS) {
      const int r = e / BK, c = e % BK;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d)
        acc = fmaf(Qs[r * DH + d], Ks[c * DH + d], acc);
      Ss[e] = acc;
    }
  }
}

// O[r][:] = O[r][:]·alpha[r] + P[r][:] · V
template <typename T, int DH>
__device__ __forceinline__ void accumulate_pv(const T* Ps, const T* Vs,
                                              float* Os, const float* alpha,
                                              float* scratch, int warp,
                                              int lane, int tid) {
  if constexpr (std::is_same<T, bf16>::value) {
    float* mine = scratch + warp * 256;
#pragma unroll
    for (int n = 0; n < DH / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, Ps + warp * 16 * BK + kk * 16, BK);
        wmma::load_matrix_sync(b, Vs + kk * 16 * DH + n * 16, DH);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(mine, acc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = warp * 16 + (e >> 4);
        float* o = Os + r * DH + n * 16 + (e & 15);
        *o = *o * alpha[r] + mine[e];
      }
      __syncwarp();
    }
  } else {
    for (int e = tid; e < BQ * DH; e += NTHREADS) {
      const int r = e / DH, c = e % DH;
      float acc = 0.f;
#pragma unroll 8
      for (int j = 0; j < BK; ++j) acc = fmaf(Ps[r * BK + j], Vs[j * DH + c], acc);
      Os[e] = Os[e] * alpha[r] + acc;
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(NTHREADS)
varlen_attention_kernel(Params p) {
  using Lay = Layout<T, DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + Lay::q);
  T* Ks = reinterpret_cast<T*>(smem + Lay::k);
  T* Vs = reinterpret_cast<T*>(smem + Lay::v);
  float* Ss = reinterpret_cast<float*>(smem + Lay::s);
  T* Ps = reinterpret_cast<T*>(smem + Lay::p);
  float* Os = reinterpret_cast<float*>(smem + Lay::o);
  float* scratch = reinterpret_cast<float*>(smem + Lay::w);
  float* row_m = reinterpret_cast<float*>(smem + Lay::rowf);
  float* row_l = row_m + BQ;
  float* row_a = row_l + BQ;
  int* row_pos = reinterpret_cast<int*>(smem + Lay::rowi);
  int* row_seg = row_pos + BQ;
  int* key_pos = reinterpret_cast<int*>(smem + Lay::key);
  int* key_seg = key_pos + BK;
  int* key_ok = key_seg + BK;
  int* range = key_ok + BK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int head = blockIdx.y;
  const int row0 = blockIdx.x * BQ;
  const int nrows = min(BQ, p.RG - row0);
  const T* q = static_cast<const T*>(p.q) + ((size_t)head * p.RG + row0) * DH;
  const T* k = static_cast<const T*>(p.k) + (size_t)head * p.Tkv * DH;
  const T* v = static_cast<const T*>(p.v) + (size_t)head * p.Tkv * DH;
  const int* kv_pos = p.kv_pos + (size_t)head * p.kv_head_stride;
  const uint8_t* kv_valid = p.kv_valid + (size_t)head * p.kv_head_stride;
  const T zero = repro::from_f32<T>(0.f);

  for (int i = tid; i < BQ; i += NTHREADS) {
    if (i < nrows) {
      const int t = (row0 + i) / p.G;
      row_pos[i] = p.q_pos[t];
      row_seg[i] = p.q_seg[t];
    } else {
      row_pos[i] = 0;
      row_seg[i] = -2;          // matches no key (keys carry >= -1)
    }
    row_m[i] = -INFINITY;
    row_l[i] = 0.f;
  }
  for (int i = tid; i < BQ * DH; i += NTHREADS) {
    Qs[i] = (i / DH) < nrows ? q[i] : zero;
    Os[i] = 0.f;
  }
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
    // rows past nk are zero-filled: their probability is exactly 0, and
    // 0 · garbage could be NaN
    for (int i = tid; i < BK * DH; i += NTHREADS) {
      const bool in = (i / DH) < nk;
      Ks[i] = in ? k[(size_t)kv0 * DH + i] : zero;
      Vs[i] = in ? v[(size_t)kv0 * DH + i] : zero;
    }
    for (int j = tid; j < BK; j += NTHREADS) {
      const bool in = j < nk;
      key_pos[j] = in ? kv_pos[kv0 + j] : 0;
      key_seg[j] = in ? p.kv_seg[kv0 + j] : -1;
      key_ok[j] = in ? (int)kv_valid[kv0 + j] : 0;
    }
    __syncthreads();
    scores<T, DH>(Qs, Ks, Ss, warp, tid);
    __syncthreads();
    // online softmax: warp w owns rows [16w, 16w + 16), two keys a lane
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      const int qp = row_pos[r], qs = row_seg[r];
      float z[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int c = lane + 32 * hh;
        float zz = Ss[r * BK + c] * p.scale;
        if (p.softcap != 0.f) zz = p.softcap * tanhf(zz / p.softcap);
        bool ok = key_ok[c] && key_seg[c] == qs;
        if (p.causal) ok = ok && qp >= key_pos[c];
        if (p.window && p.is_local) ok = ok && abs(qp - key_pos[c]) <= p.window;
        z[hh] = ok ? zz : -1e30f;
      }
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, repro::warp_max(fmaxf(z[0], z[1])));
      const float p0 = expf(z[0] - m_new), p1 = expf(z[1] - m_new);
      Ps[r * BK + lane] = repro::from_f32<T>(p0);
      Ps[r * BK + lane + 32] = repro::from_f32<T>(p1);
      const float sum = repro::warp_sum(p0 + p1);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        row_a[r] = a;
        row_l[r] = row_l[r] * a + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();
    accumulate_pv<T, DH>(Ps, Vs, Os, row_a, scratch, warp, lane, tid);
    __syncthreads();
  }

  float* o = p.o + ((size_t)head * p.RG + row0) * DH;
  for (int i = tid; i < nrows * DH; i += NTHREADS)
    o[i] = Os[i] / fmaxf(row_l[i / DH], 1e-30f);
}

template <typename T, int DH>
cudaError_t launch(const Params& p, int K, cudaStream_t stream) {
  const size_t smem = Layout<T, DH>::total;
  auto kern = varlen_attention_kernel<T, DH>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.RG + BQ - 1) / BQ, K);
  kern<<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const Params& p, int K, int dh, cudaStream_t s) {
  switch (dh) {
    case 16: return launch<T, 16>(p, K, s);
    case 32: return launch<T, 32>(p, K, s);
    case 64: return launch<T, 64>(p, K, s);
    case 112: return launch<T, 112>(p, K, s);   // zamba2-7b: 7 x 16
    case 128: return launch<T, 128>(p, K, s);
    default: return cudaErrorInvalidValue;
  }
}

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
  if (dtype == repro::kBF16) e = dispatch_dh<bf16>(p, K, dh, s);
  else if (dtype == repro::kF32) e = dispatch_dh<float>(p, K, dh, s);
  else e = cudaErrorInvalidValue;
  return (int)e;
}
