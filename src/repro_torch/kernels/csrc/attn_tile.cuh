// The float32 attention tile shared by the port's flash-attention kernels
// (flash_varlen.cu, packed_flash_attention.cu and flash_refresh.cu; their
// bfloat16 paths run on attn_sm90.cuh or, for packed_flash_attention.cu,
// on mma.sync): one CTA of four warps owns 64 query rows, walks the keys in
// tiles of kv_tile<DH>() and keeps a float32 online softmax per row. Only
// the mask differs between the kernels; each passes its own as a functor
// to softmax_tile.
//
// The products run on the CUDA cores in full float32: this tile is the
// parity path of the reduced configs on the card (TF32 off), not a fast
// one. The attention probabilities are stored in the input type before the
// P·V product, as the Pallas kernels do.
#pragma once

#include "common.cuh"

namespace repro {
namespace attn {

constexpr int BQ = 64;          // query rows per CTA
constexpr int NWARP = 4;        // each warp owns 16 query rows
constexpr int NTHREADS = NWARP * 32;

// Keys per KV tile: 64, or 32 above head_dim 128, where a 64-key tile's
// K and V beside Q and the output accumulator (256 KB in float32 at
// head_dim 256) would pass the 227 KB a block can use; 32 keys need ~209 KB.
template <int DH>
__host__ __device__ constexpr int kv_tile() { return DH > 128 ? 32 : 64; }

// Shared-memory carve-up of one CTA: the Q, K and V tiles, the scores, the
// probabilities, the float32 output accumulator, three float and two int
// values per row, and three int values per key plus two.
template <typename T, int DH>
struct Layout {
  static constexpr int BK = kv_tile<DH>();
  static constexpr size_t q = 0;
  static constexpr size_t k = align128(q + BQ * DH * sizeof(T));
  static constexpr size_t v = align128(k + BK * DH * sizeof(T));
  static constexpr size_t s = align128(v + BK * DH * sizeof(T));
  static constexpr size_t p = align128(s + BQ * BK * sizeof(float));
  static constexpr size_t o = align128(p + BQ * BK * sizeof(T));
  static constexpr size_t rowf = align128(o + BQ * DH * sizeof(float));
  static constexpr size_t rowi = align128(rowf + 3 * BQ * sizeof(float));
  static constexpr size_t key = align128(rowi + 2 * BQ * sizeof(int));
  static constexpr size_t total = align128(key + (3 * BK + 2) * sizeof(int));
  static_assert(total <= 232448, "a block's shared memory is 227 KB");
};

// Typed pointers into one CTA's shared memory.
template <typename T, int DH>
struct Tile {
  T* Qs; T* Ks; T* Vs; float* Ss; T* Ps; float* Os;
  float* row_m; float* row_l; float* row_a;
  int* row_i0; int* row_i1;             // two per-row ints, kernel-defined
  int* key_i0; int* key_i1; int* key_i2; // three per-key ints, kernel-defined
  int* extra;                            // two more ints

  __device__ explicit Tile(unsigned char* smem) {
    using Lay = Layout<T, DH>;
    constexpr int BK = Lay::BK;
    Qs = reinterpret_cast<T*>(smem + Lay::q);
    Ks = reinterpret_cast<T*>(smem + Lay::k);
    Vs = reinterpret_cast<T*>(smem + Lay::v);
    Ss = reinterpret_cast<float*>(smem + Lay::s);
    Ps = reinterpret_cast<T*>(smem + Lay::p);
    Os = reinterpret_cast<float*>(smem + Lay::o);
    row_m = reinterpret_cast<float*>(smem + Lay::rowf);
    row_l = row_m + BQ;
    row_a = row_l + BQ;
    row_i0 = reinterpret_cast<int*>(smem + Lay::rowi);
    row_i1 = row_i0 + BQ;
    key_i0 = reinterpret_cast<int*>(smem + Lay::key);
    key_i1 = key_i0 + BK;
    key_i2 = key_i1 + BK;
    extra = key_i2 + BK;
  }
};

// S[BQ][BK] = Q[BQ][DH] · K[BK][DH]^T, unscaled
template <typename T, int DH>
__device__ __forceinline__ void scores(const T* Qs, const T* Ks, float* Ss,
                                       int tid) {
  constexpr int BK = kv_tile<DH>();
  for (int e = tid; e < BQ * BK; e += NTHREADS) {
    const int r = e / BK, c = e % BK;
    float acc = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d)
      acc = fmaf(to_f32(Qs[r * DH + d]), to_f32(Ks[c * DH + d]), acc);
    Ss[e] = acc;
  }
}

// O[r][:] = O[r][:]·alpha[r] + P[r][:] · V
template <typename T, int DH>
__device__ __forceinline__ void accumulate_pv(const T* Ps, const T* Vs,
                                              float* Os, const float* alpha,
                                              int tid) {
  constexpr int BK = kv_tile<DH>();
  for (int e = tid; e < BQ * DH; e += NTHREADS) {
    const int r = e / DH, c = e % DH;
    float acc = 0.f;
#pragma unroll 8
    for (int j = 0; j < BK; ++j)
      acc = fmaf(to_f32(Ps[r * BK + j]), to_f32(Vs[j * DH + c]), acc);
    Os[e] = Os[e] * alpha[r] + acc;
  }
}

// Load `nrows` rows of Q (row stride DH) into the tile, zero the rest and
// the output accumulator, and reset the row statistics.
template <typename T, int DH>
__device__ __forceinline__ void init_rows(const Tile<T, DH>& t, const T* q,
                                          int nrows, int tid) {
  const T zero = from_f32<T>(0.f);
  for (int i = tid; i < BQ; i += NTHREADS) {
    t.row_m[i] = -INFINITY;
    t.row_l[i] = 0.f;
  }
  for (int i = tid; i < BQ * DH; i += NTHREADS) {
    t.Qs[i] = (i / DH) < nrows ? q[i] : zero;
    t.Os[i] = 0.f;
  }
}

// Load keys [kv0, kv0 + nk) of K and V; rows past nk are zero-filled (their
// probability is exactly 0, and 0 · garbage could be NaN).
template <typename T, int DH>
__device__ __forceinline__ void load_kv(const Tile<T, DH>& t, const T* k,
                                        const T* v, int kv0, int nk, int tid) {
  constexpr int BK = kv_tile<DH>();
  const T zero = from_f32<T>(0.f);
  for (int i = tid; i < BK * DH; i += NTHREADS) {
    const bool in = (i / DH) < nk;
    t.Ks[i] = in ? k[(size_t)kv0 * DH + i] : zero;
    t.Vs[i] = in ? v[(size_t)kv0 * DH + i] : zero;
  }
}

// Load `nk` rows of K and V, row i at k + i·stride and v + i·stride (a
// strided source: one head of a token-major [T, K, DH] stream); rows past
// nk are zero-filled, as in load_kv.
template <typename T, int DH>
__device__ __forceinline__ void load_kv_rows(const Tile<T, DH>& t, const T* k,
                                             const T* v, size_t stride,
                                             int nk, int tid) {
  constexpr int BK = kv_tile<DH>();
  const T zero = from_f32<T>(0.f);
  for (int i = tid; i < BK * DH; i += NTHREADS) {
    const int r = i / DH, c = i % DH;
    const bool in = r < nk;
    t.Ks[i] = in ? k[r * stride + c] : zero;
    t.Vs[i] = in ? v[r * stride + c] : zero;
  }
}

// One KV tile of the online softmax, scores already in Ss. Warp w owns rows
// [16w, 16w + 16), BK / 32 keys a lane. logit(r, c, z) returns the logit of
// row r against key c given its scaled, softcapped score z: z itself, -1e30
// where the mask removes the pair, or -inf for a key past the end of the
// stream (probability exactly 0 whatever the row's running max).
template <int BK, typename T, typename Logit>
__device__ __forceinline__ void softmax_tile(float* Ss, T* Ps, float* row_m,
                                             float* row_l, float* row_a,
                                             float scale, float softcap,
                                             int warp, int lane, Logit logit) {
  constexpr int KPL = BK / 32;
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr;
    float z[KPL];
#pragma unroll
    for (int hh = 0; hh < KPL; ++hh) {
      const int c = lane + 32 * hh;
      float zz = Ss[r * BK + c] * scale;
      if (softcap != 0.f) zz = softcap * tanhf(zz / softcap);
      z[hh] = logit(r, c, zz);
    }
    float mx = z[0];
#pragma unroll
    for (int hh = 1; hh < KPL; ++hh) mx = fmaxf(mx, z[hh]);
    const float m_old = row_m[r];
    const float m_new = fmaxf(m_old, warp_max(mx));
    float sum = 0.f;
#pragma unroll
    for (int hh = 0; hh < KPL; ++hh) {
      const float pr = expf(z[hh] - m_new);
      Ps[r * BK + lane + 32 * hh] = from_f32<T>(pr);
      sum = hh ? sum + pr : pr;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float a = expf(m_old - m_new);
      row_a[r] = a;
      row_l[r] = row_l[r] * a + sum;
      row_m[r] = m_new;
    }
  }
}

// Instantiate `Launch<T, DH>::run(args...)` for the supported head dims.
template <template <typename, int> class Launch, typename T, typename... A>
cudaError_t dispatch_dh(int dh, A&&... args) {
  switch (dh) {
    case 16: return Launch<T, 16>::run(args...);
    case 32: return Launch<T, 32>::run(args...);
    case 64: return Launch<T, 64>::run(args...);
    case 112: return Launch<T, 112>::run(args...);   // zamba2-7b: 7 x 16
    case 128: return Launch<T, 128>::run(args...);
    case 256: return Launch<T, 256>::run(args...);   // gemma-2b
    default: return cudaErrorInvalidValue;
  }
}

// Set the kernel's dynamic shared memory to the tile's and launch it.
template <typename T, int DH, typename Kern, typename P>
cudaError_t launch_tile(Kern kern, dim3 grid, const P& p, cudaStream_t s) {
  const size_t smem = Layout<T, DH>::total;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, NTHREADS, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace attn
}  // namespace repro
