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
// against 2·T·D·V operations; at T <= 128 rows that is <= 128 op/byte, so
// it is memory-bound. A grid of one CTA per T tile that loops over all of
// V would occupy a handful of the 132 SMs. Design:
//  * grid (vocabulary splits x T tiles of 128 rows): about 256 splits, each
//    a run of 128-column vocabulary tiles, so W streams through every SM;
//  * per tile, an 8-warp CTA computes the 128 x 128 logits over D in 64-
//    wide chunks staged in shared memory (bf16 on the tensor cores with
//    WMMA 16x16x16 and float32 accumulators; float32 on the CUDA cores),
//    then folds them into per-row running (max, argmax, Σexp);
//  * each split writes its partial (m, idx, s); a second small kernel merges
//    them by the law of the reference's vocab-sharded path
//    (src/repro/kernels/ops.py::_sharded_logit_argmax): m = max mᵢ, idx from
//    the lowest split reaching m, s = Σ sᵢ·exp(mᵢ - m);
//  * the vocabulary edge (V not a multiple of the tile) is masked here.
// A first, simple kernel: no TMA, no wgmma, no double buffering yet.

#include "common.cuh"

using namespace nvcuda;
using repro::bf16;

namespace {

constexpr int BT = 128;         // rows per CTA
constexpr int BV = 128;         // vocabulary columns per tile
constexpr int BD = 64;          // model-dim chunk staged in shared memory
constexpr int NWARP = 8;        // each warp owns 16 rows
constexpr int NTHREADS = NWARP * 32;

template <typename T>
struct Layout {
  static constexpr size_t h = 0;
  static constexpr size_t w = repro::align128(h + BT * BD * sizeof(T));
  static constexpr size_t z = repro::align128(w + BD * BV * sizeof(T));
  static constexpr size_t m = repro::align128(z + BT * BV * sizeof(float));
  static constexpr size_t s = repro::align128(m + BT * sizeof(float));
  static constexpr size_t i = repro::align128(s + BT * sizeof(float));
  static constexpr size_t total = repro::align128(i + BT * sizeof(int));
};

// Zs[BT][BV] = h[t0 : t0+BT, :] · W[:, v0 : v0+BV] (rows >= nt and columns
// >= nv read as zero). VD: W is the tied [V, D] table.
template <typename T, bool VD>
__device__ __forceinline__ void logits_tile(const T* h, const T* w, T* Hs,
                                            T* Ws, float* Zs, int t0, int nt,
                                            int v0, int nv, int D, int V,
                                            int warp, int tid) {
  const T zero = repro::from_f32<T>(0.f);
  if constexpr (std::is_same<T, bf16>::value) {
    using BLayout = typename std::conditional<VD, wmma::col_major,
                                              wmma::row_major>::type;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BV / 16];
#pragma unroll
    for (int n = 0; n < BV / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
    for (int d0 = 0; d0 < D; d0 += BD) {
      const int nd = min(BD, D - d0);
      for (int i = tid; i < BT * BD; i += NTHREADS) {
        const int r = i / BD, c = i % BD;
        Hs[i] = (r < nt && c < nd) ? h[(size_t)(t0 + r) * D + d0 + c] : zero;
      }
      if (VD) {
        for (int i = tid; i < BV * BD; i += NTHREADS) {
          const int c = i / BD, d = i % BD;
          Ws[i] = (c < nv && d < nd) ? w[(size_t)(v0 + c) * D + d0 + d] : zero;
        }
      } else {
        for (int i = tid; i < BD * BV; i += NTHREADS) {
          const int d = i / BV, c = i % BV;
          Ws[i] = (c < nv && d < nd) ? w[(size_t)(d0 + d) * V + v0 + c] : zero;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Hs + warp * 16 * BD + kk * 16, BD);
#pragma unroll
        for (int n = 0; n < BV / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b;
          if (VD) wmma::load_matrix_sync(b, Ws + n * 16 * BD + kk * 16, BD);
          else wmma::load_matrix_sync(b, Ws + kk * 16 * BV + n * 16, BV);
          wmma::mma_sync(acc[n], a, b, acc[n]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int n = 0; n < BV / 16; ++n)
      wmma::store_matrix_sync(Zs + warp * 16 * BV + n * 16, acc[n], BV,
                              wmma::mem_row_major);
  } else {
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
        Hs[i] = (r < nt && c < nd) ? h[(size_t)(t0 + r) * D + d0 + c] : zero;
      }
      for (int i = tid; i < BD * BV; i += NTHREADS) {
        const int d = i / BV, c = i % BV;   // Ws is [BD][BV] for both layouts
        const bool in = c < nv && d < nd;
        Ws[i] = !in ? zero
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
}

template <typename T, bool VD>
__global__ void __launch_bounds__(NTHREADS)
logit_partial_kernel(const T* __restrict__ h, const T* __restrict__ w,
                     const uint8_t* __restrict__ valid, float* part_m,
                     int* part_i, float* part_s, int Tn, int D, int V,
                     int v_split, float softcap) {
  using Lay = Layout<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int any_valid;
  T* Hs = reinterpret_cast<T*>(smem + Lay::h);
  T* Ws = reinterpret_cast<T*>(smem + Lay::w);
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
    logits_tile<T, VD>(h, w, Hs, Ws, Zs, t0, nt, v0, nv, D, V, warp, tid);
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

template <typename T, bool VD>
cudaError_t launch(const void* h, const void* w, const uint8_t* valid,
                   float* pm, int* pi, float* ps, int Tn, int D, int V,
                   int v_split, int n_splits, float softcap, cudaStream_t s) {
  const size_t smem = Layout<T>::total;
  auto kern = logit_partial_kernel<T, VD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(n_splits, (Tn + BT - 1) / BT);
  kern<<<grid, NTHREADS, smem, s>>>(static_cast<const T*>(h),
                                    static_cast<const T*>(w), valid, pm, pi,
                                    ps, Tn, D, V, v_split, softcap);
  return cudaGetLastError();
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
    e = w_layout_vd ? launch<bf16, true>(h, w, vd, pm, pi, ps, Tn, D, V, v_split, n_splits, softcap, st)
                    : launch<bf16, false>(h, w, vd, pm, pi, ps, Tn, D, V, v_split, n_splits, softcap, st);
  else if (dtype == repro::kF32)
    e = w_layout_vd ? launch<float, true>(h, w, vd, pm, pi, ps, Tn, D, V, v_split, n_splits, softcap, st)
                    : launch<float, false>(h, w, vd, pm, pi, ps, Tn, D, V, v_split, n_splits, softcap, st);
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  logit_merge_kernel<<<(Tn + 255) / 256, 256, 0, st>>>(
      pm, pi, ps, static_cast<int*>(idx), static_cast<float*>(m),
      static_cast<float*>(s), Tn, n_splits);
  return (int)cudaGetLastError();
}
