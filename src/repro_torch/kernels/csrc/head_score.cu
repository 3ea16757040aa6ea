// Per-KV-head importance scores (C3), over the token-packed Refresh stream
// and over a padded batch.
//
// Replaces the Pallas TPU kernels src/repro/kernels/select_pack.py
// head_score_varlen_call (_varlen_kernel):
//   out[r, k, t] = max over request r's Sb·G block query rows q of
//                  Q[r, k, q] · K[k, t]   where seg[t] == r, else -inf,
// and head_score_call (_kernel), the padded form with keys per request:
//   out[b, k, s] = max over the Sb·G rows q of Q[b, k, q] · K[b, k, s].
// A raw dot product (no dh^-1/2), accumulated in float32. One kernel serves
// both: the padded form's owner of every key is its batch row b.
//
// Keys are read in place through strides (elements; the last dimension
// unit-stride): key (b, head, t) at k + b·ks_b + head·ks_h + t·ks_t, so the
// Refresh path hands over the [T, K, dh] projection output as its
// [K, T, dh] permuted view, without a copy. q [R or B, K, Rq, dh] is
// contiguous. Every row starts on a 16-byte boundary (the wrapper checks).
//
// What bounds it on an H100: 2·Σ Sᵢ·Rq·dh operations per KV head against
// the keys read once and the [R, K, T] float32 scores written; with Rq = 8
// block rows (llada-8b at block 8) that is ~4 operations per byte, so the
// bytes bound it (keys ~90% of them at R = 4, T = 1024).
//
// Design: one CTA of four warps per (64-key tile, KV head[, batch row]), so
// the grid does not grow with R and each key is read from device memory
// once. A CTA requests the tile's segment ids, then its keys (a tile of
// padding alone too: the packed stream pads less than one 128-token
// bucket, and the ids would otherwise stand before the keys); the owners
// are the requests from seg[t0] to the last id below R (segments ascend,
// PAD_SEG = 2^30 owns nothing), usually one, two at a boundary. The keys
// arrive by 16-byte cp.async into shared rows padded by 16 bytes (every
// ldmatrix touches each bank once), zero-filled past T and up to a
// multiple of 16 along dh; each owner's block rows follow in chunks of QC
// rows, double-buffered so the next owner's rows load under this one's
// products. While the keys load, the CTA writes -inf over the tile's slice
// of every request that owns none of it. bfloat16: each warp computes
// Sᵀ[16 keys, rows] = K·Qᵀ by mma.sync m16n8k16 (keys on M, the rows on N,
// dh on K), masks the rows past Rq to -inf, takes the max over the rows in
// registers (its fragment, then two shuffles across the quad that holds a
// key's columns) and keeps the score of each key its owner owns. float32
// inputs (the reduced checks) take the same grid and loads with the dot
// products on CUDA cores. Then the owners' rows go out, 16-byte stores
// where T allows. The max-pool, top-k and gather that follow stay plain
// PyTorch.

#include "sm90.cuh"

using repro::bf16;
namespace H = repro::sm90;

namespace {

constexpr int BT = 64;          // keys a CTA: 16 a warp, the mma's M side
constexpr int NTHREADS = 128;

// one 16-byte store (the compiler would split a float4 store here)
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  asm volatile("st.global.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "f"(a), "f"(b), "f"(c), "f"(d) : "memory");
}

struct Params {
  const void* q;                // [P, K, Rq, dh], P = R (varlen) or B
  const void* k;                // strided, see above
  const int* seg;               // [T] ascending owner ids; nullptr: padded
  float* out;                   // [P, K, T]
  int R, K, Rq, Tn, dh;
  int dhp, ld;                  // dh zero-filled to dhp; shared row stride
  long long ks_b, ks_h, ks_t;   // key strides, elements
};

template <typename T, int QC>
__global__ void __launch_bounds__(NTHREADS, 4)
head_score_kernel(Params p) {
  constexpr int CE = 16 / sizeof(T);      // elements a 16-byte copy
  constexpr bool kBF16 = std::is_same<T, bf16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);     // [BT][ld]
  T* Qs = Ks + BT * p.ld;                 // [2][QC][ld]
  int* sseg = reinterpret_cast<int*>(Qs + 2 * QC * p.ld);   // [BT]
  float* sc = reinterpret_cast<float*>(sseg + BT);          // [BT]

  const int tid = threadIdx.x;
  const int head = blockIdx.y, pb = blockIdx.z;
  const int t0 = blockIdx.x * BT, nt = min(BT, p.Tn - t0);
  const int cpr = p.dhp / CE;             // 16-byte copies a row
  const int cdh = p.dh / CE;              // of them holding data
  // copy c = tid + i·NTHREADS of a [rows][cpr] tile is (row, ch), stepped
  // by (dj, dch) without a division a copy
  const int j0 = tid / cpr, ch0 = tid % cpr;
  const int dj = NTHREADS / cpr, dch = NTHREADS % cpr;
  auto walk = [&](int rows, auto&& copy) {
    for (int j = j0, ch = ch0; j < rows;) {
      copy(j, ch);
      j += dj;
      ch += dch;
      if (ch >= cpr) {
        ch -= cpr;
        ++j;
      }
    }
  };

  // the tile's segment ids first, so that they arrive while the keys are
  // requested; then the keys, whether the tile has an owner or not (a tile
  // of padding alone: the packed stream pads less than one token bucket)
  int seg0 = pb, segt = -1;
  if (p.seg != nullptr) {
    seg0 = __ldg(p.seg + t0);
    if (tid < nt) segt = __ldg(p.seg + t0 + tid);
  }
  const T* kb = static_cast<const T*>(p.k) + pb * p.ks_b + head * p.ks_h +
                t0 * p.ks_t;
  walk(BT, [&](int j, int ch) {
    const bool in = j < nt && ch < cdh;
    H::cp_async16(Ks + j * p.ld + ch * CE,
                  in ? kb + j * p.ks_t + ch * CE : kb, in ? 16 : 0);
  });
  H::cp_async_commit();

  // owners: from seg[t0] on (the padded form: the batch row alone)
  const int lo = max(seg0, 0);
  const bool owned = lo < p.R;
  if (tid < BT) sseg[tid] = segt;
  const int nchunk = (p.Rq + QC - 1) / QC;

  // block rows [c0, c0 + QC) of owner r into buffer `buf`; rows past Rq and
  // columns past dh zero
  auto fetch_q = [&](int r, int c0, int buf) {
    const T* qb = static_cast<const T*>(p.q) +
                  ((size_t)r * p.K + head) * p.Rq * p.dh;
    T* dst = Qs + buf * QC * p.ld;
    walk(QC, [&](int i, int ch) {
      const int row = c0 + i;
      const bool in = row < p.Rq && ch < cdh;
      H::cp_async16(dst + i * p.ld + ch * CE,
                    in ? qb + (size_t)row * p.dh + ch * CE : qb, in ? 16 : 0);
    });
  };
  if (owned) fetch_q(lo, 0, 0);
  H::cp_async_commit();
  __syncthreads();                        // sseg
  int hi = lo;                            // the last owner: seg < R
  if (p.seg != nullptr && owned)
    hi = sseg[repro::upper_bound_i32(sseg, nt, p.R - 1) - 1];
  const int n_items = owned ? (hi - lo + 1) * nchunk : 0;

  // rows [r0, r1) of the tile's slice of out: an owner's scores where seg
  // says so (the padded form: all), -inf elsewhere. Where T allows, a
  // thread stores one float4 of keys (j = 4·(tid % 16)) in every eighth
  // row; else one key in every other row.
  auto store = [&](int r0, int r1, bool scores) {
    const size_t row_stride = (size_t)p.K * p.Tn;
    float* ob = p.out + ((size_t)r0 * p.K + head) * p.Tn + t0;
    auto pick = [&](int sg, float v, int r) {
      return scores && (p.seg == nullptr || sg == r) ? v : -INFINITY;
    };
    if ((p.Tn & 3) == 0) {                // nt % 4 == 0, rows 16-byte aligned
      const int j = 4 * (tid & 15);
      if (j >= nt) return;
      int4 sg = make_int4(0, 0, 0, 0);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (scores) {
        sg = *reinterpret_cast<const int4*>(sseg + j);
        v = *reinterpret_cast<const float4*>(sc + j);
      }
      for (int r = r0 + (tid >> 4); r < r1; r += NTHREADS / 16)
        store4(ob + (r - r0) * row_stride + j, pick(sg.x, v.x, r),
               pick(sg.y, v.y, r), pick(sg.z, v.z, r), pick(sg.w, v.w, r));
    } else {
      const int j = tid & (BT - 1);
      if (j >= nt) return;
      const int sg = scores ? sseg[j] : 0;
      const float v = scores ? sc[j] : 0.f;
      for (int r = r0 + tid / BT; r < r1; r += NTHREADS / BT)
        ob[(r - r0) * row_stride + j] = pick(sg, v, r);
    }
  };
  // the requests that own none of the tile: -inf while the keys load
  if (p.seg != nullptr) {
    store(0, owned ? lo : p.R, false);
    if (owned) store(hi + 1, p.R, false);
  }

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  float best0 = -INFINITY, best1 = -INFINITY;
  for (int it = 0; it < n_items; ++it) {
    const int r = lo + it / nchunk, c0 = (it % nchunk) * QC;
    const int nx = it + 1;
    if (nx < n_items) fetch_q(lo + nx / nchunk, (nx % nchunk) * QC, nx & 1);
    H::cp_async_commit();                 // a group an item, empty or not
    H::cp_async_wait<1>();                // the keys and this item's rows
    __syncthreads();
    const T* qs = Qs + (it & 1) * QC * p.ld;
    const int nq = min(QC, p.Rq - c0);
    if constexpr (kBF16) {
      // Sᵀ[this warp's 16 keys, QC rows]: keys g, g + 8 and rows
      // 8j + 2t, + 1 in this thread's fragment; two accumulator chains
      constexpr int NT = QC / 8;
      float s[NT][4], s2[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = s2[j][e] = 0.f;
      const bf16* ka =
          Ks + (warp * 16 + (lane & 15)) * p.ld + 8 * (lane >> 4);
      const bf16* qa = qs + (lane & 7) * p.ld + 8 * ((lane >> 3) & 1);
      // dh in steps of 16, four at a time: their fragments load back to
      // back, then their products run
      const int ks = p.dhp / 16;
      for (int s0 = 0; s0 < ks; s0 += 4) {
        uint32_t a[4][4], b[4][NT][2];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (s0 + u < ks) {
            H::ldmatrix_x4(a[u], ka + 16 * (s0 + u));
#pragma unroll
            for (int j = 0; j < NT; ++j)
              H::ldmatrix_x2(b[u][j], qa + 8 * j * p.ld + 16 * (s0 + u));
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (s0 + u < ks) {
#pragma unroll
            for (int j = 0; j < NT; ++j)
              H::mma_bf16_16816(u & 1 ? s2[j] : s[j], a[u], b[u][j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // a padded row would score 0: mask it before the max
          const float z = 8 * j + 2 * t + (e & 1) < nq ? s[j][e] + s2[j][e]
                                                       : -INFINITY;
          if (e < 2) best0 = fmaxf(best0, z);
          else best1 = fmaxf(best1, z);
        }
      if (it % nchunk == nchunk - 1) {    // owner r done
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          best0 = fmaxf(best0, __shfl_xor_sync(0xffffffffu, best0, o));
          best1 = fmaxf(best1, __shfl_xor_sync(0xffffffffu, best1, o));
        }
        const int key = warp * 16 + g;
        if (t == 0 && (p.seg == nullptr || sseg[key] == r)) sc[key] = best0;
        if (t == 0 && (p.seg == nullptr || sseg[key + 8] == r))
          sc[key + 8] = best1;
        best0 = best1 = -INFINITY;
      }
    } else {
      // two threads a key (adjacent lanes), alternate rows each
      const int key = tid >> 1, half = tid & 1;
      const float4* kr = reinterpret_cast<const float4*>(Ks + key * p.ld);
      for (int i = half; i < nq; i += 2) {
        const float4* qr = reinterpret_cast<const float4*>(qs + i * p.ld);
        float acc = 0.f;
        for (int d = 0; d < cdh; ++d) {
          const float4 a = kr[d], b = qr[d];
          acc = fmaf(a.x, b.x, acc);
          acc = fmaf(a.y, b.y, acc);
          acc = fmaf(a.z, b.z, acc);
          acc = fmaf(a.w, b.w, acc);
        }
        best0 = fmaxf(best0, acc);
      }
      if (it % nchunk == nchunk - 1) {
        best0 = fmaxf(best0, __shfl_xor_sync(0xffffffffu, best0, 1));
        if (half == 0 && (p.seg == nullptr || sseg[key] == r)) sc[key] = best0;
        best0 = -INFINITY;
      }
    }
    __syncthreads();                      // the buffer is free for a copy
  }

  if (owned) store(lo, hi + 1, true);     // the owners' rows
  H::cp_async_wait<0>();                  // a tile no request owns
}

template <typename T, int QC>
cudaError_t run(Params p, int P, cudaStream_t s) {
  constexpr int CE = 16 / sizeof(T);
  const int align = std::is_same<T, bf16>::value ? 16 : CE;
  p.dhp = (p.dh + align - 1) / align * align;
  p.ld = p.dhp + CE;
  const int smem = (BT + 2 * QC) * p.ld * (int)sizeof(T) + 2 * BT * 4;
  auto kern = head_score_kernel<T, QC>;
  if (smem > 48 * 1024) {                 // dh > 176 (bf16), > 88 (float32)
    static int allowed[64] = {};
    const cudaError_t e = H::grow_dynamic_smem(kern, smem, allowed);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.Tn + BT - 1) / BT, p.K, P);
  kern<<<grid, NTHREADS, smem, s>>>(p);
  return cudaGetLastError();
}

// Block rows a chunk: the fewest n8 fragments that hold Rq, at most four.
template <typename T>
cudaError_t launch(const Params& p, int P, cudaStream_t s) {
  if (p.Rq <= 8) return run<T, 8>(p, P, s);
  if (p.Rq <= 16) return run<T, 16>(p, P, s);
  return run<T, 32>(p, P, s);
}

// dh: whole 16-byte copies, at most 256
cudaError_t dispatch(const Params& p, int P, int dtype, cudaStream_t s) {
  if (p.dh <= 0 || p.dh > 256) return cudaErrorInvalidValue;
  if (dtype == repro::kBF16 && p.dh % 8 == 0) return launch<bf16>(p, P, s);
  if (dtype == repro::kF32 && p.dh % 4 == 0) return launch<float>(p, P, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q [R, K, Rq, dh]; key (head, t) at k + head·ks_h + t·ks_t; seg [T]
// -> out [R, K, T]
extern "C" int repro_head_score_varlen(const void* q, const void* k,
                                       const void* seg, void* out, int R,
                                       int K, int Rq, int Tn, int dh,
                                       long long ks_h, long long ks_t,
                                       int dtype, void* stream) {
  Params p{q, k, static_cast<const int*>(seg), static_cast<float*>(out),
           R, K, Rq, Tn, dh, 0, 0, 0, ks_h, ks_t};
  return (int)dispatch(p, 1, dtype, static_cast<cudaStream_t>(stream));
}

// q [B, K, Rq, dh]; key (b, head, s) at k + b·ks_b + head·ks_h + s·ks_t
// -> out [B, K, S]
extern "C" int repro_head_score(const void* q, const void* k, void* out,
                                int B, int K, int Rq, int S, int dh,
                                long long ks_b, long long ks_h,
                                long long ks_t, int dtype, void* stream) {
  Params p{q, k, nullptr, static_cast<float*>(out), B, K, Rq, S, dh, 0, 0,
           ks_b, ks_h, ks_t};
  return (int)dispatch(p, B, dtype, static_cast<cudaStream_t>(stream));
}
