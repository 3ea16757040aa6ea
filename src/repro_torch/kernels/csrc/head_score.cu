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
// both: the padded form reads its keys at a per-request stride and has no
// segments to skip or mask.
//
// What bounds it on an H100: 2·Σ Sᵢ·Sb·G·dh operations per KV head against
// the keys read and the [R, K, T] float32 scores written; with Sb·G = 8
// query rows (llada-8b at block 8) that is ~4 operations per byte, so the
// [R, K, T] output write bounds it. Design: one CTA per (T tile of 64 keys,
// KV head, request). A tile whose segment range does not contain r writes
// -inf and returns before reading anything (the Pallas kernel's tile skip);
// the few owning tiles load their keys once into shared memory (rows padded
// by one float against bank conflicts) and stream the block queries
// through in chunks of 16 rows. The max-pool, top-k and gather that follow
// stay plain PyTorch. The padded form (llada-8b's padded Refresh: B = 4,
// S = 256) is the same work without the skip: every tile is owned.

#include "common.cuh"

using repro::bf16;

namespace {

constexpr int BT = 64;          // keys per CTA
constexpr int QC = 16;          // query rows per chunk
constexpr int NTHREADS = 128;   // two threads per key

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
head_score_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const int* __restrict__ seg, float* __restrict__ out,
                  int K, int Rq, int Tn, int dh, size_t k_request_stride) {
  extern __shared__ __align__(16) float sm[];
  float* Ks = sm;                         // [BT][dh + 1]
  float* Qc = Ks + BT * (dh + 1);         // [QC][dh]
  float* red = Qc + QC * dh;              // [BT]

  const int r = blockIdx.z, head = blockIdx.y, t0 = blockIdx.x * BT;
  const int nt = min(BT, Tn - t0);
  const int tid = threadIdx.x;
  float* o = out + ((size_t)r * K + head) * Tn + t0;
  if (seg != nullptr && (r < seg[t0] || r > seg[t0 + nt - 1])) {
    for (int i = tid; i < nt; i += NTHREADS) o[i] = -INFINITY;
    return;
  }
  const T* kb = k + r * k_request_stride + ((size_t)head * Tn + t0) * dh;
  for (int i = tid; i < BT * dh; i += NTHREADS) {
    const int j = i / dh, d = i % dh;
    Ks[j * (dh + 1) + d] = j < nt ? repro::to_f32(kb[i]) : 0.f;
  }
  const T* qb = q + ((size_t)r * K + head) * Rq * dh;
  const int key = tid % BT, half = tid / BT;
  float best = -INFINITY;
  for (int q0 = 0; q0 < Rq; q0 += QC) {
    const int nq = min(QC, Rq - q0);
    __syncthreads();                      // keys loaded / last chunk used
    for (int i = tid; i < nq * dh; i += NTHREADS)
      Qc[i] = repro::to_f32(qb[(size_t)q0 * dh + i]);
    __syncthreads();
    const float* kr = Ks + key * (dh + 1);
    for (int i = half; i < nq; i += 2) {
      const float* qr = Qc + i * dh;
      float acc = 0.f;
      for (int d = 0; d < dh; ++d) acc = fmaf(qr[d], kr[d], acc);
      best = fmaxf(best, acc);
    }
  }
  if (half == 1) red[key] = best;
  __syncthreads();
  if (half == 0 && key < nt)
    o[key] = seg == nullptr || seg[t0 + key] == r ? fmaxf(best, red[key])
                                                  : -INFINITY;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const int* seg, float* out,
                   int R, int K, int Rq, int Tn, int dh,
                   size_t k_request_stride, cudaStream_t s) {
  const size_t smem = (size_t)(BT * (dh + 1) + QC * dh + BT) * sizeof(float);
  auto kern = head_score_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Tn + BT - 1) / BT, K, R);
  kern<<<grid, NTHREADS, smem, s>>>(static_cast<const T*>(q),
                                    static_cast<const T*>(k), seg, out, K,
                                    Rq, Tn, dh, k_request_stride);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_head_score_varlen(const void* q, const void* k,
                                       const void* seg, void* out, int R,
                                       int K, int Rq, int Tn, int dh,
                                       int dtype, void* stream) {
  const int* sg = static_cast<const int*>(seg);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == repro::kBF16) e = launch<bf16>(q, k, sg, o, R, K, Rq, Tn, dh, 0, s);
  else if (dtype == repro::kF32) e = launch<float>(q, k, sg, o, R, K, Rq, Tn, dh, 0, s);
  else e = cudaErrorInvalidValue;
  return (int)e;
}

// q [B, K, Rq, dh]; k [B, K, S, dh] -> out [B, K, S]
extern "C" int repro_head_score(const void* q, const void* k, void* out,
                                int B, int K, int Rq, int S, int dh,
                                int dtype, void* stream) {
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t stride = (size_t)K * S * dh;
  cudaError_t e;
  if (dtype == repro::kBF16)
    e = launch<bf16>(q, k, nullptr, o, B, K, Rq, S, dh, stride, s);
  else if (dtype == repro::kF32)
    e = launch<float>(q, k, nullptr, o, B, K, Rq, S, dh, stride, s);
  else e = cudaErrorInvalidValue;
  return (int)e;
}
