// Segment-reset Mamba2 SSD scan over a token-packed stream.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan.py
// ssm_segment_scan_call (_kernel). For each head h and channel p the state
// row s[n] = h_t[h, p, n] follows
//   s = a_t · s + xdt[t, h, p] · B[t, :],   a_t = exp(dA[t, h]) (0 at a reset)
//   y[t, h, p] = C[t, :] · s
// and request r's state is captured after flat row cap_rows[r] (-1, or any
// row outside the stream, gives a zero state). The final state is returned
// as the Pallas kernel returns it. All inputs and outputs are float32.
//
// What bounds it on an H100: 4·T·H·P·N float32 operations (state update
// and output, each a multiply-add) against the xdt/y/captured bytes; at
// zamba2-7b's Refresh (T = 1024, H = 112, P = N = 64) that is ~1.9 GFLOP on
// the CUDA cores (67 TFLOP/s, ~28 us) against ~67 MB (~20 us), so the
// arithmetic bounds it, and the recurrence serialises it over T. Design:
//  * the state of (h, p) depends only on xdt[:, h, p], dA[:, h], B and C,
//    so the Pallas kernel's sequential chunk grid becomes a token loop
//    inside a CTA that owns PT channels of one head; nothing is carried
//    between CTAs and no [T, H, P, N] state is ever written;
//  * four threads hold one channel's N-entry state row in registers (N/4
//    each) and reduce y over the four lanes with two shuffles;
//  * tokens go through shared memory TL at a time (B, C, the CTA's xdt
//    columns, dA, reset), double-buffered: cp.async copies the next pass
//    while the current one is scanned, so the loads' latency hides behind
//    the recurrence (a first version that staged with plain loads spent
//    ~9/10 of its time waiting on them);
//  * each capture row lies in one token step and each (h, p) in one CTA,
//    so the owning threads write captured[r, h, p, :] directly, no atomics;
//  * a reset is a select (s = x·b), never a multiply by a zero decay, so
//    no 0·inf can turn into NaN; no decay is ever built from a sentinel.
// Still simple: the token recurrence, not the chunked SSD form on tensor
// cores; the chunk of the plain version is a tiling choice that y and the
// captures do not depend on. xdt, B and C must be 16-byte aligned.

#include "common.cuh"

namespace {

constexpr int LANES = 4;        // threads per channel's state row
constexpr int TL = 32;          // tokens per pass

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// one state entry over one token: a reset (a == 0) selects, never 0·s
__device__ __forceinline__ float advance(float s, float a, float xb) {
  return a == 0.f ? xb : fmaf(a, s, xb);
}

__host__ __device__ constexpr int stage_floats(int N, int PT) {
  return 2 * TL * N + TL * PT + 2 * TL;   // B, C, xdt columns, dA, reset
}

template <int NPER>
__global__ void ssm_scan_kernel(const float* __restrict__ xdt,
                                const float* __restrict__ dA,
                                const float* __restrict__ Bm,
                                const float* __restrict__ Cm,
                                const float* __restrict__ reset,
                                const int* __restrict__ cap_rows,
                                float* __restrict__ y,
                                float* __restrict__ cap_out,
                                float* __restrict__ final_state, int Tn,
                                int H, int P, int R) {
  constexpr int N = NPER * LANES;
  const int PT = blockDim.x / LANES;      // channels of this CTA
  const int SF = stage_floats(N, PT);
  extern __shared__ __align__(16) float sm[];
  int* flag = reinterpret_cast<int*>(sm + 2 * SF);   // [TL] a capture row
  int* caps = flag + TL;                             // [R]

  const int h = blockIdx.y, p0 = blockIdx.x * PT;
  const int tid = threadIdx.x, pl = tid / LANES, lane = tid % LANES;
  const int p = p0 + pl, n0 = lane * NPER;
  const size_t row_hp = (size_t)h * P + p;      // (h, p) within [H, P]

  // copy one pass of tokens [t0, t0 + nt) into a buffer, asynchronously
  auto stage = [&](float* buf, int t0) {
    const int nt = min(TL, Tn - t0);
    float* Bs = buf;
    float* Cs = Bs + TL * N;
    float* Xs = Cs + TL * N;
    float* Ds = Xs + TL * PT;
    float* Rs = Ds + TL;
    for (int i = tid; i < nt * N / 4; i += blockDim.x) {
      cp_async16(Bs + 4 * i, Bm + (size_t)t0 * N + 4 * i);
      cp_async16(Cs + 4 * i, Cm + (size_t)t0 * N + 4 * i);
    }
    const int xv = PT / 4;
    for (int i = tid; i < nt * xv; i += blockDim.x) {
      const int t = i / xv, j = (i % xv) * 4;
      cp_async16(Xs + t * PT + j, xdt + ((size_t)(t0 + t) * H + h) * P + p0 + j);
    }
    for (int t = tid; t < nt; t += blockDim.x) {
      cp_async4(Ds + t, dA + (size_t)(t0 + t) * H + h);
      cp_async4(Rs + t, reset + t0 + t);
    }
    cp_async_commit();
  };

  float s[NPER];
#pragma unroll
  for (int i = 0; i < NPER; ++i) s[i] = 0.f;

  for (int r = tid; r < R; r += blockDim.x) caps[r] = cap_rows[r];
  // captures at no row of the stream are zero states
  for (int r = 0; r < R; ++r) {
    const int row = cap_rows[r];
    if (row < 0 || row >= Tn) {
      float* dst = cap_out + ((size_t)r * H * P + row_hp) * N + n0;
#pragma unroll
      for (int i = 0; i < NPER; ++i) dst[i] = 0.f;
    }
  }
  __syncthreads();

  const int n_pass = (Tn + TL - 1) / TL;
  stage(sm, 0);
  for (int k = 0; k < n_pass; ++k) {
    const int t0 = k * TL, nt = min(TL, Tn - t0);
    if (k + 1 < n_pass) {
      stage(sm + ((k + 1) & 1) * SF, t0 + TL);
      cp_async_wait<1>();                 // this pass landed, the next flies
    } else {
      cp_async_wait<0>();
    }
    for (int t = tid; t < nt; t += blockDim.x) {
      int f = 0;
      for (int r = 0; r < R; ++r) f |= caps[r] == t0 + t;
      flag[t] = f;
    }
    __syncthreads();
    const float* Bs = sm + (k & 1) * SF;
    const float* Cs = Bs + TL * N;
    const float* Xs = Cs + TL * N;
    const float* Ds = Xs + TL * PT;
    const float* Rs = Ds + TL;
    for (int t = 0; t < nt; ++t) {
      const float a = Rs[t] != 0.f ? 0.f : expf(Ds[t]);
      const float x = Xs[t * PT + pl];
      const float4* b4 = reinterpret_cast<const float4*>(Bs + t * N + n0);
      const float4* c4 = reinterpret_cast<const float4*>(Cs + t * N + n0);
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int q = 0; q < NPER / 4; ++q) {
        const float4 b = b4[q], c = c4[q];
        float* sq = s + 4 * q;
        sq[0] = advance(sq[0], a, x * b.x);
        acc0 = fmaf(c.x, sq[0], acc0);
        sq[1] = advance(sq[1], a, x * b.y);
        acc1 = fmaf(c.y, sq[1], acc1);
        sq[2] = advance(sq[2], a, x * b.z);
        acc0 = fmaf(c.z, sq[2], acc0);
        sq[3] = advance(sq[3], a, x * b.w);
        acc1 = fmaf(c.w, sq[3], acc1);
      }
      float acc = acc0 + acc1;
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (lane == 0) y[(size_t)(t0 + t) * H * P + row_hp] = acc;
      if (flag[t]) {
        for (int r = 0; r < R; ++r) {
          if (caps[r] != t0 + t) continue;
          float* dst = cap_out + ((size_t)r * H * P + row_hp) * N + n0;
#pragma unroll
          for (int i = 0; i < NPER; ++i) dst[i] = s[i];
        }
      }
    }
    __syncthreads();                      // the buffer is free for a copy
  }
  float* fin = final_state + row_hp * N + n0;
#pragma unroll
  for (int i = 0; i < NPER; ++i) fin[i] = s[i];
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

template <int NPER>
cudaError_t launch(const float* xdt, const float* dA, const float* Bm,
                   const float* Cm, const float* reset, const int* cap_rows,
                   float* y, float* cap, float* fin, int Tn, int H, int P,
                   int R, cudaStream_t stream) {
  // channels per CTA: the widest of 32/16 that still gives two CTAs per SM,
  // else 8 (every warp whole: 4 lanes x 8 channels = 32 threads)
  int PT = 8;
  const int wider[2] = {32, 16};
  for (int cand : wider) {
    if (P % cand == 0 && H * (P / cand) >= 2 * sm_count()) { PT = cand; break; }
  }
  if (P % PT) return cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * stage_floats(NPER * LANES, PT) * sizeof(float)
                      + (size_t)(TL + R) * sizeof(int);
  auto kern = ssm_scan_kernel<NPER>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(P / PT, H);
  kern<<<grid, PT * LANES, smem, stream>>>(xdt, dA, Bm, Cm, reset, cap_rows,
                                           y, cap, fin, Tn, H, P, R);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_ssm_segment_scan(const void* xdt, const void* dA,
                                      const void* Bm, const void* Cm,
                                      const void* reset, const void* cap_rows,
                                      void* y, void* cap, void* fin, int Tn,
                                      int H, int P, int N, int R,
                                      void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  const int* cr = static_cast<const int*>(cap_rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (N) {
    case 16: e = launch<4>(f(xdt), f(dA), f(Bm), f(Cm), f(reset), cr, o(y),
                           o(cap), o(fin), Tn, H, P, R, s); break;
    case 32: e = launch<8>(f(xdt), f(dA), f(Bm), f(Cm), f(reset), cr, o(y),
                           o(cap), o(fin), Tn, H, P, R, s); break;
    case 64: e = launch<16>(f(xdt), f(dA), f(Bm), f(Cm), f(reset), cr, o(y),
                            o(cap), o(fin), Tn, H, P, R, s); break;
    case 128: e = launch<32>(f(xdt), f(dA), f(Bm), f(Cm), f(reset), cr, o(y),
                             o(cap), o(fin), Tn, H, P, R, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return (int)e;
}
