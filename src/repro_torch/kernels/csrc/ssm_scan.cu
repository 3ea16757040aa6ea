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
// What bounds it on an H100: the token recurrence is 4·T·H·P·N float32
// operations (~1.9 GFLOP at zamba2-7b's Refresh, T = 1024, H = 112,
// P = N = 64), but walked token by token it is a dependent chain T long,
// and that latency, not operations or bytes, bounded the first version of
// this kernel. This one computes the chunked SSD form of the Pallas kernel
// in chunks of 64 tokens, parallel over (chunk, head), in four launches:
//  1. ssm_gram_kernel, grid (chunks): G = C·B^T of each chunk, which every
//     head shares (ssm_groups = 1), on and left of the diagonal blocks;
//  2. ssm_chunk_state_kernel, grid (chunks, H): the prefix sums cs of dA
//     and the reset counts cnt of the chunk (a warp scan), then the
//     chunk-end state Δ = (decay ∘ X)^T·B [P x N], token j decaying by
//     exp(cs_last - cs_j) iff no reset falls after it in the chunk, and
//     the chunk's carry exp(cs_last) (0 if a reset falls in it);
//  3. ssm_state_pass_kernel: for every (h, p, n) a short pass over the T/64
//     chunks, state_in[k] = S; S = S·carry[k] + Δ[k] (in place over Δ); the
//     final state; zero captures for rows outside the stream;
//  4. ssm_chunk_out_kernel, grid (chunks, H): M = G ∘ L with L_ij =
//     exp(cs_i - cs_j) iff j <= i and cnt_i == cnt_j (a reset is a count
//     mask, never a -inf decay nor a multiply by a zero decay), then
//     Y = M·X + csx ∘ (C·state_in^T) with csx_i = exp(cs_i) iff no reset
//     falls in [0, i]; each capture row in the chunk gets the masked
//     partial state of step 3 of the Pallas kernel plus its share of
//     state_in.
// The products run on the tensor cores (mma.sync m16n8k8 tf32) with the
// 3xTF32 split, so float32 accuracy holds over sums of 64-128 terms. No
// [T, H, P, N] tensor is written: the state traffic is [T/64, H, P, N]
// (Δ written, read and overwritten by state_in, which is read). A ragged
// last chunk is zero-filled (dA = 0, no reset, X = B = C = 0), so T need
// not be a multiple of the chunk. xdt, B and C must be 16-byte aligned
// (cp.async copies them 16 bytes at a time). What still bounds it: the
// rate of tf32 mma.sync (three products for each float32 one) and each
// CTA's load latency (it loads, then computes; three CTAs an SM).

#include "sm90.cuh"

namespace H = repro::sm90;

namespace {

constexpr int CH = 64;          // tokens a chunk (four 16-row blocks)
constexpr int NWARP = 8;
constexpr int NTHREADS = NWARP * 32;
constexpr int MIN_CTAS = 3;     // CTAs an SM the register budget allows

struct Args {
  const float* xdt;     // [T, H, P]
  const float* dA;      // [T, H]
  const float* Bm;      // [T, N]
  const float* Cm;      // [T, N]
  const float* reset;   // [T]
  const int* cap_rows;  // [R]
  float* y;             // [T, H, P]
  float* cap;           // [R, H, P, N]
  float* fin;           // [H, P, N]
  float* states;        // [chunks, H, P, N]: Δ, then state_in
  float* carry;         // [chunks, H]
  float* gram;          // [chunks, 64, 64]: G = C·B^T
  int T, H, P, N, R;
};

// shared-memory layout, in floats; strides pad rows so that the operand
// reads of mma3_tf32 fall in distinct banks. The output kernel keeps G
// (then M, in place), C (then B, for the captures) and the incoming state
// S beside X.
struct Smem {
  int ldx, ldn, ldm;
  int xs, bs, cs_, ss, dec, cum, cnt, csx, total;
  __host__ __device__ Smem(int P, int N, bool out) {
    ldx = P + 8;
    ldn = N + 4;
    ldm = CH + 4;
    xs = 0;
    bs = xs + CH * ldx;
    cs_ = bs + CH * (out ? ldm : ldn);
    ss = cs_ + (out ? CH * ldn : 0);
    dec = ss + (out ? P * ldn : 0);
    cum = dec + CH;
    cnt = cum + CH;
    csx = cnt + CH;
    total = csx + CH;
  }
};

// rows [t0, t0 + nvalid) of a [T, N] matrix into shared memory at stride
// ld, zeros past nvalid (cp.async; the caller commits)
__device__ void load_rows(float* dst, int ld, const float* src, int N, int t0,
                          int nvalid) {
  const int nv = N / 4;
  for (int i = threadIdx.x; i < CH * nv; i += NTHREADS) {
    const int r = i / nv, c = (i % nv) * 4;
    H::cp_async16(dst + r * ld + c,
                  src + (size_t)(t0 + min(r, nvalid - 1)) * N + c,
                  r < nvalid ? 16 : 0);
  }
}

// One (chunk, head) into shared memory by cp.async: X and, for the chunk
// states, B; for the output, G, C and the incoming state S. Meanwhile warp
// 0 scans the chunk's resets into the inclusive counts cnt and dA into the
// prefix sums cum, and sets the incoming-state gates csx = exp(cum) where
// no reset falls in [0, i]. Ends in a barrier.
__device__ void stage(const Args& a, const Smem& L, float* sm, int k, int t0,
                      int nvalid, int h, bool out) {
  const int tid = threadIdx.x, P = a.P, N = a.N, xv = P / 4;
  for (int i = tid; i < CH * xv; i += NTHREADS) {
    const int r = i / xv, c = (i % xv) * 4;
    const int row = t0 + min(r, nvalid - 1);
    H::cp_async16(sm + L.xs + r * L.ldx + c,
                  a.xdt + ((size_t)row * a.H + h) * P + c, r < nvalid ? 16 : 0);
  }
  if (out) {
    const float* gk = a.gram + (size_t)k * CH * CH;
    for (int i = tid; i < CH * CH / 4; i += NTHREADS) {
      const int r = i / (CH / 4), c = (i % (CH / 4)) * 4;
      H::cp_async16(sm + L.bs + r * L.ldm + c, gk + r * CH + c);
    }
    load_rows(sm + L.cs_, L.ldn, a.Cm, N, t0, nvalid);
    const float* st = a.states + ((size_t)k * a.H + h) * P * N;
    for (int i = tid; i < P * N / 4; i += NTHREADS) {
      const int r = i / (N / 4), c = (i % (N / 4)) * 4;
      H::cp_async16(sm + L.ss + r * L.ldn + c, st + (size_t)r * N + c);
    }
  } else {
    load_rows(sm + L.bs, L.ldn, a.Bm, N, t0, nvalid);
  }
  H::cp_async_commit();
  if (tid < 32) {
    // lane l: rows 2l, 2l + 1; inclusive sums by a warp scan
    const int r0 = 2 * tid, r1 = r0 + 1;
    const float d0 = r0 < nvalid ? a.dA[(size_t)(t0 + r0) * a.H + h] : 0.f;
    const float d1 = r1 < nvalid ? a.dA[(size_t)(t0 + r1) * a.H + h] : 0.f;
    const int c0 = r0 < nvalid && a.reset[t0 + r0] != 0.f;
    const int c1 = r1 < nvalid && a.reset[t0 + r1] != 0.f;
    float x = d0 + d1;
    int n = c0 + c1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float xo = __shfl_up_sync(0xffffffffu, x, o);
      const int no = __shfl_up_sync(0xffffffffu, n, o);
      if (tid >= o) { x += xo; n += no; }
    }
    float* cum = sm + L.cum;
    int* cnt = reinterpret_cast<int*>(sm + L.cnt);
    cum[r0] = x - d1;
    cum[r1] = x;
    cnt[r0] = n - c1;
    cnt[r1] = n;
    sm[L.csx + r0] = n - c1 == 0 ? __expf(x - d1) : 0.f;
    sm[L.csx + r1] = n == 0 ? __expf(x) : 0.f;
  }
  H::cp_async_wait<0>();
  __syncthreads();
}

// out[p][n] = Σ_{j <= last} dec_j · X[j][p] · B[j][n] over the CTA's warps
// in 16 x 32 tiles; `emit(p, n, value)` stores each element
template <class Emit>
__device__ void partial_state(const Args& a, const Smem& L, const float* sm,
                              const float* Bs, int last, Emit emit) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, P = a.P, N = a.N;
  const int rbn = (P + 15) / 16, cbn = (N + 31) / 32;
  const int k1 = (last + 8) / 8 * 8;
  const float* X = sm + L.xs;
  const float* dec = sm + L.dec;
  for (int task = warp; task < rbn * cbn; task += NWARP) {
    const int p0 = task / cbn * 16, n0 = task % cbn * 32;
    const int nv = min(4, (N - n0) / 8);
    float acc[4][4] = {};
    H::mma3_tf32<4>(
        acc, nv, 0, k1,
        [&](int i, int k) {
          return p0 + i < P ? X[k * L.ldx + p0 + i] * dec[k] : 0.f;
        },
        [&](int k, int n) { return Bs[k * L.ldn + n0 + n]; });
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= nv) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + g + 8 * (e >> 1);
        if (p < P) emit(p, n0 + 8 * j + 2 * t + (e & 1), acc[j][e]);
      }
    }
  }
}

// decay of token j into row `last`: exp(cs_last - cs_j) iff j <= last and
// no reset falls in (j, last]
__device__ void decay_to(const Smem& L, float* sm, int last) {
  const int j = threadIdx.x;
  if (j < CH) {
    const float* cum = sm + L.cum;
    const int* cnt = reinterpret_cast<const int*>(sm + L.cnt);
    sm[L.dec + j] = j <= last && cnt[j] == cnt[last]
                        ? __expf(cum[last] - cum[j]) : 0.f;
  }
  __syncthreads();
}

// G = C·B^T of one chunk, in the 16-row blocks' tiles on and left of the
// diagonal (the only ones M reads)
__global__ void __launch_bounds__(NTHREADS)
ssm_gram_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int k = blockIdx.x, t0 = k * CH, nvalid = min(CH, a.T - t0);
  const int ldn = a.N + 4;
  float* Bs = sm;
  float* Cs = sm + CH * ldn;
  load_rows(Bs, ldn, a.Bm, a.N, t0, nvalid);
  load_rows(Cs, ldn, a.Cm, a.N, t0, nvalid);
  H::cp_async_commit();
  H::cp_async_wait<0>();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = 16 * (warp >> 1), j0 = 32 * (warp & 1);
  const int nv = min(4, (i0 + 16 - j0 + 7) / 8);
  if (nv <= 0) return;
  float acc[4][4] = {};
  H::mma3_tf32<4>(
      acc, nv, 0, a.N, [&](int i, int kk) { return Cs[(i0 + i) * ldn + kk]; },
      [&](int kk, int n) { return Bs[(j0 + n) * ldn + kk]; });
  float* gk = a.gram + (size_t)k * CH * CH;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= nv) break;
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<float2*>(gk + (i0 + g + 8 * half) * CH + j0 + 8 * j +
                                 2 * t) =
          make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
  }
}

__global__ void __launch_bounds__(NTHREADS, MIN_CTAS)
ssm_chunk_state_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int k = blockIdx.x, h = blockIdx.y, t0 = k * CH;
  const int nvalid = min(CH, a.T - t0), last = nvalid - 1;
  const Smem L(a.P, a.N, false);
  stage(a, L, sm, k, t0, nvalid, h, false);
  decay_to(L, sm, last);
  float* dst = a.states + ((size_t)k * a.H + h) * a.P * a.N;
  partial_state(a, L, sm, sm + L.bs, last, [&](int p, int n, float v) {
    dst[(size_t)p * a.N + n] = v;
  });
  if (threadIdx.x == 0) {
    const int c_last = reinterpret_cast<const int*>(sm + L.cnt)[last];
    a.carry[(size_t)k * a.H + h] =
        c_last == 0 ? __expf(sm[L.cum + last]) : 0.f;
  }
}

__global__ void __launch_bounds__(256)
ssm_state_pass_kernel(Args a, int n_chunks) {
  const size_t PN = (size_t)a.P * a.N, HPN = a.H * PN;
  const size_t e = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (e >= HPN) return;
  const int h = (int)(e / PN);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  constexpr int AHEAD = 8;               // chunks whose Δ load at once
  for (int k0 = 0; k0 < n_chunks; k0 += AHEAD) {
    float4 d[AHEAD];
    float c[AHEAD];
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      if (k0 + i < n_chunks) {
        d[i] = *reinterpret_cast<const float4*>(a.states + (k0 + i) * HPN + e);
        c[i] = a.carry[(size_t)(k0 + i) * a.H + h];
      }
    }
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      if (k0 + i >= n_chunks) break;
      *reinterpret_cast<float4*>(a.states + (k0 + i) * HPN + e) = s;
      s.x = fmaf(s.x, c[i], d[i].x);
      s.y = fmaf(s.y, c[i], d[i].y);
      s.z = fmaf(s.z, c[i], d[i].z);
      s.w = fmaf(s.w, c[i], d[i].w);
    }
  }
  *reinterpret_cast<float4*>(a.fin + e) = s;
  for (int r = 0; r < a.R; ++r) {
    const int row = a.cap_rows[r];
    if (row < 0 || row >= a.T)
      *reinterpret_cast<float4*>(a.cap + r * HPN + e) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__global__ void __launch_bounds__(NTHREADS, MIN_CTAS)
ssm_chunk_out_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int k = blockIdx.x, h = blockIdx.y, t0 = k * CH;
  const int nvalid = min(CH, a.T - t0);
  const int P = a.P, N = a.N;
  const Smem L(P, N, true);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  stage(a, L, sm, k, t0, nvalid, h, true);
  const float* X = sm + L.xs;
  float* M = sm + L.bs;                    // G, then M in place
  const float* Cs = sm + L.cs_;
  const float* S = sm + L.ss;
  const float* cum = sm + L.cum;
  const int* cnt = reinterpret_cast<const int*>(sm + L.cnt);
  const float* csx = sm + L.csx;

  // M = G ∘ L on the rows' blocks up to the diagonal: L_ij = exp(cs_i -
  // cs_j) iff j <= i and no reset falls in (j, i]
  for (int e = threadIdx.x; e < CH * CH; e += NTHREADS) {
    const int i = e / CH, j = e % CH;
    if (j < (i / 16 + 1) * 16)
      M[i * L.ldm + j] = j <= i && cnt[j] == cnt[i]
                             ? M[i * L.ldm + j] * __expf(cum[i] - cum[j])
                             : 0.f;
  }
  __syncthreads();

  // Y = M·X + csx ∘ (C·S^T), rows of 16 by 32 channels
  const int cbn = (P + 31) / 32;
  for (int task = warp; task < 4 * cbn; task += NWARP) {
    const int i0 = task / cbn * 16, p0 = task % cbn * 32;
    const int nv = min(4, (P - p0) / 8);
    float acc[4][4] = {}, acc2[4][4] = {};
    H::mma3_tf32<4>(
        acc, nv, 0, i0 + 16,
        [&](int i, int kk) { return M[(i0 + i) * L.ldm + kk]; },
        [&](int kk, int n) { return X[kk * L.ldx + p0 + n]; });
    H::mma3_tf32<4>(
        acc2, nv, 0, N,
        [&](int i, int kk) { return Cs[(i0 + i) * L.ldn + kk]; },
        [&](int kk, int n) { return S[(p0 + n) * L.ldn + kk]; });
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= nv) break;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = i0 + g + 8 * half;
        const float c = csx[i];
        if (i < nvalid)
          *reinterpret_cast<float2*>(
              a.y + ((size_t)(t0 + i) * a.H + h) * P + p0 + 8 * j + 2 * t) =
              make_float2(fmaf(c, acc2[j][2 * half], acc[j][2 * half]),
                          fmaf(c, acc2[j][2 * half + 1],
                               acc[j][2 * half + 1]));
      }
    }
  }

  // captures whose row lies in this chunk: the masked partial state plus
  // the incoming state's share (B is loaded over C first)
  bool b_loaded = false;
  for (int r = 0; r < a.R; ++r) {
    const int loc = a.cap_rows[r] - t0;
    if (loc < 0 || loc >= nvalid) continue;
    __syncthreads();                       // C and dec are free
    if (!b_loaded) {
      load_rows(sm + L.cs_, L.ldn, a.Bm, N, t0, nvalid);
      H::cp_async_commit();
      H::cp_async_wait<0>();
      b_loaded = true;
    }
    decay_to(L, sm, loc);                  // ends in a barrier
    const float base = cnt[loc] == 0 ? __expf(cum[loc]) : 0.f;
    float* dst = a.cap + ((size_t)r * a.H + h) * P * N;
    partial_state(a, L, sm, sm + L.cs_, loc, [&](int p, int n, float v) {
      dst[(size_t)p * N + n] = v + base * S[p * L.ldn + n];
    });
  }
}

}  // namespace

extern "C" int repro_ssm_segment_scan(const void* xdt, const void* dA,
                                      const void* Bm, const void* Cm,
                                      const void* reset, const void* cap_rows,
                                      void* y, void* cap, void* fin,
                                      void* states, void* carry, void* gram,
                                      int Tn, int Hn, int P, int N, int R,
                                      void* stream) {
  if (Tn <= 0 || P % 8 || N % 8) return (int)cudaErrorInvalidValue;
  Args a;
  a.xdt = static_cast<const float*>(xdt);
  a.dA = static_cast<const float*>(dA);
  a.Bm = static_cast<const float*>(Bm);
  a.Cm = static_cast<const float*>(Cm);
  a.reset = static_cast<const float*>(reset);
  a.cap_rows = static_cast<const int*>(cap_rows);
  a.y = static_cast<float*>(y);
  a.cap = static_cast<float*>(cap);
  a.fin = static_cast<float*>(fin);
  a.states = static_cast<float*>(states);
  a.carry = static_cast<float*>(carry);
  a.gram = static_cast<float*>(gram);
  a.T = Tn; a.H = Hn; a.P = P; a.N = N; a.R = R;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (Tn + CH - 1) / CH;
  const int smem0 = 2 * CH * (N + 4) * (int)sizeof(float);
  const int smem1 = Smem(P, N, false).total * (int)sizeof(float);
  const int smem3 = Smem(P, N, true).total * (int)sizeof(float);
  // the shared memory grows with N and P
  static int allowed0[64], allowed1[64], allowed3[64];
  cudaError_t e = H::grow_dynamic_smem(ssm_gram_kernel, smem0, allowed0);
  if (e == cudaSuccess)
    e = H::grow_dynamic_smem(ssm_chunk_state_kernel, smem1, allowed1);
  if (e == cudaSuccess)
    e = H::grow_dynamic_smem(ssm_chunk_out_kernel, smem3, allowed3);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(n_chunks, Hn);
  ssm_gram_kernel<<<n_chunks, NTHREADS, smem0, s>>>(a);
  ssm_chunk_state_kernel<<<grid, NTHREADS, smem1, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t quads = (size_t)Hn * P * N / 4;
  ssm_state_pass_kernel<<<(unsigned)((quads + 255) / 256), 256, 0, s>>>(
      a, n_chunks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssm_chunk_out_kernel<<<grid, NTHREADS, smem3, s>>>(a);
  return (int)cudaGetLastError();
}
