// Hopper (sm_90a) building blocks shared by the port's redesigned kernels
// (attn_sm90.cuh's attention tile, logit_argmax.cu, packed_flash_attention.cu,
// ssm_scan.cu, head_score.cu): mbarriers, TMA loads and the host-side TMA
// maps, wgmma descriptors and products; cp.async copies and the warp-level
// mma.sync products (bf16 m16n8k16, tf32 m16n8k8 with a 3xTF32 split) for
// tiles too narrow for a 64-row wgmma.
#pragma once

#include <cuda.h>
#include <dlfcn.h>

#include <mutex>

#include "common.cuh"

namespace repro {
namespace sm90 {

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

// Wait for the completion of the barrier's phase of this parity. A wait
// that outlasts ~2^35 cycles (~20 s) traps: a launch error, not a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) break;
    if (clock64() - t0 > (1ll << 35)) __trap();
  }
}

// a TMA load of one box of a 3-d tensor map, completing on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving an accumulator across an async wgmma
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}


// wgmma shared-memory descriptor, 128-byte swizzle (the atom base must be
// 1024-byte aligned; rows of 128 bytes, 16-byte chunk c of row r at chunk
// c ^ (r % 8)): lbo / sbo in bytes
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = (uint64_t)((saddr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier among `count` threads (whole warps) on hardware barrier `id`
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// D[64 x 8] (+)= A[64 x 16] · B[16 x 8], both from shared memory; B
// K-major, A K-major (TA = 0) or M-major (TA = 1); D: 4 floats a thread.
template <int TA>
__device__ __forceinline__ void wgmma_m64n8k16_ss(float* d, uint64_t da,
                                                   uint64_t db, int accum) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, %7, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(accum), "n"(TA));
}

// D[64 x 16] (+)= A[64 x 16] · B[16 x 16], both from shared memory; B
// K-major, A K-major (TA = 0) or M-major (TA = 1); D: 8 floats a thread.
template <int TA>
__device__ __forceinline__ void wgmma_m64n16k16_ss(float* d, uint64_t da,
                                                   uint64_t db, int accum) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accum), "n"(TA));
}

// D[64 x 32] (+)= A[64 x 16] · B[16 x 32], both from shared memory; B
// K-major, A K-major (TA = 0) or M-major (TA = 1); D: 16 floats a thread.
template <int TA>
__device__ __forceinline__ void wgmma_m64n32k16_ss(float* d, uint64_t da,
                                                   uint64_t db, int accum) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, %19, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accum), "n"(TA));
}

// D[64 x 64] (+)= A[64 x 16] · B[16 x 64], both from shared memory; B
// K-major, A K-major (TA = 0) or M-major (TA = 1); D: 32 floats a thread.
template <int TA>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t da,
                                                   uint64_t db, int accum) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accum), "n"(TA));
}

// D[64 x 128] (+)= A[64 x 16] · B[16 x 128], both from shared memory; B
// K-major, A K-major (TA = 0) or M-major (TA = 1); D: 64 floats a thread.
template <int TA>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float* d, uint64_t da,
                                                   uint64_t db, int accum) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accum), "n"(TA));
}

// D[64 x 64] += A[64 x 16] · B[16 x 64], A from registers (each warp's
// m16k16 fragment), B N-major from shared memory; D: 32 floats a thread.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float* d, const uint32_t* a,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] · B[16 x 128], A from registers (each warp's
// m16k16 fragment), B N-major from shared memory; D: 64 floats a thread.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float* d, const uint32_t* a,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// wgmma_ss<N, TA>: the m64nNk16 product above of width N
template <int N, int TA>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int accum) {
  if constexpr (N == 8) wgmma_m64n8k16_ss<TA>(d, da, db, accum);
  else if constexpr (N == 16) wgmma_m64n16k16_ss<TA>(d, da, db, accum);
  else if constexpr (N == 32) wgmma_m64n32k16_ss<TA>(d, da, db, accum);
  else if constexpr (N == 64) wgmma_m64n64k16_ss<TA>(d, da, db, accum);
  else wgmma_m64n128k16_ss<TA>(d, da, db, accum);
}

// ---------------------------------------------------------------------------
// cp.async copies and warp-level products (mma.sync)
// ---------------------------------------------------------------------------

// 16 bytes global -> shared; `bytes` < 16 zero-fills the rest (0: all zero,
// `src` is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// four 8x8 b16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; `trans` hands each thread the transpose
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n" : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// two 8x8 b16 matrices, lanes 0-15 giving the row addresses (the others'
// are ignored)
__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n" : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]),
               "=r"(r[3]) : "r"(smem_u32(p)));
}

// the transpose of an 8x8 b16 matrix held one 32-bit pair a thread
// (thread l: row l / 4, columns 2(l % 4), +1)
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(d) : "r"(a));
  return d;
}

// D[16 x 8] += A[16 x 16] · B[16 x 8], bf16 in, f32 accumulate. Thread l
// (g = l / 4, t = l % 4) holds a = {A[g][2t..], A[g+8][2t..], A[g][2t+8..],
// A[g+8][2t+8..]}, b = {B[2t..][g], B[2t+8..][g]}, d = {D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = hi + lo, each a tf32 value: the 3xTF32 split. hi keeps x's top 10
// mantissa bits (truncated, so x - hi is exact in float32) and lo the next
// 10 or 11: hi + lo is x to ~2^-20 relative.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// D[16 x 8] += A[16 x 8] · B[8 x 8] in tf32, f32 accumulate. Thread l
// (g, t as above) holds a = {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]},
// b = {B[t][g], B[t+4][g]}, d as in mma_bf16_16816.
__device__ __forceinline__ void mma_tf32_1688(float* d, const uint32_t* a,
                                              const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[16 x 8·NT] += A[16 x K] · B[K x 8·NT] over k in [k0, k1) (multiples
// of 8) and the first `nv` column tiles, float32 operands through the
// 3xTF32 split (a_hi·b_hi + a_hi·b_lo + a_lo·b_hi: products to ~2^-19
// relative, where one tf32 product keeps ~2^-11). `a(i, k)` and `b(k, n)`
// read the operands (shared memory, with any scaling or mask folded in);
// each warp calls it for its own tile. The next step's operands load while
// this step's products run.
template <int NT, class FA, class FB>
__device__ __forceinline__ void mma3_tf32(float (&acc)[NT][4], int nv, int k0,
                                          int k1, FA a, FB b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float ar[4], br[NT][2];
  auto load = [&](int k) {
    ar[0] = a(g, k + t);
    ar[1] = a(g + 8, k + t);
    ar[2] = a(g, k + t + 4);
    ar[3] = a(g + 8, k + t + 4);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nv) {
        br[j][0] = b(k + t, 8 * j + g);
        br[j][1] = b(k + t + 4, 8 * j + g);
      }
    }
  };
  if (k0 < k1) load(k0);
  for (int k = k0; k < k1; k += 8) {
    uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(ar[e], ah[e], al[e]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      split_tf32(br[j][0], bh[j][0], bl[j][0]);
      split_tf32(br[j][1], bh[j][1], bl[j][1]);
    }
    if (k + 8 < k1) load(k + 8);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= nv) break;
      mma_tf32_1688(acc[j], al, bh[j]);
      mma_tf32_1688(acc[j], ah, bl[j]);
      mma_tf32_1688(acc[j], ah, bh[j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: TMA maps, made in the C entry point at each launch
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in the libcuda.so.1 that PyTorch loaded
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A bf16 3-d tensor of (inner, d1, d2) elements, d1 and d2 steps of s1 and
// s2 elements, as boxes of (64 inner elements, b1, b2), 128-byte swizzle;
// out-of-bounds elements read as zeros. TMA needs a 16-byte aligned base
// and steps.
inline cudaError_t tma_map(CUtensorMap* map, const void* ptr, int inner,
                           int d1, int d2, size_t s1, size_t s2, int b1,
                           int b2) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  if ((reinterpret_cast<uintptr_t>(ptr) & 15) || (s1 % 8) || (s2 % 8))
    return cudaErrorMisalignedAddress;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)d1,
                              (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)s1 * 2, (cuuint64_t)s2 * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)b1, (cuuint32_t)b2};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                         const_cast<void*>(ptr), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A bf16 [streams][rows][inner] tensor as boxes of (64 inner elements,
// box_rows, 1): TMA coordinates (column, row, stream).
inline cudaError_t tma_map_3d(CUtensorMap* map, const void* ptr, int inner,
                              int rows, int streams, int box_rows) {
  return tma_map(map, ptr, inner, rows, streams, inner, (size_t)rows * inner,
                 box_rows, 1);
}

// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) once a device for the
// kernel whose flags word `done` is (one per kernel, a bit per device).
template <class Kern>
inline cudaError_t allow_dynamic_smem(Kern kern, int bytes,
                                      unsigned* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = 1u << (dev & 31);
  if (__atomic_load_n(done, __ATOMIC_ACQUIRE) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) __atomic_fetch_or(done, bit, __ATOMIC_RELEASE);
  return e;
}

// Raise the kernel's dynamic shared memory bound to `bytes` when a launch
// needs more than it was allowed on this device so far (`allowed`: one
// entry a device, one array a kernel); the bound only grows.
template <class Kern>
inline cudaError_t grow_dynamic_smem(Kern kern, int bytes, int* allowed) {
  static std::mutex mu;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) dev = 63;
  std::lock_guard<std::mutex> lock(mu);
  if (allowed[dev] >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) allowed[dev] = bytes;
  return e;
}

}  // namespace sm90
}  // namespace repro
