// Hopper (sm_90a) building blocks shared by the kernels in this directory:
// mbarriers, TMA tile loads, wgmma shared-memory descriptors and the wgmma
// instructions themselves, as inline PTX.  Include after <cuda.h> (for
// CUtensorMap).
//
// The wgmma wrappers take bf16 operands and accumulate into f32 registers,
// m64nNk16: d is the 64 x N accumulator spread over the warpgroup's 128
// threads as PTX lays it out (thread t of warp w holds rows 16w + t/4 and
// 16w + t/4 + 8, columns 8j + 2(t%4) and +1, in d[4j .. 4j+3]).  wgmma_ss
// reads A and B from shared memory, both K-major (wgmma_ss_tb: B MN-major,
// its transpose bit set); wgmma_rs reads A from
// registers (the bf16 pairs of the same row/column layout) and B from
// shared memory MN-major (its transpose bit set); wgmma_rs_kmajor reads B
// K-major.  scale_d = 0 overwrites d, 1 accumulates into it.
//
// split_bf16 writes an f32 pair as bf16 hi = bf16(v) and lo = bf16(v - hi),
// both rounded to nearest even.  |v - hi| is at most half an ulp of hi,
// 2^(e-8) for 2^e <= |v| < 2^(e+1), and v - hi is exact in f32.  Unless
// |v - hi| is exactly 2^(e-8) (then lo = v - hi), v - hi lies below
// 2^(e-8), so its exponent is at most e - 9 and rounding it to bf16 (8
// significant bits) errs by at most 2^(e-9-8) = 2^(e-17): |v - hi - lo| <=
// 2^-17 |v|.  (The largest ratio over 10^7 random f32 values is 7.61e-6,
// just under 2^-17 = 7.63e-6.)  A product of two bf16 values is exact in
// f32, so a wgmma over hi and lo pieces loses only what the pieces drop.
// split3_bf16 adds a third piece: hi = bf16(v), mid = bf16(v - hi), lo =
// bf16(v - hi - mid), every difference exact in f32; v - hi - mid is the
// two-piece residual (at most 2^-17 |v|), and rounding it to bf16 errs by at
// most 2^-8 of it, so |v - hi - mid - lo| <= 2^-25 |v|.
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// (a, b) -> bf16 pairs hi = bf16(a, b) and lo = bf16((a, b) - hi), each
// within 2^-17 of its value (header).
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// (a, b) -> bf16 pairs hi, mid and lo, within 2^-25 of each value (header).
__device__ __forceinline__ void split3_bf16(float a, float b, uint32_t& hi, uint32_t& mid,
                                            uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const float ra = a - hf.x, rb = b - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(ra - mf.x, rb - mf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The f32 routes' six products of pieces (0 hi, 1 mid, 2 lo): product t
// multiplies piece term_a(t) of A by piece term_b(t) of B, smallest first
// (mid.mid, lo.hi, hi.lo, mid.hi, hi.mid, hi.hi); mid.lo, lo.mid and lo.lo
// (each at most 2^-25 of |a||b|) drop.
__device__ __forceinline__ constexpr int term_a(int t) {
  return t == 0 ? 1 : t == 1 ? 2 : t == 3 ? 1 : 0;
}
__device__ __forceinline__ constexpr int term_b(int t) {
  return t == 0 ? 1 : t == 2 ? 2 : t == 4 ? 1 : 0;
}

// Byte offset of (row, byte) in a tile whose rows are `sw` bytes, swizzled
// as TMA writes it (16-byte unit u of a row XOR bits 7.. of the offset);
// `off` is relative to a 1 KB aligned base.
__device__ __forceinline__ uint32_t swz(uint32_t off, uint32_t sw) {
  return off ^ (((off >> 7) & (sw / 16 - 1)) << 4);
}

// Makes this thread's ordinary stores to shared memory visible to the async
// proxy (wgmma operand reads); a barrier after it orders every thread's.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait that lasts
// about 10 s (a pipeline fault) traps, so the launch fails with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > 20000000000LL) __trap();
  }
}

// ------------------------------------------------------------------- TMA
// One box of a rank-4 tensor map into shared memory; completion is counted
// in bytes on `bar`.  c0 is the innermost coordinate.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
         "r"(bar)
      : "memory");
}

// One box of a rank-5 tensor map into shared memory (as tma_load_4d).
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
         "r"(c4), "r"(bar)
      : "memory");
}

// One box of shared memory out to a rank-4 / rank-5 tensor map (elements past
// the tensor's bounds are not written), in this thread's bulk group: the
// threads that wrote `src` fence_proxy_async and meet at a barrier first;
// bulk_commit then bulk_wait_read before `src` is written again or the
// block exits.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4}], [%5];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(src)
      : "memory");
}

__device__ __forceinline__ void tma_store_5d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4, %5}], [%6];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4),
         "r"(src)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

// `bytes` contiguous bytes of device memory into shared memory, counted on
// `bar` as a TMA box is; src and dst 16-byte aligned, bytes a multiple of 16.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// 16 bytes of device memory into shared memory without passing through
// registers (cp.async, cached in L2 only); the first `bytes` (0 or 16) come
// from src, the rest are zeros.  Complete after cp_async_commit and
// cp_async_wait<0>; then a barrier makes them visible to the block, and
// fence_proxy_async to wgmma.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Barrier `id` (1..15; 0 is __syncthreads) over kThreads threads, whole warps.
template <int kThreads>
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(kThreads) : "memory");
}

// Arrive at barrier `id` without waiting (the threads that bar.sync on it
// wait for these); orders this thread's earlier shared-memory accesses
// before the waiters' later ones.
template <int kThreads>
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "n"(kThreads) : "memory");
}

// (lo, hi) rounded to a bf16 pair (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------------ wgmma
// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle mode (1: 128 B, 2: 64 B, 3: 32 B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes, uint32_t swizzle_mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32) | ((uint64_t)swizzle_mode << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// m64nNk16, bf16 x bf16 -> f32; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// m64n128k16, bf16 x bf16 -> f32; A K-major and B MN-major (its transpose
// bit set), both in shared memory.
__device__ __forceinline__ void wgmma_ss_tb(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// m64nNk16, bf16 x bf16 -> f32; A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// m64n64k16, bf16 x bf16 -> f32; A in registers, B K-major in shared memory.
__device__ __forceinline__ void wgmma_rs_kmajor(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// ---------------------------------------------------- mma.sync (one warp)
// Four 8 x 8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 (16 bytes), and register j of lane t holds
// matrix j's (row t / 4, columns 2 (t % 4) and + 1); with .trans, its
// (rows 2 (t % 4) and + 1, column t / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// Two matrices, .trans; lanes 0-15 give the addresses.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr) : "memory");
}

// d += a.b, m16n8k16, bf16 x bf16 -> f32.  a: the 16 x 16 A fragment (a[0]
// rows t/4, columns 2(t%4) and +1; a[1] rows + 8; a[2] columns + 8; a[3]
// both); b0, b1: the 16 x 8 B fragment (rows 2(t%4) and +1, column t/4;
// rows + 8); d: rows t/4 (d[0], d[1]) and t/4 + 8 (d[2], d[3]), columns
// 2(t%4) and +1 -- the layout of a[0] / a[1] over 8 columns, so two
// neighbouring accumulators of scores are one A fragment.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mma_bf16 on fragments a warp gathers element by element (the `ssd_chunk`
// one-pass kernels, forward and backward): f(row, col) gives an f32 value,
// and each f32 operand enters as bf16 hi + lo (split_bf16).
//
// The A fragment (mma_bf16's register order) of rows r0 .. r0 + 15 and
// columns k0 .. k0 + 15 of f(row, col).
template <class F>
__device__ __forceinline__ void frag_a(float (&a)[8], F f, int r0, int k0) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  a[0] = f(r0 + g, k0 + 2 * t);
  a[1] = f(r0 + g, k0 + 2 * t + 1);
  a[2] = f(r0 + g + 8, k0 + 2 * t);
  a[3] = f(r0 + g + 8, k0 + 2 * t + 1);
  a[4] = f(r0 + g, k0 + 2 * t + 8);
  a[5] = f(r0 + g, k0 + 2 * t + 9);
  a[6] = f(r0 + g + 8, k0 + 2 * t + 8);
  a[7] = f(r0 + g + 8, k0 + 2 * t + 9);
}

// The B fragment of rows k0 .. k0 + 15 and columns n0 .. n0 + 7 of f(k, n).
template <class F>
__device__ __forceinline__ void frag_b(float (&b)[4], F f, int k0, int n0) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  b[0] = f(k0 + 2 * t, n0 + g);
  b[1] = f(k0 + 2 * t + 1, n0 + g);
  b[2] = f(k0 + 2 * t + 8, n0 + g);
  b[3] = f(k0 + 2 * t + 9, n0 + g);
}

// An A (B) fragment as bf16 hi and lo pieces.
__device__ __forceinline__ void split_a(const float (&a)[8], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) split_bf16(a[2 * r], a[2 * r + 1], hi[r], lo[r]);
}
__device__ __forceinline__ void split_b(const float (&b)[4], uint32_t (&hi)[2], uint32_t (&lo)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) split_bf16(b[2 * r], b[2 * r + 1], hi[r], lo[r]);
}

// d += a.b on one m16n8k16 tile from pieces: a's lo piece where kA, b's
// where kB (a bf16 input is exact as its hi piece alone): the products of
// pieces but lo.lo, small terms first (lo.hi, hi.lo, hi.hi).
template <bool kA, bool kB>
__device__ __forceinline__ void mma_pieces(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  if (kA) mma_bf16(d, al, bh[0], bh[1]);
  if (kB) mma_bf16(d, ah, bl[0], bl[1]);
  mma_bf16(d, ah, bh[0], bh[1]);
}

// mma_pieces from f32 fragments, split here.
template <bool kA, bool kB>
__device__ __forceinline__ void mma_split(float (&d)[4], const float (&a)[8], const float (&b)[4]) {
  uint32_t ah[4], al[4], bh[2], bl[2];
  split_a(a, ah, al);
  split_b(b, bh, bl);
  mma_pieces<kA, kB>(d, ah, al, bh, bl);
}

// Row and column of accumulator element e of the tile at (m0, n0).
__device__ __forceinline__ int acc_row(int m0, int e) {
  return m0 + threadIdx.x % 32 / 4 + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int n0, int e) {
  return n0 + 2 * (threadIdx.x % 4) + (e & 1);
}

}  // namespace hopper

// ------------------------------------------------------------------------
// The packed route of flash_attention (csrc/flash_attention.cu, forward;
// csrc/flash_attention_bwd.cu, backward): what both kernels and their
// wrapper (`flash_attention.packed_plan`) share.  A unit is one (record b,
// KV head kv): its q rows are the G = H / K heads of the group at every
// position, row (s, g) in the order of q.reshape(B, Sq, K, G, D).  A tile
// holds U whole units (G * Sq * U <= kRows rows) or, where one unit is
// longer than kRows, P positions of one unit; its keys are the U units' Sk
// keys each, U * Sk <= N rows.
namespace packed {

constexpr int kRows = 128;     // q rows a tile: 8 warps of 16 (PACKED_ROWS in the wrapper)
constexpr int kThreads = 256;

// bf16 tiles as TMA writes them: rows of SW bytes (one chunk of CW
// columns), NC chunks across D, each chunk's 16-byte units swizzled by row.
template <int D>
struct Sw {
  static constexpr int SW = D >= 64 ? 128 : 2 * D;
  static constexpr int CW = SW / 2;
  static constexpr int NC = D / CW;
};

// Address of element (row, col) of a bf16 tile of `rows` rows at `tile` (1 KB
// aligned).
template <int D>
__device__ __forceinline__ uint32_t at(uint32_t tile, int rows, int row, int col) {
  constexpr int SW = Sw<D>::SW, CW = Sw<D>::CW;
  return tile + (col / CW) * rows * SW + hopper::swz(row * SW + (col % CW) * 2, SW);
}

// A launch's packing (the wrapper's `packed_plan`).
struct Geo {
  int B, Sq, Sk, H, K, G;
  int U;  // records a tile
  int P;  // positions a tile
  int T;  // tiles a unit
};

inline CUtensorMapSwizzle swizzle_of(int D) {
  return D >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                 : D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
}

// q, out, dO or dq (B, Sq, H, D) bf16 as (D, G, K, Sq, B): a box (one chunk
// of D, G, 1, P, U) is one tile of rows (g, s, u), fastest first.
inline CUresult q_map(CUtensorMap* map, const void* ptr, const Geo& g, int D) {
  const int CW = (D >= 64 ? 128 : 2 * D) / 2;
  const cuuint64_t dims[5] = {(cuuint64_t)D, (cuuint64_t)g.G, (cuuint64_t)g.K, (cuuint64_t)g.Sq,
                              (cuuint64_t)g.B};
  const cuuint64_t strides[4] = {(cuuint64_t)D * 2, (cuuint64_t)g.G * D * 2,
                                 (cuuint64_t)g.H * D * 2, (cuuint64_t)g.Sq * g.H * D * 2};
  const cuuint32_t box[5] = {(cuuint32_t)CW, (cuuint32_t)g.G, 1, (cuuint32_t)g.P,
                             (cuuint32_t)g.U};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(ptr),
                                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                swizzle_of(D), CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// k, v, dk or dv (B, Sk, K, D) bf16 as (D, K, Sk, B): a box (one chunk of
// D, 1, Sk, U) is the U units' keys, U * Sk rows.
inline CUresult kv_map(CUtensorMap* map, const void* ptr, const Geo& g, int D) {
  const int CW = (D >= 64 ? 128 : 2 * D) / 2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)g.K, (cuuint64_t)g.Sk, (cuuint64_t)g.B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)g.K * D * 2,
                                 (cuuint64_t)g.Sk * g.K * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)CW, 1, (cuuint32_t)g.Sk, (cuuint32_t)g.U};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                swizzle_of(D), CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The plan's limits (packed_plan checks the same): G * P * U rows fit a
// tile, P * T covers Sq with no tile wholly past it, U * Sk keys fit N, every
// box dimension at most 256, the grid's blocks an int.
inline bool bad_geo(const Geo& g, int N) {
  return g.B < 1 || g.Sq < 1 || g.Sk < 1 || g.K < 1 || g.H != g.G * g.K || g.U < 1 || g.P < 1 ||
         g.T < 1 || g.G > 256 || g.P > 256 || g.U > 256 || g.Sk > 256 ||
         g.G * g.P * g.U > kRows || g.P * g.T < g.Sq || (g.T - 1) * g.P >= g.Sq ||
         (g.T > 1 && g.U != 1) || (g.T == 1 && g.P != g.Sq) || g.U * g.Sk > N ||
         (long long)((g.B + g.U - 1) / g.U) * g.K * g.T > 2147483647LL;
}

}  // namespace packed

// The packed kernels' (D, N) instantiations, FN<D, N>(...) for runtime D
// and N: N in {16, 32, 64}, at most 32 at D = 256 (PACKED_KEYS and
// PACKED_MAX_KEYS in the wrapper); any other pair returns
// cudaErrorInvalidValue.
#define PACKED_DISPATCH(FN, ...)                                        \
  switch (D * 1000 + N) {                                                \
    case 16016: return FN<16, 16>(__VA_ARGS__);                          \
    case 16032: return FN<16, 32>(__VA_ARGS__);                          \
    case 16064: return FN<16, 64>(__VA_ARGS__);                          \
    case 32016: return FN<32, 16>(__VA_ARGS__);                          \
    case 32032: return FN<32, 32>(__VA_ARGS__);                          \
    case 32064: return FN<32, 64>(__VA_ARGS__);                          \
    case 64016: return FN<64, 16>(__VA_ARGS__);                          \
    case 64032: return FN<64, 32>(__VA_ARGS__);                          \
    case 64064: return FN<64, 64>(__VA_ARGS__);                          \
    case 128016: return FN<128, 16>(__VA_ARGS__);                        \
    case 128032: return FN<128, 32>(__VA_ARGS__);                        \
    case 128064: return FN<128, 64>(__VA_ARGS__);                        \
    case 256016: return FN<256, 16>(__VA_ARGS__);                        \
    case 256032: return FN<256, 32>(__VA_ARGS__);                        \
    default: return cudaErrorInvalidValue;                               \
  }

