// The gradient of the Mamba-2 SSD intra-chunk block for Hopper (sm_90a),
// plain C interface.
//
// Replaces no TPU kernel.  It is the gradient of the function that the
// Pallas kernel `ssd_chunk` computes (src/repro/kernels/ssd_scan.py:25-41);
// the JAX package trains by differentiating its plain `ssd_chunked`
// (src/repro/models/ssm.py:33) and has no backward kernel.  It is added so
// that the port's SSM family trains on the card through `ssd_chunk`'s
// autograd Function (kernels/ssd_scan.py `SSDChunk`).
//
// The forward, per chunk c and head h of group g = h / (H / G):
//
//   cum   = cumsum(dA)                         L[i, j] = exp(cum_i - cum_j), j <= i, else 0
//   S     = C_g B_g^T                          M = S * L
//   w_j   = exp(cum_{Q-1} - cum_j)
//   y     = M x          st = (w * x)^T B_g    dec = exp(cum_{Q-1})
//
// Given dy (nc, Q, H, P), dst (nc, H, P, N) and ddec (nc, H), all f32:
//
//   v      = B_g dst^T                               (Q, P)
//   dx     = M^T dy + w * v
//   dM     = dy x^T,   dS_h = dM * L
//   dC_g   = (sum_h dS_h) B_g
//   dB_g   = (sum_h dS_h)^T C_g + sum_h (w_h * x_h) dst_h   ((Q, P) times (P, N))
//   G      = dM * M  (lower triangle)
//   dcum_i = sum_j G_ij - sum_k G_ki - u_i,   u_j = w_j sum_p x_jp v_jp
//   dcum_{Q-1} += sum_j u_j + ddec * dec
//   ddA    = reverse cumsum of dcum
//
// Every product of the inputs is exact in f32 and every sum is taken in f32
// in a fixed order: no atomics, so two calls on the same inputs give the
// same bits (a restart that replays a step relies on it).  dx, dB and dC are
// rounded once to the inputs' type at the end; ddA is f32.
//
// Bound on an H100 SXM: at the training shape (mamba2-2.7b, 4 x 4096 tokens
// in chunks of 256: nc 64, Q 256, H 80, G 1, P 64, N 128, bf16 inputs) the
// function reads x, B, C (bf16), dA, dy, dst and ddec (f32) and writes dx,
// dB, dC (bf16) and ddA (f32): 0.87 GB, 0.26 ms at 3.35 TB/s.  Its
// multiply-adds on the causal pairs, dM and M^T dy over P and the two state
// products per head, S, dC and dB per chunk and group, are 8.8e10 flops
// (chip_smoke.py `ssd_bwd_bound`): 1.3 ms at the 67 TFLOP/s f32 CUDA-core
// peak; the tensor-core route's bf16 products of pieces (2.2e11 flops) take
// 0.22 ms at the 989 TFLOP/s bf16 peak, so there bytes bound it.
//
// Two routes, both on the tensor cores; the wrapper picks one before the
// launch (`ssd_scan.backward_route`): the one-pass kernel (`op::bwd_chunk`,
// below the wgmma kernels) for the calls off the wgmma shapes at chunks of
// at most 32 tokens, the wgmma kernels for every other call.  The wgmma
// kernels compute S = C B^T once per chunk and group into a device scratch
// first and end with `bwd_dc` (dC = (sum_h dS_h) B from the scratch's group
// sums, CUDA cores); cum goes through the scratch too.
//
// x, B and C at the forward's tensor-core shapes (P in {16, 32, 64}, N in
// {16, 32, 64, 128}, 16-byte alignment), bf16 as follows and f32 as the
// paragraph after: `tc::bwd_scores` (S^T, one
// wgmma chain a 64 x 64 tile), `tc::bwd_dx` and `tc::bwd_group`, on
// wgmma.  The bf16 inputs are exact as one bf16 piece; every f32 operand of
// a product (dy, dst, M = S * L, w * x, sum dS) enters as bf16 hi + lo
// (hopper::split_bf16, within 2^-17 of the value), and each product runs
// as the products of pieces, small terms first: a dropped lo
// piece of dy or dst moves ddA past its 1e-4 limit (CPU emulation,
// tests/test_torch_ssd_bwd_tc.py).  All work is laid out on the transposed
// tiles (rows j, columns i >= j): S^T's rows are M^T's, which is the A
// operand of dx's product straight from the accumulator's registers.
//   `tc::bwd_dx`: one block of two warpgroups per chunk and head.  x and B
// arrive by TMA while the threads split dy and dst into swizzled bf16
// pieces; warpgroup min(b, nt-1-b) % 2 takes row band b (bands 0 and 3, 1
// and 2 at Q 256: five 64 x 64 tiles each): v_j = B_j dst^T (wgmma, B
// exact), u_j = w_j x_j . v_j, dx_j = w_j v_j; per column tile i >= j, dM^T
// = x_j dy_i^T (wgmma), M^T = S^T exp(cum_i - cum_j) selected to 0 for i <
// j (S^T's tile read from the scratch a tile ahead), G^T = dM^T M^T summed
// by rows (colG_j) and by columns (the band's share of rowG_i, summed over
// bands in order through shared memory), dx_j += M^T dy_i (wgmma from
// registers).  Then dcum and ddA as the CUDA-core route; the head's cum to
// the scratch.  207,880 B of shared memory at the training shape: one block
// a SM, so a block's staging is not overlapped with any tile's products.
//   `tc::bwd_group`: one block of two warpgroups per chunk, group and row
// band j (bands on the grid's slow axis, the heavy ones first): for each
// head of the group in head order, its x rows of the band (TMA), dy rows i
// >= j (TMA), dst and cum (bulk copies) land in shared memory on one
// mbarrier while the previous head's products run, and the threads split dy
// and dst into pieces.  Warpgroup k keeps the sum over heads of dS^T = (x_j
// dy_i^T) L^T for the tiles i = j + k, j + k + 2 in registers (f32, head
// order), and the warpgroup of the head's parity adds its state term (w
// x)_j dst to its dB accumulator (wgmma: w x split in registers, dst
// MN-major).  At the end each adds (sum dS^T)_ji C_i (C by cp.async), writes
// its sums to the scratch as (sum_h dS_h)[i][j], and warpgroup 0 adds
// warpgroup 1's accumulator and stores dB_j: no atomics anywhere, so two
// calls give the same bits.
//
// f32 x, B and C at the same shapes (token strides 16 bytes apart) take
// the same kernels with those three split into bf16 hi + lo as well (the
// f32 forward's `tc::ssd_chunk_split` holds its limits so), every product
// of two split operands as three products of pieces (lo.hi, hi.lo, hi.hi)
// and u = w x . v with x as hi + lo: within 2.2e-5 of each gradient's
// largest value in the CPU emulation (the f32 limits are 1e-4), and each lo
// piece kept is needed (tests/test_torch_ssd_bwd_tc.py).  Shared memory is
// what changes.  x's two pieces (64 KB at Q 256, P 64) and dy's (64 KB)
// leave `tc::bwd_dx` no room for B's two pieces (128 KB), so v = B dst^T
// comes from `tc::bwd_v`, a kernel of its own run after `tc::bwd_scores`:
// one block per (chunk and group, 64-row band, run of 8 heads), B's band
// and two heads' dst split by the threads (96 KB: two blocks an SM), v to
// the scratch V (nc, H, Q, P) f32 (335 MB at the training shape, written
// once and read once), and `tc::bwd_dx` reads its rows in the accumulator's
// layout (142,344 B).  `tc::bwd_scores` splits B's band and C's rows (164,864
// B); `tc::bwd_group` splits each head's x band rows into its two x buffers
// (the bf16 route's double buffer, so x is not landed ahead: 217,096 B as in
// bf16) and C into two tiles at the end; `bwd_dc` reads f32 B.  Bound at
// (64, 256, 80, 1, 64, 128) f32: 1.22 GB of inputs and outputs, 0.36 ms on
// bytes; the products of pieces take 0.27 ms at the bf16 peak.
//
// Every other call (P 8 or 24, N 40 or 48, misaligned or odd-stride
// slices) at chunks longer than 32 tokens takes the wgmma kernels on
// operands the wrapper zero-pads to the next P of {16, 32, 64} and N of
// {16, 32, 64, 128} in fresh aligned copies (`ssd_scan.pad_to_tensor_cores`:
// zero columns add exact zeros to every sum).
// B and C are read as `ssd_chunk` takes them, strided slices of the
// projection (a token stride each); x likewise; dy, dst, ddec and dA are
// contiguous and the outputs are written contiguous.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // threads a block of bwd_dc
constexpr int kMaxQ = 256;     // chunk length at most (and a multiple of 16)
constexpr int kMaxN = 128;     // state dim at most
constexpr int kTile = 32;      // rows (columns) of the group kernels' tiles
constexpr int kPMax = 64;      // head dim at most

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Inclusive scan of v[0..Q) in place by warp 0 (the caller syncs before and
// after): lane l sums its k = ceil(Q / 32) consecutive values in order, the
// lanes' totals are scanned by shuffles, and each lane adds the sum of the
// lanes before it.  reverse scans from the end (v[i] = sum_{k >= i}).
__device__ void warp_scan(float* v, int Q, bool reverse) {
  const int lane = threadIdx.x & 31;
  const int k = (Q + 31) / 32;
  const int lo = lane * k, hi = min(lo + k, Q);
  float run = 0.f;
  for (int a = lo; a < hi; ++a) {
    const int i = reverse ? Q - 1 - a : a;
    run += v[i];
    v[i] = run;
  }
  float incl = run;
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += o;
  }
  const float before = incl - run;
  for (int a = lo; a < hi; ++a) {
    const int i = reverse ? Q - 1 - a : a;
    v[i] += before;
  }
}

// Rows [i0, i0 + 32) of dC = (sum_h dS_h) B over j <= i, for chunk c
// and group g: a thread owns column n and 16 rows, the scratch's rows read
// as float4 broadcasts after a transposed staging.  grid (Q / 32, nc * G).
constexpr int kRowPad = kTile + 4;  // a row of 32 floats, 16-byte aligned

template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_dc(
    const T* __restrict__ B, const float* __restrict__ dSsum, T* __restrict__ dC, int Q, int G,
    int N, long long sB) {
  __shared__ __align__(16) float dSt[kTile][kRowPad];  // [j][i]
  __shared__ float Bc[kTile][kMaxN];                     // [j][n]
  const int t = threadIdx.x;
  const int i0 = blockIdx.x * kTile;
  const int cg = blockIdx.y, c = cg / G, g = cg % G;
  const int n = t & 127, half = t >> 7;
  const long long base = (long long)cg * Q * Q;
  float acc[kTile / 2];
#pragma unroll
  for (int rr = 0; rr < kTile / 2; ++rr) acc[rr] = 0.f;
  const int jend = min(Q, i0 + kTile);
  for (int jb = 0; jb < jend; jb += kTile) {
    __syncthreads();
    for (int idx = t; idx < kTile * kTile; idx += kThreads) {
      const int ii = idx / kTile, jj = idx % kTile, i = i0 + ii, j = jb + jj;
      dSt[jj][ii] = (i < Q && j <= i) ? dSsum[base + (long long)i * Q + j] : 0.f;
    }
    for (int idx = t; idx < kTile * kMaxN; idx += kThreads) {
      const int jj = idx / kMaxN, nn = idx % kMaxN, j = jb + jj;
      Bc[jj][nn] = (j < Q && nn < N) ? ld(B + ((long long)c * Q + j) * sB + (long long)g * N + nn) : 0.f;
    }
    __syncthreads();
    for (int jj = 0; jj < kTile; ++jj) {
      const float bv = Bc[jj][n];
      const float4* d = reinterpret_cast<const float4*>(&dSt[jj][half * (kTile / 2)]);
#pragma unroll
      for (int q = 0; q < kTile / 8; ++q) {
        const float4 v = d[q];
        acc[4 * q] += v.x * bv;
        acc[4 * q + 1] += v.y * bv;
        acc[4 * q + 2] += v.z * bv;
        acc[4 * q + 3] += v.w * bv;
      }
    }
  }
  if (n >= N) return;
#pragma unroll
  for (int rr = 0; rr < kTile / 2; ++rr) {
    const int i = i0 + half * (kTile / 2) + rr;
    if (i < Q) st(dC + (((long long)c * Q + i) * G + g) * N + n, acc[rr]);
  }
}

template <typename F>
cudaError_t attrs(F* fn, int dynamic_smem, int* regs, int* smem) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return err;
  *regs = a.numRegs;
  *smem = (int)a.sharedSizeBytes + dynamic_smem;
  return cudaSuccess;
}

// --------------------------------------------------- bf16: tensor cores
namespace tc {

constexpr int kRows = 64;      // rows of a tile (a band): one warpgroup's wgmma M
constexpr int kTcThreads = 256;  // two warpgroups

using hopper::split_bf16;
using hopper::swz;

template <int P, int N>
struct Cfg {
  static constexpr int SWX = 2 * P;                  // x, dy: one swizzled chunk of P columns
  static constexpr uint32_t kModeX = SWX == 128 ? 1 : SWX == 64 ? 2 : 3;
  static constexpr int SWB = N >= 64 ? 128 : 2 * N;  // B, C, dst: chunks of SWB bytes
  static constexpr int CWB = SWB / 2;                // bf16 columns a chunk
  static constexpr int NCB = N / CWB;                // chunks across N
  static constexpr uint32_t kModeB = SWB == 128 ? 1 : SWB == 64 ? 2 : 3;
  static constexpr int LW = P < 32 ? P : 32;         // f32 dy columns a TMA box (128 B at most)
};

__host__ __device__ constexpr uint32_t kb_up(uint32_t bytes) { return (bytes + 1023u) & ~1023u; }

// Rows [r0, r1) of a (rows, W) bf16 operand whose row t starts at src + t
// tok into a swizzled tile [W / (SW / 2)][rows_pad][SW] at shared address
// dst (row t at its own index), as TMA would write it; zeros from row Q on.
// By cp.async, 16 bytes a thread at a time: complete once the caller has
// committed and waited.
template <int W, int SW>
__device__ __forceinline__ void load_bf16(uint32_t dst, const __nv_bfloat16* src, long long tok,
                                          int r0, int r1, int Q, int rows_pad) {
  constexpr int CW = SW / 2, U = W / 8;
  const int units = (r1 - r0) * U;
  for (int u = threadIdx.x; u < units; u += kTcThreads) {
    const int t = r0 + u / U, col = (u % U) * 8;
    const bool in = t < Q;
    hopper::cp_async16(dst + (col / CW) * rows_pad * SW + swz(t * SW + (col % CW) * 2, SW),
                       in ? src + (size_t)t * tok + col : src, in ? 16u : 0u);
  }
}

// Eight f32 values as bf16 hi and lo pieces (hopper::split_bf16), stored as
// one 16-byte unit each at byte offset `off` of hi and lo.
__device__ __forceinline__ void split_unit(uint8_t* hi, uint8_t* lo, uint32_t off, float4 a,
                                           float4 b) {
  uint4 h, l;
  split_bf16(a.x, a.y, h.x, l.x);
  split_bf16(a.z, a.w, h.y, l.y);
  split_bf16(b.x, b.y, h.z, l.z);
  split_bf16(b.z, b.w, h.w, l.w);
  *reinterpret_cast<uint4*>(hi + off) = h;
  *reinterpret_cast<uint4*>(lo + off) = l;
}

// Rows [r0, r1) of a (rows, W) f32 operand (row t at src + t tok) as bf16
// hi and lo pieces in two swizzled tiles laid out as load_bf16's; zeros from
// row Q on.  Every thread keeps KB 16-byte units' loads in flight before it
// stores any.
template <int W, int SW, int KB>
__device__ __forceinline__ void stage_split(uint8_t* hi, uint8_t* lo, const float* src,
                                            long long tok, int r0, int r1, int Q, int rows_pad) {
  constexpr int CW = SW / 2, U = W / 8;
  const int units = (r1 - r0) * U;
  for (int u0 = threadIdx.x; u0 < units; u0 += KB * kTcThreads) {
    float4 v[KB][2];
#pragma unroll
    for (int b = 0; b < KB; ++b) {
      const int u = u0 + b * kTcThreads, t = r0 + u / U, col = (u % U) * 8;
      v[b][0] = v[b][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (u < units && t < Q) {
        const float4* s4 = reinterpret_cast<const float4*>(src + (size_t)t * tok + col);
        v[b][0] = s4[0];
        v[b][1] = s4[1];
      }
    }
#pragma unroll
    for (int b = 0; b < KB; ++b) {
      const int u = u0 + b * kTcThreads, t = r0 + u / U, col = (u % U) * 8;
      if (u >= units) break;
      split_unit(hi, lo, (col / CW) * rows_pad * SW + swz(t * SW + (col % CW) * 2, SW), v[b][0],
                 v[b][1]);
    }
  }
}

// Rows [r0, r1) of a (rows, W) f32 tile in shared memory, landed in column
// pieces of LW floats ([W / LW][rows_pad][LW], as TMA boxes LW wide leave
// it; LW = W: plain rows), as bf16 hi and lo pieces laid out as
// stage_split's.  Every thread reads KB units before it splits any.
template <int W, int SW, int LW, int KB>
__device__ __forceinline__ void split_tile(uint8_t* hi, uint8_t* lo, const float* src, int r0,
                                           int r1, int rows_pad) {
  constexpr int CW = SW / 2, U = W / 8;
  const int units = (r1 - r0) * U;
  for (int u0 = threadIdx.x; u0 < units; u0 += KB * kTcThreads) {
    float4 v[KB][2];
#pragma unroll
    for (int b = 0; b < KB; ++b) {
      const int u = u0 + b * kTcThreads, t = r0 + u / U, col = (u % U) * 8;
      if (u < units) {
        const float4* s4 = reinterpret_cast<const float4*>(
            src + ((size_t)(col / LW) * rows_pad + t) * LW + col % LW);
        v[b][0] = s4[0];
        v[b][1] = s4[1];
      }
    }
#pragma unroll
    for (int b = 0; b < KB; ++b) {
      const int u = u0 + b * kTcThreads, t = r0 + u / U, col = (u % U) * 8;
      if (u >= units) break;
      split_unit(hi, lo, (col / CW) * rows_pad * SW + swz(t * SW + (col % CW) * 2, SW), v[b][0],
                 v[b][1]);
    }
  }
}

// Columns i0 .. i0 + 63 of rows r0 and r1 of S^T (bwd_scores' scratch, row
// j at St + j Q), in the accumulator layout: entries i < j, which bwd_scores
// never wrote, and those past Q are not read.
__device__ __forceinline__ void load_st(float (&s)[32], const float* St, int i0, int r0, int r1,
                                        int Q, int cq) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int col = i0 + 8 * jj + cq;
    float2 a = make_float2(0.f, 0.f), d = make_float2(0.f, 0.f);
    if (col < Q && r0 < Q && col + 1 >= r0)
      a = *reinterpret_cast<const float2*>(St + (size_t)r0 * Q + col);
    if (col < Q && r1 < Q && col + 1 >= r1)
      d = *reinterpret_cast<const float2*>(St + (size_t)r1 * Q + col);
    s[4 * jj] = a.x;
    s[4 * jj + 1] = a.y;
    s[4 * jj + 2] = d.x;
    s[4 * jj + 3] = d.y;
  }
}

// exp(x) as the special-function unit gives it (ex2.approx of x log2(e),
// within a few ulp where |x| is small; results below 2^-126 flush to 0):
// two instructions and no branch, so the masked loops below interleave.
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// Columns (col, col + 1) of row t of a swizzled one-chunk tile of SW-byte
// rows, widened to f32.
template <int SW>
__device__ __forceinline__ float2 tile_pair(const uint8_t* tile, int t, int col) {
  const __nv_bfloat162 v =
      *reinterpret_cast<const __nv_bfloat162*>(tile + swz(t * SW + col * 2, SW));
  return __bfloat1622float2(v);
}

// The products of two operands' pieces (0 hi, 1 lo) that an f32 product
// runs, small terms first: lo.hi, hi.lo, hi.hi (lo.lo, within 2^-34 of the
// product, drops).  With one operand exact in bf16 (its hi piece alone) the
// terms of the other's pieces run in the same order.
template <bool kSplitA, bool kSplitB>
struct Terms {
  static constexpr int n = kSplitA && kSplitB ? 3 : kSplitA || kSplitB ? 2 : 1;
  static __host__ __device__ constexpr int a(int t) {
    return kSplitA && t == 0 ? 1 : 0;
  }
  static __host__ __device__ constexpr int b(int t) {
    return kSplitB && t == (kSplitA ? 1 : 0) && n > 1 ? 1 : 0;
  }
};

// Rows [r0, r1) of a (rows, W) operand of type T (row t at src + t tok) into
// its swizzled tile(s) at shared address dst (laid out as load_bf16's), zeros
// from row Q on: bf16 as it is by cp.async (complete once the caller has
// committed and waited), f32 as bf16 hi and lo pieces (lo `lo_off` bytes
// after hi) by the threads.
template <typename T, int W, int SW, int KB>
__device__ __forceinline__ void load_operand(uint8_t* gbase, uint32_t base, uint32_t dst,
                                             uint32_t lo_off, const T* src, long long tok, int r0,
                                             int r1, int Q, int rows_pad) {
  if constexpr (sizeof(T) == 4)
    stage_split<W, SW, KB>(gbase + (dst - base), gbase + (dst + lo_off - base), src, tok, r0, r1,
                           Q, rows_pad);
  else
    load_bf16<W, SW>(dst, src, tok, r0, r1, Q, rows_pad);
}

// Two adjacent output values (8-byte aligned for f32, 4-byte for bf16).
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = hopper::pack_bf16(a, b);
}

// 1, tensor cores.  S^T = B C^T of chunk c and group g for row band j and
// its column tiles i >= j, to the scratch as S^T[j][i] (row-major: the
// layout bwd_dx reads).  bf16 x bf16 products are exact in f32, so in bf16
// S^T is the CUDA-core kernel's up to the order of summation; f32 B and C
// enter as hi and lo pieces, three products.  One block of two warpgroups a
// band (warpgroup k takes the tiles i = j + k, j + k + 2); B's band rows
// and C's rows i >= j arrive by cp.async (bf16) or are split by the threads
// (f32); grid (nc * G, nt).
template <typename T, int P, int N>
__global__ void __launch_bounds__(kTcThreads, 1) bwd_scores(
    const T* __restrict__ B, const T* __restrict__ C, float* __restrict__ St, int Q, int G,
    long long sB, long long sC) {
  using K = Cfg<P, N>;
  using Tm = Terms<sizeof(T) == 4, sizeof(T) == 4>;
  constexpr int SWB = K::SWB, CWB = K::CWB;
  const int nt = (Q + kRows - 1) / kRows, qpad = nt * kRows;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t bb = kb_up(K::NCB * kRows * SWB), cb = kb_up(K::NCB * qpad * SWB);
  const uint32_t b_s = base, c_s = base + (sizeof(T) == 4 ? 2 : 1) * bb;  // piece p: + p bb, + p cb
  const int cgi = blockIdx.x, c = cgi / G, g = cgi % G, j = blockIdx.y, j0 = j * kRows;
  const int wg = threadIdx.x / 128, wt = threadIdx.x % 128, warp = wt / 32, lane = wt % 32;
  load_operand<T, N, SWB, 4>(gbase, base, b_s, bb, B + ((size_t)c * Q + j0) * sB + (size_t)g * N,
                             sB, 0, kRows, Q - j0, kRows);
  load_operand<T, N, SWB, 4>(gbase, base, c_s, cb, C + (size_t)c * Q * sC + (size_t)g * N, sC, j0,
                             qpad, Q, qpad);
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  hopper::fence_proxy_async();
  __syncthreads();
  const int r0 = j0 + 16 * warp + lane / 4, r1 = r0 + 8, cq = 2 * (lane % 4);
  float* const out = St + (size_t)cgi * Q * Q;
  for (int i = j + wg; i < nt; i += 2) {
    const int i0 = i * kRows;
    float acc[32];
    hopper::wgmma_fence();
#pragma unroll
    for (int t = 0; t < Tm::n; ++t)
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const uint32_t ch = kk * 16 / CWB, col = (kk * 16 % CWB) * 2;
        hopper::wgmma_ss(
            acc,
            hopper::make_desc(b_s + Tm::a(t) * bb + ch * kRows * SWB + col, 16, 8 * SWB,
                              K::kModeB),
            hopper::make_desc(c_s + Tm::b(t) * cb + ch * qpad * SWB + i0 * SWB + col, 16, 8 * SWB,
                              K::kModeB),
            t > 0 || kk > 0);
      }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = i0 + 8 * jj + cq;
      if (col >= Q) continue;
      if (r0 < Q)
        *reinterpret_cast<float2*>(out + (size_t)r0 * Q + col) =
            make_float2(acc[4 * jj], acc[4 * jj + 1]);
      if (r1 < Q)
        *reinterpret_cast<float2*>(out + (size_t)r1 * Q + col) =
            make_float2(acc[4 * jj + 2], acc[4 * jj + 3]);
    }
  }
}

template <typename T, int P, int N>
__host__ __device__ constexpr uint32_t scores_smem_bytes(int qpad) {
  using K = Cfg<P, N>;
  return 1024 + (sizeof(T) == 4 ? 2 : 1) *
                    (kb_up(K::NCB * kRows * K::SWB) + kb_up(K::NCB * qpad * K::SWB));
}

// 1b, tensor cores, f32 inputs only.  v_h = B_j dst_h^T (64 x P) of chunk c
// and row band j for a run of kVHeads heads of group g, to the scratch as
// V[c][h][t][p] (f32): bwd_dx reads it instead of staging B, whose two
// pieces would not fit beside x's and dy's.  B's band and each pair of
// heads' dst are split into hi and lo pieces by the block's threads;
// warpgroup k takes the pair's head k, three products of pieces (lo.hi,
// hi.lo, hi.hi); grid (nc * G, nt, ceil(H / G / kVHeads)).
constexpr int kVHeads = 8;

template <int P, int N>
__host__ __device__ constexpr uint32_t v_smem_bytes() {
  using K = Cfg<P, N>;
  return 1024 + 2 * kb_up(K::NCB * kRows * K::SWB) + 4 * kb_up(K::NCB * P * K::SWB);
}

template <int P, int N>
__global__ void __launch_bounds__(kTcThreads, 1) bwd_v(const float* __restrict__ B,
                                                       const float* __restrict__ dst,
                                                       float* __restrict__ V, int Q, int H, int G,
                                                       long long sB) {
  using K = Cfg<P, N>;
  using Tm = Terms<true, true>;
  constexpr int SWB = K::SWB, CWB = K::CWB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t bb = kb_up(K::NCB * kRows * SWB), db = kb_up(K::NCB * P * SWB);
  const uint32_t b_s = base, d_s = base + 2 * bb;  // B: hi, lo; dst: [pair slot][hi, lo]
  const int cgi = blockIdx.x, c = cgi / G, g = cgi % G, j0 = blockIdx.y * kRows;
  const int rep = H / G, k0 = blockIdx.z * kVHeads, k1 = min(rep, k0 + kVHeads);
  const int wg = threadIdx.x / 128, wt = threadIdx.x % 128, warp = wt / 32, lane = wt % 32;
  const int r0 = j0 + 16 * warp + lane / 4, r1 = r0 + 8, cq = 2 * (lane % 4);
  stage_split<N, SWB, 4>(gbase + (b_s - base), gbase + (b_s + bb - base),
                         B + ((size_t)c * Q + j0) * sB + (size_t)g * N, sB, 0, kRows, Q - j0,
                         kRows);
  for (int k = k0; k < k1; k += 2) {
    __syncthreads();  // the last pair's products have read its dst pieces
    for (int e = 0; e < 2 && k + e < k1; ++e)
      stage_split<N, SWB, 4>(gbase + (d_s + 2 * e * db - base), gbase + (d_s + (2 * e + 1) * db - base),
                             dst + ((size_t)c * H + g * rep + k + e) * P * N, N, 0, P, P, P);
    hopper::fence_proxy_async();
    __syncthreads();
    if (k + wg >= k1) continue;
    const uint32_t dw = d_s + 2 * wg * db;
    float acc[P / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int t = 0; t < Tm::n; ++t)
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const uint32_t ch = kk * 16 / CWB, col = (kk * 16 % CWB) * 2;
        hopper::wgmma_ss(
            acc,
            hopper::make_desc(b_s + Tm::a(t) * bb + ch * kRows * SWB + col, 16, 8 * SWB,
                              K::kModeB),
            hopper::make_desc(dw + Tm::b(t) * db + ch * P * SWB + col, 16, 8 * SWB, K::kModeB),
            t > 0 || kk > 0);
      }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    float* const out = V + ((size_t)c * H + g * rep + k + wg) * Q * P;
#pragma unroll
    for (int jj = 0; jj < P / 8; ++jj) {
      const int col = 8 * jj + cq;
      if (r0 < Q) *reinterpret_cast<float2*>(out + (size_t)r0 * P + col) = make_float2(acc[4 * jj], acc[4 * jj + 1]);
      if (r1 < Q)
        *reinterpret_cast<float2*>(out + (size_t)r1 * P + col) =
            make_float2(acc[4 * jj + 2], acc[4 * jj + 3]);
    }
  }
}

// The row (column) band a warpgroup of bwd_dx owns: bands b and nt - 1 - b
// go together, pairs alternating between the two warpgroups, so that each
// walks about half of the causal tiles.
__device__ __forceinline__ int band_owner(int b, int nt) { return min(b, nt - 1 - b) % 2; }

// bf16: x, dy's two pieces, B and dst's two pieces; f32: x's and dy's two
// pieces each (v comes from bwd_v's scratch).
template <typename T, int P, int N>
__host__ __device__ constexpr uint32_t dx_smem_bytes(int qpad) {
  using K = Cfg<P, N>;
  return 1024 + (sizeof(T) == 4 ? 4 * kb_up(qpad * K::SWX)
                                : 3 * kb_up(qpad * K::SWX) + kb_up(K::NCB * qpad * K::SWB) +
                                      2 * kb_up(K::NCB * P * K::SWB)) +
         4 * (2 * kMaxQ + 4 * kMaxQ + 2 * 4 * kRows + 2 * kMaxQ) + 8;
}

// 2, tensor cores.  dx, ddA (and the head's cum, to `cum_out`) of chunk c
// and head h: one block of two warpgroups; grid (nc * H).  The head's x,
// dy (split into hi and lo), its group's B and its dst (split) are staged
// in shared memory as swizzled wgmma operands; f32 x is split into hi and
// lo as well, and B and dst are not staged: v comes from bwd_v's scratch
// `V` (B's two pieces beside x's and dy's would take 256 KB at Q 256).
// Warpgroup `band_owner(b)` takes row band b of the transposed tiles (rows
// j, columns i >= j):
//   v_j    = B_j dst^T                  wgmma from shared memory (B exact, dst lo then hi;
//                                       f32: read from V)
//   u_j    = w_j x_j . v_j,   dx_j = w_j v_j
//   per column tile i:
//     dM^T = x_j dy_i^T                 wgmma, dy lo then hi (f32: x lo.dy hi, x hi.dy lo,
//                                       x hi.dy hi)
//     M^T  = S^T exp(cum_i - cum_j)     S^T (bwd_scores' scratch) read while dM^T runs;
//                                       selected to 0 where i < j or past Q
//     G^T  = dM^T M^T (i > j): row sums to colG_j, column sums to this
//            band's share of rowG_i (shared memory, summed over bands in order)
//     dx_j += M^T dy_i                  M^T split hi + lo in registers (the A operand),
//                                       dy MN-major: lo.hi, hi.lo, hi.hi
// Then dcum_i = rowG_i - colG_i - u_i (+ sum u + ddec dec at Q - 1) and
// ddA its reverse cumsum, as the CUDA-core kernel does.
template <typename T, int P, int N>
__global__ void __launch_bounds__(kTcThreads, 1) bwd_dx(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap bmap,
    const T* __restrict__ xf, long long sx, const float* __restrict__ V,
    const float* __restrict__ dA, const float* __restrict__ dy,
    const float* __restrict__ dst, const float* __restrict__ ddec, const float* __restrict__ St,
    T* __restrict__ dx, float* __restrict__ ddA, float* __restrict__ cum_out, int Q,
    int H, int G) {
  using K = Cfg<P, N>;
  constexpr bool kSplit = sizeof(T) == 4;  // f32 x in hi and lo pieces, v from V
  using Tm = Terms<kSplit, true>;          // dM^T's products: x's pieces by dy's
  constexpr int SWX = K::SWX, SWB = K::SWB, CWB = K::CWB;
  const int nt = (Q + kRows - 1) / kRows, qpad = nt * kRows;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t xb = kb_up(qpad * SWX), bb = kSplit ? 0 : kb_up(K::NCB * qpad * SWB),
                 db = kSplit ? 0 : kb_up(K::NCB * P * SWB);
  const uint32_t x_s = base, xl_s = x_s + xb, dyh_s = xl_s + (kSplit ? xb : 0),
                 dyl_s = dyh_s + xb, b_s = dyl_s + xb, dh_s = b_s + bb, dl_s = dh_s + db;
  float* const cum = reinterpret_cast<float*>(gbase + (dl_s + db - base));
  float* const w = cum + kMaxQ;
  float* const rowGp = w + kMaxQ;          // [4 bands][kMaxQ]: band b's column sums of G^T
  float* const red = rowGp + 4 * kMaxQ;    // [2 warpgroups][4 warps][64]
  float* const colG = red + 2 * 4 * kRows;  // [kMaxQ]
  float* const uu = colG + kMaxQ;           // [kMaxQ]
  const uint32_t bar = hopper::smem_addr(uu + kMaxQ);  // x and B arrived
  uint8_t* const xg = gbase + (x_s - base);
  uint8_t* const xlg = gbase + (xl_s - base);

  const int c = blockIdx.x / H, h = blockIdx.x % H, g = h / (H / G);
  const long long cg = (long long)c * G + g;
  const int wg = threadIdx.x / 128, wt = threadIdx.x % 128, warp = wt / 32, lane = wt % 32;

  if constexpr (kSplit) {  // x split into hi and lo by the threads
    stage_split<P, SWX, 8>(xg, xlg, xf + (size_t)c * Q * sx + (size_t)h * P, sx, 0, qpad, Q,
                           qpad);
  } else if (threadIdx.x == 0) {
    // x and B by TMA (rows past Q arrive as zeros) while the threads split
    // dy and dst (all of a thread's loads of each in flight at once)
    hopper::mbar_init(bar, 1);
    hopper::mbar_fence_init();
    hopper::mbar_expect_tx(bar, qpad * SWX + K::NCB * qpad * SWB);
    for (int t = 0; t < nt; ++t) {
      hopper::tma_load_4d(x_s + t * kRows * SWX, &xmap, bar, 0, h, t * kRows, c);
      for (int cc = 0; cc < K::NCB; ++cc)
        hopper::tma_load_4d(b_s + cc * qpad * SWB + t * kRows * SWB, &bmap, bar, cc * CWB, g,
                            t * kRows, c);
    }
  }
  stage_split<P, SWX, 8>(gbase + (dyh_s - base), gbase + (dyl_s - base),
                         dy + ((size_t)c * Q * H + h) * P, (long long)H * P, 0, qpad, Q, qpad);
  if constexpr (!kSplit)
    stage_split<N, SWB, 4>(gbase + (dh_s - base), gbase + (dl_s - base),
                           dst + ((size_t)c * H + h) * P * N, N, 0, P, P, P);
  if (threadIdx.x < 32) {  // cum: each lane sums its 8 steps, then a shuffle scan
    float part[8], run = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int t = 8 * lane + e;
      run += t < Q ? dA[((size_t)c * Q + t) * H + h] : 0.f;
      part[e] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    float before = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) before = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) cum[8 * lane + e] = before + part[e];
    __syncwarp();
    const float end = cum[Q - 1];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int t = 8 * lane + e;
      w[t] = t < Q ? expf(end - cum[t]) : 0.f;
    }
  }
  hopper::fence_proxy_async();
  __syncthreads();  // the mbarrier's init is visible before any thread waits on it
  if constexpr (!kSplit) hopper::mbar_wait(bar, 0);

  const int p0 = 16 * warp + lane / 4, cq = 2 * (lane % 4);
  const float* const Sc = St + cg * Q * Q;
  for (int b = 0; b < nt; ++b) {
    if (band_owner(b, nt) != wg) continue;
    const int j0 = b * kRows, r0 = j0 + p0, r1 = r0 + 8;
    float s[32];  // S^T's tile (j, i), loaded a tile ahead
    load_st(s, Sc, j0, r0, r1, Q, cq);
    // v_j = B_j dst^T: M rows j, N columns p, K the state dim (both K-major)
    float acc[P / 2];
    if constexpr (kSplit) {  // bwd_v's rows r0 and r1, in the accumulator's layout
      const float* const vh = V + ((size_t)c * H + h) * Q * P;
#pragma unroll
      for (int jj = 0; jj < P / 8; ++jj) {
        const int col = 8 * jj + cq;
        const float2 a = r0 < Q ? *reinterpret_cast<const float2*>(vh + (size_t)r0 * P + col)
                                : make_float2(0.f, 0.f);
        const float2 d = r1 < Q ? *reinterpret_cast<const float2*>(vh + (size_t)r1 * P + col)
                                : make_float2(0.f, 0.f);
        acc[4 * jj] = a.x;
        acc[4 * jj + 1] = a.y;
        acc[4 * jj + 2] = d.x;
        acc[4 * jj + 3] = d.y;
      }
    } else {
      hopper::wgmma_fence();
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const uint32_t dp = t == 0 ? dl_s : dh_s;
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {
          const uint32_t ch = kk * 16 / CWB, col = (kk * 16 % CWB) * 2;
          hopper::wgmma_ss(acc, hopper::make_desc(b_s + ch * qpad * SWB + j0 * SWB + col, 16,
                                                  8 * SWB, K::kModeB),
                           hopper::make_desc(dp + ch * P * SWB + col, 16, 8 * SWB, K::kModeB),
                           t > 0 || kk > 0);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
    }
    // u_j = w_j x_j . v_j (f32 x as hi + lo); dx_j starts at w_j v_j
    const float w0 = w[r0], w1 = w[r1];
    float u0 = 0.f, u1 = 0.f;
#pragma unroll
    for (int jj = 0; jj < P / 8; ++jj) {
      const int col = 8 * jj + cq;
      float2 a = tile_pair<SWX>(xg, r0, col), d = tile_pair<SWX>(xg, r1, col);
      if constexpr (kSplit) {
        const float2 al = tile_pair<SWX>(xlg, r0, col), dl = tile_pair<SWX>(xlg, r1, col);
        a = make_float2(a.x + al.x, a.y + al.y);
        d = make_float2(d.x + dl.x, d.y + dl.y);
      }
      u0 += a.x * acc[4 * jj] + a.y * acc[4 * jj + 1];
      u1 += d.x * acc[4 * jj + 2] + d.y * acc[4 * jj + 3];
      acc[4 * jj] *= w0;
      acc[4 * jj + 1] *= w0;
      acc[4 * jj + 2] *= w1;
      acc[4 * jj + 3] *= w1;
    }
    u0 += __shfl_xor_sync(0xffffffffu, u0, 1);
    u0 += __shfl_xor_sync(0xffffffffu, u0, 2);
    u1 += __shfl_xor_sync(0xffffffffu, u1, 1);
    u1 += __shfl_xor_sync(0xffffffffu, u1, 2);
    u0 *= w0;
    u1 *= w1;
    const float cj0 = cum[r0], cj1 = cum[r1];
    float cg0 = 0.f, cg1 = 0.f;  // colG of rows r0, r1: G^T's row sums over i > j
    for (int i = b; i < nt; ++i) {
      const int i0 = i * kRows;
      // dM^T = x_j dy_i^T: M rows j, N columns i, K = P (both K-major)
      float dm[32];
      hopper::wgmma_fence();
#pragma unroll
      for (int t = 0; t < Tm::n; ++t) {
        const uint32_t xp = Tm::a(t) ? xl_s : x_s, yp = Tm::b(t) ? dyl_s : dyh_s;
#pragma unroll
        for (int kk = 0; kk < P / 16; ++kk)
          hopper::wgmma_ss(dm, hopper::make_desc(xp + j0 * SWX + kk * 32, 16, 8 * SWX, K::kModeX),
                           hopper::make_desc(yp + i0 * SWX + kk * 32, 16, 8 * SWX, K::kModeX),
                           t > 0 || kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dm);
      float colsum[16];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ic = i0 + 8 * jj + cq + (e & 1);
          const int jr = (e >> 1) ? r1 : r0;
          const float cj = (e >> 1) ? cj1 : cj0;
          const bool keep = ic >= jr && ic < Q && jr < Q;
          const float l = fast_exp(cum[ic < Q ? ic : 0] - cj);  // selected, never masked
          const float m = keep ? s[4 * jj + e] * l : 0.f;
          const float gv = keep && ic > jr ? dm[4 * jj + e] * m : 0.f;
          s[4 * jj + e] = m;
          if (e >> 1) cg1 += gv; else cg0 += gv;
          if (e < 2) colsum[2 * jj + e] = gv; else colsum[2 * jj + (e & 1)] += gv;
        }
      // M^T split in registers (its k16 slice kk is A fragment kk of the dx
      // product), then the next tile's S^T requested
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        split_bf16(s[4 * jj], s[4 * jj + 1], hi[jj / 2][2 * (jj % 2)], lo[jj / 2][2 * (jj % 2)]);
        split_bf16(s[4 * jj + 2], s[4 * jj + 3], hi[jj / 2][2 * (jj % 2) + 1],
                   lo[jj / 2][2 * (jj % 2) + 1]);
      }
      if (i + 1 < nt) load_st(s, Sc, i0 + kRows, r0, r1, Q, cq);
      // this warp's 16 rows summed for each column, then the warps in order
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        colsum[k] += __shfl_xor_sync(0xffffffffu, colsum[k], 4);
        colsum[k] += __shfl_xor_sync(0xffffffffu, colsum[k], 8);
        colsum[k] += __shfl_xor_sync(0xffffffffu, colsum[k], 16);
      }
      float* const rw = red + (wg * 4 + warp) * kRows;
      if (lane < 4)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          rw[8 * jj + cq] = colsum[2 * jj];
          rw[8 * jj + cq + 1] = colsum[2 * jj + 1];
        }
      hopper::named_sync<128>(1 + wg);
      if (wt < kRows) {
        const float* r = red + wg * 4 * kRows + wt;
        rowGp[b * kMaxQ + i0 + wt] = ((r[0] + r[kRows]) + r[2 * kRows]) + r[3 * kRows];
      }
      // dx_j += M^T dy_i, dy_i MN-major (P contiguous), small terms first
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const uint32_t yp = t == 1 ? dyl_s : dyh_s;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_rs(acc, t == 0 ? lo[kk] : hi[kk],
                           hopper::make_desc(yp + (i0 + 16 * kk) * SWX, qpad * SWX, 8 * SWX,
                                             K::kModeX),
                           1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::named_sync<128>(1 + wg);  // red is read before the next tile writes it
    }
    cg0 += __shfl_xor_sync(0xffffffffu, cg0, 1);
    cg0 += __shfl_xor_sync(0xffffffffu, cg0, 2);
    cg1 += __shfl_xor_sync(0xffffffffu, cg1, 1);
    cg1 += __shfl_xor_sync(0xffffffffu, cg1, 2);
    if (lane % 4 == 0) {
      colG[r0] = cg0;
      colG[r1] = cg1;
      uu[r0] = r0 < Q ? u0 : 0.f;
      uu[r1] = r1 < Q ? u1 : 0.f;
    }
#pragma unroll
    for (int jj = 0; jj < P / 8; ++jj) {
      const int col = 8 * jj + cq;
      if (r0 < Q) store_pair(dx + (((size_t)c * Q + r0) * H + h) * P + col, acc[4 * jj], acc[4 * jj + 1]);
      if (r1 < Q)
        store_pair(dx + (((size_t)c * Q + r1) * H + h) * P + col, acc[4 * jj + 2], acc[4 * jj + 3]);
    }
  }
  __syncthreads();
  // dcum_i = rowG_i - colG_i - u_i, rowG summed over the bands b <= i's in order
  float* const dcum = red;  // the tile exchange is done: reuse it (kMaxQ floats)
  for (int t = threadIdx.x; t < kMaxQ; t += kTcThreads) {
    float v = 0.f;
    if (t < Q) {
      float rg = 0.f;
      for (int bb = 0; bb <= t / kRows; ++bb) rg += rowGp[bb * kMaxQ + t];
      v = rg - colG[t] - uu[t];
    }
    dcum[t] = v;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    float us = 0.f;  // sum u in a fixed order: 8 steps a lane, then a tree
#pragma unroll
    for (int e = 0; e < 8; ++e) us += 8 * lane + e < Q ? uu[8 * lane + e] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) us += __shfl_xor_sync(0xffffffffu, us, off);
    if (lane == 0) dcum[Q - 1] += us + ddec[(size_t)c * H + h] * expf(cum[Q - 1]);
    __syncwarp();
    warp_scan(dcum, Q, true);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < Q; t += kTcThreads) {
    ddA[((size_t)c * Q + t) * H + h] = dcum[t];
    cum_out[((size_t)c * H + h) * Q + t] = cum[t];
  }
}

// bwd_group's shared memory, byte offsets from its 1 KB-aligned base.  A
// head's buffers: x of the band twice (the next head's lands while this
// one's products run), dy's and dst's hi and lo pieces, and the landing
// area where the next head's dy, dst (f32, as they are) and cum arrive by
// cp.async.  At the end C and the warpgroups' exchange reuse the region.
// f32 x takes the two x buffers as its hi and lo pieces (split by the
// threads from device memory at each head), and f32 C two tiles.
template <typename T, int P, int N>
struct GroupSmem {
  using K = Cfg<P, N>;
  uint32_t xb, yb, db, x, dyh, dyl, dh, dl, ly, ld, lc, c, cb, comb, cum, total;
  __host__ __device__ constexpr explicit GroupSmem(int qpad)
      : xb(kb_up(kRows * K::SWX)), yb(kb_up(qpad * K::SWX)), db(kb_up(K::NCB * P * K::SWB)),
        x(0), dyh(2 * xb), dyl(dyh + yb), dh(dyl + yb), dl(dh + db), ly(dl + db),
        ld(ly + kb_up(qpad * P * 4)), lc(ld + kb_up(P * N * 4)), c(0),
        cb(kb_up(K::NCB * qpad * K::SWB)), comb((sizeof(T) == 4 ? 2 : 1) * cb),
        cum(lc + 4 * kMaxQ > comb + 4 * kRows * N ? lc + 4 * kMaxQ : comb + 4 * kRows * N),
        total(1024 + cum + 2 * 4 * kMaxQ + 8) {}
};

// 3, tensor cores.  dB of row band j (64 rows) of chunk c and group g, and
// the band's columns of sum_h dS_h to the scratch (for bwd_dc): one block
// of two warpgroups; grid (nc * G, nt).  For each head of the group, in
// head order: its x rows of the band (TMA), dy rows i >= j, dst and its
// cum from bwd_dx's scratch (bulk copies) arrive on one mbarrier (the next
// head's while this head's products run), and dy and dst are split into hi
// and lo pieces in shared memory (f32 x's band rows are split by the
// threads from device memory there too: three products for dM^T, and C in
// two pieces at the end).  Warpgroup k owns the column tiles i = j + k, j + k + 2
// of the band and keeps their sum over heads of dS^T = (x_j dy_i^T) L^T in
// registers (f32, in head order); warpgroup (head index) % 2 adds the
// head's state term (w x)_j dst (A from registers: w x split hi + lo; dst
// MN-major: lo.hi, hi.lo, hi.hi) to its dB accumulator.  At the end each
// warpgroup adds (sum dS^T)_ji C_i (sum dS split hi + lo, C exact) for its
// tiles, and warpgroup 0 adds warpgroup 1's accumulator: no atomics.
template <typename T, int P, int N>
__global__ void __launch_bounds__(kTcThreads, 1) bwd_group(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap dymap,
    const T* __restrict__ xf, long long sx, const T* __restrict__ C, const float* __restrict__ dst,
    const float* __restrict__ cum_in, float* __restrict__ dSsum, T* __restrict__ dB,
    int Q, int H, int G, long long sC) {
  using K = Cfg<P, N>;
  constexpr bool kSplit = sizeof(T) == 4;  // f32 x and C in hi and lo pieces
  using Tm = Terms<kSplit, true>;          // dM^T's products: x's pieces by dy's
  using Tc = Terms<true, kSplit>;          // dB's: (sum dS)'s pieces by C's
  constexpr int SWX = K::SWX, SWB = K::SWB, kLW = K::LW;
  const int nt = (Q + kRows - 1) / kRows, qpad = nt * kRows;
  const GroupSmem<T, P, N> L(qpad);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  float* const cum = reinterpret_cast<float*>(gbase + L.cum);
  float* const w = cum + kMaxQ;
  const float* const land_dy = reinterpret_cast<const float*>(gbase + L.ly);
  const float* const land_dst = reinterpret_cast<const float*>(gbase + L.ld);
  const float* const land_cum = reinterpret_cast<const float*>(gbase + L.lc);
  const uint32_t bar = hopper::smem_addr(w + kMaxQ);  // a head's landing arrived

  const int j = blockIdx.y, j0 = j * kRows;  // bands on the slow axis: the heavy ones first
  const int cgi = blockIdx.x, c = cgi / G, g = cgi % G, rep = H / G;
  const int wg = threadIdx.x / 128, wt = threadIdx.x % 128, warp = wt / 32, lane = wt % 32;
  const int p0 = 16 * warp + lane / 4, cq = 2 * (lane % 4);
  const int r0 = j0 + p0, r1 = r0 + 8;

  // Head k's x rows of the band (TMA, into buffer k % 2), dy rows j0 ..
  // qpad - 1 (TMA boxes of 64 rows by kLW floats; rows past Q arrive as
  // zeros), dst and cum (one bulk copy each), all counted on `bar`; issued
  // by one thread.
  auto issue = [&](int k) {
    if (threadIdx.x != 0) return;
    const int h = g * rep + k;
    hopper::mbar_expect_tx(bar, (kSplit ? 0 : kRows * SWX) + (qpad - j0) * P * 4 + P * N * 4 +
                                    Q * 4);
    if (!kSplit) hopper::tma_load_4d(base + L.x + (k & 1) * L.xb, &xmap, bar, 0, h, j0, c);
    for (int t = j; t < nt; ++t)
      for (int pc = 0; pc < P / kLW; ++pc)
        hopper::tma_load_4d(base + L.ly + ((pc * qpad) + t * kRows) * kLW * 4, &dymap, bar,
                            pc * kLW, h, t * kRows, c);
    hopper::bulk_load(base + L.ld, dst + ((size_t)c * H + h) * P * N, P * N * 4, bar);
    hopper::bulk_load(base + L.lc, cum_in + ((size_t)c * H + h) * Q, Q * 4, bar);
  };

  float dsum[2][32], acc[N / 2];
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int e = 0; e < 32; ++e) dsum[k][e] = 0.f;
#pragma unroll
  for (int e = 0; e < N / 2; ++e) acc[e] = 0.f;

  if (threadIdx.x == 0) {
    hopper::mbar_init(bar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  issue(0);
  for (int k = 0; k < rep; ++k) {
    hopper::mbar_wait(bar, k & 1);
    __syncthreads();  // head k has landed; head k - 1's products are done
    split_tile<P, SWX, kLW, 4>(gbase + L.dyh, gbase + L.dyl, land_dy, j0, qpad, qpad);
    split_tile<N, SWB, N, 4>(gbase + L.dh, gbase + L.dl, land_dst, 0, P, P);
    if constexpr (kSplit)
      stage_split<P, SWX, 2>(gbase + L.x, gbase + L.x + L.xb,
                             xf + ((size_t)c * Q + j0) * sx + (size_t)(g * rep + k) * P, sx, 0,
                             kRows, Q - j0, kRows);
    for (int t = threadIdx.x; t < kMaxQ; t += kTcThreads) {
      cum[t] = t < Q ? land_cum[t] : 0.f;
      w[t] = t < Q ? expf(land_cum[Q - 1] - land_cum[t]) : 0.f;
    }
    hopper::fence_proxy_async();
    __syncthreads();  // the pieces are written; the landing area is free
    if (k + 1 < rep) issue(k + 1);
    // bf16: head k's x; f32: its hi piece, the lo piece one buffer on
    const uint32_t x_s = base + L.x + (kSplit ? 0 : (k & 1) * L.xb);
    const uint8_t* const xg = gbase + (x_s - base);
    const float cj0 = cum[r0], cj1 = cum[r1];
#pragma unroll
    for (int slot = 0; slot < 2; ++slot) {
      const int i = j + wg + 2 * slot;
      if (i >= nt) break;
      const int i0 = i * kRows;
      float dm[32];
      hopper::wgmma_fence();
#pragma unroll
      for (int t = 0; t < Tm::n; ++t) {
        const uint32_t yp = base + (Tm::b(t) ? L.dyl : L.dyh), xp = x_s + Tm::a(t) * L.xb;
#pragma unroll
        for (int kk = 0; kk < P / 16; ++kk)
          hopper::wgmma_ss(dm, hopper::make_desc(xp + kk * 32, 16, 8 * SWX, K::kModeX),
                           hopper::make_desc(yp + i0 * SWX + kk * 32, 16, 8 * SWX, K::kModeX),
                           t > 0 || kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dm);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ic = i0 + 8 * jj + cq + (e & 1);
          const int jr = (e >> 1) ? r1 : r0;
          const bool keep = ic >= jr && ic < Q && jr < Q;
          const float l = fast_exp(cum[ic < Q ? ic : 0] - ((e >> 1) ? cj1 : cj0));
          dsum[slot][4 * jj + e] += keep ? dm[4 * jj + e] * l : 0.f;
        }
    }
    if (k % 2 == wg) {  // the state term: dB_j += (w x)_j dst_h
      uint32_t ah[P / 16][4], al[P / 16][4];
      const float w0 = w[r0], w1 = w[r1];
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int col = 16 * kk + 8 * hf + cq;
          float2 a = tile_pair<SWX>(xg, p0, col), d = tile_pair<SWX>(xg, p0 + 8, col);
          if constexpr (kSplit) {  // x = hi + lo
            const float2 al = tile_pair<SWX>(xg + L.xb, p0, col),
                         dl = tile_pair<SWX>(xg + L.xb, p0 + 8, col);
            a = make_float2(a.x + al.x, a.y + al.y);
            d = make_float2(d.x + dl.x, d.y + dl.y);
          }
          split_bf16(a.x * w0, a.y * w0, ah[kk][2 * hf], al[kk][2 * hf]);
          split_bf16(d.x * w1, d.y * w1, ah[kk][2 * hf + 1], al[kk][2 * hf + 1]);
        }
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const uint32_t dp = base + (t == 1 ? L.dl : L.dh);
#pragma unroll
        for (int kk = 0; kk < P / 16; ++kk)
          hopper::wgmma_rs(acc, t == 0 ? al[kk] : ah[kk],
                           hopper::make_desc(dp + 16 * kk * SWB, P * SWB, 8 * SWB, K::kModeB), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
    }
  }

  // The band's C rows (the head buffers are free), then dB_j += (sum dS^T)_ji
  // C_i over this warpgroup's tiles; the sums to the scratch as
  // (sum_h dS_h)[i][j]
  __syncthreads();
  load_operand<T, N, SWB, 4>(gbase, base, base + L.c, L.cb, C + (size_t)c * Q * sC + (size_t)g * N,
                             sC, j0, qpad, Q, qpad);
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  hopper::fence_proxy_async();
  __syncthreads();
  float* const out = dSsum + (size_t)cgi * Q * Q;
#pragma unroll
  for (int slot = 0; slot < 2; ++slot) {
    const int i = j + wg + 2 * slot;
    if (i >= nt) break;
    const int i0 = i * kRows;
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int ic = i0 + 8 * jj + cq;
      const float* d = dsum[slot] + 4 * jj;
      split_bf16(d[0], d[1], hi[jj / 2][2 * (jj % 2)], lo[jj / 2][2 * (jj % 2)]);
      split_bf16(d[2], d[3], hi[jj / 2][2 * (jj % 2) + 1], lo[jj / 2][2 * (jj % 2) + 1]);
      if (ic < Q) {
        if (r0 < Q) out[(size_t)ic * Q + r0] = d[0];
        if (r1 < Q) out[(size_t)ic * Q + r1] = d[2];
      }
      if (ic + 1 < Q) {
        if (r0 < Q) out[(size_t)(ic + 1) * Q + r0] = d[1];
        if (r1 < Q) out[(size_t)(ic + 1) * Q + r1] = d[3];
      }
    }
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int t = 0; t < Tc::n; ++t)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_rs(acc, Tc::a(t) ? lo[kk] : hi[kk],
                         hopper::make_desc(base + L.c + Tc::b(t) * L.cb + (i0 + 16 * kk) * SWB,
                                           qpad * SWB, 8 * SWB, K::kModeB),
                         1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
  }
  // warpgroup 1's accumulator to shared memory (each thread its own
  // slots), then warpgroup 0 adds it and stores dB
  float* const comb = reinterpret_cast<float*>(gbase + L.comb);
  if (wg == 1)
#pragma unroll
    for (int e = 0; e < N / 2; ++e) comb[e * 128 + wt] = acc[e];
  __syncthreads();
  if (wg == 0) {
    T* const ob = dB + (size_t)c * Q * G * N + (size_t)g * N;
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj) {
      const int col = 8 * jj + cq;
      const float a0 = acc[4 * jj] + comb[(4 * jj) * 128 + wt];
      const float a1 = acc[4 * jj + 1] + comb[(4 * jj + 1) * 128 + wt];
      const float b0 = acc[4 * jj + 2] + comb[(4 * jj + 2) * 128 + wt];
      const float b1 = acc[4 * jj + 3] + comb[(4 * jj + 3) * 128 + wt];
      if (r0 < Q) store_pair(ob + (size_t)r0 * G * N + col, a0, a1);
      if (r1 < Q) store_pair(ob + (size_t)r1 * G * N + col, b0, b1);
    }
  }
}

// A rank-4 TMA map over (width, heads or groups, Q, nc) of a bf16 operand
// whose (heads, width) rows are packed and whose tokens are `tok` elements
// apart, in boxes of 64 rows by box_cols, swizzled as the operand tiles.
CUresult encode_map(CUtensorMap* map, const void* ptr, int width, int heads, int Q, int nc,
                    long long tok, int box_cols, int swizzle_bytes) {
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)heads, (cuuint64_t)Q,
                              (cuuint64_t)nc};
  const cuuint64_t strides[3] = {(cuuint64_t)width * 2, (cuuint64_t)tok * 2,
                                 (cuuint64_t)Q * tok * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, 1, (cuuint32_t)kRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = swizzle_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A rank-4 TMA map over (P, H, Q, nc) of the contiguous f32 dy, in boxes of
// 64 rows by box_cols floats, unswizzled.
CUresult encode_dy_map(CUtensorMap* map, const float* dy, int P, int H, int Q, int nc,
                       int box_cols) {
  const cuuint64_t dims[4] = {(cuuint64_t)P, (cuuint64_t)H, (cuuint64_t)Q, (cuuint64_t)nc};
  const cuuint64_t strides[3] = {(cuuint64_t)P * 4, (cuuint64_t)H * P * 4,
                                 (cuuint64_t)Q * H * P * 4};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, 1, (cuuint32_t)kRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(dy),
                                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// T: bf16 or f32 x, B and C.  The scratch as ssd_chunk_bwd_tc_scratch_floats
// gives it: S, S^T, sum_h dS_h, cum, then (f32) V.
template <typename T, int P, int N>
cudaError_t run(const void* x, const float* dA, const void* B, const void* C, const float* dy,
                const float* dst, const float* ddec, void* dx, float* ddA, void* dB, void* dC,
                float* scratch, int nc, int Q, int H, int G, long long sx, long long sB,
                long long sC, cudaStream_t stream) {
  constexpr bool kSplit = sizeof(T) == 4;
  const long long qq = (long long)nc * G * Q * Q;
  float* S = scratch;
  float* St = S + qq;
  float* dSsum = St + qq;
  float* cum = dSsum + qq;
  float* V = cum + (long long)nc * H * Q;
  const int nt = (Q + kRows - 1) / kRows, qpad = nt * kRows;
  const dim3 tiles((Q + kTile - 1) / kTile, nc * G);
  const T* xt = static_cast<const T*>(x);
  const T* Bt = static_cast<const T*>(B);
  const T* Ct = static_cast<const T*>(C);
  const int sm_s = (int)scores_smem_bytes<T, P, N>(qpad);
  cudaError_t err =
      cudaFuncSetAttribute(bwd_scores<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, sm_s);
  if (err != cudaSuccess) return err;
  bwd_scores<T, P, N><<<dim3(nc * G, nt), kTcThreads, sm_s, stream>>>(Bt, Ct, St, Q, G, sB, sC);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  using K = Cfg<P, N>;
  CUtensorMap xm{}, bm{}, dym{};
  if (encode_dy_map(&dym, dy, P, H, Q, nc, K::LW) != CUDA_SUCCESS) return cudaErrorInvalidValue;
  if constexpr (kSplit) {
    const int sm_v = (int)v_smem_bytes<P, N>();
    err = cudaFuncSetAttribute(bwd_v<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, sm_v);
    if (err != cudaSuccess) return err;
    bwd_v<P, N><<<dim3(nc * G, nt, (H / G + kVHeads - 1) / kVHeads), kTcThreads, sm_v, stream>>>(
        static_cast<const float*>(B), dst, V, Q, H, G, sB);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  } else if (encode_map(&xm, x, P, H, Q, nc, sx, P, K::SWX) != CUDA_SUCCESS ||
             encode_map(&bm, B, N, G, Q, nc, sB, K::CWB, K::SWB) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  const int sm_dx = (int)dx_smem_bytes<T, P, N>(qpad);
  err = cudaFuncSetAttribute(bwd_dx<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, sm_dx);
  if (err != cudaSuccess) return err;
  bwd_dx<T, P, N><<<nc * H, kTcThreads, sm_dx, stream>>>(xm, bm, xt, sx, V, dA, dy, dst, ddec, St,
                                                        static_cast<T*>(dx), ddA, cum, Q, H, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int sm_g = (int)GroupSmem<T, P, N>(qpad).total;
  err = cudaFuncSetAttribute(bwd_group<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, sm_g);
  if (err != cudaSuccess) return err;
  bwd_group<T, P, N><<<dim3(nc * G, nt), kTcThreads, sm_g, stream>>>(
      xm, dym, xt, sx, Ct, dst, cum, dSsum, static_cast<T*>(dB), Q, H, G, sC);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dc<T><<<tiles, kThreads, 0, stream>>>(Bt, dSsum, static_cast<T*>(dC), Q, G, N, sB);
  return cudaGetLastError();
}

// Kernel `which` of the route in launch order: bf16 0 bwd_scores, 1
// bwd_dx, 2 bwd_group, 3 bwd_dc; f32 0 bwd_scores, 1 bwd_v, 2 bwd_dx, 3
// bwd_group, 4 bwd_dc.
template <typename T, int P, int N>
cudaError_t resources_of(int which, int* regs, int* smem) {
  if (sizeof(T) == 4) {
    if (which == 1) return attrs(bwd_v<P, N>, (int)v_smem_bytes<P, N>(), regs, smem);
    if (which > 1) --which;
  }
  switch (which) {
    case 0: return attrs(bwd_scores<T, P, N>, (int)scores_smem_bytes<T, P, N>(kMaxQ), regs, smem);
    case 1: return attrs(bwd_dx<T, P, N>, (int)dx_smem_bytes<T, P, N>(kMaxQ), regs, smem);
    case 2: return attrs(bwd_group<T, P, N>, (int)GroupSmem<T, P, N>(kMaxQ).total, regs, smem);
    default: return attrs(bwd_dc<T>, 0, regs, smem);
  }
}

#define SSD_BWD_TC_DISPATCH(FN, T, ...)                                 \
  switch (P * 1000 + N) {                                               \
    case 16016: return FN<T, 16, 16>(__VA_ARGS__);                      \
    case 16032: return FN<T, 16, 32>(__VA_ARGS__);                      \
    case 16064: return FN<T, 16, 64>(__VA_ARGS__);                      \
    case 16128: return FN<T, 16, 128>(__VA_ARGS__);                     \
    case 32016: return FN<T, 32, 16>(__VA_ARGS__);                      \
    case 32032: return FN<T, 32, 32>(__VA_ARGS__);                      \
    case 32064: return FN<T, 32, 64>(__VA_ARGS__);                      \
    case 32128: return FN<T, 32, 128>(__VA_ARGS__);                     \
    case 64016: return FN<T, 64, 16>(__VA_ARGS__);                      \
    case 64032: return FN<T, 64, 32>(__VA_ARGS__);                      \
    case 64064: return FN<T, 64, 64>(__VA_ARGS__);                      \
    case 64128: return FN<T, 64, 128>(__VA_ARGS__);                     \
    default: return cudaErrorInvalidValue;                              \
  }

template <typename T>
cudaError_t launch(const void* x, const float* dA, const void* B, const void* C, const float* dy,
                   const float* dst, const float* ddec, void* dx, float* ddA, void* dB, void* dC,
                   float* scratch, int nc, int Q, int H, int G, int P, int N, long long sx,
                   long long sB, long long sC, cudaStream_t stream) {
  SSD_BWD_TC_DISPATCH(run, T, x, dA, B, C, dy, dst, ddec, dx, ddA, dB, dC, scratch, nc, Q, H, G,
                      sx, sB, sC, stream)
}

template <typename T>
cudaError_t resources(int which, int P, int N, int* regs, int* smem) {
  SSD_BWD_TC_DISPATCH(resources_of, T, which, regs, smem)
}

}  // namespace tc

// ------------------------------- chunks of at most 32 tokens: one pass
// The calls the wgmma kernels do not take as they are (P 8 or 24, N 40 or
// 48, misaligned or odd-stride slices) at chunks of Q <= 32 tokens: the
// reduced mamba2's 16 (nc 16, Q 16, H 16, G 1, P 8, N 16).  There a
// wgmma kernel's block holds one ragged 16-row tile of a head, and a chain
// of short launches sets the time (the padded wgmma route's four took 47
// us of device time at that shape on an H100, its pads and slices more of
// the host's; the bound is well under 1 us).  So one launch does it all:
// one block of eight warps per chunk and group.
//   B and C of the group are staged in shared memory (f32) and S = C B^T
// computed once (Q x Q).  Warp w then takes the group's heads w, w + 8,
// ... in order, each on its own: cum by a shuffle scan of its lanes (token
// = lane), w, v = B dst^T, u, dx = w v + M^T dy, dM = dy x^T, G = dM M
// summed by rows and columns, dS = dM L added to the warp's own (Q x Q)
// partial sum in shared memory, dcum and ddA by a reverse shuffle scan.
// After a barrier the eight partial sums are added in warp order (a fixed
// order: no atomics, two calls give the same bits), and the warps share the
// output tiles of dC = (sum dS) B and dB = (sum dS)^T C + sum_h (w x)_h
// dst_h, the state term head by head, each head's product into a fresh
// accumulator added in f32.  Every product runs on the tensor cores as
// mma.sync m16n8k16 tiles whose fragments the threads gather from shared
// or device memory (a few KB a head: L2), each f32 operand as bf16 hi + lo
// and three products of pieces (lo.hi, hi.lo, hi.hi), bf16 inputs exact as
// one piece: the wgmma kernels' arithmetic (their dC ran in f32 on the CUDA
// cores; here it is a product of pieces too).  P, N and Q are padded to
// the tile shape with zeros in the gathers, which add exact zeros.
namespace op {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 32;     // chunk length at most: one lane a token
constexpr int kMaxRep = 256;  // heads a group at most: their w rows stay in shared memory

// Offsets of a launch's shared memory, in floats: S (Q x Q), B and C (Q x
// NK, N padded to 16), the warps' partial sums of dS (kWarps x Q x Q), their
// sum, w of every head of the group (rep x Q), and each warp's cum, row and
// column sums of G, and u (kMaxQ each).
struct Smem {
  int S, Bs, Cs, part, dss, w, cum, rg, cg, u, total;
  __host__ __device__ Smem(int Q, int NK, int rep) {
    S = 0;
    Bs = S + Q * Q;
    Cs = Bs + Q * NK;
    part = Cs + Q * NK;
    dss = part + kWarps * Q * Q;
    w = dss + Q * Q;
    cum = w + rep * Q;
    rg = cum + kWarps * kMaxQ;
    cg = rg + kWarps * kMaxQ;
    u = cg + kWarps * kMaxQ;
    total = u + kWarps * kMaxQ;
  }
};

// The fragment gathers and the split products (hopper.cuh), shared with
// the forward's one-pass kernel (csrc/ssd_chunk.cu `op::fwd_chunk`).
using hopper::acc_col;
using hopper::acc_row;
using hopper::frag_a;
using hopper::frag_b;
using hopper::mma_split;

// grid (nc * G), kThreads threads; Q 16 or 32, P <= 64, N <= 128, H / G <=
// kMaxRep.  Operands as the wgmma route takes them, at any alignment and
// token stride.
template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_chunk(
    const T* __restrict__ x, const float* __restrict__ dA, const T* __restrict__ B,
    const T* __restrict__ C, const float* __restrict__ dy, const float* __restrict__ dst,
    const float* __restrict__ ddec, T* __restrict__ dx, float* __restrict__ ddA,
    T* __restrict__ dB, T* __restrict__ dC, int Q, int H, int G, int P, int N, long long sx,
    long long sB, long long sC) {
  constexpr bool kF32 = sizeof(T) == 4;  // f32 x, B and C enter as hi + lo too
  constexpr int kMaxQT = kMaxQ / 16, kMaxPT = kPMax / 8;
  extern __shared__ __align__(16) float sm[];
  const int NK = (N + 15) / 16 * 16, PK = (P + 15) / 16 * 16, QT = Q / 16, rep = H / G;
  const Smem L(Q, NK, rep);
  float* const S = sm + L.S;
  float* const Bs = sm + L.Bs;
  float* const Cs = sm + L.Cs;
  float* const dss = sm + L.dss;
  float* const wsm = sm + L.w;
  const int cgi = blockIdx.x, c = cgi / G, g = cgi % G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* const part = sm + L.part + warp * Q * Q;  // this warp's partial sum of dS
  float* const cumw = sm + L.cum + warp * kMaxQ;
  float* const rgw = sm + L.rg + warp * kMaxQ;
  float* const cgw = sm + L.cg + warp * kMaxQ;
  float* const uw = sm + L.u + warp * kMaxQ;
  const long long tok0 = (long long)c * Q;  // the chunk's first token
  float a[8], b[4];

  for (int e = tid; e < Q * NK; e += kThreads) {
    const int j = e / NK, n = e % NK;
    Bs[e] = n < N ? ld(B + (tok0 + j) * sB + (long long)g * N + n) : 0.f;
    Cs[e] = n < N ? ld(C + (tok0 + j) * sC + (long long)g * N + n) : 0.f;
  }
  for (int e = tid; e < kWarps * Q * Q; e += kThreads) sm[L.part + e] = 0.f;
  __syncthreads();
  // S = C B^T
  for (int tile = warp; tile < QT * 2 * QT; tile += kWarps) {
    const int m0 = tile / (2 * QT) * 16, n0 = tile % (2 * QT) * 8;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < NK; k0 += 16) {
      frag_a(a, [&](int i, int n) { return Cs[i * NK + n]; }, m0, k0);
      frag_b(b, [&](int n, int j) { return Bs[j * NK + n]; }, k0, n0);
      mma_split<kF32, kF32>(d, a, b);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) S[acc_row(m0, e) * Q + acc_col(n0, e)] = d[e];
  }
  __syncthreads();

  for (int hl = warp; hl < rep; hl += kWarps) {
    const int h = g * rep + hl;
    auto X = [&](int j, int p) {
      return p < P ? ld(x + (tok0 + j) * sx + (long long)h * P + p) : 0.f;
    };
    auto DY = [&](int i, int p) { return p < P ? dy[((tok0 + i) * H + h) * P + p] : 0.f; };
    auto DST = [&](int p, int n) {
      return p < P && n < N ? dst[(((long long)c * H + h) * P + p) * N + n] : 0.f;
    };
    // cum: an inclusive scan over the lanes (lane = token); w
    float cv = lane < Q ? dA[(tok0 + lane) * H + h] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, cv, o);
      if (lane >= o) cv += y;
    }
    const float clast = __shfl_sync(0xffffffffu, cv, Q - 1);
    if (lane < Q) {
      cumw[lane] = cv;
      wsm[hl * Q + lane] = expf(clast - cv);
    }
    __syncwarp();

    // v = B dst^T (rows j, columns p), then dx = w v and u = w x . v
    float acc[kMaxQT][kMaxPT][4];
#pragma unroll
    for (int mt = 0; mt < kMaxQT; ++mt)
#pragma unroll
      for (int pt = 0; pt < kMaxPT; ++pt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][pt][e] = 0.f;
        if (mt >= QT || pt * 8 >= PK) continue;
        for (int k0 = 0; k0 < NK; k0 += 16) {
          frag_a(a, [&](int j, int n) { return Bs[j * NK + n]; }, mt * 16, k0);
          frag_b(b, [&](int n, int p) { return DST(p, n); }, k0, pt * 8);
          mma_split<kF32, true>(acc[mt][pt], a, b);
        }
      }
#pragma unroll
    for (int mt = 0; mt < kMaxQT; ++mt) {
      if (mt >= QT) continue;
      float up[2] = {0.f, 0.f};
#pragma unroll
      for (int pt = 0; pt < kMaxPT; ++pt) {
        if (pt * 8 >= PK) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          up[e >> 1] += X(acc_row(mt * 16, e), acc_col(pt * 8, e)) * acc[mt][pt][e];
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        up[hr] += __shfl_xor_sync(0xffffffffu, up[hr], 1);
        up[hr] += __shfl_xor_sync(0xffffffffu, up[hr], 2);
        const int j = acc_row(mt * 16, 2 * hr);
        const float wj = wsm[hl * Q + j];
        if (lane % 4 == 0) uw[j] = wj * up[hr];
#pragma unroll
        for (int pt = 0; pt < kMaxPT; ++pt) {
          acc[mt][pt][2 * hr] *= wj;
          acc[mt][pt][2 * hr + 1] *= wj;
        }
      }
    }
    // dx += M^T dy over the rows i >= j, M^T[j][i] = S[i][j] exp(cum_i - cum_j)
#pragma unroll
    for (int mt = 0; mt < kMaxQT; ++mt)
#pragma unroll
      for (int pt = 0; pt < kMaxPT; ++pt) {
        if (mt >= QT || pt * 8 >= PK) continue;
        for (int k0 = mt * 16; k0 < Q; k0 += 16) {
          frag_a(a, [&](int j, int i) {
            return i >= j ? S[i * Q + j] * expf(cumw[i] - cumw[j]) : 0.f;
          }, mt * 16, k0);
          frag_b(b, DY, k0, pt * 8);
          mma_split<true, true>(acc[mt][pt], a, b);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = acc_row(mt * 16, e), p = acc_col(pt * 8, e);
          if (p < P) st(dx + ((tok0 + j) * H + h) * P + p, acc[mt][pt][e]);
        }
      }

    // dM = dy x^T (rows i, columns j); G = dM M and dS = dM L below the diagonal
    float rg[kMaxQT][2], cg[2 * kMaxQT][2];
#pragma unroll
    for (int mt = 0; mt < kMaxQT; ++mt) rg[mt][0] = rg[mt][1] = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2 * kMaxQT; ++nt) cg[nt][0] = cg[nt][1] = 0.f;
#pragma unroll
    for (int mt = 0; mt < kMaxQT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2 * kMaxQT; ++nt) {
        if (mt >= QT || nt >= 2 * QT || nt * 8 > mt * 16 + 15) continue;
        float dm[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k0 = 0; k0 < PK; k0 += 16) {
          frag_a(a, DY, mt * 16, k0);
          frag_b(b, [&](int p, int j) { return X(j, p); }, k0, nt * 8);
          mma_split<true, kF32>(dm, a, b);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = acc_row(mt * 16, e), j = acc_col(nt * 8, e);
          if (j > i) continue;
          const float l = expf(cumw[i] - cumw[j]);
          part[i * Q + j] += dm[e] * l;
          if (j < i) {
            const float gv = dm[e] * (S[i * Q + j] * l);
            rg[mt][e >> 1] += gv;
            cg[nt][e & 1] += gv;
          }
        }
      }
#pragma unroll
    for (int mt = 0; mt < kMaxQT; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float v = rg[mt][hr];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (mt < QT && lane % 4 == 0) rgw[acc_row(mt * 16, 2 * hr)] = v;
      }
#pragma unroll
    for (int nt = 0; nt < 2 * kMaxQT; ++nt)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        float v = cg[nt][e1];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (nt < 2 * QT && lane < 4) cgw[acc_col(nt * 8, e1)] = v;
      }
    __syncwarp();
    // dcum_i = rowG_i - colG_i - u_i (+ sum u + ddec dec at Q - 1); ddA its
    // reverse cumsum, by a shuffle scan
    float ui = lane < Q ? uw[lane] : 0.f;
    float dc = lane < Q ? rgw[lane] - cgw[lane] - ui : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ui += __shfl_xor_sync(0xffffffffu, ui, o);
    if (lane == Q - 1) dc += ui + ddec[(long long)c * H + h] * expf(clast);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_down_sync(0xffffffffu, dc, o);
      if (lane + o < 32) dc += y;
    }
    if (lane < Q) ddA[(tok0 + lane) * H + h] = dc;
    __syncwarp();  // the next head overwrites this warp's cum, sums and u
  }
  __syncthreads();
  // sum_h dS_h: the warps' partial sums in warp order
  for (int e = tid; e < Q * Q; e += kThreads) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += sm[L.part + w * Q * Q + e];
    dss[e] = v;
  }
  __syncthreads();
  // dC = (sum dS) B and dB = (sum dS)^T C + sum_h (w x)_h dst_h, a tile a warp in turn
  const int ntn = NK / 8, tiles = QT * ntn;
  for (int tile = warp; tile < 2 * tiles; tile += kWarps) {
    const bool is_b = tile >= tiles;
    const int tt = is_b ? tile - tiles : tile, m0 = tt / ntn * 16, n0 = tt % ntn * 8;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < Q; k0 += 16) {
      if (is_b) {
        frag_a(a, [&](int j, int i) { return dss[i * Q + j]; }, m0, k0);
        frag_b(b, [&](int i, int n) { return Cs[i * NK + n]; }, k0, n0);
      } else {
        frag_a(a, [&](int i, int j) { return dss[i * Q + j]; }, m0, k0);
        frag_b(b, [&](int j, int n) { return Bs[j * NK + n]; }, k0, n0);
      }
      mma_split<true, kF32>(d, a, b);
    }
    if (is_b) {
      for (int hl = 0; hl < rep; ++hl) {  // the state term, head by head
        const int h = g * rep + hl;
        float t4[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k0 = 0; k0 < PK; k0 += 16) {
          frag_a(a, [&](int j, int p) {
            return p < P ? wsm[hl * Q + j] * ld(x + (tok0 + j) * sx + (long long)h * P + p)
                         : 0.f;
          }, m0, k0);
          frag_b(b, [&](int p, int n) {
            return p < P && n < N ? dst[(((long long)c * H + h) * P + p) * N + n] : 0.f;
          }, k0, n0);
          mma_split<true, true>(t4, a, b);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) d[e] += t4[e];
      }
    }
    T* const out = is_b ? dB : dC;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = acc_row(m0, e), n = acc_col(n0, e);
      if (n < N) st(out + ((tok0 + row) * G + g) * N + n, d[e]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dA, const void* B, const void* C, const float* dy,
                   const float* dst, const float* ddec, void* dx, float* ddA, void* dB, void* dC,
                   int nc, int Q, int H, int G, int P, int N, long long sx, long long sB,
                   long long sC, cudaStream_t stream) {
  const int smem = Smem(Q, (N + 15) / 16 * 16, H / G).total * (int)sizeof(float);
  const cudaError_t err =
      cudaFuncSetAttribute(bwd_chunk<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  bwd_chunk<T><<<nc * G, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dA, static_cast<const T*>(B), static_cast<const T*>(C), dy, dst,
      ddec, static_cast<T*>(dx), ddA, static_cast<T*>(dB), static_cast<T*>(dC), Q, H, G, P, N, sx,
      sB, sC);
  return cudaGetLastError();
}

}  // namespace op

}  // namespace

extern "C" {

// Floats of device scratch a call needs: S, S^T and sum_h dS_h, (nc * G, Q,
// Q) each, and cum (nc, H, Q).
long long ssd_chunk_bwd_scratch_floats(int nc, int Q, int H, int G) {
  return 3LL * nc * G * Q * Q + (long long)nc * H * Q;
}

// Floats of device scratch the tensor-core route needs: as
// ssd_chunk_bwd_scratch_floats, then (f32 inputs) bwd_v's V (nc, H, Q, P).
long long ssd_chunk_bwd_tc_scratch_floats(int nc, int Q, int H, int G, int P, int is_bf16) {
  return ssd_chunk_bwd_scratch_floats(nc, Q, H, G) + (is_bf16 ? 0LL : (long long)nc * H * Q * P);
}

// The wgmma route.  x: (nc, Q, H, P) and B, C: (nc, Q, G, N) of one type
// (bf16 when is_bf16, else f32), each token's row packed, tokens `s*`
// elements apart, with P in {16, 32, 64} and N in {16, 32, 64, 128}, data
// 16-byte aligned and token strides 16 bytes apart; dA (nc, Q, H), dy (nc,
// Q, H, P), dst (nc, H, P, N) and ddec (nc, H) contiguous f32, dy and dst
// 16-byte aligned.  Writes dx (nc, Q, H, P), dB and dC (nc, Q, G, N)
// contiguous in the inputs' type and ddA (nc, Q, H) f32, using the scratch
// ssd_chunk_bwd_tc_scratch_floats gives.  Q a multiple of 16 up to 256, H
// % G == 0.  Returns a cudaError_t (0 on success), after checking
// cudaGetLastError() behind every launch; any other operand returns
// cudaErrorInvalidValue and launches nothing.
int ssd_chunk_bwd_tc_launch(const void* x, const float* dA, const void* B, const void* C,
                            const float* dy, const float* dst, const float* ddec, void* dx,
                            float* ddA, void* dB, void* dC, float* scratch,
                            long long scratch_floats, int nc, int Q, int H, int G, int P, int N,
                            long long sx, long long sB, long long sC, int is_bf16,
                            cudaStream_t stream) {
  const int step = is_bf16 ? 8 : 4;  // elements in 16 bytes
  if (nc < 1 || Q < 16 || Q > kMaxQ || Q % 16 || G < 1 || H % G ||
      scratch_floats < ssd_chunk_bwd_tc_scratch_floats(nc, Q, H, G, P, is_bf16) || sx % step ||
      sB % step || sC % step ||
      ((uintptr_t)x | (uintptr_t)B | (uintptr_t)C | (uintptr_t)dy | (uintptr_t)dst) % 16)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)tc::launch<__nv_bfloat16>(x, dA, B, C, dy, dst, ddec, dx, ddA, dB, dC, scratch, nc,
                                          Q, H, G, P, N, sx, sB, sC, stream);
  return (int)tc::launch<float>(x, dA, B, C, dy, dst, ddec, dx, ddA, dB, dC, scratch, nc, Q, H, G,
                                P, N, sx, sB, sC, stream);
}

// Registers a thread and shared memory a block (static plus dynamic, at Q =
// 256) of the tensor-core route's kernel `which` at head dim P and state
// dim N: bf16 0 bwd_scores, 1 tc::bwd_dx, 2 tc::bwd_group, 3 bwd_dc; f32 0
// bwd_scores, 1 tc::bwd_v, 2 tc::bwd_dx, 3 tc::bwd_group, 4 bwd_dc.
int ssd_chunk_bwd_tc_resources(int which, int is_bf16, int P, int N, int* regs, int* smem) {
  if (is_bf16) return (int)tc::resources<__nv_bfloat16>(which, P, N, regs, smem);
  return (int)tc::resources<float>(which, P, N, regs, smem);
}

// The one-pass route: Q 16 or 32, P <= 64, N <= 128, H / G <= 256; operands
// as ssd_chunk_bwd_tc_launch takes them, at any alignment and token stride.
// One launch, no scratch; any other shape returns cudaErrorInvalidValue and
// launches nothing.
int ssd_chunk_bwd_op_launch(const void* x, const float* dA, const void* B, const void* C,
                            const float* dy, const float* dst, const float* ddec, void* dx,
                            float* ddA, void* dB, void* dC, int nc, int Q, int H, int G, int P,
                            int N, long long sx, long long sB, long long sC, int is_bf16,
                            cudaStream_t stream) {
  if (nc < 1 || (Q != 16 && Q != 32) || P < 1 || P > kPMax || N < 1 || N > kMaxN || G < 1 ||
      H % G || H / G > op::kMaxRep)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)op::launch<__nv_bfloat16>(x, dA, B, C, dy, dst, ddec, dx, ddA, dB, dC, nc, Q, H, G,
                                          P, N, sx, sB, sC, stream);
  return (int)op::launch<float>(x, dA, B, C, dy, dst, ddec, dx, ddA, dB, dC, nc, Q, H, G, P, N,
                                sx, sB, sC, stream);
}

// Registers a thread and shared memory a block (static plus dynamic) of the
// one-pass kernel at chunk length Q, state dim N and H / G heads a group.
int ssd_chunk_bwd_op_resources(int is_bf16, int Q, int N, int rep, int* regs, int* smem) {
  const int dyn = op::Smem(Q, (N + 15) / 16 * 16, rep).total * (int)sizeof(float);
  if (is_bf16) return (int)attrs(op::bwd_chunk<__nv_bfloat16>, dyn, regs, smem);
  return (int)attrs(op::bwd_chunk<float>, dyn, regs, smem);
}

const char* ssd_chunk_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
