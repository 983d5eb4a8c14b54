// Mamba-2 SSD intra-chunk block for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `ssd_chunk` in src/repro/kernels/ssd_scan.py
// (kernel body `_kernel`, pallas_call in `ssd_chunk`).  What it computes, for
// x (nc, Q, H, P), dA (nc, Q, H) and B, C (nc, Q, G, N) with H % G == 0,
// head h reading group g = h / (H / G), per chunk c and head h:
//
//   cum         = cumsum(dA[c, :, h])                      f32
//   L[i, j]     = exp(cum[i] - cum[j]) if j <= i else 0    selected, never masked by a product
//   y_diag      = ((C B^T) * L) @ x                        (Q, P) f32
//   states      = (x * exp(cum[Q-1] - cum))^T @ B          (P, N) f32
//   chunk_decay = exp(cum[Q-1])
//
// with every product of the inputs exact and every sum in f32.  Outputs are
// y_diag (nc, Q, H, P), states (nc, H, P, N) and chunk_decay (nc, H).
//
// Bound on an H100 SXM: bytes.  At the SSM path's prefill shape (mamba2-2.7b,
// batch 4 x 4096 tokens in chunks of 256: nc 64, Q 256, H 80, G 1, P 64,
// N 128, bf16 inputs) the function reads x (168 MB), B, C and dA (14 MB) and
// writes y_diag (336 MB) and states (168 MB): 0.69 GB, 0.20 ms at 3.35 TB/s,
// three quarters of it the f32 stores.  Its multiply-adds, C B^T over N
// once per chunk and group on the causal pairs, the scores times x over P
// and the states over Q per head, are 4.36e10 flops (chip_smoke.py
// `ssd_bound`): 0.044 ms at the 989 TFLOP/s bf16 tensor-core peak, 0.65 ms
// at the 67 TFLOP/s f32 CUDA-core peak.  With f32 inputs the function moves
// 0.86 GB, 0.257 ms, its bound on either route.
//
// Three kernels; the wrapper picks one by dtype, shape and layout before the
// launch, and a kernel that does not take its operands refuses them.
//
// bf16, P in {16, 32, 64}, N in {16, 32, 64, 128}, x, B and C 16-byte
// aligned with token strides of a multiple of 8 elements:
// `ssd_chunk_wgmma`, on the tensor cores.
//   One block of four warpgroups (512 threads) per chunk and run of R
// consecutive heads of one group; R divides the group's heads and is chosen
// for waves on the card's SMs (40 at the serving shape: 128 blocks, one
// wave).  Blocks go head-run fastest, so a chunk's blocks share its B and C
// in L2.  Thread 0 loads the chunk's B and C once by TMA (rank-4 maps over
// (N, G, Q, nc) at their real token stride: slices of one projection need no
// copy) and each head's x tile into one of two buffers, head h + 1's while
// head h computes.  Rows come in 64-row TMA boxes; a box's rows past Q
// arrive as zeros.  Tiles are swizzled 128 B (64 B at a width of 32, 32 B at
// 16), 1 KB aligned.  Warp 0 scans the next head's dA (loaded one head
// ahead) into cum and the states weights.  Shared memory is 197 KB a block
// at the serving shape, so one block a SM.
//   Per head, warpgroups 0, 1 and 3 take the 64-row tiles of y_diag, the
// last tile to 0, the one before it and the first to 1, the rest to 3 (at
// Q = 256: 4, 3 + 1 and 2 of the 10 causal (i, j) tiles), and warpgroup 2
// takes states.  For each j <= i: S = C_i B_j^T as wgmma m64n64k16 from
// shared memory, both K-major (rows are N-contiguous), f32 accumulation: a
// product of bf16 values is exact in f32, so S is the reference's up to
// summation order.  M = S * L stays f32, L selected to 0 above the diagonal
// and past Q (there cum[i] - cum[j] > 0 may overflow), its exp the
// special-function unit's (`__expf`: ex2.approx of x log2(e), within
// 2 + 1.2|x| ulp, where |x| is small exactly where L is large).  M feeds the
// second product, where a bf16 M would miss the 1e-4 tolerance by about
// 20x, so M is split in registers into hi = bf16(M) and lo = bf16(M - hi),
// with |M - hi - lo| <= 2^-17 |M| (derived in hopper.cuh), and y_i +=
// hi x_j + lo x_j as two wgmma m64nPk16 with A from registers (S's
// accumulator layout is the A operand's) and x_j MN-major through the
// descriptor's transpose bit.  The
// f32 y tile is stored from registers, 8 bytes a thread, a quad covering 32
// contiguous bytes, rows < Q only.
//   states: xw = x * exp(cum[Q-1] - cum) is f32, split the same way, read
// transposed from the swizzled x tile into A fragments (one bf16 load an
// element); states += xw_hi^T B + xw_lo^T B as wgmma m64nNk16 with B
// MN-major.
//   The cumsum is one warp's, in a fixed order: each lane sums its 8
// consecutive steps in sequence, the 32 lane totals go through an inclusive
// shuffle scan (offsets 1, 2, 4, 8, 16), and each step adds its lane's
// exclusive prefix.  The reference sums in another order; the checks admit
// the f32 bound of either order.
//   Within a warpgroup every step waits for its product (S, then M's split,
// then the y product); the four warpgroups overlap one another.  At the
// serving shape that is about 0.45 ms against the 0.20 ms bound (PERF.md).
//
// f32 at the same shapes, alignment and token strides of a multiple of 4
// elements: `ssd_chunk_split`, on the tensor cores.  x, B and C enter as
// two bf16 pieces each, hi = bf16(v) and lo = bf16(v - hi), |v - hi - lo|
// <= 2^-17 |v|, as M and xw already do, and each product runs as three
// wgmma products of pieces (lo.lo, at most 2^-16 of |a||b| and far less on
// average, drops):
//   S       = Ch.Bh^T + Cl.Bh^T + Ch.Bl^T     (C from registers, B K-major)
//   y      += Mh.xh   + Ml.xh   + Mh.xl       (M from registers, x MN-major)
//   states += xwh^T.Bh + xwl^T.Bh + xwh^T.Bl  (xw = (xh + xl) w, split again)
// At the shapes of chip_smoke.py's f32 cases the route stays within 1.9e-5
// of the largest value (the 1e-4 limit; the CPU emulation in
// tests/test_torch_ssd_tc.py, where dropping any one of the six lo terms
// misses it).  Shared memory is what shapes the design: B and C in two
// pieces alone would take 256 KB at the serving shape.  So C never enters
// shared memory: S = C B^T is computed once per block, for all R of its
// heads, from C's A fragments read straight from device memory and split
// in registers, against B's pieces (K-major), and each y warpgroup keeps
// its own (i, j) tiles of S in a scratch buffer in device memory (10 tiles
// of 16 KB a block at Q = 256, in the accumulator's own layout, so each
// thread reads back only what it wrote, 16 bytes at a time, from L2; the
// next tile's read is issued before this tile's products, and C's next
// fragments likewise while S is computed: without that the reads' latency
// cost 0.27 ms of 1.22 at the serving shape on an H100).  The
// block's threads split B (f32, from device memory) into its pieces once,
// and each head's x into one buffer of pieces, written where and as TMA
// would write them and fenced for the async proxy: B's pieces 128 KB, x's
// 64 KB, cum and w 4 KB, 201,728 B a block at the serving shape.  Per head,
// M = S * L from the kept S (L and its selection as in bf16) and the three
// y products, and warpgroup 2's three states products, as in bf16; each
// product's small terms go first, so that the tensor cores' truncating f32
// accumulation adds them to small partial sums.  The x load of the next
// head is not overlapped with this head's products (one buffer of x fits,
// not two; it costs about 0.15 ms at the serving shape on an H100,
// scripts/ssd_split_parts.py).  Bound at the
// serving shape: bytes, 0.257 ms (the three products take 0.13 ms at the
// bf16 peak).
//
// bf16 and f32 operands off those shapes (P 8 or 24, N 40 or 48,
// misaligned data or odd token strides) at chunks of at most 32 tokens:
// `op::fwd_chunk`, one launch on the tensor cores as mma.sync m16n8k16.
// These are the reduced configs' calls (the reduced mamba2's (nc 16, Q 16,
// H 16, G 1, P 8, N 16), bound by bytes at about 0.1 us), where a chain of
// fixed costs sets the time, not the products; the kernel keeps that chain
// short.  A block of four warps takes a chunk and a run of four heads of
// one group (grid (nc G, ceil(H / G / 4)): 64 blocks at the reduced shape
// on 132 SMs, where a block a chunk and group would give 16).  Its threads
// stage the group's B and C (f32, the state dim zero-padded to 16) and
// form S = C B^T once, each warp its tiles below the diagonal; meanwhile
// each warp stages its head's x (the head dim padded to 16), scans dA in
// a fixed order (a lane a token, an inclusive shuffle scan) and writes
// chunk_decay.  Then each warp on its own head: M = S * L, L selected to
// 0 above the diagonal before its exp (there cum_i - cum_j > 0 may
// overflow), into the warp's shared memory; y_diag = M x; states = (w
// x)^T B with w = exp(cum[Q-1] - cum).  M and w x are f32 and enter their
// products split into bf16 hi + lo, as on the wgmma route; with f32 inputs
// x, B and C do too, and every product is its pieces' products but lo.lo
// (the split route's arithmetic).  The fragments are gathered from shared
// memory; the sums are f32 in a fixed order, so two calls give the same
// bits.  Longer chunks off the wgmma shapes take the wgmma kernels on
// operands the wrapper zero-pads to their shapes (`ssd_scan.route`).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ------------------------------------------------- bf16: tensor cores
namespace tc {

constexpr int kThreads = 512;  // warpgroups 0, 1, 3: y_diag; 2: states; thread 0 issues TMA
constexpr int kRows = 64;      // rows of a (i, j) tile and of a TMA box
constexpr int kMaxQ = 256;

template <int P, int N>
struct Cfg {
  static constexpr int SWB = N >= 64 ? 128 : 2 * N;  // B, C swizzle span (bytes of a chunk row)
  static constexpr int CWB = SWB / 2;                // bf16 columns per B/C chunk
  static constexpr int NCB = N / CWB;                // chunks across N
  static constexpr uint32_t kModeB = SWB == 128 ? 1 : SWB == 64 ? 2 : 3;
  static constexpr int SWX = 2 * P;                  // x swizzle span: one chunk, P <= 64
  static constexpr uint32_t kModeX = SWX == 128 ? 1 : SWX == 64 ? 2 : 3;
};

// Shared memory a block: B and C of the chunk, x of two heads, cum and the
// states weights of two heads, three mbarriers, 1 KB of slack to align the
// swizzled tiles to 1 KB.
size_t smem_bytes(int Q, int P, int N) {
  const size_t qpad = (size_t)((Q + kRows - 1) / kRows) * kRows;
  return 1024 + 2 * qpad * N * 2 + 2 * qpad * P * 2 + 4 * 4 * kMaxQ + 3 * 8;
}

using hopper::split_bf16;
using hopper::swz;

// dA of head h for this lane's 8 steps 8 lane .. 8 lane + 7 (0 past Q).
__device__ __forceinline__ void load_dA(float (&v)[8], const float* dA, int c, int Q, int H,
                                        int h, int lane) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int t = 8 * lane + e;
    v[e] = t < Q ? dA[((size_t)c * Q + t) * H + h] : 0.f;
  }
}

// One warp's cumsum of a head's dA, in a fixed order: each lane sums its 8
// steps in sequence, the lanes' totals go through an inclusive shuffle scan
// (offsets 1, 2, 4, 8, 16), and each step adds the lane's exclusive prefix
// (the next lower lane's inclusive total).  Writes cum[0..256) (steps past Q
// hold cum[Q-1]), the states weights w[t] = exp(cum[Q-1] - cum[t]) (0 past
// Q), and chunk_decay = exp(cum[Q-1]).
__device__ __forceinline__ void scan_head(const float (&v)[8], int lane, int Q, float* cum,
                                          float* w, float* decay) {
  float part[8], run = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    run += v[e];
    part[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += n;
  }
  float base = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) base = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) cum[8 * lane + e] = base + part[e];
  __syncwarp();
  const float end = cum[Q - 1];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int t = 8 * lane + e;
    w[t] = t < Q ? expf(end - cum[t]) : 0.f;
  }
  if (lane == 0) *decay = expf(end);
}

// Head h's x tile of chunk c into `dst`, nt boxes of 64 rows, counted on `bar`.
template <int SWX>
__device__ __forceinline__ void load_x(const CUtensorMap* xmap, uint32_t dst, uint32_t bar,
                                       uint32_t bytes, int nt, int h, int c) {
  hopper::mbar_expect_tx(bar, bytes);
  for (int t = 0; t < nt; ++t)
    hopper::tma_load_4d(dst + t * kRows * SWX, xmap, bar, 0, h, t * kRows, c);
}

// Tile i's rows go to warpgroup 0 if it is the last tile, 1 if it is the
// one before it or the first, else 3: at 4 tiles, 4, 3 + 1 and 2 of the 10
// causal (i, j) tiles.  Warpgroup 2 takes states.
__device__ __forceinline__ int tile_owner(int i, int nt) {
  return i == nt - 1 ? 0 : (i == nt - 2 || i == 0) ? 1 : 3;
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads, 1) ssd_chunk_wgmma(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap bmap,
    const __grid_constant__ CUtensorMap cmap, const float* __restrict__ dA,
    float* __restrict__ y, float* __restrict__ states, float* __restrict__ decay, int Q, int H,
    int G, int R) {
  using K = Cfg<P, N>;
  constexpr int SWB = K::SWB, CWB = K::CWB, SWX = K::SWX;
  const int nt = (Q + kRows - 1) / kRows, qpad = nt * kRows;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t bc_bytes = (uint32_t)qpad * N * 2, x_bytes = (uint32_t)qpad * P * 2;
  const uint32_t b_s = base;               // [NCB][qpad][CWB], swizzled
  const uint32_t c_s = b_s + bc_bytes;     // [NCB][qpad][CWB]
  const uint32_t x_s = c_s + bc_bytes;     // [2 heads][qpad][P]
  float* const cumf = reinterpret_cast<float*>(gbase + 2 * bc_bytes + 2 * x_bytes);
  const uint32_t bars = x_s + 2 * x_bytes + 4 * 4 * kMaxQ;  // bc, x[2]
  const uint32_t bc_bar = bars;
  auto x_bar = [&](int s) { return bars + 8u * (1 + s); };

  const int runs = H / R;
  const int c = blockIdx.x / runs, h0 = (blockIdx.x - c * runs) * R;
  const int g = h0 / (H / G);
  const int wg = threadIdx.x / 128, wt = threadIdx.x % 128, warp = wt / 32, lane = wt % 32;

  if (threadIdx.x == 0) {
    hopper::mbar_init(bc_bar, 1);
    hopper::mbar_init(x_bar(0), 1);
    hopper::mbar_init(x_bar(1), 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hopper::mbar_expect_tx(bc_bar, 2 * bc_bytes);
    for (int cc = 0; cc < K::NCB; ++cc)
      for (int t = 0; t < nt; ++t) {
        const uint32_t off = cc * qpad * SWB + t * kRows * SWB;
        hopper::tma_load_4d(b_s + off, &bmap, bc_bar, cc * CWB, g, t * kRows, c);
        hopper::tma_load_4d(c_s + off, &cmap, bc_bar, cc * CWB, g, t * kRows, c);
      }
    load_x<SWX>(&xmap, x_s, x_bar(0), x_bytes, nt, h0, c);
  }
  float nxt[8];  // warp 0: dA of the next head, loaded one head ahead
  if (threadIdx.x < 32) {
    load_dA(nxt, dA, c, Q, H, h0, lane);
    scan_head(nxt, lane, Q, cumf, cumf + 2 * kMaxQ, decay + (size_t)c * H + h0);
    if (R > 1) load_dA(nxt, dA, c, Q, H, h0 + 1, lane);
  }
  __syncthreads();

  const int p0 = 16 * warp + lane / 4, p1 = p0 + 8;  // this thread's accumulator rows
  const int cq = 2 * (lane % 4);                      // and its first column in each 8
  for (int k = 0; k < R; ++k) {
    const int s = k & 1, h = h0 + k;
    if (threadIdx.x < 32 && k + 1 < R) {
      scan_head(nxt, lane, Q, cumf + (s ^ 1) * kMaxQ, cumf + (2 + (s ^ 1)) * kMaxQ,
                decay + (size_t)c * H + h + 1);
      if (k + 2 < R) load_dA(nxt, dA, c, Q, H, h + 2, lane);
    }
    if (threadIdx.x == 0 && k + 1 < R)
      load_x<SWX>(&xmap, x_s + (s ^ 1) * x_bytes, x_bar(s ^ 1), x_bytes, nt, h + 1, c);
    if (k == 0) hopper::mbar_wait(bc_bar, 0);
    hopper::mbar_wait(x_bar(s), (k >> 1) & 1);
    const float* cum = cumf + s * kMaxQ;
    const float* w = cumf + (2 + s) * kMaxQ;
    const uint32_t xs = x_s + s * x_bytes;
    const uint8_t* const xg = gbase + (xs - base);

    // ---- y_diag: row tile i against the causal column tiles j <= i
    for (int i = 0; i < nt; ++i) {
      if (tile_owner(i, nt) != wg) continue;
      const int i0 = i * kRows, r0 = i0 + p0, r1 = i0 + p1;
      const float cr0 = cum[r0], cr1 = cum[r1];
      float acc[P / 2];
#pragma unroll
      for (int e = 0; e < P / 2; ++e) acc[e] = 0.f;
      for (int j = 0; j <= i; ++j) {
        const int j0 = j * kRows;
        // S = C_i . B_j^T, both K-major (N contiguous): exact bf16 products, f32 sums
        float sc[32];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {
          const uint32_t off = (kk * 16 / CWB) * qpad * SWB + (kk * 16 % CWB) * 2;
          hopper::wgmma_ss(sc, hopper::make_desc(c_s + off + i0 * SWB, 16, 8 * SWB, K::kModeB),
                           hopper::make_desc(b_s + off + j0 * SWB, 16, 8 * SWB, K::kModeB),
                           kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        // M = S * L, L selected (never multiplied) to 0 above the diagonal and
        // past Q, then split into bf16 hi + lo: the A fragments of M . x_j
        uint32_t hi[4][4], lo[4][4];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int cb = j0 + 8 * jj + cq;
          const float cc0 = cum[cb], cc1 = cum[cb + 1];
          const bool v0 = r0 < Q, v1 = r1 < Q;
          const float m00 = v0 && cb <= r0 ? sc[4 * jj] * __expf(cr0 - cc0) : 0.f;
          const float m01 = v0 && cb + 1 <= r0 ? sc[4 * jj + 1] * __expf(cr0 - cc1) : 0.f;
          const float m10 = v1 && cb <= r1 ? sc[4 * jj + 2] * __expf(cr1 - cc0) : 0.f;
          const float m11 = v1 && cb + 1 <= r1 ? sc[4 * jj + 3] * __expf(cr1 - cc1) : 0.f;
          split_bf16(m00, m01, hi[jj / 2][2 * (jj % 2)], lo[jj / 2][2 * (jj % 2)]);
          split_bf16(m10, m11, hi[jj / 2][2 * (jj % 2) + 1], lo[jj / 2][2 * (jj % 2) + 1]);
        }
        // y_i += hi . x_j + lo . x_j, x_j MN-major (P contiguous): a k16 step is 16 rows
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t xd =
              hopper::make_desc(xs + (j0 + 16 * kk) * SWX, qpad * SWX, 8 * SWX, K::kModeX);
          hopper::wgmma_rs(acc, hi[kk], xd, 1);
          hopper::wgmma_rs(acc, lo[kk], xd, 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
      }
#pragma unroll
      for (int jj = 0; jj < P / 8; ++jj) {
        const int col = 8 * jj + cq;
        if (r0 < Q)
          *reinterpret_cast<float2*>(y + (((size_t)c * Q + r0) * H + h) * P + col) =
              make_float2(acc[4 * jj], acc[4 * jj + 1]);
        if (r1 < Q)
          *reinterpret_cast<float2*>(y + (((size_t)c * Q + r1) * H + h) * P + col) =
              make_float2(acc[4 * jj + 2], acc[4 * jj + 3]);
      }
    }

    // ---- states[p][n] = sum_t xw[t][p] B[t][n], xw = x * w split into bf16
    // hi + lo and read transposed from the swizzled x tile into A fragments;
    // B MN-major (N contiguous).  Warpgroup 2 computes it beside the y tiles.
    if (wg == 2) {
      float st[N / 2];
#pragma unroll
      for (int e = 0; e < N / 2; ++e) st[e] = 0.f;
      auto xw = [&](int p, int t) {
        if (p >= P) return 0.f;
        const __nv_bfloat16 v =
            *reinterpret_cast<const __nv_bfloat16*>(xg + swz(t * SWX + p * 2, SWX));
        return __bfloat162float(v) * w[t];
      };
      for (int t0 = 0; t0 < qpad; t0 += 64) {
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int t = t0 + 16 * kk + cq;
          split_bf16(xw(p0, t), xw(p0, t + 1), ah[kk][0], al[kk][0]);
          split_bf16(xw(p1, t), xw(p1, t + 1), ah[kk][1], al[kk][1]);
          split_bf16(xw(p0, t + 8), xw(p0, t + 9), ah[kk][2], al[kk][2]);
          split_bf16(xw(p1, t + 8), xw(p1, t + 9), ah[kk][3], al[kk][3]);
        }
        hopper::fence_regs(st);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t bd =
              hopper::make_desc(b_s + (t0 + 16 * kk) * SWB, qpad * SWB, 8 * SWB, K::kModeB);
          hopper::wgmma_rs(st, ah[kk], bd, 1);
          hopper::wgmma_rs(st, al[kk], bd, 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(st);
      }
      float* const sblk = states + ((size_t)c * H + h) * P * N;
#pragma unroll
      for (int jj = 0; jj < N / 8; ++jj) {
        const int col = 8 * jj + cq;
        if (p0 < P)
          *reinterpret_cast<float2*>(sblk + (size_t)p0 * N + col) =
              make_float2(st[4 * jj], st[4 * jj + 1]);
        if (p1 < P)
          *reinterpret_cast<float2*>(sblk + (size_t)p1 * N + col) =
              make_float2(st[4 * jj + 2], st[4 * jj + 3]);
      }
    }
    __syncthreads();  // buffers s are free for head k + 2, cum of head k + 1 is written
  }
}

// ------------------------------------------------ split f32: tensor cores
// Shared memory a block of the split route: B's hi and lo pieces, x's hi and
// lo pieces of one head, cum and the states weights of two heads, 1 KB of
// slack to align the swizzled tiles to 1 KB.
size_t split_smem_bytes(int Q, int P, int N) {
  const size_t qpad = (size_t)((Q + kRows - 1) / kRows) * kRows;
  return 1024 + 2 * qpad * N * 2 + 2 * qpad * P * 2 + 4 * 4 * kMaxQ;
}

// The causal (i, j) score tiles of a chunk of nt row tiles; tile (i, j) is
// number i (i + 1) / 2 + j.  A tile is 64 x 64 f32 in the accumulator
// layout: float4 e (0..7) of thread t at (e * 128 + t) * 4.
constexpr int kScoreTileFloats = kRows * kRows;
__host__ __device__ __forceinline__ int score_tiles(int nt) { return nt * (nt + 1) / 2; }

// Rows [0, qpad) of a (Q, W) f32 operand whose tokens are `tok` elements
// apart, as bf16 hi and lo pieces (hopper::split_bf16) at `hi` and `lo`,
// each [W / (SW / 2)][qpad][SW / 2] and swizzled as TMA writes a tile of SW
// byte rows; zeros past Q.  Every thread of the block takes 16-byte units,
// kBatch at a time: all of a batch's loads are issued before any is used,
// so a batch costs one trip to device memory.
template <int W, int SW>
__device__ __forceinline__ void split_rows(uint8_t* hi, uint8_t* lo, const float* src,
                                           long long tok, int Q, int qpad) {
  constexpr int CW = SW / 2, U = W / 8, kBatch = 4;
  const int units = qpad * U;
  for (int u0 = threadIdx.x; u0 < units; u0 += kBatch * kThreads) {
    float4 v[kBatch][2];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int u = u0 + i * kThreads, t = u / U, col = (u - t * U) * 8;
      v[i][0] = v[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (u < units && t < Q) {
        const float4* s4 = reinterpret_cast<const float4*>(src + (size_t)t * tok + col);
        v[i][0] = s4[0];
        v[i][1] = s4[1];
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int u = u0 + i * kThreads, t = u / U, col = (u - t * U) * 8;
      if (u >= units) break;
      uint4 h, l;
      split_bf16(v[i][0].x, v[i][0].y, h.x, l.x);
      split_bf16(v[i][0].z, v[i][0].w, h.y, l.y);
      split_bf16(v[i][1].x, v[i][1].y, h.z, l.z);
      split_bf16(v[i][1].z, v[i][1].w, h.w, l.w);
      const uint32_t off = (col / CW) * qpad * SW + swz(t * SW + (col % CW) * 2, SW);
      *reinterpret_cast<uint4*>(hi + off) = h;
      *reinterpret_cast<uint4*>(lo + off) = l;
    }
  }
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads, 1) ssd_chunk_split(
    const float* __restrict__ x, const float* __restrict__ dA, const float* __restrict__ B,
    const float* __restrict__ C, float* __restrict__ y, float* __restrict__ states,
    float* __restrict__ decay, float* __restrict__ scores, int Q, int H, int G, int R,
    long long x_tok, long long b_tok, long long c_tok) {
  using K = Cfg<P, N>;
  constexpr int SWB = K::SWB, CWB = K::CWB, SWX = K::SWX;
  constexpr int KG = N / 16 < 4 ? N / 16 : 4;  // k16 steps of C held in registers at once
  const int nt = (Q + kRows - 1) / kRows, qpad = nt * kRows;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t bc_bytes = (uint32_t)qpad * N * 2, x_bytes = (uint32_t)qpad * P * 2;
  const uint32_t b_s = base;                // hi [NCB][qpad][CWB], lo at + bc_bytes
  const uint32_t x_s = b_s + 2 * bc_bytes;  // hi [qpad][P], lo at + x_bytes
  float* const cumf = reinterpret_cast<float*>(gbase + 2 * bc_bytes + 2 * x_bytes);

  const int runs = H / R;
  const int c = blockIdx.x / runs, h0 = (blockIdx.x - c * runs) * R;
  const int g = h0 / (H / G);
  const int wg = threadIdx.x / 128, wt = threadIdx.x % 128, warp = wt / 32, lane = wt % 32;
  const int p0 = 16 * warp + lane / 4, p1 = p0 + 8;  // this thread's accumulator rows
  const int cq = 2 * (lane % 4);                      // and its first column in each 8
  float* const sblk = scores + (size_t)blockIdx.x * score_tiles(nt) * kScoreTileFloats;

  float nxt[8];  // warp 0: dA of the next head, loaded one head ahead
  if (threadIdx.x < 32) {
    load_dA(nxt, dA, c, Q, H, h0, lane);
    scan_head(nxt, lane, Q, cumf, cumf + 2 * kMaxQ, decay + (size_t)c * H + h0);
    if (R > 1) load_dA(nxt, dA, c, Q, H, h0 + 1, lane);
  }
  split_rows<N, SWB>(gbase, gbase + bc_bytes, B + (size_t)c * Q * b_tok + (size_t)g * N, b_tok,
                     Q, qpad);
  hopper::fence_proxy_async();
  __syncthreads();

  // ---- S = C B^T, once for the block's heads: each y warpgroup computes
  // its own row tiles' (i, j) tiles and keeps them in its scratch, where
  // each thread reads back only what it wrote.  C_i enters as A fragments
  // straight from device memory, split in registers; B_j K-major.
  // S = Ch.Bh^T + Cl.Bh^T + Ch.Bl^T.
  const float* cg = C + (size_t)c * Q * c_tok + (size_t)g * N;
  constexpr int NG = N / 16 / KG;  // groups of KG k16 steps across N
  for (int i = 0; i < nt; ++i) {
    if (tile_owner(i, nt) != wg) continue;
    const int r0 = i * kRows + p0, r1 = r0 + 8;
    // C_i's f32 values of k group kg, for this thread's A fragments
    float2 raw[KG][4];
    auto load_c = [&](int kg) {
#pragma unroll
      for (int kk = 0; kk < KG; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e & 1 ? r1 : r0, col = 16 * (kg * KG + kk) + cq + (e & 2 ? 8 : 0);
          raw[kk][e] = row < Q
                           ? *reinterpret_cast<const float2*>(cg + (size_t)row * c_tok + col)
                           : make_float2(0.f, 0.f);
        }
    };
    load_c(0);
    for (int j = 0; j <= i; ++j) {
      float sc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = 0.f;
#pragma unroll
      for (int kg = 0; kg < NG; ++kg) {
        uint32_t ch[KG][4], cl[KG][4];
#pragma unroll
        for (int kk = 0; kk < KG; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) split_bf16(raw[kk][e].x, raw[kk][e].y, ch[kk][e], cl[kk][e]);
        // the next group's values, in flight while this group's products run
        if (NG > 1 && (j < i || kg + 1 < NG)) load_c((kg + 1) % NG);
        hopper::fence_regs(sc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KG; ++kk) {
          const int ks = kg * KG + kk;
          const uint32_t off = (ks * 16 / CWB) * qpad * SWB + (ks * 16 % CWB) * 2 + j * kRows * SWB;
          const uint64_t bd = hopper::make_desc(b_s + off, 16, 8 * SWB, K::kModeB);
          const uint64_t bld = hopper::make_desc(b_s + bc_bytes + off, 16, 8 * SWB, K::kModeB);
          hopper::wgmma_rs_kmajor(sc, cl[kk], bd, 1);
          hopper::wgmma_rs_kmajor(sc, ch[kk], bld, 1);
          hopper::wgmma_rs_kmajor(sc, ch[kk], bd, 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
      }
      float4* const dst =
          reinterpret_cast<float4*>(sblk + (size_t)(i * (i + 1) / 2 + j) * kScoreTileFloats) + wt;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e * 128] = make_float4(sc[4 * e], sc[4 * e + 1], sc[4 * e + 2], sc[4 * e + 3]);
    }
  }

  for (int k = 0; k < R; ++k) {
    const int s = k & 1, h = h0 + k;
    if (threadIdx.x < 32 && k + 1 < R) {
      scan_head(nxt, lane, Q, cumf + (s ^ 1) * kMaxQ, cumf + (2 + (s ^ 1)) * kMaxQ,
                decay + (size_t)c * H + h + 1);
      if (k + 2 < R) load_dA(nxt, dA, c, Q, H, h + 2, lane);
    }
    uint8_t* const xg = gbase + (x_s - base);
    split_rows<P, SWX>(xg, xg + x_bytes, x + (size_t)c * Q * x_tok + (size_t)h * P, x_tok, Q,
                       qpad);
    hopper::fence_proxy_async();
    __syncthreads();  // x's pieces written; head h's cum (scanned a head ahead) visible
    const float* cum = cumf + s * kMaxQ;
    const float* w = cumf + (2 + s) * kMaxQ;

    // ---- y_diag: row tile i against the causal column tiles j <= i
    for (int i = 0; i < nt; ++i) {
      if (tile_owner(i, nt) != wg) continue;
      const int i0 = i * kRows, r0 = i0 + p0, r1 = i0 + p1;
      const float cr0 = cum[r0], cr1 = cum[r1];
      float acc[P / 2];
#pragma unroll
      for (int e = 0; e < P / 2; ++e) acc[e] = 0.f;
      // This thread's part of score tile (i, j), kept by this warpgroup
      auto load_scores = [&](float (&sc)[32], int j) {
        const float4* const src = reinterpret_cast<const float4*>(
                                      sblk + (size_t)(i * (i + 1) / 2 + j) * kScoreTileFloats) +
                                  wt;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float4 v = src[e * 128];
          sc[4 * e] = v.x;
          sc[4 * e + 1] = v.y;
          sc[4 * e + 2] = v.z;
          sc[4 * e + 3] = v.w;
        }
      };
      float sc[32];
      load_scores(sc, 0);
      for (int j = 0; j <= i; ++j) {
        const int j0 = j * kRows;
        // M = S * L, L selected (never multiplied) to 0 above the diagonal and
        // past Q, then split into bf16 hi + lo: the A fragments of M . x_j
        uint32_t hi[4][4], lo[4][4];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int cb = j0 + 8 * jj + cq;
          const float cc0 = cum[cb], cc1 = cum[cb + 1];
          const bool v0 = r0 < Q, v1 = r1 < Q;
          const float m00 = v0 && cb <= r0 ? sc[4 * jj] * __expf(cr0 - cc0) : 0.f;
          const float m01 = v0 && cb + 1 <= r0 ? sc[4 * jj + 1] * __expf(cr0 - cc1) : 0.f;
          const float m10 = v1 && cb <= r1 ? sc[4 * jj + 2] * __expf(cr1 - cc0) : 0.f;
          const float m11 = v1 && cb + 1 <= r1 ? sc[4 * jj + 3] * __expf(cr1 - cc1) : 0.f;
          split_bf16(m00, m01, hi[jj / 2][2 * (jj % 2)], lo[jj / 2][2 * (jj % 2)]);
          split_bf16(m10, m11, hi[jj / 2][2 * (jj % 2) + 1], lo[jj / 2][2 * (jj % 2) + 1]);
        }
        // the next tile's scores, in flight while this tile's products run
        if (j < i) load_scores(sc, j + 1);
        // y_i += Ml.xh + Mh.xl + Mh.xh (the small terms first), x_j MN-major
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int t = 0; t < 3; ++t)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint32_t off = (t == 1 ? x_bytes : 0) + (j0 + 16 * kk) * SWX;
            hopper::wgmma_rs(acc, t == 0 ? lo[kk] : hi[kk],
                             hopper::make_desc(x_s + off, qpad * SWX, 8 * SWX, K::kModeX), 1);
          }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
      }
#pragma unroll
      for (int jj = 0; jj < P / 8; ++jj) {
        const int col = 8 * jj + cq;
        if (r0 < Q)
          *reinterpret_cast<float2*>(y + (((size_t)c * Q + r0) * H + h) * P + col) =
              make_float2(acc[4 * jj], acc[4 * jj + 1]);
        if (r1 < Q)
          *reinterpret_cast<float2*>(y + (((size_t)c * Q + r1) * H + h) * P + col) =
              make_float2(acc[4 * jj + 2], acc[4 * jj + 3]);
      }
    }

    // ---- states: xw = (xh + xl) * w, split again, read transposed from the
    // swizzled x pieces into A fragments; states += xwh^T.Bh + xwl^T.Bh +
    // xwh^T.Bl with B MN-major.  Warpgroup 2, beside the y tiles.
    if (wg == 2) {
      float st[N / 2];
#pragma unroll
      for (int e = 0; e < N / 2; ++e) st[e] = 0.f;
      auto xw = [&](int p, int t) {
        if (p >= P) return 0.f;
        const uint32_t off = swz(t * SWX + p * 2, SWX);
        return (__bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(xg + off)) +
                __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(xg + x_bytes + off))) *
               w[t];
      };
      for (int t0 = 0; t0 < qpad; t0 += 64) {
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int t = t0 + 16 * kk + cq;
          split_bf16(xw(p0, t), xw(p0, t + 1), ah[kk][0], al[kk][0]);
          split_bf16(xw(p1, t), xw(p1, t + 1), ah[kk][1], al[kk][1]);
          split_bf16(xw(p0, t + 8), xw(p0, t + 9), ah[kk][2], al[kk][2]);
          split_bf16(xw(p1, t + 8), xw(p1, t + 9), ah[kk][3], al[kk][3]);
        }
        hopper::fence_regs(st);
        hopper::wgmma_fence();
#pragma unroll
        for (int t = 0; t < 3; ++t)  // xwl.Bh, xwh.Bl, xwh.Bh: the small terms first
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint32_t off = (t == 1 ? bc_bytes : 0) + (t0 + 16 * kk) * SWB;
            hopper::wgmma_rs(st, t == 0 ? al[kk] : ah[kk],
                             hopper::make_desc(b_s + off, qpad * SWB, 8 * SWB, K::kModeB), 1);
          }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(st);
      }
      float* const sout = states + ((size_t)c * H + h) * P * N;
#pragma unroll
      for (int jj = 0; jj < N / 8; ++jj) {
        const int col = 8 * jj + cq;
        if (p0 < P)
          *reinterpret_cast<float2*>(sout + (size_t)p0 * N + col) =
              make_float2(st[4 * jj], st[4 * jj + 1]);
        if (p1 < P)
          *reinterpret_cast<float2*>(sout + (size_t)p1 * N + col) =
              make_float2(st[4 * jj + 2], st[4 * jj + 3]);
      }
    }
    __syncthreads();  // x's buffer is free for head h + 1, its cum is written
  }
}

// A rank-4 map over (width, heads or groups, Q, nc) of a bf16 operand whose
// (heads, width) rows are packed and whose tokens are `tok` elements apart.
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

// Heads per block: a divisor R of the heads of one group, chosen for waves
// on the card's SMs.  Cost waves * (4 R + 1): a wave runs R heads one after
// the other, plus about a quarter of a head to load the chunk's B and C.
// Ties go to the larger R (fewer B and C loads).
int heads_per_block(int nc, int H, int G, int sms) {
  const int hg = H / G;
  int best = 1;
  long long best_cost = -1;
  for (int r = 1; r <= hg; ++r) {
    if (hg % r) continue;
    const long long blocks = (long long)nc * (H / r);
    const long long cost = (blocks + sms - 1) / sms * (4LL * r + 1);
    if (best_cost < 0 || cost <= best_cost) {
      best = r;
      best_cost = cost;
    }
  }
  return best;
}

template <int P, int N>
cudaError_t launch(const void* x, const void* dA, const void* B, const void* C, void* y,
                   void* states, void* decay, int nc, int Q, int H, int G, long long x_tok,
                   long long b_tok, long long c_tok, cudaStream_t stream) {
  using K = Cfg<P, N>;
  CUtensorMap xm, bm, cm;
  if (encode_map(&xm, x, P, H, Q, nc, x_tok, P, K::SWX) != CUDA_SUCCESS ||
      encode_map(&bm, B, N, G, Q, nc, b_tok, K::CWB, K::SWB) != CUDA_SUCCESS ||
      encode_map(&cm, C, N, G, Q, nc, c_tok, K::CWB, K::SWB) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int R = heads_per_block(nc, H, G, sms);
  const size_t smem = smem_bytes(Q, P, N);
  err = cudaFuncSetAttribute(ssd_chunk_wgmma<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  ssd_chunk_wgmma<P, N><<<nc * (H / R), kThreads, smem, stream>>>(
      xm, bm, cm, static_cast<const float*>(dA), static_cast<float*>(y),
      static_cast<float*>(states), static_cast<float*>(decay), Q, H, G, R);
  return cudaGetLastError();
}

template <int P, int N>
cudaError_t resources(int Q, int* regs, int* smem) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, ssd_chunk_wgmma<P, N>);
  *regs = attr.numRegs;
  *smem = (int)(attr.sharedSizeBytes + smem_bytes(Q, P, N));
  return err;
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

// Floats of score scratch the split route needs: a block's causal score
// tiles, for each of its nc * H / R blocks.
cudaError_t split_scratch_floats(int nc, int Q, int H, int G, long long* floats) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)nc * (H / heads_per_block(nc, H, G, sms));
  *floats = blocks * score_tiles((Q + kRows - 1) / kRows) * kScoreTileFloats;
  return cudaSuccess;
}

template <int P, int N>
cudaError_t launch_split(const void* x, const void* dA, const void* B, const void* C, void* y,
                         void* states, void* decay, void* scores, int nc, int Q, int H, int G,
                         long long x_tok, long long b_tok, long long c_tok, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int R = heads_per_block(nc, H, G, sms);
  const size_t smem = split_smem_bytes(Q, P, N);
  err = cudaFuncSetAttribute(ssd_chunk_split<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  ssd_chunk_split<P, N><<<nc * (H / R), kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dA), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<float*>(y), static_cast<float*>(states),
      static_cast<float*>(decay), static_cast<float*>(scores), Q, H, G, R, x_tok, b_tok, c_tok);
  return cudaGetLastError();
}

template <int P, int N>
cudaError_t resources_split(int Q, int* regs, int* smem) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, ssd_chunk_split<P, N>);
  *regs = attr.numRegs;
  *smem = (int)(attr.sharedSizeBytes + split_smem_bytes(Q, P, N));
  return err;
}

// The route's shapes: P in {16, 32, 64}, N in {16, 32, 64, 128}.
bool takes(int P, int N) {
  return (P == 16 || P == 32 || P == 64) && (N == 16 || N == 32 || N == 64 || N == 128);
}

#define SSD_TC_DISPATCH(FN, ...)                                      \
  switch (P * 1000 + N) {                                             \
    case 16016: return FN<16, 16>(__VA_ARGS__);                       \
    case 16032: return FN<16, 32>(__VA_ARGS__);                       \
    case 16064: return FN<16, 64>(__VA_ARGS__);                       \
    case 16128: return FN<16, 128>(__VA_ARGS__);                      \
    case 32016: return FN<32, 16>(__VA_ARGS__);                       \
    case 32032: return FN<32, 32>(__VA_ARGS__);                       \
    case 32064: return FN<32, 64>(__VA_ARGS__);                       \
    case 32128: return FN<32, 128>(__VA_ARGS__);                      \
    case 64016: return FN<64, 16>(__VA_ARGS__);                       \
    case 64032: return FN<64, 32>(__VA_ARGS__);                       \
    case 64064: return FN<64, 64>(__VA_ARGS__);                       \
    case 64128: return FN<64, 128>(__VA_ARGS__);                      \
    default: return cudaErrorInvalidValue;                            \
  }

cudaError_t dispatch(const void* x, const void* dA, const void* B, const void* C, void* y,
                     void* states, void* decay, int nc, int Q, int H, int G, int P, int N,
                     long long x_tok, long long b_tok, long long c_tok, cudaStream_t st) {
  SSD_TC_DISPATCH(launch, x, dA, B, C, y, states, decay, nc, Q, H, G, x_tok, b_tok, c_tok, st)
}

cudaError_t dispatch_split(const void* x, const void* dA, const void* B, const void* C, void* y,
                           void* states, void* decay, void* scores, int nc, int Q, int H, int G,
                           int P, int N, long long x_tok, long long b_tok, long long c_tok,
                           cudaStream_t st) {
  SSD_TC_DISPATCH(launch_split, x, dA, B, C, y, states, decay, scores, nc, Q, H, G, x_tok, b_tok,
                  c_tok, st)
}

cudaError_t dispatch_resources(int is_bf16, int Q, int P, int N, int* regs, int* smem) {
  if (!is_bf16) SSD_TC_DISPATCH(resources_split, Q, regs, smem)
  SSD_TC_DISPATCH(resources, Q, regs, smem)
}

}  // namespace tc

// ------------------------------- chunks of at most 32 tokens: one pass
namespace op {

constexpr int kWarps = 4;  // heads a block: a warp a head
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxQ = 32;  // chunk length at most: a lane a token for the scan
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxRep = 256;  // heads a group at most (the backward's one-pass limit)

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// Offsets of a launch's shared memory, in floats: S (Q x Q), B and C (Q x
// NK, N padded to 16), then each warp's x (Q x PK, P padded to 16), M (Q x
// Q), cum and w (kMaxQ each).
struct Smem {
  int S, Bs, Cs, x, M, cum, w, total;
  __host__ __device__ Smem(int Q, int NK, int PK) {
    S = 0;
    Bs = S + Q * Q;
    Cs = Bs + Q * NK;
    x = Cs + Q * NK;
    M = x + kWarps * Q * PK;
    cum = M + kWarps * Q * Q;
    w = cum + kWarps * kMaxQ;
    total = w + kWarps * kMaxQ;
  }
};

// grid (nc * G, ceil(H / G / kWarps)), kThreads threads; Q 16 or 32, P <=
// kMaxP, N <= kMaxN.  x, B and C at any alignment and token stride.
template <typename T>
__global__ void __launch_bounds__(kThreads) fwd_chunk(
    const T* __restrict__ x, const float* __restrict__ dA, const T* __restrict__ B,
    const T* __restrict__ C, float* __restrict__ y, float* __restrict__ states,
    float* __restrict__ decay, int Q, int H, int G, int P, int N, long long sx, long long sB,
    long long sC) {
  constexpr bool kF32 = sizeof(T) == 4;  // f32 x, B and C enter as hi + lo too
  constexpr int kMaxQT = kMaxQ / 16, kMaxPT = kMaxP / 8, kMaxNT = kMaxN / 8;
  extern __shared__ __align__(16) float sm[];
  const int NK = (N + 15) / 16 * 16, PK = (P + 15) / 16 * 16, QT = Q / 16, rep = H / G;
  const Smem L(Q, NK, PK);
  float* const S = sm + L.S;
  float* const Bs = sm + L.Bs;
  float* const Cs = sm + L.Cs;
  const int cgi = blockIdx.x, c = cgi / G, g = cgi % G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hl = blockIdx.y * kWarps + warp;  // this warp's head in the group
  const bool active = hl < rep;
  const long long h = (long long)g * rep + hl;
  float* const xs = sm + L.x + warp * Q * PK;
  float* const Ms = sm + L.M + warp * Q * Q;
  float* const cumw = sm + L.cum + warp * kMaxQ;
  float* const ww = sm + L.w + warp * kMaxQ;
  const long long tok0 = (long long)c * Q;  // the chunk's first token
  float a[8], b[4];
  uint32_t ah[4], al[4], bh[2], bl[2];

  float cv = active && lane < Q ? dA[(tok0 + lane) * H + h] : 0.f;
  for (int e = tid; e < Q * NK; e += kThreads) {
    const int j = e / NK, n = e % NK;
    Bs[e] = n < N ? ld(B + (tok0 + j) * sB + (long long)g * N + n) : 0.f;
    Cs[e] = n < N ? ld(C + (tok0 + j) * sC + (long long)g * N + n) : 0.f;
  }
  if (active) {
    for (int e = lane; e < Q * PK; e += 32) {
      const int j = e / PK, p = e % PK;
      xs[e] = p < P ? ld(x + (tok0 + j) * sx + h * P + p) : 0.f;
    }
    // cum: an inclusive scan over the lanes (lane = token); w and chunk_decay
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, cv, o);
      if (lane >= o) cv += v;
    }
    const float clast = __shfl_sync(0xffffffffu, cv, Q - 1);
    if (lane < Q) {
      cumw[lane] = cv;
      ww[lane] = expf(clast - cv);
    }
    if (lane == 0) decay[(long long)c * H + h] = expf(clast);
  }
  __syncthreads();
  // S = C B^T, the tiles at or below the diagonal (M is 0 above it)
  for (int tile = warp; tile < QT * 2 * QT; tile += kWarps) {
    const int m0 = tile / (2 * QT) * 16, n0 = tile % (2 * QT) * 8;
    if (n0 > m0 + 15) continue;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < NK; k0 += 16) {
      hopper::frag_a(a, [&](int i, int n) { return Cs[i * NK + n]; }, m0, k0);
      hopper::frag_b(b, [&](int n, int j) { return Bs[j * NK + n]; }, k0, n0);
      hopper::mma_split<kF32, kF32>(d, a, b);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) S[hopper::acc_row(m0, e) * Q + hopper::acc_col(n0, e)] = d[e];
  }
  __syncthreads();
  if (!active) return;  // past the block's last barrier

  // M = S * L: L selected to 0 above the diagonal, then exponentiated
  for (int e = lane; e < Q * Q; e += 32) {
    const int i = e / Q, j = e % Q;
    Ms[e] = j <= i ? S[e] * expf(cumw[i] - cumw[j]) : 0.f;
  }
  __syncwarp();

  // y_diag = M x: each k16 step of M split once, for every column tile of x
  float acc[kMaxQT][kMaxPT][4];
#pragma unroll
  for (int mt = 0; mt < kMaxQT; ++mt)
#pragma unroll
    for (int pt = 0; pt < kMaxPT; ++pt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][pt][e] = 0.f;
#pragma unroll
  for (int mt = 0; mt < kMaxQT; ++mt) {
    if (mt >= QT) continue;
#pragma unroll
    for (int kt = 0; kt <= mt; ++kt) {  // M is 0 right of the diagonal tile
      hopper::frag_a(a, [&](int i, int j) { return Ms[i * Q + j]; }, mt * 16, kt * 16);
      hopper::split_a(a, ah, al);
#pragma unroll
      for (int pt = 0; pt < kMaxPT; ++pt) {
        if (pt * 8 >= P) continue;
        hopper::frag_b(b, [&](int j, int p) { return xs[j * PK + p]; }, kt * 16, pt * 8);
        hopper::split_b(b, bh, bl);
        hopper::mma_pieces<true, kF32>(acc[mt][pt], ah, al, bh, bl);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < kMaxQT; ++mt)
#pragma unroll
    for (int pt = 0; pt < kMaxPT; ++pt) {
      if (mt >= QT || pt * 8 >= P) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = hopper::acc_row(mt * 16, e), p = hopper::acc_col(pt * 8, e);
        if (p < P) y[((tok0 + i) * H + h) * P + p] = acc[mt][pt][e];
      }
    }

  // states = (w x)^T B: rows p, columns n, k over the chunk's tokens
  for (int mt = 0; mt * 16 < P; ++mt) {
    float st[kMaxNT][4];
#pragma unroll
    for (int nt = 0; nt < kMaxNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = 0.f;
    for (int kt = 0; kt < QT; ++kt) {
      hopper::frag_a(a, [&](int p, int j) { return ww[j] * xs[j * PK + p]; }, mt * 16, kt * 16);
      hopper::split_a(a, ah, al);
#pragma unroll
      for (int nt = 0; nt < kMaxNT; ++nt) {
        if (nt * 8 >= N) continue;
        hopper::frag_b(b, [&](int j, int n) { return Bs[j * NK + n]; }, kt * 16, nt * 8);
        hopper::split_b(b, bh, bl);
        hopper::mma_pieces<true, kF32>(st[nt], ah, al, bh, bl);
      }
    }
    float* const sh = states + ((long long)c * H + h) * P * N;
#pragma unroll
    for (int nt = 0; nt < kMaxNT; ++nt) {
      if (nt * 8 >= N) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = hopper::acc_row(mt * 16, e), n = hopper::acc_col(nt * 8, e);
        if (p < P && n < N) sh[(long long)p * N + n] = st[nt][e];
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dA, const void* B, const void* C, void* y,
                   void* states, void* decay, int nc, int Q, int H, int G, int P, int N,
                   long long sx, long long sB, long long sC, cudaStream_t stream) {
  const int smem = Smem(Q, (N + 15) / 16 * 16, (P + 15) / 16 * 16).total * (int)sizeof(float);
  if (smem > 48 * 1024) {  // past the default: ask for it (only at the widest shapes)
    const cudaError_t err =
        cudaFuncSetAttribute(fwd_chunk<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(nc * G, (H / G + kWarps - 1) / kWarps);
  fwd_chunk<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dA), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<float*>(y), static_cast<float*>(states),
      static_cast<float*>(decay), Q, H, G, P, N, sx, sB, sC);
  return cudaGetLastError();
}

template <typename T>
cudaError_t resources(int Q, int P, int N, int* regs, int* smem) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fwd_chunk<T>);
  *regs = attr.numRegs;
  *smem = (int)attr.sharedSizeBytes +
          Smem(Q, (N + 15) / 16 * 16, (P + 15) / 16 * 16).total * (int)sizeof(float);
  return err;
}

}  // namespace op

// The shapes every entry takes: Q a multiple of 16 up to 256, H % G == 0,
// P <= 64, N <= 128, nc * H blocks at most 2^31 - 1.
bool bad_shape(int nc, int Q, int H, int G, int P, int N) {
  return nc < 1 || Q < 16 || Q > tc::kMaxQ || Q % 16 != 0 || G < 1 || H % G != 0 || P < 1 ||
         P > op::kMaxP || N < 1 || N > op::kMaxN || (long long)nc * H > 2147483647LL;
}

}  // namespace

extern "C" {

// The wgmma route, bf16.  x: (nc, Q, H, P) and B, C: (nc, Q, G, N) bf16,
// each token's row packed, tokens `*_tok` elements apart, P in {16, 32,
// 64}, N in {16, 32, 64, 128}, x, B, C 16-byte aligned with token strides
// of a multiple of 8 elements; dA: (nc, Q, H) contiguous f32.  Writes y
// (nc, Q, H, P), states (nc, H, P, N) and decay (nc, H), contiguous f32.
// Returns the launch's cudaError_t; operands it does not take return
// cudaErrorInvalidValue and launch nothing.
int ssd_chunk_launch(const void* x, const void* dA, const void* B, const void* C, void* y,
                     void* states, void* decay, int nc, int Q, int H, int G, int P, int N,
                     long long x_tok, long long b_tok, long long c_tok, void* stream) {
  const bool aligned = ((uintptr_t)x | (uintptr_t)B | (uintptr_t)C) % 16 == 0 &&
                       x_tok % 8 == 0 && b_tok % 8 == 0 && c_tok % 8 == 0;
  if (bad_shape(nc, Q, H, G, P, N) || !tc::takes(P, N) || !aligned)
    return (int)cudaErrorInvalidValue;
  return (int)tc::dispatch(x, dA, B, C, y, states, decay, nc, Q, H, G, P, N, x_tok, b_tok, c_tok,
                           static_cast<cudaStream_t>(stream));
}

// The split route (f32 operands on the tensor cores): as ssd_chunk_launch
// with f32 x, B, C, P in {16, 32, 64}, N in {16, 32, 64, 128}, x, B, C
// 16-byte aligned with token strides of a multiple of 4 elements, and
// `scores` f32 scratch of at least ssd_chunk_split_scratch floats
// (`scores_floats`).  Returns the launch's cudaError_t; operands it does not
// take return cudaErrorInvalidValue and launch nothing.
int ssd_chunk_split_launch(const void* x, const void* dA, const void* B, const void* C, void* y,
                           void* states, void* decay, void* scores, long long scores_floats,
                           int nc, int Q, int H, int G, int P, int N, long long x_tok,
                           long long b_tok, long long c_tok, void* stream) {
  if (bad_shape(nc, Q, H, G, P, N) || !tc::takes(P, N) ||
      ((uintptr_t)x | (uintptr_t)B | (uintptr_t)C | (uintptr_t)scores) % 16 != 0 ||
      x_tok % 4 != 0 || b_tok % 4 != 0 || c_tok % 4 != 0)
    return (int)cudaErrorInvalidValue;
  long long need = 0;
  const cudaError_t err = tc::split_scratch_floats(nc, Q, H, G, &need);
  if (err != cudaSuccess) return (int)err;
  if (scores_floats < need) return (int)cudaErrorInvalidValue;
  return (int)tc::dispatch_split(x, dA, B, C, y, states, decay, scores, nc, Q, H, G, P, N, x_tok,
                                 b_tok, c_tok, static_cast<cudaStream_t>(stream));
}

// Floats of score scratch ssd_chunk_split_launch needs for these shapes
// (into *floats); returns a cudaError_t.
int ssd_chunk_split_scratch(int nc, int Q, int H, int G, long long* floats) {
  if (nc < 1 || Q < 1 || G < 1 || H % G != 0) return (int)cudaErrorInvalidValue;
  return (int)tc::split_scratch_floats(nc, Q, H, G, floats);
}

// The one-pass route: Q 16 or 32 and H / G <= 256, P <= 64, N <= 128, x, B
// and C bf16 (is_bf16) or f32 at any alignment and token stride (each
// token's row packed); dA and the outputs as ssd_chunk_launch.  One launch,
// no scratch; any other shape returns cudaErrorInvalidValue and launches
// nothing.
int ssd_chunk_op_launch(const void* x, const void* dA, const void* B, const void* C, void* y,
                        void* states, void* decay, int nc, int Q, int H, int G, int P, int N,
                        long long x_tok, long long b_tok, long long c_tok, int is_bf16,
                        void* stream) {
  if (bad_shape(nc, Q, H, G, P, N) || Q > op::kMaxQ || H / G > op::kMaxRep ||
      (long long)nc * G > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? op::launch<__nv_bfloat16>(x, dA, B, C, y, states, decay, nc, Q, H, G, P,
                                                   N, x_tok, b_tok, c_tok, st)
                       : op::launch<float>(x, dA, B, C, y, states, decay, nc, Q, H, G, P, N,
                                           x_tok, b_tok, c_tok, st));
}

// A route's registers a thread and shared memory a block (static plus the
// dynamic bytes its launch asks for) at chunk length Q, head dim P and
// state dim N: one_pass 1 the one-pass kernel, else the wgmma route's
// (with f32, is_bf16 0, the split kernel).
int ssd_chunk_resources(int one_pass, int is_bf16, int Q, int P, int N, int* regs,
                        int* smem_bytes) {
  if (one_pass) {
    if (bad_shape(1, Q, 1, 1, P, N) || Q > op::kMaxQ) return (int)cudaErrorInvalidValue;
    return (int)(is_bf16 ? op::resources<__nv_bfloat16>(Q, P, N, regs, smem_bytes)
                         : op::resources<float>(Q, P, N, regs, smem_bytes));
  }
  if (!tc::takes(P, N)) return (int)cudaErrorInvalidValue;
  return (int)tc::dispatch_resources(is_bf16, Q, P, N, regs, smem_bytes);
}

const char* ssd_chunk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
