// Blockwise (flash) causal or full attention with GQA for Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (kernel body `_kernel`, pallas_call in
// `flash_attention`).  What it computes, for q (B, Sq, H, D) and k, v
// (B, Sk, K, D) with H % K == 0, query head h reading KV head h / (H / K):
//
//   s   = (f32(q) * scale) @ f32(k)^T          f32 scores, never stored
//   s   = -1e30 where causal and k_pos > q_pos, or k_pos >= Sk
//   online over KV tiles j:  m' = max(m, rowmax s_j);  p = exp(s_j - m')
//                            l  = exp(m - m') * l + rowsum p
//                            acc = exp(m - m') * acc + round_v(p) @ f32(v_j)
//   o   = acc / max(l, 1e-20), cast to q's type
//
// where round_v rounds p to v's type (bf16 or f32), as the reference casts p
// to v.dtype before its PV product.  Positions start at 0 for both q and k.
// Given a non-null `lse` pointer, each kernel also writes every row's
// log-sum-exp, lse = log sum_j exp(s_j) over the unmasked keys (the natural
// log of the scaled scores; (B, H, Sq) f32), from its running max and sum:
// the backward (flash_attention_bwd.cu) reads it instead of recomputing S.
// Serving passes null; the tensor-core kernel then runs its instantiation
// without that code (kLse false), so serving's kernel is the one it was.
//
// Bound on an H100 SXM: operations.  The two products are 2*B*H*Sq*Sk*D
// multiply-adds (4*B*H*Sq*Sk*D flops), halved when causal; at the serving
// path's prefill shape (B 4, S 4096, H 64, K 8, D 128, bf16) that is
// 1.1e12 flops, 1.1 ms at the 989 TFLOP/s bf16 tensor-core peak, while each
// input read once and the output written once is 0.6 GB, 0.18 ms at
// 3.35 TB/s.
//
// Two kernels; the wrapper picks one before the launch (`flash_attention.route`):
// the packed one for short bf16 sequences (`packed_plan`; "packed", below),
// else one kernel in two instantiations by dtype ("tensor_cores").
//
// bf16, short sequences: `pk::packed_fwd<D, N, kLse>`, the packed route.  At
// a transformer UDF's 8 tokens a (batch, head) fills 8 rows of the 128-row
// tile below, so that kernel ran 256,000 blocks for 8 rows of work each at
// (B 2000, S 8, H 128, K 8, D 128).  Here a unit is one (record, KV head):
// the G = H / K heads of the group at every position, row (s, g) as
// q.reshape(B, Sq, K, G, D) orders them, and a 128-row tile holds U whole
// units (U = 128 / (G Sq), at most 64 keys' worth; a unit longer than 128
// rows spans tiles of P = 128 / G positions).  One rank-5 TMA box (a chunk of
// D, G, 1, P, U) over q as (D, G, K, Sq, B) loads a tile, one rank-4 box
// (D, 1, Sk, U) over K or V the U units' keys; the output goes back by a TMA
// store of the same box from the tile's own rows of shared memory.  All of
// a tile's keys (U Sk <= N of 16, 32 or 64 columns) fit one S tile, so the
// softmax is one pass with no rescaling: S = Q.K^T, masked to the row's own
// unit (block-diagonal) and causally within it, p = exp2(s c - m c), l from
// the f32 p, P.V with p rounded to bf16, out = acc / l.  Products are
// `mma.sync` m16n8k16 (8 warps of 16 rows, operands by `ldmatrix` from the
// swizzled tiles, P from the score registers): the work is tiny (4.7
// GFLOP at the shape above), so the tile shape, not wgmma's 64-row
// granularity, decides.  Bound: bytes.  q read and out written once are
// 1.05 GB at that shape, 0.33 ms at 3.35 TB/s, against 0.005 ms of bf16
// tensor-core work; the design moves those bytes with TMA and keeps three
// blocks an SM (72 registers, 42.5 KB of shared memory), so one block's
// loads run while another computes.  The lse (kLse) is staged in shared
// memory and written as one run of G P floats a unit.
//
// bf16: `flash_attention_wgmma<D, false, kLse>`, on the tensor cores.  A bf16 x
// bf16 product is exact in f32, so wgmma with f32 accumulation gives the
// reference's f32 scores up to the order of summation, provided the scale
// is applied to the f32 accumulator and never to a bf16 operand: q is not
// rounded anywhere.
// The scale and log2(e) are folded into one factor c, and p = exp2(s*c - m)
// with m the running row max of s*c.  l is summed from the f32 p, then p is
// rounded to bf16 for the P.V product, as the reference rounds it.
//   One block of 384 threads per (batch*head, 128-row query tile).  Warp-
// groups 0 and 1 consume, 64 query rows each; warpgroup 2 produces: one of
// its threads issues every TMA load, and `setmaxnreg` moves registers from
// it (24 a thread) to the consumers (240).  The block's q tile is loaded
// once by TMA; K and V tiles of BK rows (128, or 64 at D = 256, where the
// f32 accumulator alone takes 128 registers) stream through a two-stage
// ring in shared memory, one `mbarrier` per stage for "full" (TMA bytes
// arrived) and one for "empty" (both consumers done).  Tiles are swizzled
// 128 B (64 B at D = 32, 32 B at D = 16) and split into chunks of one
// swizzle row across D.  The tensor maps are rank 4 over (D, heads, S, B) on
// the contiguous tensors, so GQA is a coordinate (kvh = h / (H / K)) and
// rows past Sq or Sk arrive as zeros, which the kernel masks by position.
// Per KV tile a consumer runs S = Q.K^T as wgmma m64nBKk16 from shared
// memory (K as stored is the K-major B operand), the online softmax in
// registers (a row's max and sum reduced over the 4 threads that share it),
// then O += P.V as wgmma m64nDk16 with P from registers (the score
// accumulator's layout is the A operand's) and V read MN-major through the
// descriptor's transpose bit.  Only the causal diagonal tile and the ragged
// edge tile are masked.  The output is divided by l, rounded to bf16,
// staged in the warpgroup's own q rows of shared memory and written with
// coalesced 16-byte stores, rows < Sq only.  Blocks are issued longest
// first: the grid's fastest axis is batch*head, its slow axis the q tile
// from the last one down, so the causal triangle's heavy tiles do not trail.
// Still serial within a consumer: softmax waits for its S product and the
// next S product for the P.V product (FA3's ping-pong between the two
// warpgroups and its intra-warpgroup overlap are later work).
//
// f32, every head dim: `flash_attention_wgmma<D, true, kLse>`, the same
// kernel on split-bf16 operands.  Each f32 operand v enters as three bf16
// pieces, hi = bf16(v), mid = bf16(v - hi) and lo = bf16(v - hi - mid),
// with |v - hi - mid - lo| <= 2^-25 |v| (derived in hopper.cuh), and each
// product as six wgmma products of pieces, every bf16 x bf16 term exact in
// f32 (smallest first):
//   S  = Qm.Km^T + Ql.Kh^T + Qh.Kl^T + Qm.Kh^T + Qh.Km^T + Qh.Kh^T
//   O += Pm.Vm   + Pl.Vh   + Ph.Vl   + Pm.Vh   + Ph.Vm   + Ph.Vh
// (wgmma from shared memory for S; P split in registers).  The dropped
// mid.lo, lo.mid and lo.lo terms and the pieces' own residuals are each at
// most 2^-25 of |a||b| a term, so each product errs by a few f32 steps of
// sum|a||b|.  Two pieces (hi, lo: |v - hi - lo| <= 2^-17 |v|, three
// products) are not enough: their error reaches the f32 limits themselves
// (2e-5 absolute and relative, 1e-4 of a row's largest value); the CPU
// emulation in tests/test_torch_flash_attention.py reads 1.4e-5 to 2.2e-5
// with two pieces and about 1.5e-6 with three, and one of the 18 f32 cases
// missed with two on an H100.  A dropped hi.mid or mid.hi term, or inputs
// without their mid and lo pieces, miss the limits by two orders of
// magnitude.  The scale stays folded into exp2 (q is split unscaled), l is
// summed from the f32 p, and p is split, not rounded, for P.V.  Each KV
// tile's P.V goes to a fresh accumulator and is added to O with f32 FMAs
// (O = corr O + tile): the tensor cores' f32 accumulation truncates, and
// with all six products of every tile summed into O that bias grew with
// the key count, to 5.5e-5 of outputs near 3 at 4,096 keys on the dense
// model's own inputs on an H100 (twice the limit; the CPU emulation rounds to nearest
// and cannot show it); per tile it stays a few ulp (9e-6 there, the
// CUDA-core kernel's own difference from the plain version).  For the same
// reason each product's small terms go first.  K and V are split once a
// call by `split_bf16_segments` (split_bf16.cuh) into bf16 pieces in device
// memory (K and V are H / K times smaller than q under GQA, and every q
// tile of a head group reads them again), and loaded by TMA as in bf16: a
// stage holds three pieces of a K tile and three of a V tile.  Each
// consumer warpgroup splits its own 64 f32 q rows once, reading them from
// device memory and writing the pieces where and as TMA would (16-byte
// units, swizzled), then fences them for the async proxy; so q is read once
// and never stored split.  KV tiles are 32 rows at D = 128, 64 at D = 64 and
// 128 below: at D = 128 the q pieces take 96 KB and two stages of 6 x 8 KB
// another 96 KB, 197,672 B of shared memory a block.  O is divided by l and
// stored f32 from the accumulator, 8 bytes a thread.  Bound at the serving
// shape: six products of each of the two, 6 x 1.1e12 flops at the 989
// TFLOP/s bf16 peak, 6.67 ms, and the pre-pass (read K and V, write three
// pieces of each: 0.34 GB, 0.10 ms); the f32 CUDA-core peak gives the
// function 16.41 ms.
//   At D = 256 the q pieces of one 64-row warpgroup take 96 KB, so the block
// has one consumer warpgroup (64 query rows) and the producer, 256 threads
// with no register transfer, and KV tiles of 32 rows in two rings of one
// stage each, K's three 16 KB pieces and V's (96 KB; 197,672 B of shared
// memory in all): the producer loads tile j + 1's K once S of tile j has
// read K, and its V once P.V of tile j has read V, so each load runs while
// the consumer works on the other operand.  O at m64n256 holds 128 f32
// registers a thread, so a tile's P.V runs in two column halves of 128,
// each into a fresh 64-register accumulator added to its half of O.  Bound
// at paligemma's prefill (B 4, S 4096, H 8, K 1, causal): six products of
// 2.75e11 flops at the bf16 peak, 1.67 ms, plus the pre-pass, 0.02 ms.
// What that bound leaves out: the S product reads its A operand (q's
// pieces, 2 KB a k16 step) from shared memory again for every 32 keys.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "split_bf16.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the reference's masked score

// ------------------------------------------ bf16 and split f32: tensor cores
namespace tc {

constexpr int kRowsPerWG = 64;  // query rows per consumer warpgroup
constexpr int kStages = 2;      // K/V ring depth
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// The split route's six products of pieces, smallest first (hopper.cuh).
using hopper::term_a;
using hopper::term_b;

// kSplit: f32 operands as bf16 hi, mid and lo pieces (q split by the
// consumers, K and V by `split_bf16_segments` beforehand); otherwise bf16.
// Split at D = 256: one consumer warpgroup (its q pieces alone take 96 KB),
// 32-row KV tiles in separate K and V rings of one stage each (kSepKV: the
// next tile's K loads while this tile's V is in use, and its V while the
// next S product runs), and P.V in two column halves of 128.
template <int D, bool kSplit>
struct Cfg {
  static constexpr bool kWide = kSplit && D == 256;
  static constexpr int kCons = kWide ? 1 : 2;                 // consumer warpgroups
  static constexpr int kBQ = kCons * kRowsPerWG;              // query rows per block
  static constexpr int kThreads = 128 * (kCons + 1);         // the last warpgroup produces
  static constexpr bool kSepKV = kWide;                       // K and V rings apart
  static constexpr int kStg = kWide ? 1 : kStages;            // stages a ring
  static constexpr int BK = kSplit ? (D >= 128 ? 32 : D >= 64 ? 64 : 128)  // KV rows a tile
                                   : (D >= 256 ? 64 : 128);
  static constexpr int NH = kWide ? 2 : 1;          // P.V's column halves (fresh accumulators)
  static constexpr int SW = D >= 64 ? 128 : 2 * D;  // swizzle span: bytes of one chunk row
  static constexpr int CW = SW / 2;                // bf16 columns per chunk
  static constexpr int NC = D / CW;                // chunks across D
  static constexpr uint32_t kMode = SW == 128 ? 1 : SW == 64 ? 2 : 3;  // descriptor swizzle
  static constexpr int kParts = kSplit ? 3 : 1;    // pieces of each operand: hi (, mid, lo)
  static constexpr int kWGQBytes = kRowsPerWG * D * 2;  // one piece of a warpgroup's q rows
  static constexpr int kQBytes = kCons * kParts * kWGQBytes;
  static constexpr int kTileBytes = BK * D * 2;  // one piece of one K or V tile
  static constexpr int kBarBytes = 8 * (1 + 2 * kStg + (kSepKV ? 2 : 0));
  // 1 KB of slack to align the swizzled tiles to 1 KB
  static constexpr size_t kSmem = 1024 + kQBytes + 2 * kParts * kStg * kTileBytes + kBarBytes;
};

using hopper::pack_bf16;

// The tensor maps of a launch: q (bf16 only) and each piece of K and V.
struct Maps {
  CUtensorMap q, k[3], v[3];
};

// kSplit: maps.q is unused and q is the f32 queries; maps.k and maps.v hold
// the bf16 hi, mid and lo pieces of K and V; o is f32.  Otherwise q is
// unused, maps.k[0] and maps.v[0] are K and V, and o is bf16.  kLse: also
// write each row's log-sum-exp to lse (otherwise lse is unused, and the
// kernel is the one serving launches, compiled without that code).
template <int D, bool kSplit, bool kLse>
__global__ void __launch_bounds__(Cfg<D, kSplit>::kThreads, 1) flash_attention_wgmma(
    const __grid_constant__ Maps maps, const float* __restrict__ q, void* __restrict__ o,
    float* __restrict__ lse, int Sq, int Sk, int H, int K, int causal, float c) {
  using C = Cfg<D, kSplit>;
  constexpr int BK = C::BK, SW = C::SW, CW = C::CW, NC = C::NC;
  constexpr int kStg = C::kStg;
  constexpr uint32_t kPiece = kStg * C::kTileBytes;  // a piece's ring; the next follows
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t q_s = base;                     // [2 WG][piece][NC][64][CW]
  const uint32_t k_s = q_s + C::kQBytes;          // [piece][stage][NC][BK][CW]
  const uint32_t v_s = k_s + C::kParts * kPiece;  // [piece][stage][NC][BK][CW]
  const uint32_t bars = v_s + C::kParts * kPiece; // q, full[stages], empty[stages] (, V's)
  const uint32_t q_bar = bars;
  // kSepKV: full and empty are K's ring, vfull and vempty V's
  auto full_bar = [&](int s) { return bars + 8u * (1 + s); };
  auto empty_bar = [&](int s) { return bars + 8u * (1 + kStg + s); };
  const uint32_t vfull_bar = bars + 8u * (1 + 2 * kStg), vempty_bar = vfull_bar + 8u;

  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const int kvh = h / (H / K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kBQ;  // longest causal rows first
  int n_kv = (Sk + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (q0 + C::kBQ - 1) / BK + 1);  // tiles at or before the last row
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_bar, 1);
    for (int s = 0; s < kStg; ++s) {
      hopper::mbar_init(full_bar(s), 1);
      hopper::mbar_init(empty_bar(s), C::kCons * 128);  // every consumer thread arrives
    }
    if constexpr (C::kSepKV) {
      hopper::mbar_init(vfull_bar, 1);
      hopper::mbar_init(vempty_bar, C::kCons * 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == C::kCons) {  // ------------------------------------ producer
    // (with one consumer the block has 256 threads and needs no transfer)
    if constexpr (C::kCons == 2) hopper::setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      if constexpr (!kSplit) {  // split: the consumers build their q pieces
        const int halves = Sq - q0 > kRowsPerWG ? 2 : 1;  // no box wholly past Sq
        hopper::mbar_expect_tx(q_bar, halves * C::kWGQBytes);
        for (int w = 0; w < halves; ++w)
          for (int cc = 0; cc < NC; ++cc)
            hopper::tma_load_4d(q_s + w * C::kWGQBytes + cc * kRowsPerWG * SW, &maps.q, q_bar,
                                cc * CW, h, q0 + w * kRowsPerWG, b);
      }
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kStg;
        hopper::mbar_wait(empty_bar(s), ((j / kStg) & 1) ^ 1);
        if constexpr (C::kSepKV) {  // K of tile j once S of tile j - 1 is done, then its V
          hopper::mbar_expect_tx(full_bar(s), C::kParts * C::kTileBytes);
          for (int cc = 0; cc < NC; ++cc)
#pragma unroll
            for (int piece = 0; piece < C::kParts; ++piece)
              hopper::tma_load_4d(k_s + piece * kPiece + s * C::kTileBytes + cc * BK * SW,
                                  &maps.k[piece], full_bar(s), cc * CW, kvh, j * BK, b);
          hopper::mbar_wait(vempty_bar, (j & 1) ^ 1);
          hopper::mbar_expect_tx(vfull_bar, C::kParts * C::kTileBytes);
          for (int cc = 0; cc < NC; ++cc)
#pragma unroll
            for (int piece = 0; piece < C::kParts; ++piece)
              hopper::tma_load_4d(v_s + piece * kPiece + cc * BK * SW, &maps.v[piece], vfull_bar,
                                  cc * CW, kvh, j * BK, b);
          continue;
        }
        hopper::mbar_expect_tx(full_bar(s), 2 * C::kParts * C::kTileBytes);
        for (int cc = 0; cc < NC; ++cc) {
          const uint32_t off = s * C::kTileBytes + cc * BK * SW;
#pragma unroll
          for (int piece = 0; piece < C::kParts; ++piece) {
            const uint32_t po = piece * kPiece + off;
            hopper::tma_load_4d(k_s + po, &maps.k[piece], full_bar(s), cc * CW, kvh, j * BK, b);
            hopper::tma_load_4d(v_s + po, &maps.v[piece], full_bar(s), cc * CW, kvh, j * BK, b);
          }
        }
      }
    }
  } else {  // ----------------------------------------------- consumers
    if constexpr (C::kCons == 2) hopper::setmaxnreg_inc<kConsumerRegs>();
    const int warp = tid / 32, lane = tid % 32;
    const int qw0 = q0 + wg * kRowsPerWG;          // this warpgroup's first row
    const int r0 = qw0 + 16 * warp + lane / 4;     // this thread's rows: r0 and r0 + 8
    int n_w = qw0 < Sq ? n_kv : 0;                 // tiles this warpgroup computes
    if (causal) n_w = min(n_w, (qw0 + kRowsPerWG - 1) / BK + 1);
    const uint32_t qw = q_s + wg * C::kParts * C::kWGQBytes;  // piece i at + i kWGQBytes

    float acc[D / 2], s[BK / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this thread's part

    if constexpr (kSplit) {
      // This warpgroup's 64 f32 query rows (zeros past Sq) as bf16 hi, mid
      // and lo, written where and as TMA would write them: 16-byte units of
      // 8 columns, swizzled within 1 KB.
      const float* qb = q + (size_t)b * Sq * H * D + (size_t)h * D;
      uint8_t* const qg = gbase + (qw - base);
      constexpr int kUnits = kRowsPerWG * D / 8, kBatch = kUnits < 512 ? kUnits / 128 : 4;
#pragma unroll 1
      for (int u0 = tid; u0 < kUnits; u0 += kBatch * 128) {
        float4 v[kBatch][2];  // a batch's loads all issued before any is used
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int u = u0 + i * 128, row = u / (D / 8), col = (u - row * (D / 8)) * 8;
          v[i][0] = v[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (qw0 + row < Sq) {
            const float4* src =
                reinterpret_cast<const float4*>(qb + (size_t)(qw0 + row) * H * D + col);
            v[i][0] = src[0];
            v[i][1] = src[1];
          }
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int u = u0 + i * 128, row = u / (D / 8), col = (u - row * (D / 8)) * 8;
          uint4 hi, mid, lo;
          hopper::split3_bf16(v[i][0].x, v[i][0].y, hi.x, mid.x, lo.x);
          hopper::split3_bf16(v[i][0].z, v[i][0].w, hi.y, mid.y, lo.y);
          hopper::split3_bf16(v[i][1].x, v[i][1].y, hi.z, mid.z, lo.z);
          hopper::split3_bf16(v[i][1].z, v[i][1].w, hi.w, mid.w, lo.w);
          const uint32_t off = (col / CW) * kRowsPerWG * SW +
                               hopper::swz(row * SW + (col % CW) * 2, SW);
          *reinterpret_cast<uint4*>(qg + off) = hi;
          *reinterpret_cast<uint4*>(qg + C::kWGQBytes + off) = mid;
          *reinterpret_cast<uint4*>(qg + 2 * C::kWGQBytes + off) = lo;
        }
      }
      hopper::fence_proxy_async();
      hopper::named_sync<128>(1 + wg);
    } else {
      hopper::mbar_wait(q_bar, 0);
    }
    for (int j = 0; j < n_kv; ++j) {
      const int st = j % kStg;
      hopper::mbar_wait(full_bar(st), (j / kStg) & 1);
      if (j < n_w) {
        const int k0 = j * BK;
        const uint32_t kt = k_s + st * C::kTileBytes, vt = v_s + st * C::kTileBytes;
        // S = Q.K^T, both K-major; a k16 step is 32 bytes along a chunk row.
        // Split: the six products of pieces term_a(t) and term_b(t); bf16: the
        // one product hi.hi (t = 5).
        constexpr int t0 = kSplit ? 0 : 5;
        hopper::wgmma_fence();
#pragma unroll
        for (int t = t0; t < 6; ++t) {
          const uint32_t qp = qw + term_a(t) * C::kWGQBytes;
          const uint32_t kp = kt + term_b(t) * kPiece;
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t col = (kk * 16 % CW) * 2;
            const uint32_t chunk = kk * 16 / CW;
            hopper::wgmma_ss(s,
                             hopper::make_desc(qp + chunk * kRowsPerWG * SW + col, 16, 8 * SW,
                                               C::kMode),
                             hopper::make_desc(kp + chunk * BK * SW + col, 16, 8 * SW, C::kMode),
                             t > t0 || kk > 0);
          }
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        if constexpr (C::kSepKV) hopper::mbar_arrive(empty_bar(st));  // K's tile is read

        if (k0 + BK > Sk || (causal && k0 + BK - 1 > qw0)) {  // diagonal or ragged tile
          const int kc = k0 + 2 * (lane % 4);
#pragma unroll
          for (int i = 0; i < BK / 8; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kpos = kc + 8 * i + (e & 1);
              const int qpos = r0 + 8 * (e >> 1);
              if (kpos >= Sk || (causal && kpos > qpos)) s[4 * i + e] = kNegInf;
            }
        }
        float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
          mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float mn0 = fmaxf(m0, mx0 * c), mn1 = fmaxf(m1, mx1 * c);
        const float corr0 = exp2f(m0 - mn0), corr1 = exp2f(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
          s[4 * i] = exp2f(fmaf(s[4 * i], c, -mn0));
          s[4 * i + 1] = exp2f(fmaf(s[4 * i + 1], c, -mn0));
          s[4 * i + 2] = exp2f(fmaf(s[4 * i + 2], c, -mn1));
          s[4 * i + 3] = exp2f(fmaf(s[4 * i + 3], c, -mn1));
          sum0 += s[4 * i] + s[4 * i + 1];
          sum1 += s[4 * i + 2] + s[4 * i + 3];
        }
        l0 = corr0 * l0 + sum0;  // from the f32 p, as the reference sums it
        l1 = corr1 * l1 + sum1;
        if constexpr (kSplit) {
          // p split into bf16 hi, mid and lo: the k16 slice kk of the scores
          // is A fragment kk.  The tile's P.V, the six products of pieces
          // smallest first, goes to a fresh accumulator, added to acc in
          // f32 FMAs (acc = corr acc + tile): the tensor cores' f32
          // accumulation truncates each sum, and summed into acc over every
          // KV tile that bias grows with the key count (2e-5 of |o| at 4,096
          // keys); within one tile it stays a few ulp.
          uint32_t pp[3][BK / 16][4];
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              hopper::split3_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1], pp[0][kk][e],
                                  pp[1][kk][e], pp[2][kk][e]);
          if constexpr (C::kSepKV) hopper::mbar_wait(vfull_bar, j & 1);
          // At D = 256 in two column halves, each with its own fresh accumulator
          // (two of D / 2 columns would not fit beside O's 128 registers).
          constexpr int DH = D / C::NH;
#pragma unroll
          for (int half = 0; half < C::NH; ++half) {
            float tile[DH / 2];
            const uint32_t vh = vt + half * (DH / CW) * BK * SW;  // the half's first chunk
            hopper::wgmma_fence();
#pragma unroll
            for (int t = 0; t < 6; ++t)
#pragma unroll
              for (int kk = 0; kk < BK / 16; ++kk)
                hopper::wgmma_rs(tile, pp[term_a(t)][kk],
                                 hopper::make_desc(vh + term_b(t) * kPiece + kk * 16 * SW,
                                                   BK * SW, 8 * SW, C::kMode),
                                 t > 0 || kk > 0);
            hopper::wgmma_commit();
            hopper::wgmma_wait<0>();
            hopper::fence_regs(tile);
            float* const ah = acc + half * (DH / 2);
#pragma unroll
            for (int i = 0; i < DH / 8; ++i) {
              ah[4 * i] = fmaf(ah[4 * i], corr0, tile[4 * i]);
              ah[4 * i + 1] = fmaf(ah[4 * i + 1], corr0, tile[4 * i + 1]);
              ah[4 * i + 2] = fmaf(ah[4 * i + 2], corr1, tile[4 * i + 2]);
              ah[4 * i + 3] = fmaf(ah[4 * i + 3], corr1, tile[4 * i + 3]);
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < D / 8; ++i) {
            acc[4 * i] *= corr0;
            acc[4 * i + 1] *= corr0;
            acc[4 * i + 2] *= corr1;
            acc[4 * i + 3] *= corr1;
          }
          // p rounded to bf16: the k16 slice kk of the scores is A fragment kk
          uint32_t p[BK / 16][4];
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
            p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
            p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
            p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
          }
          // O += P.V, V MN-major: a k16 step is 16 key rows
          hopper::fence_regs(acc);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            hopper::wgmma_rs(acc, p[kk],
                             hopper::make_desc(vt + kk * 16 * SW, BK * SW, 8 * SW, C::kMode), 1);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(acc);
        }
        if constexpr (C::kSepKV) hopper::mbar_arrive(vempty_bar);  // V's tile is read
      } else if constexpr (C::kSepKV) {  // a tile this warpgroup skips: release both
        hopper::mbar_arrive(empty_bar(st));
        hopper::mbar_wait(vfull_bar, j & 1);
        hopper::mbar_arrive(vempty_bar);
      }
      if constexpr (!C::kSepKV) hopper::mbar_arrive(empty_bar(st));
    }

    if (n_w > 0) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const float den0 = fmaxf(l0, 1e-20f), den1 = fmaxf(l1, 1e-20f);
      if (kLse && lane % 4 == 0) {  // m is in log2 units of s * scale
        float* const row = lse + ((size_t)b * H + h) * Sq;
        if (r0 < Sq) row[r0] = (m0 + log2f(l0)) * kLn2;
        if (r0 + 8 < Sq) row[r0 + 8] = (m1 + log2f(l1)) * kLn2;
      }
      if constexpr (kSplit) {
        // f32 straight from the accumulator: 8 bytes a thread, a quad
        // covering 32 contiguous bytes of a row, rows < Sq only.
        float* const of = static_cast<float*>(o);
        const int cq = 2 * (lane % 4);
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          if (r0 < Sq)
            *reinterpret_cast<float2*>(of + (((size_t)b * Sq + r0) * H + h) * D + 8 * i + cq) =
                make_float2(acc[4 * i] / den0, acc[4 * i + 1] / den0);
          if (r0 + 8 < Sq)
            *reinterpret_cast<float2*>(of + (((size_t)b * Sq + r0 + 8) * H + h) * D + 8 * i +
                                       cq) = make_float2(acc[4 * i + 2] / den1,
                                                         acc[4 * i + 3] / den1);
        }
        return;
      }
      // Stage the bf16 tile in this warpgroup's q rows, [64][D] with its
      // 16-byte chunks swizzled by row, then store 16 bytes a thread.
      constexpr int NCH = D / 8;
      constexpr int kSwz = NCH >= 8 ? 7 : NCH - 1;
      uint8_t* const ost = gbase + wg * C::kWGQBytes;
      hopper::named_sync<128>(1 + wg);  // every warp's last Q.K^T has read q
      const int lr = 16 * warp + lane / 4;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        *reinterpret_cast<uint32_t*>(ost + lr * D * 2 + ((i ^ (lr & kSwz)) * 16) +
                                     4 * (lane % 4)) =
            pack_bf16(acc[4 * i] / den0, acc[4 * i + 1] / den0);
        *reinterpret_cast<uint32_t*>(ost + (lr + 8) * D * 2 + ((i ^ ((lr + 8) & kSwz)) * 16) +
                                     4 * (lane % 4)) =
            pack_bf16(acc[4 * i + 2] / den1, acc[4 * i + 3] / den1);
      }
      hopper::named_sync<128>(1 + wg);
      for (int idx = tid; idx < kRowsPerWG * NCH; idx += 128) {
        const int row = idx / NCH, ch = idx - row * NCH;
        const int qpos = qw0 + row;
        if (qpos >= Sq) break;  // rows only grow with idx
        const uint4 val =
            *reinterpret_cast<const uint4*>(ost + row * D * 2 + ((ch ^ (row & kSwz)) * 16));
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(o) +
                                  (((size_t)b * Sq + qpos) * H + h) * D + ch * 8) = val;
      }
    }
  }
}

CUresult encode_map(CUtensorMap* map, const void* ptr, int D, int heads, int S, int B,
                    int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D, bool kSplit, bool kLse>
cudaError_t run(const Maps& maps, const void* q, void* o, float* lse, int B, int Sq, int Sk, int H,
                int K, int causal, float scale, cudaStream_t stream) {
  using C = Cfg<D, kSplit>;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_wgmma<D, kSplit, kLse>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + C::kBQ - 1) / C::kBQ);
  flash_attention_wgmma<D, kSplit, kLse><<<grid, C::kThreads, C::kSmem, stream>>>(
      maps, kSplit ? static_cast<const float*>(q) : nullptr, o, lse, Sq, Sk, H, K, causal,
      scale * kLog2e);
  return cudaGetLastError();
}

// kSplit: q is f32 and k[0..2], v[0..2] the bf16 hi, mid and lo pieces of K
// and V; otherwise q, k[0] and v[0] are bf16.  lse: null, or where the rows'
// log-sum-exp go (the kLse kernel).
template <int D, bool kSplit>
cudaError_t launch(const void* q, const void* const* k, const void* const* v, void* o,
                   float* lse, int B, int Sq, int Sk, int H, int K, int causal, float scale,
                   cudaStream_t stream) {
  using C = Cfg<D, kSplit>;
  const CUtensorMapSwizzle sw = C::SW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : C::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B;
  Maps maps{};  // the maps a route does not read stay zero
  if (!kSplit && encode_map(&maps.q, q, D, H, Sq, B, kRowsPerWG, C::CW, sw) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  for (int piece = 0; piece < C::kParts; ++piece)
    if (encode_map(&maps.k[piece], k[piece], D, K, Sk, B, C::BK, C::CW, sw) != CUDA_SUCCESS ||
        encode_map(&maps.v[piece], v[piece], D, K, Sk, B, C::BK, C::CW, sw) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  return lse != nullptr
             ? run<D, kSplit, true>(maps, q, o, lse, B, Sq, Sk, H, K, causal, scale, stream)
             : run<D, kSplit, false>(maps, q, o, lse, B, Sq, Sk, H, K, causal, scale, stream);
}

template <int D, bool kSplit>
cudaError_t resources(int* regs, int* smem) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, flash_attention_wgmma<D, kSplit, false>);
  *regs = attr.numRegs;
  *smem = (int)(attr.sharedSizeBytes + Cfg<D, kSplit>::kSmem);
  return err;
}

}  // namespace tc

// ------------------------------------------- bf16, short sequences: packed
namespace pk {

using packed::at;
using packed::Geo;
using packed::kRows;
using packed::kThreads;
using hopper::pack_bf16;
using tc::kLn2;
using tc::kLog2e;

// N: key columns a tile (U * Sk rounded up to 16, 32 or 64).
template <int D, int N>
struct FwdCfg {
  static constexpr int kQBytes = kRows * D * 2;                     // q, then the output
  static constexpr int kKVBytes = (N * D * 2 + 1023) / 1024 * 1024;  // K; V
  static constexpr size_t kSmem = 1024 + kQBytes + 2 * kKVBytes + 16 + kRows * 4;  // bar, lse
};

struct FwdMaps {
  CUtensorMap q, o, k, v;
};

// One block a tile: U records' units of one KV head (or P positions of one
// unit).  Rows past the box and keys past U * Sk are never stored; the
// keys' padding rows are zeroed, since P.V reads them (times p = 0).
template <int D, int N, bool kLse>
__global__ void __launch_bounds__(kThreads, 2) packed_fwd(
    const __grid_constant__ FwdMaps maps, float* __restrict__ lse, const Geo g, int causal,
    float c) {
  using C = FwdCfg<D, N>;
  constexpr int SW = packed::Sw<D>::SW, CW = packed::Sw<D>::CW, NC = packed::Sw<D>::NC;
  constexpr int DC = D < 64 ? D : 64;  // output columns a pass (a fresh accumulator)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t q_s = base, k_s = q_s + C::kQBytes, v_s = k_s + C::kKVBytes;
  const uint32_t bar = v_s + C::kKVBytes;
  float* const lse_s = reinterpret_cast<float*>(gbase + (bar + 16 - base));  // a row's lse

  const int t = blockIdx.x % g.T, rest = blockIdx.x / g.T;
  const int kv = rest % g.K, b0 = (rest / g.K) * g.U, p0 = t * g.P;
  const int unit_rows = g.G * g.P, box_rows = unit_rows * g.U, keys = g.U * g.Sk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < (N - keys) * (D / 8); i += kThreads) {
    const int row = keys + i / (D / 8), col = (i % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(gbase + (at<D>(k_s, N, row, col) - base)) = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(gbase + (at<D>(v_s, N, row, col) - base)) = make_uint4(0, 0, 0, 0);
  }
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hopper::mbar_expect_tx(bar, (box_rows + 2 * keys) * D * 2);
    for (int cc = 0; cc < NC; ++cc) {
      hopper::tma_load_5d(q_s + cc * kRows * SW, &maps.q, bar, cc * CW, 0, kv, p0, b0);
      hopper::tma_load_4d(k_s + cc * N * SW, &maps.k, bar, cc * CW, kv, 0, b0);
      hopper::tma_load_4d(v_s + cc * N * SW, &maps.v, bar, cc * CW, kv, 0, b0);
    }
  }
  hopper::mbar_wait(bar, 0);

  const int r0 = 16 * warp;
  if (r0 < box_rows) {
    // S = Q.K^T: A (16 q rows) and B (16 keys a load) by ldmatrix
    float s[N / 8][4];
#pragma unroll
    for (int j = 0; j < N / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      hopper::ldsm_x4(a, at<D>(q_s, kRows, r0 + lane % 8 + 8 * (lane / 8 % 2),
                               kk * 16 + 8 * (lane / 16)));
#pragma unroll
      for (int nb = 0; nb < N / 16; ++nb) {
        uint32_t b[4];
        hopper::ldsm_x4(b, at<D>(k_s, N, nb * 16 + lane % 8 + 8 * (lane / 16),
                                 kk * 16 + 8 * (lane / 8 % 2)));
        hopper::mma_bf16(s[2 * nb], a, b[0], b[1]);
        hopper::mma_bf16(s[2 * nb + 1], a, b[2], b[3]);
      }
    }
    // Each of this thread's rows (r, r + 8) attends key columns [lo, hi):
    // its own unit's keys, up to its position when causal; none past the box.
    int lo[2], hi[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = r0 + lane / 4 + 8 * hr;
      const int u = r / unit_rows, pos = p0 + (r - u * unit_rows) / g.G;
      lo[hr] = u * g.Sk;
      hi[hr] = r >= box_rows ? lo[hr] : lo[hr] + (causal ? min(g.Sk, pos + 1) : g.Sk);
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * (lane % 4) + (e & 1), hr = e >> 1;
        if (col < lo[hr] || col >= hi[hr]) s[j][e] = kNegInf;
        mx[hr] = fmaxf(mx[hr], s[j][e]);
      }
    float mc[2], l[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      mc[hr] = mx[hr] * c;
    }
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(fmaf(s[j][e], c, -mc[e >> 1]));
        l[e >> 1] += s[j][e];  // from the f32 p, as the reference sums it
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    }
    // p rounded to bf16: score tiles 2kk and 2kk + 1 are A fragment kk
    uint32_t pa[N / 16][4];
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    const float den0 = fmaxf(l[0], 1e-20f), den1 = fmaxf(l[1], 1e-20f);
    __syncwarp();
    // O = P.V, DC columns a pass, V read transposed; each pass's rows go to
    // this warp's own q rows (no other warp reads them)
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += DC) {
      float o[DC / 8][4];
#pragma unroll
      for (int j = 0; j < DC / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
        for (int nd = 0; nd < DC / 16; ++nd) {
          uint32_t b[4];
          hopper::ldsm_x4_trans(b, at<D>(v_s, N, kk * 16 + lane % 8 + 8 * (lane / 8 % 2),
                                         d0 + nd * 16 + 8 * (lane / 16)));
          hopper::mma_bf16(o[2 * nd], pa[kk], b[0], b[1]);
          hopper::mma_bf16(o[2 * nd + 1], pa[kk], b[2], b[3]);
        }
      const int row = r0 + lane / 4;
#pragma unroll
      for (int j = 0; j < DC / 8; ++j) {
        const int col = d0 + 8 * j + 2 * (lane % 4);
        *reinterpret_cast<uint32_t*>(gbase + (at<D>(q_s, kRows, row, col) - base)) =
            pack_bf16(o[j][0] / den0, o[j][1] / den0);
        *reinterpret_cast<uint32_t*>(gbase + (at<D>(q_s, kRows, row + 8, col) - base)) =
            pack_bf16(o[j][2] / den1, o[j][3] / den1);
      }
    }
    if (kLse && lane % 4 == 0) {  // m is in log2 units of s * scale
      lse_s[r0 + lane / 4] = (mc[0] + log2f(l[0])) * kLn2;
      lse_s[r0 + lane / 4 + 8] = (mc[1] + log2f(l[1])) * kLn2;
    }
  }
  hopper::fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int cc = 0; cc < NC; ++cc)
      hopper::tma_store_5d(&maps.o, q_s + cc * kRows * SW, cc * CW, 0, kv, p0, b0);
    hopper::bulk_commit();
  }
  // The tile's lse in the module's (B, H, Sq) order: (g, s) of a unit, s
  // fastest, is one run of G * P floats (all of a unit's when P = Sq), so
  // consecutive threads write consecutive floats.
  if (kLse && threadIdx.x < box_rows) {
    const int u = threadIdx.x / unit_rows, j = threadIdx.x - u * unit_rows;
    const int gi = j / g.P, sl = j - gi * g.P, b = b0 + u, pos = p0 + sl;
    if (b < g.B && pos < g.Sq)
      lse[((size_t)b * g.H + kv * g.G + gi) * g.Sq + pos] = lse_s[u * unit_rows + sl * g.G + gi];
  }
  if (threadIdx.x == 0) hopper::bulk_wait_read<0>();
}

template <int D, int N, bool kLse>
cudaError_t run(const FwdMaps& maps, float* lse, const Geo& g, int causal, float scale,
                cudaStream_t stream) {
  using C = FwdCfg<D, N>;
  cudaError_t err = cudaFuncSetAttribute(packed_fwd<D, N, kLse>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::kSmem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((g.B + g.U - 1) / g.U) * g.K * g.T;
  packed_fwd<D, N, kLse><<<(unsigned)blocks, kThreads, C::kSmem, stream>>>(maps, lse, g, causal,
                                                                          scale * kLog2e);
  return cudaGetLastError();
}

template <int D, int N>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   const Geo& g, int causal, float scale, cudaStream_t stream) {
  FwdMaps maps{};
  if (packed::q_map(&maps.q, q, g, D) != CUDA_SUCCESS ||
      packed::q_map(&maps.o, o, g, D) != CUDA_SUCCESS ||
      packed::kv_map(&maps.k, k, g, D) != CUDA_SUCCESS ||
      packed::kv_map(&maps.v, v, g, D) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return lse != nullptr ? run<D, N, true>(maps, lse, g, causal, scale, stream)
                        : run<D, N, false>(maps, lse, g, causal, scale, stream);
}

template <int D, int N>
cudaError_t resources(int with_lse, cudaFuncAttributes* a, size_t* dyn) {
  *dyn = FwdCfg<D, N>::kSmem;
  return with_lse ? cudaFuncGetAttributes(a, packed_fwd<D, N, true>)
                  : cudaFuncGetAttributes(a, packed_fwd<D, N, false>);
}

}  // namespace pk

cudaError_t dispatch_packed(int D, int N, const void* q, const void* k, const void* v, void* o,
                            float* lse, const packed::Geo& g, int causal, float scale,
                            cudaStream_t st) {
  PACKED_DISPATCH(pk::launch, q, k, v, o, lse, g, causal, scale, st)
}

cudaError_t dispatch_packed_resources(int D, int N, int with_lse, cudaFuncAttributes* a,
                                      size_t* dyn) {
  PACKED_DISPATCH(pk::resources, with_lse, a, dyn)
}

// Every head dim on both routes (kSplit true: f32 as bf16 pieces).
#define FLASH_DISPATCH(FN, SPLIT, ...)                       \
  switch (D) {                                               \
    case 16: return FN<16, SPLIT>(__VA_ARGS__);              \
    case 32: return FN<32, SPLIT>(__VA_ARGS__);              \
    case 64: return FN<64, SPLIT>(__VA_ARGS__);              \
    case 128: return FN<128, SPLIT>(__VA_ARGS__);            \
    case 256: return FN<256, SPLIT>(__VA_ARGS__);            \
    default: return cudaErrorInvalidValue;                   \
  }

// kernel: 1 the bf16 kernel, 2 the split (f32) kernel.
cudaError_t dispatch_resources(int D, int kernel, int* regs, int* smem) {
  if (kernel == 2) FLASH_DISPATCH(tc::resources, true, regs, smem)
  if (kernel == 1) FLASH_DISPATCH(tc::resources, false, regs, smem)
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// bf16: q, o (B, Sq, H, D); k, v (B, Sk, K, D); all contiguous and
// 16-byte aligned (TMA).  lse: null, or (B, H, Sq) f32 for each row's
// log-sum-exp (natural log, of the scaled scores s = scale * q.k over the
// unmasked keys), which the backward reads.  Returns the launch's
// cudaError_t.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                           int B, int Sq, int Sk, int H, int K, int D, int causal, float scale,
                           void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || K < 1 || H % K != 0 || (long long)B * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const void* const kp[1] = {k};
  const void* const vp[1] = {v};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  FLASH_DISPATCH(tc::launch, false, q, kp, vp, o, l, B, Sq, Sk, H, K, causal, scale, st)
}

// The split route: q, o (B, Sq, H, D) f32; k_pieces and v_pieces, 3
// pointers each, to the bf16 hi, mid and lo pieces (B, Sk, K, D) of K and V
// (split_bf16_launch); D in {16, 32, 64, 128, 256}; all contiguous and
// 16-byte aligned; lse as flash_attention_launch takes it.  Returns the
// launch's cudaError_t; any other D returns cudaErrorInvalidValue and
// launches nothing.
int flash_attention_split_launch(const void* q, const void* const* k_pieces,
                                 const void* const* v_pieces, void* o, void* lse, int B, int Sq,
                                 int Sk, int H, int K, int D, int causal, float scale,
                                 void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || K < 1 || H % K != 0 || (long long)B * H > 2147483647LL ||
      ((uintptr_t)q | (uintptr_t)o) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  FLASH_DISPATCH(tc::launch, true, q, k_pieces, v_pieces, o, l, B, Sq, Sk, H, K, causal, scale,
                 st)
}

// src (n f32) -> hi, mid, lo (n bf16 each): hi = bf16(src), mid = bf16(src -
// hi), lo = bf16(src - hi - mid), each rounded to nearest even; all 16-byte
// aligned.
int split_bf16_launch(const void* src, void* hi, void* mid, void* lo, long long n,
                      void* stream) {
  if (n < 1 || ((uintptr_t)src | (uintptr_t)hi | (uintptr_t)mid | (uintptr_t)lo) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return (int)split::launch(src, hi, mid, lo, n, static_cast<cudaStream_t>(stream));
}

// A kernel's registers a thread at launch and shared memory a block
// (static plus the dynamic bytes the launch asks for); `kernel` as in
// dispatch_resources.
int flash_attention_resources(int D, int kernel, int* regs, int* smem_bytes) {
  return (int)dispatch_resources(D, kernel, regs, smem_bytes);
}

// The packed route: bf16 q, o (B, Sq, H, D) and k, v (B, Sk, K, D), all
// contiguous and 16-byte aligned (TMA); lse as flash_attention_launch takes
// it; U records a tile, P positions a tile, T tiles a unit and N key columns
// a tile as the wrapper's packed_plan gives them.  A plan or a head dim the
// kernels do not take returns cudaErrorInvalidValue and launches nothing.
int flash_attention_packed_launch(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int B, int Sq, int Sk, int H, int K, int D, int U,
                                  int P, int T, int N, int causal, float scale, void* stream) {
  if (K < 1 || H % K != 0) return (int)cudaErrorInvalidValue;
  const packed::Geo g{B, Sq, Sk, H, K, H / K, U, P, T};
  if (packed::bad_geo(g, N) ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch_packed(D, N, q, k, v, o, static_cast<float*>(lse), g, causal, scale,
                              static_cast<cudaStream_t>(stream));
}

// The packed kernel's registers a thread, shared memory a block (static plus
// dynamic) and local memory a thread at (D, N), with or without the lse.
int flash_attention_packed_resources(int D, int N, int with_lse, int* regs, int* smem,
                                     int* local) {
  cudaFuncAttributes a;
  size_t dyn = 0;
  const cudaError_t e = dispatch_packed_resources(D, N, with_lse, &a, &dyn);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *smem = (int)(a.sharedSizeBytes + dyn);
  *local = (int)a.localSizeBytes;
  return 0;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
