// The backward of blockwise (flash) causal or full attention with GQA for
// Hopper (sm_90a), plain C interface.
//
// The gradient of the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py:62 (pallas_call at :81).  The JAX
// package has no backward kernel: it differentiates `layers.mha`'s einsum
// route with `jax.grad`.  This is the port's own backward of the forward
// kernel in flash_attention.cu, for the same operands: q (B, Sq, H, D), k and
// v (B, Sk, K, D), H % K == 0, query head h reading KV head h / (H / K),
// causal (positions aligned at 0) or full, bf16 or f32, D in {16, ..., 256}.
// With s = (f32(q) * scale) @ f32(k)^T masked as the forward masks it:
//
//   lse = logsumexp(s)                   (row, f32: the forward's, read here)
//   p   = exp(s - lse)                   (f32)
//   Di  = rowsum(f32(dO) * f32(O))       (row, f32)
//   dP  = f32(dO) @ f32(v)^T
//   dS  = p * (dP - Di)
//   dV  = round_v(p)^T @ f32(dO)         (p rounded to v's type, as the
//                                         forward rounds it before P.V)
//   dK  = dS^T @ (f32(q) * scale)
//   dQ  = scale * dS @ f32(k)
//
// all sums in f32, each gradient rounded once to the operand type at the
// end.  lse is the forward's row log-sum-exp (flash_attention.cu writes it:
// natural log, of the scaled scores, over the unmasked keys), so no pass
// here recomputes it.
//
// Bound on an H100 SXM: operations.  FlashAttention-2 counts the backward
// as 2.5 times the forward's 4*B*H*Sq*Sk*D flops (halved when causal): five
// products of the forward's two.  At (B 1, S 4096, H 64, K 8, D 128) that
// is 6.9e11 flops, 0.69 ms at the 989 TFLOP/s bf16 tensor-core peak.
//
// bf16, short sequences (`flash_attention.packed_plan`, the forward's packed
// route): `pk::packed_bwd<D, N>`, one kernel in one pass.  A block holds the
// U units of one KV head that a forward tile holds (all of a unit's rows:
// where a unit spans several 128-row tiles the block walks them as bands, in
// order) and their U Sk keys.  Every q row that attends those keys is in the
// block, so it computes everything itself and no atomics are needed (two
// calls are equal bit for bit): per band Di = rowsum(dO O) (O read from
// device memory while the band's q and dO land by TMA), S = Q.K^T and dP =
// dO.V^T, P = exp2(S c - lse2) from the forward's lse (masked to the row's
// own unit and causally), dS = P (dP - Di), dQ = scale dS.K written
// straight from registers; then P and dS go to shared memory in bf16 and
// the block's warps sum dV += P^T.dO and dK += dS^T.Q over the band's rows,
// each warp its own m16n8 tiles of them (ldmatrix.trans of P, dS, dO and Q),
// 16 rows a step in order.  At the end dK (scaled) and dV leave by TMA
// stores.  Five products where the tensor-core route below runs seven, no
// pre-pass and no (2, B, H, Sqp) scratch.  Bound: bytes.  q, k, v, o, dO
// and the lse read once and dq, dk, dv written once are 2.24 GB at (B 2000,
// S 8, H 128, K 8, D 128), 0.67 ms, against 0.012 ms of bf16 tensor-core
// work.
//
// Every other launch first runs `bwd_prep` (one warp a row): Di from O and dO,
// and a copy of the forward's lse (times log2(e) on the tensor-core route),
// into (2, B, H, Sqp) f32 scratch the wrapper allocates; rows Sq .. Sqp
// (padding to a multiple of 64 on the tensor-core route, so a stage's rows
// arrive by one bulk copy) hold 0.  It reads O and dO once: memory-bound,
// 134 MB at the shape above, 0.04 ms at 3.35 TB/s.  Then two kernels, on
// one of two routes the wrapper picks before the launch
// (`flash_attention.backward_route`):
//
// bf16, D in {16, ..., 256}: `tc::dkdv_wgmma<D>` then `tc::dq_wgmma<D>`, on
// the tensor cores.  A bf16 x bf16 product is exact in f32, so wgmma with
// f32 accumulation gives the plain version's f32 S and dP up to the order of
// summation; the scale is applied in f32 (folded into exp2 for S, to dK and
// dQ at the end), never to a bf16 operand.  P = exp2(S*c - lse*log2(e))
// with c = scale*log2(e).  New rounding against the plain formulas: dS is
// rounded to bf16 as the A operand of the dK and dQ products (P's rounding
// for dV is the plain version's own); the CPU emulation in
// tests/test_torch_flash_backward.py holds that arithmetic to jax.grad.
// Both kernels have the forward's shape: 384 threads, warpgroup 2 the
// producer (one thread issues every TMA load through full/empty mbarriers;
// `setmaxnreg` 24), warpgroups 0 and 1 consume (240).  Tiles are 128-byte
// swizzled, 64 columns a chunk (below D 64 one chunk of D columns, 2 D-byte
// swizzled), loaded by rank-4 tensor maps over
// (D, heads, S, B), so GQA is a coordinate and rows past Sq or Sk arrive as
// zeros; only the causal diagonal and the ragged edge are masked (p = 0).
//   dK/dV: one block per (KV tile, KV head, batch), issued longest first
// (the grid's slow axis is the KV tile, from the first).  The block's K and
// V tiles are loaded once; the producer streams the group's (G = H / K
// query heads) Q and dO tiles of 64 rows with their lse and Di rows through
// a two-stage ring, from the causal frontier on.  At D <= 128 each consumer
// owns 64 KV rows (128 a block) and per stage computes S^T = K.Q^T and
// dP^T = V.dO^T (wgmma from shared memory, all K-major), P^T and
// dS^T = P^T * (dP^T - Di) in registers (the accumulator's layout is the A
// operand's, hence the transposed products), then dV += bf16(P^T).dO and
// dK += bf16(dS^T).Q with A from registers and dO and Q read MN-major
// through the transpose bit, as the forward reads V.  Each product is its
// own commit group, so P^T is computed while dP^T's product runs and dS^T
// while dV's does.  At D = 256 one
// warpgroup's f32 dK and dV alone would be 256 registers a thread, so the
// block owns 64 KV rows and the two consumers split the work: each computes
// S^T and dP^T for half of the stage's 64 q columns, writes its half of
// bf16 P^T and dS^T into shared memory (swizzled as TMA would, then
// fenced for the async proxy), and after a barrier of both accumulates dV
// and dK for half of the 256 head-dim columns from shared memory (216,104 B
// a block).  A block owns its KV tile across the whole query-head group, so
// the sums over the group run in a fixed order and no atomics are needed:
// two calls give the same bits.  dK is scaled in f32 at the end; both are
// staged through shared memory and written with 16-byte stores.
//   dQ: one block per (batch * head, 128-row q tile), issued longest first;
// Q and dO are loaded once, K and V tiles (128 rows, 32 at D = 256) stream
// through a two-stage ring.  A consumer owns 64 q rows: S = Q.K^T and
// dP = dO.V^T from shared memory, P and dS in registers (lse and Di of its
// two rows a thread; P while dP's product runs), then dQ += bf16(dS).K, K
// read MN-major.  dQ is scaled in f32 at the end.
//
// f32, D in {16, ..., 256}: `tc::dkdv_split<D>` then `tc::dq_split<D>` (at
// D 256 `tc::dkdv_split_wide` and `tc::dq_split_wide`, below), the
// split route, on the tensor cores as the forward's f32 route is
// (flash_attention.cu): every f32 operand enters as three bf16 pieces, hi =
// bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid), within 2^-25 |v|
// (hopper.cuh), and every product as six wgmma products of pieces, smallest
// first (mid.mid, lo.hi, hi.lo, mid.hi, hi.mid, hi.hi; each bf16 x bf16
// term exact in f32).  q, k, v and dO are split beforehand by
// `split_bf16_segments` (split_bf16.cuh: the four tensors in one launch
// from the same C entry, where four calls from Python cost 0.3 ms of host
// time at the reduced shape)
// into bf16 pieces in device memory (the dK/dV kernel reads every Q and dO
// tile again for each KV tile), loaded by
// TMA as in bf16; P^T / P and dS^T / dS are split in registers, never
// rounded, so dV's product sees p in v's type (f32) as the plain formulas
// do.  The scale stays in f32 (folded into exp2, applied to dK and dQ
// last).  The tensor cores' f32 accumulation truncates: the forward's f32
// route drifted by 5.5e-5 of outputs near 3 at 4,096 keys when every tile's
// products summed into O, so each stage's six-product sum here goes to a
// fresh accumulator and is added to the running dK, dV or dQ with f32 adds
// (dK and dV sum up to G * Sq / BQ stages, 1,024 at the training shape).
//   dK/dV: one block per (64-row KV tile, KV head, batch), longest first.
// Three pieces of K and V take 96 KB at D = 128, so a stage holds 32 q rows
// (64 at D = 64): three pieces each of Q and dO, 48 KB, then lse2 and Di.
// Consumer 0 computes S^T = K.Q^T (m64n32, six products over D), P^T in
// f32, hands P^T to consumer 1 through shared memory (in the accumulator's
// own order, 8 KB: one f32 a thread a register, no bank conflicts) and
// accumulates dV += P^T.dO; consumer 1 computes dP^T = V.dO^T, dS^T = P^T
// (dP^T - Di) and dK += dS^T.Q.  Each owns one 64 x D f32 sum (64 + 64
// fresh registers at D = 128), its A pieces in registers (24), so neither
// splits the head dim.  Two named barriers hand P^T over, each with one
// side arriving without waiting: consumer 1 waits until P^T is written,
// consumer 0 (from the second stage on) until the last one was read, so
// consumer 0 computes the next S^T and P^T while consumer 1 is still on
// its dS^T and dK (4% faster than both waiting at both, same bits; NVIDIA
// H100).  Shared memory: 98,304 B of K and V pieces, two stages
// of 50,176 B, 8,192 B of P^T: 207,912 B a block at D = 128 (166,952 at
// D = 64).
//   dQ: one block per (batch * head, 64-row q tile), longest first: three
// pieces of Q and dO for 64 rows take 96 KB at D = 128, so K and V stream
// in 32-row tiles (64 at D = 64), 48 KB a stage.  The consumers take
// alternate KV tiles, each its own ring stage (S and dP m64n32 over D, dS
// split in registers, dQ += dS.K), and consumer 1's f32 partial sum is added
// to consumer 0's once at the end, in a fixed order: 197,672 B (148,520 at
// D = 64).  Bound at (1, 4096, 64, 8, 128) causal: six products of pieces
// of FA2's 6.87e11 flops at the bf16 peak, 4.17 ms, plus the pre-pass over
// q, k, v and dO (f32 read, three bf16 pieces written: 0.75 GB, 0.23 ms);
// the f32 CUDA-core peak gives 10.26 ms.
//   D = 256: three pieces of a 64-row K tile take 96 KB, of V as much, and
// of a 64-row Q or dO tile as much again, so no operand stays resident.
// Both kernels stream every operand through a ring of slots in
// 64-column chunks of the head dim (one chunk of each piece a slot, 128-byte
// swizzled TMA boxes), and a stage takes 2 x 4 ring loads: four for the
// scores, summed chunk by chunk into one accumulator (six products of
// pieces a chunk, smallest first), and four for the gradient products,
// which need the stage's scores whole; each of those chunks gives 64
// columns of dK / dV / dQ in a fresh 64 x 64 accumulator (32 registers),
// added to the running 64 x 256 f32 sum (128 registers a thread).  The
// design trades L2 traffic for shared memory: K, V, Q and dO cross from L2
// again for every stage.
//   `tc::dkdv_split_wide`: one block per (64-row KV tile, KV head, batch),
// 32-row q stages; a slot holds K's and V's chunk (3 x 8 KB each) and the
// stage's Q and dO chunk (3 x 4 KB each), 73,728 B; the gradient loads
// carry Q and dO only.  Consumer 0 sums S^T = K.Q^T, consumer 1 dP^T =
// V.dO^T; P^T goes from 0 to 1 in shared memory (8 KB) as in dkdv_split;
// then 0 sums dV and 1 dK.  Shared memory: three slots (two took 16.7 ms
// where three take 14.6 at paligemma's shape on an H100 SXM at 700 W: the
// loads' latency, not L2's bandwidth, held the ring), three sets of lse2 and Di rows (256 B each),
// P^T, barriers: 231,216 B a block.  Registers a
// consumer thread: 128 (sum) + 32 (fresh) + 16 (S^T) + 24 (pieces of P^T).
//   `tc::dq_split_wide`: one block per (batch * head, 64-row q tile), 64-key
// stages, consumer w taking keys 32 w .. 32 w + 31; a slot holds Q's, dO's,
// K's and V's chunk (3 x 8 KB each), 98,304 B; the gradient loads carry K
// only.  Each consumer sums its S and dP over the chunks, forms P and dS
// in registers, and sums its own dQ; consumer 1's is added to consumer 0's
// once at the end through the ring.  Two slots: 197,664 B a block;
// registers 128 + 32 + 16 + 16 + 24 (pieces of dS).  Bound at (4, 4096,
// 8, 1, 256) causal: six products of 6.87e11 flops at 989 TFLOP/s, 4.17
// ms, plus the pre-pass (0.75 GB, 0.23 ms): 4.40 ms, operations; the
// chunks' L2 traffic, about 50 GB (dK/dV) and 32 GB (dQ) a call, is what
// the design pays for fitting in 227 KB.
//
// D 16 and 32 (the reduced configs' training) run the same kernels,
// instantiated at that head dim with the forward's swizzle
// (flash_attention.cu): one chunk of 2 D bytes a row, 32- or 64-byte
// swizzled TMA boxes and descriptors (`packed::Sw`).  A bf16 x bf16 product
// is as exact at D 16 as at 128, so the arithmetic, the block ownership and
// the fixed order of every sum are unchanged; no route of this file runs on
// the CUDA cores.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hopper.cuh"
#include "split_bf16.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ inline float ld(const float* p) { return *p; }
__device__ inline float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// ------------------------------------------------------------ both routes
// One warp a row of the (B, H, Sqp) scratch: Di = rowsum(dO * O) (lanes
// stride the head dim, then a fixed shuffle tree) and the forward's lse
// times `mul`; 0 for the padding rows s >= Sq.
template <typename T>
__global__ void __launch_bounds__(256) bwd_prep(
    const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ lse_out, float* __restrict__ di, int rows, int Sq, int Sqp, int H, int D,
    float mul) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * 8 + threadIdx.x / 32;  // (b * H + h) * Sqp + s
  if (row >= rows) return;
  const int bh = row / Sqp, s = row - bh * Sqp;
  float acc = 0.f, l = 0.f;
  if (s < Sq) {
    const int b = bh / H, h = bh - b * H;
    const size_t off = (((size_t)b * Sq + s) * H + h) * D;
    for (int d = lane; d < D; d += 32) acc = fmaf(ld(dout + off + d), ld(o + off + d), acc);
    l = lse[(size_t)bh * Sq + s] * mul;
  }
#pragma unroll
  for (int x = 16; x > 0; x >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, x);
  if (lane == 0) {
    di[row] = acc;
    lse_out[row] = l;
  }
}

template <typename T>
cudaError_t launch_prep(const void* o, const void* dout, const float* lse, float* lse_out,
                        float* di, int rows, int Sq, int Sqp, int H, int D, float mul,
                        cudaStream_t st) {
  bwd_prep<T><<<(rows + 7) / 8, 256, 0, st>>>(static_cast<const T*>(o),
                                              static_cast<const T*>(dout), lse, lse_out, di,
                                              rows, Sq, Sqp, H, D, mul);
  return cudaGetLastError();
}

// ------------- bf16, D in {64, 128, 256}, and split f32, D in {64, 128, 256}: wgmma
namespace tc {

constexpr int kThreads = 384;   // warpgroups 0 and 1 consume, 2 produces
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;
constexpr int kRows = 64;       // rows a consumer warpgroup owns, and every TMA box's rows
constexpr int kStages = 2;      // ring depth
constexpr int SW = 128;         // bytes of a swizzled chunk row from D 64 on (below: 2 D)
constexpr int CW = 64;          // bf16 columns a chunk (below D 64: D)
constexpr int kPairBar = 3;     // named barrier of both consumers (1 + wg: one consumer's)

// The descriptor's swizzle mode for rows of `sw` bytes: 128, 64 or 32 B.
__host__ __device__ constexpr uint32_t mode_of(int sw) { return sw == 128 ? 1 : sw == 64 ? 2 : 3; }
constexpr uint32_t kMode = mode_of(SW);

// The tensor maps of a launch; g is dO.
struct Maps {
  CUtensorMap q, k, v, g;
};

using hopper::pack_bf16;

// K-major operand: rows from row0 of a [chunk][ROWS][SWB / 2] tile whose rows
// are SWB bytes, k16 step kk (32 bytes along a chunk row).
template <int ROWS, int SWB = SW>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int row0, int kk) {
  constexpr int CWB = SWB / 2;
  return hopper::make_desc(tile + (kk * 16 / CWB) * ROWS * SWB + row0 * SWB + (kk * 16 % CWB) * 2,
                           16, 8 * SWB, mode_of(SWB));
}

// MN-major B operand of a [chunk][ROWS][SWB / 2] tile: K rows [16 kk, 16 kk +
// 16), N columns from chunk c0 on.
template <int ROWS, int SWB = SW>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk, int c0 = 0) {
  return hopper::make_desc(tile + c0 * ROWS * SWB + kk * 16 * SWB, ROWS * SWB, 8 * SWB,
                           mode_of(SWB));
}

// A consumer's 64 x W accumulator times `mul`, rounded to bf16, staged in `sm`
// ([64][W], 16-byte units swizzled by row) and written rows < `rows` to
// `out` (row stride `ld` elements) with 16-byte stores.
template <int W>
__device__ __forceinline__ void store_tile(const float (&acc)[W / 2], float mul, uint8_t* sm,
                                           __nv_bfloat16* out, size_t ld, int rows, int bar) {
  constexpr int NCH = W / 8;
  constexpr int kSwz = NCH >= 8 ? 7 : NCH - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int lr = 16 * warp + lane / 4;
#pragma unroll
  for (int i = 0; i < W / 8; ++i) {
    *reinterpret_cast<uint32_t*>(sm + lr * W * 2 + ((i ^ (lr & kSwz)) * 16) + 4 * (lane % 4)) =
        pack_bf16(acc[4 * i] * mul, acc[4 * i + 1] * mul);
    *reinterpret_cast<uint32_t*>(sm + (lr + 8) * W * 2 + ((i ^ ((lr + 8) & kSwz)) * 16) +
                                 4 * (lane % 4)) =
        pack_bf16(acc[4 * i + 2] * mul, acc[4 * i + 3] * mul);
  }
  hopper::named_sync<128>(bar);
  for (int idx = tid; idx < kRows * NCH; idx += 128) {
    const int row = idx / NCH, ch = idx - row * NCH;
    if (row >= rows) break;  // rows only grow with idx
    *reinterpret_cast<uint4*>(out + row * ld + ch * 8) =
        *reinterpret_cast<const uint4*>(sm + row * W * 2 + ((ch ^ (row & kSwz)) * 16));
  }
}

template <int D>
struct DkdvCfg {
  static constexpr bool kSplitD = D >= 256;  // the consumers split dK/dV's columns
  static constexpr int BKV = kSplitD ? 64 : 2 * kRows;  // KV rows a block
  static constexpr int BQ = 64;                          // q rows a stage
  static constexpr int NQ = kSplitD ? BQ / 2 : BQ;       // S^T columns a consumer computes
  static constexpr int DW = kSplitD ? D / 2 : D;         // dK/dV columns a consumer sums
  static constexpr int NC = packed::Sw<D>::NC;  // chunks across D (the forward's swizzle)
  static constexpr int kKVBytes = BKV * D * 2;           // the K tile; the V tile
  static constexpr int kQBytes = BQ * D * 2;             // a stage's Q tile; its dO tile
  static constexpr int kStageBytes = 2 * kQBytes + 1024;  // then lse2 and Di rows, 1 KB aligned
  static constexpr int kPBytes = kSplitD ? 2 * BKV * BQ * 2 : 0;  // bf16 P^T, dS^T
  static constexpr int kBarBytes = 8 * (1 + 2 * kStages);
  static constexpr size_t kSmem =
      1024 + 2 * kKVBytes + kStages * kStageBytes + kPBytes + kBarBytes;
};

// lse2 (the forward's lse times log2 e) and di: (B, H, Sqp) f32 from bwd_prep.
template <int D>
__global__ void __launch_bounds__(kThreads, 1) dkdv_wgmma(
    const __grid_constant__ Maps maps, const float* __restrict__ lse2,
    const float* __restrict__ di, __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    int Sq, int Sqp, int Sk, int H, int K, int causal, float c, float scale) {
  using C = DkdvCfg<D>;
  constexpr int BKV = C::BKV, BQ = C::BQ, NQ = C::NQ, DW = C::DW, NC = C::NC;
  // this head dim's swizzle, as the forward's: 128-byte rows of 64 columns a
  // chunk from D 64 on, one chunk of 2 D bytes below (shadows tc::SW, tc::CW)
  constexpr int SW = packed::Sw<D>::SW, CW = packed::Sw<D>::CW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t k_s = base;                             // [NC][BKV][CW]
  const uint32_t v_s = k_s + C::kKVBytes;                // [NC][BKV][CW]
  const uint32_t st_s = v_s + C::kKVBytes;               // stages: Q, dO [NC][BQ][CW]; lse2, Di
  const uint32_t p_s = st_s + kStages * C::kStageBytes;  // (split D) P^T, dS^T [BKV][BQ]
  const uint32_t bars = p_s + C::kPBytes;                // kv, full[stages], empty[stages]
  const uint32_t kv_bar = bars;
  auto full_bar = [&](int s) { return bars + 8u * (1 + s); };
  auto empty_bar = [&](int s) { return bars + 8u * (1 + kStages + s); };

  const int b = blockIdx.x / K, kvh = blockIdx.x - b * K, G = H / K;
  const int k0 = blockIdx.y * BKV;  // the first KV tiles, the longest under causal, first
  const int n_q = (Sq + BQ - 1) / BQ;
  const int first_q = causal ? min(k0 / BQ, n_q) : 0;  // q tiles holding a row >= k0
  const int n_qt = n_q - first_q, n_it = G * n_qt;     // stages: (head of the group, q tile)
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full_bar(s), 1);
      hopper::mbar_init(empty_bar(s), 2 * 128);  // every consumer thread arrives
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // ------------------------------------------ producer
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      const int halves = min(BKV / kRows, (Sk - k0 + kRows - 1) / kRows);  // no box past Sk
      hopper::mbar_expect_tx(kv_bar, 2 * halves * kRows * D * 2);
      for (int w = 0; w < halves; ++w)
        for (int cc = 0; cc < NC; ++cc) {
          const uint32_t off = cc * BKV * SW + w * kRows * SW;
          hopper::tma_load_4d(k_s + off, &maps.k, kv_bar, cc * CW, kvh, k0 + w * kRows, b);
          hopper::tma_load_4d(v_s + off, &maps.v, kv_bar, cc * CW, kvh, k0 + w * kRows, b);
        }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages;
        const int g = it / n_qt, q0 = (first_q + it - g * n_qt) * BQ, h = kvh * G + g;
        const uint32_t st = st_s + s * C::kStageBytes;
        hopper::mbar_wait(empty_bar(s), ((it / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(full_bar(s), 2 * C::kQBytes + 2 * BQ * 4);
        for (int cc = 0; cc < NC; ++cc) {
          hopper::tma_load_4d(st + cc * BQ * SW, &maps.q, full_bar(s), cc * CW, h, q0, b);
          hopper::tma_load_4d(st + C::kQBytes + cc * BQ * SW, &maps.g, full_bar(s), cc * CW, h,
                              q0, b);
        }
        const size_t row = ((size_t)b * H + h) * Sqp + q0;
        hopper::bulk_load(st + 2 * C::kQBytes, lse2 + row, BQ * 4, full_bar(s));
        hopper::bulk_load(st + 2 * C::kQBytes + BQ * 4, di + row, BQ * 4, full_bar(s));
      }
    }
  } else {  // ----------------------------------------------- consumers
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int warp = tid / 32, lane = tid % 32;
    const int kr = C::kSplitD ? 0 : kRows * wg;  // this consumer's first KV row of the tile
    const int qc = C::kSplitD ? NQ * wg : 0;     // its first column of a stage's q rows
    const int kw0 = k0 + kr;
    const int kr0 = kw0 + 16 * warp + lane / 4;  // this thread's KV rows: kr0 and kr0 + 8
    float acc_k[DW / 2], acc_v[DW / 2], s[NQ / 2], dp[NQ / 2];
#pragma unroll
    for (int i = 0; i < DW / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NQ / 2; ++i) s[i] = dp[i] = 0.f;

    hopper::mbar_wait(kv_bar, 0);
    for (int it = 0; it < n_it; ++it) {
      const int st = it % kStages;
      const int g = it / n_qt, q0 = (first_q + it - g * n_qt) * BQ;
      const uint32_t qt = st_s + st * C::kStageBytes, gt = qt + C::kQBytes;
      const float* const l2s = reinterpret_cast<const float*>(gbase + (qt + 2 * C::kQBytes - base));
      const float* const dis = l2s + BQ;
      const int qa = q0 + qc;  // the q position of this consumer's first column
      hopper::mbar_wait(full_bar(st), (it / kStages) & 1);
      // split D: both consumers always take part (they share P^T and dS^T);
      // otherwise skip a stage wholly before this consumer's rows, or past Sk
      if (C::kSplitD || (kw0 < Sk && !(causal && qa + NQ - 1 < kw0))) {
        // S^T = K.Q^T and dP^T = V.dO^T, all K-major, one commit group each:
        // P^T is computed while dP^T runs
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_ss(s, kmajor<BKV, SW>(k_s, kr, kk), kmajor<BQ, SW>(qt, qc, kk), kk > 0);
        hopper::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_ss(dp, kmajor<BKV, SW>(v_s, kr, kk), kmajor<BQ, SW>(gt, qc, kk), kk > 0);
        hopper::wgmma_commit();
        hopper::fence_regs(dp);
        hopper::wgmma_wait<1>();
        hopper::fence_regs(s);

        // P^T = exp2(S^T c - lse2), masked entries 0
        const bool edge = (causal && kw0 + kRows - 1 > qa) || qa + NQ > Sq || kw0 + kRows > Sk;
#pragma unroll
        for (int j = 0; j < NQ / 8; ++j) {
          const int col = qc + 8 * j + 2 * (lane % 4);
          const float2 l2 = *reinterpret_cast<const float2*>(l2s + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            float p = exp2f(fmaf(s[i], c, -((e & 1) ? l2.y : l2.x)));
            if (edge) {
              const int qpos = q0 + col + (e & 1), kpos = kr0 + 8 * (e >> 1);
              if (qpos >= Sq || kpos >= Sk || (causal && kpos > qpos)) p = 0.f;
            }
            s[i] = p;
          }
        }
        // dS^T = P^T (dP^T - Di), once dP^T is done
        auto grad_scores = [&]() {
#pragma unroll
          for (int j = 0; j < NQ / 8; ++j) {
            const float2 dd =
                *reinterpret_cast<const float2*>(dis + qc + 8 * j + 2 * (lane % 4));
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? dd.y : dd.x));
          }
        };

        if constexpr (C::kSplitD) {
          hopper::wgmma_wait<0>();
          hopper::fence_regs(dp);
          grad_scores();
          // Each consumer's half of bf16 P^T and dS^T into shared memory
          // ([BKV][BQ] rows of 128 bytes, swizzled as TMA writes), then dV
          // and dK for this consumer's DW head-dim columns from there.
          uint8_t* const pg = gbase + (p_s - base);
          hopper::named_sync<256>(kPairBar);  // both consumers' last dK/dV products read them
#pragma unroll
          for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int row = 16 * warp + lane / 4 + 8 * hr;
              const int col = qc + 8 * j + 2 * (lane % 4);
              const uint32_t off = hopper::swz(row * (BQ * 2) + col * 2, SW);
              *reinterpret_cast<uint32_t*>(pg + off) =
                  pack_bf16(s[4 * j + 2 * hr], s[4 * j + 2 * hr + 1]);
              *reinterpret_cast<uint32_t*>(pg + BKV * BQ * 2 + off) =
                  pack_bf16(dp[4 * j + 2 * hr], dp[4 * j + 2 * hr + 1]);
            }
          hopper::fence_proxy_async();
          hopper::named_sync<256>(kPairBar);
          const int c0 = (DW / CW) * wg;  // this consumer's first chunk of dO and Q
          hopper::fence_regs(acc_v);
          hopper::fence_regs(acc_k);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)
            hopper::wgmma_ss_tb(acc_v, hopper::make_desc(p_s + kk * 32, 16, 8 * SW, kMode),
                                mnmajor<BQ, SW>(gt, kk, c0), 1);
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)
            hopper::wgmma_ss_tb(acc_k,
                                hopper::make_desc(p_s + BKV * BQ * 2 + kk * 32, 16, 8 * SW, kMode),
                                mnmajor<BQ, SW>(qt, kk, c0), 1);
        } else {
          // bf16 P^T and dS^T as A operands from registers: the k16 slice kk
          // of the accumulator is A fragment kk.  dV's product runs while
          // dS^T is computed.
          uint32_t pa[NQ / 16][4], da[NQ / 16][4];
#pragma unroll
          for (int kk = 0; kk < NQ / 16; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
          hopper::fence_regs(acc_v);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < NQ / 16; ++kk)
            hopper::wgmma_rs(acc_v, pa[kk], mnmajor<BQ, SW>(gt, kk), 1);
          hopper::wgmma_commit();
          hopper::fence_regs(acc_v);
          hopper::wgmma_wait<1>();  // dP^T done; dV may still run
          hopper::fence_regs(dp);
          grad_scores();
#pragma unroll
          for (int kk = 0; kk < NQ / 16; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              da[kk][e] = pack_bf16(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1]);
          hopper::fence_regs(acc_k);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < NQ / 16; ++kk)
            hopper::wgmma_rs(acc_k, da[kk], mnmajor<BQ, SW>(qt, kk), 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc_v);
        hopper::fence_regs(acc_k);
      }
      hopper::mbar_arrive(empty_bar(st));
    }

    // Both consumers are done with K and V: their tiles become the staging.
    hopper::named_sync<256>(kPairBar);
    if (kw0 < Sk) {
      const int dc = C::kSplitD ? DW * wg : 0;
      const size_t ld = (size_t)K * D;
      const size_t at = (((size_t)b * Sk + kw0) * K + kvh) * D + dc;
      const int rows = min(kRows, Sk - kw0);
      store_tile<DW>(acc_k, scale, gbase + (k_s - base) + wg * kRows * DW * 2, dk + at, ld, rows,
                     1 + wg);
      store_tile<DW>(acc_v, 1.f, gbase + (v_s - base) + wg * kRows * DW * 2, dv + at, ld, rows,
                     1 + wg);
    }
  }
}

template <int D>
struct DqCfg {
  static constexpr int BK = D >= 256 ? 32 : 128;  // KV rows a stage
  static constexpr int NC = packed::Sw<D>::NC;  // chunks across D (the forward's swizzle)
  static constexpr int kWGBytes = kRows * D * 2;  // a consumer's Q rows; its dO rows
  static constexpr int kTileBytes = BK * D * 2;   // a stage's K tile; its V tile
  static constexpr int kBarBytes = 8 * (1 + 2 * kStages);
  static constexpr size_t kSmem = 1024 + 4 * kWGBytes + 2 * kStages * kTileBytes + kBarBytes;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1) dq_wgmma(
    const __grid_constant__ Maps maps, const float* __restrict__ lse2,
    const float* __restrict__ di, __nv_bfloat16* __restrict__ dq, int Sq, int Sqp, int Sk, int H,
    int K, int causal, float c, float scale) {
  using C = DqCfg<D>;
  constexpr int BK = C::BK, NC = C::NC, BQ = 2 * kRows;
  // this head dim's swizzle, as the forward's: 128-byte rows of 64 columns a
  // chunk from D 64 on, one chunk of 2 D bytes below (shadows tc::SW, tc::CW)
  constexpr int SW = packed::Sw<D>::SW, CW = packed::Sw<D>::CW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t q_s = base;                          // [2 WG][NC][64][CW]
  const uint32_t g_s = q_s + 2 * C::kWGBytes;         // [2 WG][NC][64][CW]
  const uint32_t k_s = g_s + 2 * C::kWGBytes;         // [stage][NC][BK][CW]
  const uint32_t v_s = k_s + kStages * C::kTileBytes;  // [stage][NC][BK][CW]
  const uint32_t bars = v_s + kStages * C::kTileBytes;  // q, full[stages], empty[stages]
  const uint32_t q_bar = bars;
  auto full_bar = [&](int s) { return bars + 8u * (1 + s); };
  auto empty_bar = [&](int s) { return bars + 8u * (1 + kStages + s); };

  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const int kvh = h / (H / K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal rows first
  int n_kv = (Sk + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (q0 + BQ - 1) / BK + 1);  // tiles at or before the last row
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full_bar(s), 1);
      hopper::mbar_init(empty_bar(s), 2 * 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // ------------------------------------------ producer
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      const int halves = Sq - q0 > kRows ? 2 : 1;  // no box wholly past Sq
      hopper::mbar_expect_tx(q_bar, 2 * halves * C::kWGBytes);
      for (int w = 0; w < halves; ++w)
        for (int cc = 0; cc < NC; ++cc) {
          const uint32_t off = w * C::kWGBytes + cc * kRows * SW;
          hopper::tma_load_4d(q_s + off, &maps.q, q_bar, cc * CW, h, q0 + w * kRows, b);
          hopper::tma_load_4d(g_s + off, &maps.g, q_bar, cc * CW, h, q0 + w * kRows, b);
        }
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kStages;
        hopper::mbar_wait(empty_bar(s), ((j / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(full_bar(s), 2 * C::kTileBytes);
        for (int cc = 0; cc < NC; ++cc) {
          const uint32_t off = s * C::kTileBytes + cc * BK * SW;
          hopper::tma_load_4d(k_s + off, &maps.k, full_bar(s), cc * CW, kvh, j * BK, b);
          hopper::tma_load_4d(v_s + off, &maps.v, full_bar(s), cc * CW, kvh, j * BK, b);
        }
      }
    }
  } else {  // ----------------------------------------------- consumers
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int warp = tid / 32, lane = tid % 32;
    const int qw0 = q0 + wg * kRows;            // this consumer's first row
    const int r0 = qw0 + 16 * warp + lane / 4;  // this thread's rows: r0 and r0 + 8
    int n_w = qw0 < Sq ? n_kv : 0;              // tiles this consumer computes
    if (causal) n_w = min(n_w, (qw0 + kRows - 1) / BK + 1);
    const uint32_t qw = q_s + wg * C::kWGBytes, gw = g_s + wg * C::kWGBytes;
    const size_t row = ((size_t)b * H + h) * Sqp;
    const float l2_0 = r0 < Sq ? lse2[row + r0] : 0.f, l2_1 = r0 + 8 < Sq ? lse2[row + r0 + 8] : 0.f;
    const float di_0 = r0 < Sq ? di[row + r0] : 0.f, di_1 = r0 + 8 < Sq ? di[row + r0 + 8] : 0.f;

    float acc[D / 2], s[BK / 2], dp[BK / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.f;

    hopper::mbar_wait(q_bar, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int st = j % kStages;
      hopper::mbar_wait(full_bar(st), (j / kStages) & 1);
      if (j < n_w) {
        const int k0 = j * BK;
        const uint32_t kt = k_s + st * C::kTileBytes, vt = v_s + st * C::kTileBytes;
        // S = Q.K^T and dP = dO.V^T, all K-major, one commit group each: P is
        // computed while dP runs
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_ss(s, kmajor<kRows, SW>(qw, 0, kk), kmajor<BK, SW>(kt, 0, kk), kk > 0);
        hopper::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_ss(dp, kmajor<kRows, SW>(gw, 0, kk), kmajor<BK, SW>(vt, 0, kk), kk > 0);
        hopper::wgmma_commit();
        hopper::fence_regs(dp);
        hopper::wgmma_wait<1>();
        hopper::fence_regs(s);

        const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > qw0);
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = 4 * i + e, hr = e >> 1;
            float p = exp2f(fmaf(s[x], c, -(hr ? l2_1 : l2_0)));
            if (edge) {
              const int kpos = k0 + 8 * i + 2 * (lane % 4) + (e & 1), qpos = r0 + 8 * hr;
              if (kpos >= Sk || (causal && kpos > qpos)) p = 0.f;
            }
            s[x] = p;
          }
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dp);
#pragma unroll
        for (int x = 0; x < BK / 2; ++x) dp[x] = s[x] * (dp[x] - ((x & 2) ? di_1 : di_0));
        // dQ += bf16(dS).K, K MN-major: a k16 step is 16 key rows
        uint32_t da[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) da[kk][e] = pack_bf16(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1]);
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          hopper::wgmma_rs(acc, da[kk], mnmajor<BK, SW>(kt, kk), 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
      }
      hopper::mbar_arrive(empty_bar(st));
    }

    if (n_w > 0) {
      hopper::named_sync<128>(1 + wg);  // every warp's last product has read this consumer's Q
      store_tile<D>(acc, scale, gbase + (qw - base),
                    dq + (((size_t)b * Sq + qw0) * H + h) * D, (size_t)H * D,
                    min(kRows, Sq - qw0), 1 + wg);
    }
  }
}

// ------------------------------------- f32, D in {64, 128}: split-bf16 wgmma
// The six products of pieces (hopper.cuh), smallest first.
using hopper::term_a;
using hopper::term_b;

// The tensor maps of a split launch: each bf16 piece (hi, mid, lo) of q, dO,
// k and v.
struct SplitMaps {
  CUtensorMap q[3], g[3], k[3], v[3];
};

template <int D>
struct DkdvSplitCfg {
  static constexpr int BKV = kRows;               // KV rows a block
  static constexpr int BQ = D >= 128 ? 32 : 64;   // q rows a stage
  static constexpr int NC = packed::Sw<D>::NC;  // chunks across D (the forward's swizzle)
  static constexpr int kKVBytes = BKV * D * 2;    // one piece of the K tile; of the V tile
  static constexpr int kQBytes = BQ * D * 2;      // one piece of a stage's Q tile; of its dO tile
  static constexpr int kStageBytes = 6 * kQBytes + 1024;  // then lse2 and Di rows, 1 KB aligned
  static constexpr int kPBytes = BKV * BQ * 4;    // f32 P^T, consumer 0 to consumer 1
  static constexpr int kBarBytes = 8 * (1 + 2 * kStages);
  static constexpr size_t kSmem =
      1024 + 6 * kKVBytes + kStages * kStageBytes + kPBytes + kBarBytes;
};

// dK/dV on split-bf16 operands.  lse2 (the forward's lse times log2 e) and
// di: (B, H, Sqp) f32 from bwd_prep; dk, dv f32.
template <int D>
__global__ void __launch_bounds__(kThreads, 1) dkdv_split(
    const __grid_constant__ SplitMaps maps, const float* __restrict__ lse2,
    const float* __restrict__ di, float* __restrict__ dk, float* __restrict__ dv, int Sq,
    int Sqp, int Sk, int H, int K, int causal, float c, float scale) {
  using C = DkdvSplitCfg<D>;
  constexpr int BKV = C::BKV, BQ = C::BQ, NC = C::NC;
  // this head dim's swizzle, as the forward's: 128-byte rows of 64 columns a
  // chunk from D 64 on, one chunk of 2 D bytes below (shadows tc::SW, tc::CW)
  constexpr int SW = packed::Sw<D>::SW, CW = packed::Sw<D>::CW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t k_s = base;                             // [piece][NC][BKV][CW]
  const uint32_t v_s = k_s + 3 * C::kKVBytes;            // [piece][NC][BKV][CW]
  const uint32_t st_s = v_s + 3 * C::kKVBytes;           // stages: Q, dO [piece][NC][BQ][CW]; lse2, Di
  const uint32_t p_s = st_s + kStages * C::kStageBytes;  // f32 P^T in accumulator order
  const uint32_t bars = p_s + C::kPBytes;                // kv, full[stages], empty[stages]
  const uint32_t kv_bar = bars;
  auto full_bar = [&](int s) { return bars + 8u * (1 + s); };
  auto empty_bar = [&](int s) { return bars + 8u * (1 + kStages + s); };

  const int b = blockIdx.x / K, kvh = blockIdx.x - b * K, G = H / K;
  const int k0 = blockIdx.y * BKV;  // the first KV tiles, the longest under causal, first
  const int n_q = (Sq + BQ - 1) / BQ;
  const int first_q = causal ? min(k0 / BQ, n_q) : 0;  // q tiles holding a row >= k0
  const int n_qt = n_q - first_q, n_it = G * n_qt;     // stages: (head of the group, q tile)
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full_bar(s), 1);
      hopper::mbar_init(empty_bar(s), 2 * 128);  // every consumer thread arrives
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // ------------------------------------------ producer
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      hopper::mbar_expect_tx(kv_bar, 6 * C::kKVBytes);
#pragma unroll
      for (int piece = 0; piece < 3; ++piece)
        for (int cc = 0; cc < NC; ++cc) {
          const uint32_t off = piece * C::kKVBytes + cc * BKV * SW;
          hopper::tma_load_4d(k_s + off, &maps.k[piece], kv_bar, cc * CW, kvh, k0, b);
          hopper::tma_load_4d(v_s + off, &maps.v[piece], kv_bar, cc * CW, kvh, k0, b);
        }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages;
        const int g = it / n_qt, q0 = (first_q + it - g * n_qt) * BQ, h = kvh * G + g;
        const uint32_t st = st_s + s * C::kStageBytes;
        hopper::mbar_wait(empty_bar(s), ((it / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(full_bar(s), 6 * C::kQBytes + 2 * BQ * 4);
#pragma unroll
        for (int piece = 0; piece < 3; ++piece)
          for (int cc = 0; cc < NC; ++cc) {
            const uint32_t off = piece * C::kQBytes + cc * BQ * SW;
            hopper::tma_load_4d(st + off, &maps.q[piece], full_bar(s), cc * CW, h, q0, b);
            hopper::tma_load_4d(st + 3 * C::kQBytes + off, &maps.g[piece], full_bar(s), cc * CW,
                                h, q0, b);
          }
        const size_t row = ((size_t)b * H + h) * Sqp + q0;
        hopper::bulk_load(st + 6 * C::kQBytes, lse2 + row, BQ * 4, full_bar(s));
        hopper::bulk_load(st + 6 * C::kQBytes + BQ * 4, di + row, BQ * 4, full_bar(s));
      }
    }
  } else {  // ----------------------------------------------- consumers
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int warp = tid / 32, lane = tid % 32;
    const int kr0 = k0 + 16 * warp + lane / 4;  // this thread's KV rows: kr0 and kr0 + 8
    // Consumer 0 computes S^T = K.Q^T, P^T and dV; consumer 1 dP^T = V.dO^T,
    // dS^T (reading consumer 0's f32 P^T) and dK.
    const uint32_t a_s = wg == 0 ? k_s : v_s;
    float* const pbuf = reinterpret_cast<float*>(gbase + (p_s - base));
    float acc[D / 2], x[BQ / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) x[i] = 0.f;

    hopper::mbar_wait(kv_bar, 0);
    for (int it = 0; it < n_it; ++it) {
      const int st = it % kStages;
      const int g = it / n_qt, q0 = (first_q + it - g * n_qt) * BQ;
      const uint32_t qt = st_s + st * C::kStageBytes, gt = qt + 3 * C::kQBytes;
      const float* const l2s = reinterpret_cast<const float*>(gbase + (qt + 6 * C::kQBytes - base));
      const float* const dis = l2s + BQ;
      hopper::mbar_wait(full_bar(st), (it / kStages) & 1);

      // S^T (or dP^T): six products of pieces, smallest first, all K-major
      const uint32_t b_s = wg == 0 ? qt : gt;
      hopper::wgmma_fence();
#pragma unroll
      for (int t = 0; t < 6; ++t)
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_ss(x, kmajor<BKV, SW>(a_s + term_a(t) * C::kKVBytes, 0, kk),
                           kmajor<BQ, SW>(b_s + term_b(t) * C::kQBytes, 0, kk), t > 0 || kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(x);

      if (wg == 0) {
        if (it > 0) hopper::named_sync<256>(kPairBar);  // consumer 1 has read the last P^T
        // P^T = exp2(S^T c - lse2), masked entries 0, to consumer 1 in the
        // accumulator's order (thread-contiguous: no bank conflicts)
        const bool edge = (causal && k0 + BKV - 1 > q0) || q0 + BQ > Sq || k0 + BKV > Sk;
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const int col = 8 * j + 2 * (lane % 4);
          const float2 l2 = *reinterpret_cast<const float2*>(l2s + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            float p = exp2f(fmaf(x[i], c, -((e & 1) ? l2.y : l2.x)));
            if (edge) {
              const int qpos = q0 + col + (e & 1), kpos = kr0 + 8 * (e >> 1);
              if (qpos >= Sq || kpos >= Sk || (causal && kpos > qpos)) p = 0.f;
            }
            x[i] = p;
            pbuf[i * 128 + tid] = p;
          }
        }
        hopper::named_arrive<256>(kPairBar + 1);  // P^T written
      } else {  // dS^T = P^T (dP^T - Di)
        hopper::named_sync<256>(kPairBar + 1);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 dd = *reinterpret_cast<const float2*>(dis + 8 * j + 2 * (lane % 4));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            x[i] = pbuf[i * 128 + tid] * (x[i] - ((e & 1) ? dd.y : dd.x));
          }
        }
        hopper::named_arrive<256>(kPairBar);  // P^T read
      }

      // P^T (or dS^T) split into bf16 hi, mid and lo as A operands from
      // registers (the k16 slice kk of the accumulator is A fragment kk);
      // the stage's dV = P^T.dO (or dK = dS^T.Q), six products of pieces
      // with dO (Q) read MN-major, goes to a fresh accumulator and is added
      // to the running sum in f32: the tensor cores' f32 accumulation
      // truncates, and summed over every stage that bias would grow with
      // the group's q rows.
      uint32_t xa[3][BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          hopper::split3_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1], xa[0][kk][e],
                              xa[1][kk][e], xa[2][kk][e]);
      const uint32_t c_s = wg == 0 ? gt : qt;
      float tile[D / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int t = 0; t < 6; ++t)
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          hopper::wgmma_rs(tile, xa[term_a(t)][kk],
                           mnmajor<BQ, SW>(c_s + term_b(t) * C::kQBytes, kk), t > 0 || kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(tile);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] += tile[i];
      hopper::mbar_arrive(empty_bar(st));
    }

    if (wg == 0 && n_it > 0) hopper::named_sync<256>(kPairBar);  // the last P^T read
    // dV (consumer 0) or dK times the scale (consumer 1), f32, 8 bytes a
    // thread, rows < Sk
    float* const out = wg == 0 ? dv : dk;
    const float mul = wg == 0 ? 1.f : scale;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int kpos = kr0 + 8 * hr;
      if (kpos >= Sk) continue;
      float* const row = out + (((size_t)b * Sk + kpos) * K + kvh) * D + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(row + 8 * j) =
            make_float2(acc[4 * j + 2 * hr] * mul, acc[4 * j + 2 * hr + 1] * mul);
    }
  }
}

template <int D>
struct DqSplitCfg {
  static constexpr int BK = D >= 128 ? 32 : 64;  // KV rows a stage
  static constexpr int NC = packed::Sw<D>::NC;  // chunks across D (the forward's swizzle)
  static constexpr int kQBytes = kRows * D * 2;  // one piece of the block's Q rows; of its dO rows
  static constexpr int kTileBytes = BK * D * 2;  // one piece of a stage's K tile; of its V tile
  static constexpr int kStageBytes = 6 * kTileBytes;
  static constexpr int kBarBytes = 8 * (1 + 2 * kStages);
  static constexpr size_t kSmem = 1024 + 6 * kQBytes + kStages * kStageBytes + kBarBytes;
};

// dQ on split-bf16 operands; dq f32.
template <int D>
__global__ void __launch_bounds__(kThreads, 1) dq_split(
    const __grid_constant__ SplitMaps maps, const float* __restrict__ lse2,
    const float* __restrict__ di, float* __restrict__ dq, int Sq, int Sqp, int Sk, int H, int K,
    int causal, float c, float scale) {
  using C = DqSplitCfg<D>;
  constexpr int BK = C::BK, NC = C::NC;
  // this head dim's swizzle, as the forward's: 128-byte rows of 64 columns a
  // chunk from D 64 on, one chunk of 2 D bytes below (shadows tc::SW, tc::CW)
  constexpr int SW = packed::Sw<D>::SW, CW = packed::Sw<D>::CW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t q_s = base;                           // [piece][NC][64][CW]
  const uint32_t g_s = q_s + 3 * C::kQBytes;           // [piece][NC][64][CW]
  const uint32_t st_s = g_s + 3 * C::kQBytes;          // stages: K, V [piece][NC][BK][CW]
  const uint32_t bars = st_s + kStages * C::kStageBytes;  // q, full[stages], empty[stages]
  const uint32_t q_bar = bars;
  auto full_bar = [&](int s) { return bars + 8u * (1 + s); };
  auto empty_bar = [&](int s) { return bars + 8u * (1 + kStages + s); };

  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const int kvh = h / (H / K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest causal rows first
  int n_kv = (Sk + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (q0 + kRows - 1) / BK + 1);  // tiles at or before the last row
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full_bar(s), 1);
      hopper::mbar_init(empty_bar(s), 128);  // stage s is consumer s's alone
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // ------------------------------------------ producer
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      hopper::mbar_expect_tx(q_bar, 6 * C::kQBytes);
#pragma unroll
      for (int piece = 0; piece < 3; ++piece)
        for (int cc = 0; cc < NC; ++cc) {
          const uint32_t off = piece * C::kQBytes + cc * kRows * SW;
          hopper::tma_load_4d(q_s + off, &maps.q[piece], q_bar, cc * CW, h, q0, b);
          hopper::tma_load_4d(g_s + off, &maps.g[piece], q_bar, cc * CW, h, q0, b);
        }
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kStages;
        const uint32_t st = st_s + s * C::kStageBytes;
        hopper::mbar_wait(empty_bar(s), ((j / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(full_bar(s), C::kStageBytes);
#pragma unroll
        for (int piece = 0; piece < 3; ++piece)
          for (int cc = 0; cc < NC; ++cc) {
            const uint32_t off = piece * C::kTileBytes + cc * BK * SW;
            hopper::tma_load_4d(st + off, &maps.k[piece], full_bar(s), cc * CW, kvh, j * BK, b);
            hopper::tma_load_4d(st + 3 * C::kTileBytes + off, &maps.v[piece], full_bar(s),
                                cc * CW, kvh, j * BK, b);
          }
      }
    }
  } else {  // ----------------------------------------------- consumers
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int warp = tid / 32, lane = tid % 32;
    const int r0 = q0 + 16 * warp + lane / 4;  // this thread's rows: r0 and r0 + 8
    const size_t row = ((size_t)b * H + h) * Sqp;
    const float l2_0 = r0 < Sq ? lse2[row + r0] : 0.f, l2_1 = r0 + 8 < Sq ? lse2[row + r0 + 8] : 0.f;
    const float di_0 = r0 < Sq ? di[row + r0] : 0.f, di_1 = r0 + 8 < Sq ? di[row + r0 + 8] : 0.f;

    float acc[D / 2], s[BK / 2], dp[BK / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.f;

    hopper::mbar_wait(q_bar, 0);
    // Consumer wg takes KV tiles wg, wg + 2, ...: ring stage wg is its own.
    for (int j = wg; j < n_kv; j += kStages) {
      const int k0 = j * BK;
      const uint32_t kt = st_s + wg * C::kStageBytes, vt = kt + 3 * C::kTileBytes;
      hopper::mbar_wait(full_bar(wg), (j / kStages) & 1);
      // S = Q.K^T and dP = dO.V^T, six products of pieces each, smallest
      // first, all K-major, one commit group each: P is computed while dP runs
      hopper::wgmma_fence();
#pragma unroll
      for (int t = 0; t < 6; ++t)
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_ss(s, kmajor<kRows, SW>(q_s + term_a(t) * C::kQBytes, 0, kk),
                           kmajor<BK, SW>(kt + term_b(t) * C::kTileBytes, 0, kk), t > 0 || kk > 0);
      hopper::wgmma_commit();
#pragma unroll
      for (int t = 0; t < 6; ++t)
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_ss(dp, kmajor<kRows, SW>(g_s + term_a(t) * C::kQBytes, 0, kk),
                           kmajor<BK, SW>(vt + term_b(t) * C::kTileBytes, 0, kk), t > 0 || kk > 0);
      hopper::wgmma_commit();
      hopper::fence_regs(dp);
      hopper::wgmma_wait<1>();
      hopper::fence_regs(s);

      const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > q0);
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * i + e, hr = e >> 1;
          float p = exp2f(fmaf(s[x], c, -(hr ? l2_1 : l2_0)));
          if (edge) {
            const int kpos = k0 + 8 * i + 2 * (lane % 4) + (e & 1), qpos = r0 + 8 * hr;
            if (kpos >= Sk || (causal && kpos > qpos)) p = 0.f;
          }
          s[x] = p;
        }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
#pragma unroll
      for (int x = 0; x < BK / 2; ++x) dp[x] = s[x] * (dp[x] - ((x & 2) ? di_1 : di_0));
      // dS split into bf16 hi, mid and lo as A operands from registers; the
      // tile's dS.K (K MN-major: a k16 step is 16 key rows), six products of
      // pieces, goes to a fresh accumulator added to the running dQ in f32
      uint32_t da[3][BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          hopper::split3_bf16(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1], da[0][kk][e],
                              da[1][kk][e], da[2][kk][e]);
      float tile[D / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int t = 0; t < 6; ++t)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          hopper::wgmma_rs(tile, da[term_a(t)][kk],
                           mnmajor<BK, SW>(kt + term_b(t) * C::kTileBytes, kk), t > 0 || kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(tile);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] += tile[i];
      hopper::mbar_arrive(empty_bar(wg));
    }

    // dQ = (consumer 0's sum + consumer 1's) * scale: consumer 1's partial
    // sum passes through the ring (every stage consumed), in accumulator order
    float* const red = reinterpret_cast<float*>(gbase + (st_s - base));
    hopper::named_sync<256>(kPairBar);
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) red[i * 128 + tid] = acc[i];
    }
    hopper::named_sync<256>(kPairBar);
    if (wg == 0) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int qpos = r0 + 8 * hr;
        if (qpos >= Sq) continue;
        float* const out = dq + (((size_t)b * Sq + qpos) * H + h) * D + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int i = 4 * j + 2 * hr;
          *reinterpret_cast<float2*>(out + 8 * j) =
              make_float2((acc[i] + red[i * 128 + tid]) * scale,
                          (acc[i + 1] + red[(i + 1) * 128 + tid]) * scale);
        }
      }
    }
  }
}

// ------------------------------ f32, D = 256: split-bf16 wgmma, streamed chunks
// Three pieces of a 64-row K (or V) tile take 96 KB at D = 256, and of a
// 64-row Q (or dO) tile as much again, so nothing stays resident: each
// stage's operands stream through a ring of slots in 64-column chunks of
// the head dim (one chunk of every piece a slot), and the sums over D run
// chunk by chunk.  A stage is 2 NC ring loads: NC loads for the scores
// (S^T and dP^T, or S and dP) and NC again for the gradient products,
// which need the stage's scores whole before their first chunk.  K, V, Q
// and dO chunks are read again from L2 for every stage; the bytes that
// crossing costs bound these kernels as much as the six products do.
template <int D>
struct DkdvWideCfg {
  static constexpr int BKV = kRows;              // KV rows a block
  static constexpr int BQ = 32;                  // q rows a stage
  static constexpr int NC = D / CW;              // head-dim chunks
  static constexpr int kStages = 3;              // ring slots (2: 14% slower, NVIDIA H100)
  static constexpr int kKc = BKV * CW * 2;       // one piece of a chunk of the K tile (or V)
  static constexpr int kQc = BQ * CW * 2;        // one piece of a chunk of a stage's Q (or dO)
  static constexpr int kSlotBytes = 6 * kKc + 6 * kQc;  // K_c, V_c, Q_c, dO_c pieces
  static constexpr int kPBytes = BKV * BQ * 4;   // f32 P^T, consumer 0 to consumer 1
  static constexpr int kStatBytes = 2 * BQ * 4;  // a stage's lse2 and Di rows, one set a slot
  static constexpr int kBarBytes = 8 * 2 * kStages;
  static constexpr size_t kSmem =
      1024 + kStages * (kSlotBytes + kStatBytes) + kPBytes + kBarBytes;
};

// dK/dV on split-bf16 operands at D = 256: one block per (64-row KV tile,
// KV head, batch), longest first; stages of 32 q rows (head of the group,
// q tile) from the causal frontier on.  Consumer 0 sums S^T = K.Q^T and
// consumer 1 dP^T = V.dO^T over the NC chunks (six products of pieces a
// chunk, smallest first, into one accumulator), P^T goes from consumer 0
// to consumer 1 as in dkdv_split, then each chunk c of the stage's dO (Q)
// gives dV's (dK's) columns of chunk c: six products of P^T's (dS^T's)
// pieces from registers into a fresh 64 x 64 accumulator, added to the
// running 64 x 256 f32 sum in registers (128 a thread).  lse2 and Di, di:
// (B, H, Sqp) f32 from bwd_prep; dk, dv f32.
template <int D>
__global__ void __launch_bounds__(kThreads, 1) dkdv_split_wide(
    const __grid_constant__ SplitMaps maps, const float* __restrict__ lse2,
    const float* __restrict__ di, float* __restrict__ dk, float* __restrict__ dv, int Sq,
    int Sqp, int Sk, int H, int K, int causal, float c, float scale) {
  using C = DkdvWideCfg<D>;
  constexpr int BKV = C::BKV, BQ = C::BQ, NC = C::NC, S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t ring = base;                             // [slot]: K_c, V_c [piece][BKV][CW], Q_c, dO_c [piece][BQ][CW]
  const uint32_t stat = ring + S * C::kSlotBytes;         // [slot]: lse2, Di rows
  const uint32_t p_s = stat + S * C::kStatBytes;          // f32 P^T in accumulator order
  const uint32_t bars = p_s + C::kPBytes;                 // full[slots], empty[slots]
  auto full_bar = [&](int s) { return bars + 8u * s; };
  auto empty_bar = [&](int s) { return bars + 8u * (S + s); };
  auto slot = [&](int s) { return ring + s * C::kSlotBytes; };

  const int b = blockIdx.x / K, kvh = blockIdx.x - b * K, G = H / K;
  const int k0 = blockIdx.y * BKV;  // the first KV tiles, the longest under causal, first
  const int n_q = (Sq + BQ - 1) / BQ;
  const int first_q = causal ? min(k0 / BQ, n_q) : 0;  // q tiles holding a row >= k0
  const int n_qt = n_q - first_q, n_it = G * n_qt;     // stages: (head of the group, q tile)
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(full_bar(s), 1);
      hopper::mbar_init(empty_bar(s), 2 * 128);  // every consumer thread arrives
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // ------------------------------------------ producer
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      for (int it = 0; it < n_it; ++it) {
        const int g = it / n_qt, q0 = (first_q + it - g * n_qt) * BQ, h = kvh * G + g;
        for (int l = 0; l < 2 * NC; ++l) {
          const int r = it * 2 * NC + l, s = r % S, cc = l % NC;
          const uint32_t sl = slot(s);
          hopper::mbar_wait(empty_bar(s), ((r / S) & 1) ^ 1);
          hopper::mbar_expect_tx(full_bar(s), 6 * C::kQc + (l < NC ? 6 * C::kKc : 0) +
                                                  (l == 0 ? C::kStatBytes : 0));
#pragma unroll
          for (int piece = 0; piece < 3; ++piece) {
            const uint32_t qo = sl + 6 * C::kKc + piece * C::kQc;
            hopper::tma_load_4d(qo, &maps.q[piece], full_bar(s), cc * CW, h, q0, b);
            hopper::tma_load_4d(qo + 3 * C::kQc, &maps.g[piece], full_bar(s), cc * CW, h, q0, b);
            if (l < NC) {
              const uint32_t ko = sl + piece * C::kKc;
              hopper::tma_load_4d(ko, &maps.k[piece], full_bar(s), cc * CW, kvh, k0, b);
              hopper::tma_load_4d(ko + 3 * C::kKc, &maps.v[piece], full_bar(s), cc * CW, kvh, k0,
                                  b);
            }
          }
          if (l == 0) {
            const size_t row = ((size_t)b * H + h) * Sqp + q0;
            hopper::bulk_load(stat + s * C::kStatBytes, lse2 + row, BQ * 4, full_bar(s));
            hopper::bulk_load(stat + s * C::kStatBytes + BQ * 4, di + row, BQ * 4, full_bar(s));
          }
        }
      }
    }
  } else {  // ----------------------------------------------- consumers
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int warp = tid / 32, lane = tid % 32;
    const int kr0 = k0 + 16 * warp + lane / 4;  // this thread's KV rows: kr0 and kr0 + 8
    float* const pbuf = reinterpret_cast<float*>(gbase + (p_s - base));
    float acc[D / 2], x[BQ / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) x[i] = 0.f;

    for (int it = 0; it < n_it; ++it) {
      const int g = it / n_qt, q0 = (first_q + it - g * n_qt) * BQ;
      const int r1 = it * 2 * NC;  // the stage's first ring load
      // S^T = K.Q^T (consumer 0) or dP^T = V.dO^T (consumer 1), chunk by
      // chunk of the head dim, six products of pieces each, all K-major
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int r = r1 + cc, s = r % S;
        const uint32_t sl = slot(s);
        const uint32_t a_s = sl + (wg == 0 ? 0 : 3 * C::kKc);
        const uint32_t b_s = sl + 6 * C::kKc + (wg == 0 ? 0 : 3 * C::kQc);
        hopper::mbar_wait(full_bar(s), (r / S) & 1);
        hopper::wgmma_fence();
#pragma unroll
        for (int t = 0; t < 6; ++t)
#pragma unroll
          for (int kk = 0; kk < CW / 16; ++kk)
            hopper::wgmma_ss(x, kmajor<BKV>(a_s + term_a(t) * C::kKc, 0, kk),
                             kmajor<BQ>(b_s + term_b(t) * C::kQc, 0, kk), cc > 0 || t > 0 || kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(x);
        hopper::mbar_arrive(empty_bar(s));
      }
      const float* const l2s =
          reinterpret_cast<const float*>(gbase + (stat + (r1 % S) * C::kStatBytes - base));
      const float* const dis = l2s + BQ;

      if (wg == 0) {
        if (it > 0) hopper::named_sync<256>(kPairBar);  // consumer 1 has read the last P^T
        // P^T = exp2(S^T c - lse2), masked entries 0, to consumer 1 in the
        // accumulator's order (thread-contiguous: no bank conflicts)
        const bool edge = (causal && k0 + BKV - 1 > q0) || q0 + BQ > Sq || k0 + BKV > Sk;
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const int col = 8 * j + 2 * (lane % 4);
          const float2 l2 = *reinterpret_cast<const float2*>(l2s + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            float p = exp2f(fmaf(x[i], c, -((e & 1) ? l2.y : l2.x)));
            if (edge) {
              const int qpos = q0 + col + (e & 1), kpos = kr0 + 8 * (e >> 1);
              if (qpos >= Sq || kpos >= Sk || (causal && kpos > qpos)) p = 0.f;
            }
            x[i] = p;
            pbuf[i * 128 + tid] = p;
          }
        }
        hopper::named_arrive<256>(kPairBar + 1);  // P^T written
      } else {  // dS^T = P^T (dP^T - Di)
        hopper::named_sync<256>(kPairBar + 1);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 dd = *reinterpret_cast<const float2*>(dis + 8 * j + 2 * (lane % 4));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            x[i] = pbuf[i * 128 + tid] * (x[i] - ((e & 1) ? dd.y : dd.x));
          }
        }
        hopper::named_arrive<256>(kPairBar);  // P^T read
      }

      // P^T (or dS^T) in bf16 hi, mid and lo pieces as A operands from
      // registers; chunk c of dO (or Q), MN-major, gives dV's (dK's)
      // columns of chunk c: six products of pieces into a fresh
      // accumulator, added to the running sum in f32
      uint32_t xa[3][BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          hopper::split3_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1], xa[0][kk][e],
                              xa[1][kk][e], xa[2][kk][e]);
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int r = r1 + NC + cc, s = r % S;
        const uint32_t c_s = slot(s) + 6 * C::kKc + (wg == 0 ? 3 * C::kQc : 0);
        hopper::mbar_wait(full_bar(s), (r / S) & 1);
        float tile[CW / 2];
        hopper::wgmma_fence();
#pragma unroll
        for (int t = 0; t < 6; ++t)
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)
            hopper::wgmma_rs(tile, xa[term_a(t)][kk], mnmajor<BQ>(c_s + term_b(t) * C::kQc, kk),
                             t > 0 || kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(tile);
#pragma unroll
        for (int i = 0; i < CW / 2; ++i) acc[cc * (CW / 2) + i] += tile[i];
        hopper::mbar_arrive(empty_bar(s));
      }
    }

    if (wg == 0 && n_it > 0) hopper::named_sync<256>(kPairBar);  // the last P^T read
    // dV (consumer 0) or dK times the scale (consumer 1), f32, 8 bytes a
    // thread, rows < Sk
    float* const out = wg == 0 ? dv : dk;
    const float mul = wg == 0 ? 1.f : scale;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int kpos = kr0 + 8 * hr;
      if (kpos >= Sk) continue;
      float* const row = out + (((size_t)b * Sk + kpos) * K + kvh) * D + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(row + 8 * j) =
            make_float2(acc[4 * j + 2 * hr] * mul, acc[4 * j + 2 * hr + 1] * mul);
    }
  }
}

template <int D>
struct DqWideCfg {
  static constexpr int BK = 64;                  // KV rows a stage: 32 a consumer
  static constexpr int NC = D / CW;              // head-dim chunks
  static constexpr int kStages = 2;              // ring slots
  static constexpr int kQc = kRows * CW * 2;     // one piece of a chunk of the block's Q (or dO)
  static constexpr int kKc = BK * CW * 2;        // one piece of a chunk of a stage's K (or V)
  static constexpr int kSlotBytes = 6 * kQc + 6 * kKc;  // Q_c, dO_c, K_c, V_c pieces
  static constexpr int kBarBytes = 8 * 2 * kStages;
  static constexpr size_t kSmem = 1024 + kStages * kSlotBytes + kBarBytes;
};

// dQ on split-bf16 operands at D = 256: one block per (batch * head, 64-row
// q tile), longest first; stages of 64 KV rows, consumer w taking rows 32 w
// .. 32 w + 31 of each.  Per stage each sums S = Q.K_w^T and dP = dO.V_w^T
// over the NC chunks (six products of pieces a chunk), P and dS in
// registers, then each chunk c of K gives dQ's columns of chunk c: six
// products of dS's pieces into a fresh accumulator added to the running
// 64 x 256 f32 sum.  Consumer 1's sum is added to consumer 0's once at the
// end, in a fixed order.  dq f32.
template <int D>
__global__ void __launch_bounds__(kThreads, 1) dq_split_wide(
    const __grid_constant__ SplitMaps maps, const float* __restrict__ lse2,
    const float* __restrict__ di, float* __restrict__ dq, int Sq, int Sqp, int Sk, int H, int K,
    int causal, float c, float scale) {
  using C = DqWideCfg<D>;
  constexpr int BK = C::BK, NC = C::NC, S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t ring = base;  // [slot]: Q_c, dO_c [piece][64][CW], K_c, V_c [piece][BK][CW]
  const uint32_t bars = ring + S * C::kSlotBytes;  // full[slots], empty[slots]
  auto full_bar = [&](int s) { return bars + 8u * s; };
  auto empty_bar = [&](int s) { return bars + 8u * (S + s); };
  auto slot = [&](int s) { return ring + s * C::kSlotBytes; };

  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const int kvh = h / (H / K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest causal rows first
  int n_kv = (Sk + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (q0 + kRows - 1) / BK + 1);  // stages at or before the last row
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(full_bar(s), 1);
      hopper::mbar_init(empty_bar(s), 2 * 128);  // every consumer thread arrives
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // ------------------------------------------ producer
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      for (int j = 0; j < n_kv; ++j)
        for (int l = 0; l < 2 * NC; ++l) {
          const int r = j * 2 * NC + l, s = r % S, cc = l % NC;
          const uint32_t sl = slot(s);
          hopper::mbar_wait(empty_bar(s), ((r / S) & 1) ^ 1);
          hopper::mbar_expect_tx(full_bar(s), 3 * C::kKc + (l < NC ? 6 * C::kQc + 3 * C::kKc : 0));
#pragma unroll
          for (int piece = 0; piece < 3; ++piece) {
            const uint32_t ko = sl + 6 * C::kQc + piece * C::kKc;
            hopper::tma_load_4d(ko, &maps.k[piece], full_bar(s), cc * CW, kvh, j * BK, b);
            if (l < NC) {
              const uint32_t qo = sl + piece * C::kQc;
              hopper::tma_load_4d(qo, &maps.q[piece], full_bar(s), cc * CW, h, q0, b);
              hopper::tma_load_4d(qo + 3 * C::kQc, &maps.g[piece], full_bar(s), cc * CW, h, q0, b);
              hopper::tma_load_4d(ko + 3 * C::kKc, &maps.v[piece], full_bar(s), cc * CW, kvh,
                                  j * BK, b);
            }
          }
        }
    }
  } else {  // ----------------------------------------------- consumers
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int warp = tid / 32, lane = tid % 32;
    const int r0 = q0 + 16 * warp + lane / 4;  // this thread's rows: r0 and r0 + 8
    const size_t row = ((size_t)b * H + h) * Sqp;
    const float l2_0 = r0 < Sq ? lse2[row + r0] : 0.f, l2_1 = r0 + 8 < Sq ? lse2[row + r0 + 8] : 0.f;
    const float di_0 = r0 < Sq ? di[row + r0] : 0.f, di_1 = r0 + 8 < Sq ? di[row + r0 + 8] : 0.f;

    float acc[D / 2], s[BK / 4], dp[BK / 4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) s[i] = dp[i] = 0.f;

    for (int j = 0; j < n_kv; ++j) {
      const int kw0 = j * BK + 32 * wg;  // this consumer's first key of the stage
      const int r1 = j * 2 * NC;
      // S = Q.K_w^T and dP = dO.V_w^T, chunk by chunk, six products of
      // pieces each, all K-major, one commit group each
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int r = r1 + cc, st = r % S;
        const uint32_t sl = slot(st), ks = sl + 6 * C::kQc;
        hopper::mbar_wait(full_bar(st), (r / S) & 1);
        hopper::wgmma_fence();
#pragma unroll
        for (int t = 0; t < 6; ++t)
#pragma unroll
          for (int kk = 0; kk < CW / 16; ++kk)
            hopper::wgmma_ss(s, kmajor<kRows>(sl + term_a(t) * C::kQc, 0, kk),
                             kmajor<BK>(ks + term_b(t) * C::kKc, 32 * wg, kk),
                             cc > 0 || t > 0 || kk > 0);
        hopper::wgmma_commit();
#pragma unroll
        for (int t = 0; t < 6; ++t)
#pragma unroll
          for (int kk = 0; kk < CW / 16; ++kk)
            hopper::wgmma_ss(dp, kmajor<kRows>(sl + (3 + term_a(t)) * C::kQc, 0, kk),
                             kmajor<BK>(ks + (3 + term_b(t)) * C::kKc, 32 * wg, kk),
                             cc > 0 || t > 0 || kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        hopper::fence_regs(dp);
        hopper::mbar_arrive(empty_bar(st));
      }

      const bool edge = kw0 + 32 > Sk || (causal && kw0 + 31 > q0);
#pragma unroll
      for (int jj = 0; jj < BK / 16; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * jj + e, hr = e >> 1;
          float p = exp2f(fmaf(s[x], c, -(hr ? l2_1 : l2_0)));
          if (edge) {
            const int kpos = kw0 + 8 * jj + 2 * (lane % 4) + (e & 1), qpos = r0 + 8 * hr;
            if (kpos >= Sk || (causal && kpos > qpos)) p = 0.f;
          }
          dp[x] = p * (dp[x] - (hr ? di_1 : di_0));
        }
      // dS in bf16 hi, mid and lo as A operands from registers; chunk c of
      // K_w (MN-major: a k16 step is 16 key rows) gives dQ's columns of
      // chunk c, six products of pieces into a fresh accumulator added to
      // the running sum in f32
      uint32_t da[3][2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          hopper::split3_bf16(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1], da[0][kk][e],
                              da[1][kk][e], da[2][kk][e]);
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int r = r1 + NC + cc, st = r % S;
        const uint32_t ks = slot(st) + 6 * C::kQc;
        hopper::mbar_wait(full_bar(st), (r / S) & 1);
        float tile[CW / 2];
        hopper::wgmma_fence();
#pragma unroll
        for (int t = 0; t < 6; ++t)
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
            hopper::wgmma_rs(tile, da[term_a(t)][kk],
                             mnmajor<BK>(ks + term_b(t) * C::kKc, 2 * wg + kk), t > 0 || kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(tile);
#pragma unroll
        for (int i = 0; i < CW / 2; ++i) acc[cc * (CW / 2) + i] += tile[i];
        hopper::mbar_arrive(empty_bar(st));
      }
    }

    // dQ = (consumer 0's sum + consumer 1's) * scale: consumer 1's partial
    // sum passes through the ring (every load consumed), in accumulator order
    float* const red = reinterpret_cast<float*>(gbase + (ring - base));
    hopper::named_sync<256>(kPairBar);
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) red[i * 128 + tid] = acc[i];
    }
    hopper::named_sync<256>(kPairBar);
    if (wg == 0) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int qpos = r0 + 8 * hr;
        if (qpos >= Sq) continue;
        float* const out = dq + (((size_t)b * Sq + qpos) * H + h) * D + 2 * (lane % 4);
#pragma unroll
        for (int jx = 0; jx < D / 8; ++jx) {
          const int i = 4 * jx + 2 * hr;
          *reinterpret_cast<float2*>(out + 8 * jx) =
              make_float2((acc[i] + red[i * 128 + tid]) * scale,
                          (acc[i + 1] + red[(i + 1) * 128 + tid]) * scale);
        }
      }
    }
  }
}

CUresult encode_map(CUtensorMap* map, const void* ptr, int D, int heads, int S, int B,
                    int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  // the forward's swizzle: boxes of 64 columns from D 64 on, of D columns below
  const cuuint32_t box[4] = {(cuuint32_t)(D >= 64 ? CW : D), 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                packed::swizzle_of(D), CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// lse2, di: the (B, H, Sqp) f32 rows `bwd_prep` wrote.
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse2, const float* di, void* dq, void* dk, void* dv, int B,
                   int Sq, int Sqp, int Sk, int H, int K, int causal, float scale,
                   cudaStream_t st) {
  using CK = DkdvCfg<D>;
  using CQ = DqCfg<D>;
  Maps mk{}, mq{};
  if (encode_map(&mk.q, q, D, H, Sq, B, kRows) != CUDA_SUCCESS ||
      encode_map(&mk.g, dout, D, H, Sq, B, kRows) != CUDA_SUCCESS ||
      encode_map(&mk.k, k, D, K, Sk, B, kRows) != CUDA_SUCCESS ||
      encode_map(&mk.v, v, D, K, Sk, B, kRows) != CUDA_SUCCESS ||
      encode_map(&mq.k, k, D, K, Sk, B, CQ::BK) != CUDA_SUCCESS ||
      encode_map(&mq.v, v, D, K, Sk, B, CQ::BK) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  mq.q = mk.q;
  mq.g = mk.g;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(dkdv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)CK::kSmem)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)CQ::kSmem)) != cudaSuccess)
    return e;
  const float c = scale * kLog2e;
  dkdv_wgmma<D><<<dim3(B * K, (Sk + CK::BKV - 1) / CK::BKV), kThreads, CK::kSmem, st>>>(
      mk, lse2, di, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Sq, Sqp, Sk,
      H, K, causal, c, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  dq_wgmma<D><<<dim3(B * H, (Sq + 2 * kRows - 1) / (2 * kRows)), kThreads, CQ::kSmem, st>>>(
      mq, lse2, di, static_cast<__nv_bfloat16*>(dq), Sq, Sqp, Sk, H, K, causal, c, scale);
  return cudaGetLastError();
}

// which: 1 dK/dV, 2 dQ.
template <int D>
cudaError_t resources(int which, cudaFuncAttributes* a, size_t* dyn) {
  if (which == 1) {
    *dyn = DkdvCfg<D>::kSmem;
    return cudaFuncGetAttributes(a, dkdv_wgmma<D>);
  }
  *dyn = DqCfg<D>::kSmem;
  return cudaFuncGetAttributes(a, dq_wgmma<D>);
}

// The split route: qp, kp, vp, gp are the bf16 (hi, mid, lo) pieces of q,
// k, v and dO (the split pre-pass's output, 16-byte aligned); dq, dk, dv f32.
template <int D>
cudaError_t launch_split(const void* const* qp, const void* const* kp, const void* const* vp,
                         const void* const* gp, const float* lse2, const float* di, void* dq,
                         void* dk, void* dv, int B, int Sq, int Sqp, int Sk, int H, int K,
                         int causal, float scale, cudaStream_t st) {
  using CK = DkdvSplitCfg<D>;
  using CQ = DqSplitCfg<D>;
  SplitMaps mk{}, mq{};
  for (int i = 0; i < 3; ++i)
    if (encode_map(&mk.q[i], qp[i], D, H, Sq, B, CK::BQ) != CUDA_SUCCESS ||
        encode_map(&mk.g[i], gp[i], D, H, Sq, B, CK::BQ) != CUDA_SUCCESS ||
        encode_map(&mk.k[i], kp[i], D, K, Sk, B, CK::BKV) != CUDA_SUCCESS ||
        encode_map(&mk.v[i], vp[i], D, K, Sk, B, CK::BKV) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  // dQ's maps where its boxes differ from dK/dV's (below D 128 they are the
  // same: each encode is host time a small call feels)
  for (int i = 0; i < 3; ++i) {
    if (CK::BQ == kRows) {
      mq.q[i] = mk.q[i];
      mq.g[i] = mk.g[i];
    } else if (encode_map(&mq.q[i], qp[i], D, H, Sq, B, kRows) != CUDA_SUCCESS ||
               encode_map(&mq.g[i], gp[i], D, H, Sq, B, kRows) != CUDA_SUCCESS) {
      return cudaErrorInvalidValue;
    }
    if (CK::BKV == CQ::BK) {
      mq.k[i] = mk.k[i];
      mq.v[i] = mk.v[i];
    } else if (encode_map(&mq.k[i], kp[i], D, K, Sk, B, CQ::BK) != CUDA_SUCCESS ||
               encode_map(&mq.v[i], vp[i], D, K, Sk, B, CQ::BK) != CUDA_SUCCESS) {
      return cudaErrorInvalidValue;
    }
  }
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(dkdv_split<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)CK::kSmem)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(dq_split<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)CQ::kSmem)) != cudaSuccess)
    return e;
  const float c = scale * kLog2e;
  dkdv_split<D><<<dim3(B * K, (Sk + CK::BKV - 1) / CK::BKV), kThreads, CK::kSmem, st>>>(
      mk, lse2, di, static_cast<float*>(dk), static_cast<float*>(dv), Sq, Sqp, Sk, H, K, causal,
      c, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  dq_split<D><<<dim3(B * H, (Sq + kRows - 1) / kRows), kThreads, CQ::kSmem, st>>>(
      mq, lse2, di, static_cast<float*>(dq), Sq, Sqp, Sk, H, K, causal, c, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t split_resources(int which, cudaFuncAttributes* a, size_t* dyn) {
  if (which == 1) {
    *dyn = DkdvSplitCfg<D>::kSmem;
    return cudaFuncGetAttributes(a, dkdv_split<D>);
  }
  *dyn = DqSplitCfg<D>::kSmem;
  return cudaFuncGetAttributes(a, dq_split<D>);
}

// The split route at D = 256: as launch_split, on the streamed-chunk kernels.
template <int D>
cudaError_t launch_split_wide(const void* const* qp, const void* const* kp,
                              const void* const* vp, const void* const* gp, const float* lse2,
                              const float* di, void* dq, void* dk, void* dv, int B, int Sq,
                              int Sqp, int Sk, int H, int K, int causal, float scale,
                              cudaStream_t st) {
  using CK = DkdvWideCfg<D>;
  using CQ = DqWideCfg<D>;
  SplitMaps mk{}, mq{};
  for (int i = 0; i < 3; ++i)
    if (encode_map(&mk.q[i], qp[i], D, H, Sq, B, CK::BQ) != CUDA_SUCCESS ||
        encode_map(&mk.g[i], gp[i], D, H, Sq, B, CK::BQ) != CUDA_SUCCESS ||
        encode_map(&mk.k[i], kp[i], D, K, Sk, B, CK::BKV) != CUDA_SUCCESS ||
        encode_map(&mk.v[i], vp[i], D, K, Sk, B, CK::BKV) != CUDA_SUCCESS ||
        encode_map(&mq.q[i], qp[i], D, H, Sq, B, kRows) != CUDA_SUCCESS ||
        encode_map(&mq.g[i], gp[i], D, H, Sq, B, kRows) != CUDA_SUCCESS ||
        encode_map(&mq.k[i], kp[i], D, K, Sk, B, CQ::BK) != CUDA_SUCCESS ||
        encode_map(&mq.v[i], vp[i], D, K, Sk, B, CQ::BK) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(dkdv_split_wide<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)CK::kSmem)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(dq_split_wide<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)CQ::kSmem)) != cudaSuccess)
    return e;
  const float c = scale * kLog2e;
  dkdv_split_wide<D><<<dim3(B * K, (Sk + CK::BKV - 1) / CK::BKV), kThreads, CK::kSmem, st>>>(
      mk, lse2, di, static_cast<float*>(dk), static_cast<float*>(dv), Sq, Sqp, Sk, H, K, causal,
      c, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  dq_split_wide<D><<<dim3(B * H, (Sq + kRows - 1) / kRows), kThreads, CQ::kSmem, st>>>(
      mq, lse2, di, static_cast<float*>(dq), Sq, Sqp, Sk, H, K, causal, c, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t split_wide_resources(int which, cudaFuncAttributes* a, size_t* dyn) {
  if (which == 1) {
    *dyn = DkdvWideCfg<D>::kSmem;
    return cudaFuncGetAttributes(a, dkdv_split_wide<D>);
  }
  *dyn = DqWideCfg<D>::kSmem;
  return cudaFuncGetAttributes(a, dq_split_wide<D>);
}

}  // namespace tc

// ------------------------------------------- bf16, short sequences: packed
// One pass, one block a (U records, KV head): it holds the U units' keys and
// every q row that attends them, so it sums dK and dV over its rows in a
// fixed order and writes dq, dk and dv once each.
namespace pk {

using hopper::pack_bf16;
using packed::at;
using packed::Geo;
using packed::kRows;
using packed::kThreads;

// dK and dV as m16n8 tiles (16 keys x 8 head-dim columns), kPerWarp a warp.
template <int D, int N>
struct BwdCfg {
  static constexpr int kQBytes = kRows * D * 2;                     // a band of q; of dO
  static constexpr int kKVBytes = (N * D * 2 + 1023) / 1024 * 1024;  // K, V (then dK, dV)
  static constexpr int PS = (N + 8) * 2;  // bytes of a row of P or dS (padded: no bank conflicts)
  static constexpr int kPBytes = (kRows * PS + 1023) / 1024 * 1024;
  static constexpr size_t kSmem = 1024 + 2 * kQBytes + 2 * kKVBytes + 2 * kPBytes + 8;
  static constexpr int kTiles = (N / 16) * (D / 8);
  static constexpr int kPerWarp = (kTiles + 7) / 8;
  // Two blocks an SM (at most 128 registers a thread) where the live f32
  // values (dK and dV tiles, S and dP, dS's fragments, a dQ pass) leave room.
  static constexpr int kMinBlocks = 8 * kPerWarp + N + N / 4 + (D < 64 ? D : 64) / 2 <= 120 ? 2 : 1;
};

struct BwdMaps {
  CUtensorMap q, g, k, v, dk, dv;
};

__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const uint32_t av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&av[i]));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bv[i]));
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
  return acc;
}

// o: the forward's output (Di's other factor, read straight from device
// memory); lse: the forward's (B, H, Sq) row lse.  A band is one tile of
// rows (all of them when the U units fit kRows; else P positions of the
// one unit, T bands in order).
template <int D, int N>
__global__ void __launch_bounds__(kThreads, BwdCfg<D, N>::kMinBlocks) packed_bwd(
    const __grid_constant__ BwdMaps maps, const __nv_bfloat16* __restrict__ o,
    const float* __restrict__ lse, __nv_bfloat16* __restrict__ dq, const Geo g, int causal,
    float c, float scale) {
  using C = BwdCfg<D, N>;
  constexpr int SW = packed::Sw<D>::SW, CW = packed::Sw<D>::CW, NC = packed::Sw<D>::NC;
  constexpr int DC = D < 64 ? D : 64;  // dQ columns a pass
  constexpr int PS = C::PS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t q_s = base, g_s = q_s + C::kQBytes, k_s = g_s + C::kQBytes;
  const uint32_t v_s = k_s + C::kKVBytes, p_s = v_s + C::kKVBytes, ds_s = p_s + C::kPBytes;
  const uint32_t bar = ds_s + C::kPBytes;
  auto sm = [&](uint32_t addr) { return gbase + (addr - base); };

  const int kv = blockIdx.x % g.K, b0 = (blockIdx.x / g.K) * g.U;
  const int unit_rows = g.G * g.P, box_rows = unit_rows * g.U, keys = g.U * g.Sk;
  const int n_ks = (box_rows + 15) / 16;  // 16-row steps of the dK / dV sums
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // Zero what no box writes and a product reads: K and V rows past U * Sk
  // (times p = 0), q and dO rows past the box (times P = dS = 0).
  for (int i = threadIdx.x; i < (N - keys) * (D / 8); i += kThreads) {
    const int row = keys + i / (D / 8), col = (i % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(sm(at<D>(k_s, N, row, col))) = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(sm(at<D>(v_s, N, row, col))) = make_uint4(0, 0, 0, 0);
  }
  for (int i = threadIdx.x; i < (kRows - box_rows) * (D / 8); i += kThreads) {
    const int row = box_rows + i / (D / 8), col = (i % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(sm(at<D>(q_s, kRows, row, col))) = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(sm(at<D>(g_s, kRows, row, col))) = make_uint4(0, 0, 0, 0);
  }
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  float acc_v[C::kPerWarp][4], acc_k[C::kPerWarp][4];
#pragma unroll
  for (int i = 0; i < C::kPerWarp; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_v[i][e] = acc_k[i][e] = 0.f;

  const int r0 = 16 * warp;
  for (int t = 0; t < g.T; ++t) {
    const int p0 = t * g.P;
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(bar, (2 * box_rows + (t == 0 ? 2 * keys : 0)) * D * 2);
      for (int cc = 0; cc < NC; ++cc) {
        hopper::tma_load_5d(q_s + cc * kRows * SW, &maps.q, bar, cc * CW, 0, kv, p0, b0);
        hopper::tma_load_5d(g_s + cc * kRows * SW, &maps.g, bar, cc * CW, 0, kv, p0, b0);
        if (t == 0) {
          hopper::tma_load_4d(k_s + cc * N * SW, &maps.k, bar, cc * CW, kv, 0, b0);
          hopper::tma_load_4d(v_s + cc * N * SW, &maps.v, bar, cc * CW, kv, 0, b0);
        }
      }
    }
    // This thread's rows (r, r + 8): the keys they attend [lo, hi), their
    // place in dq (or -1 past the tensor) and the lse in log2 units; and
    // their O (Di's other factor: 16-byte units lane % 4, + 4, ...), read
    // while the band's loads land (at D 256 after, for registers).
    constexpr int kOU = D < 32 ? 1 : D / 32;                // O's units a row a thread
    constexpr int kPre = D <= 128 ? kOU : 0;                // of them read early
    int lo[2], hi[2];
    long long row_off[2];
    float lse2[2];
    uint4 ov[2][kPre > 0 ? kPre : 1];
    if (r0 < box_rows) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = r0 + lane / 4 + 8 * hr;
        const int u = r / unit_rows, rr = r - u * unit_rows;
        const int pos = p0 + rr / g.G, b = b0 + u, h = kv * g.G + rr % g.G;
        const bool valid = r < box_rows && b < g.B && pos < g.Sq;
        lo[hr] = u * g.Sk;
        hi[hr] = !valid ? lo[hr] : lo[hr] + (causal ? min(g.Sk, pos + 1) : g.Sk);
        row_off[hr] = valid ? (((long long)b * g.Sq + pos) * g.H + h) * D : -1;
        lse2[hr] = valid ? lse[((size_t)b * g.H + h) * g.Sq + pos] * kLog2e : 0.f;
#pragma unroll
        for (int i = 0; i < kPre; ++i) {
          const int u8 = lane % 4 + 4 * i;
          ov[hr][i] = valid && u8 < D / 8
                          ? *reinterpret_cast<const uint4*>(o + row_off[hr] + 8 * u8)
                          : make_uint4(0, 0, 0, 0);
        }
      }
    }
    hopper::mbar_wait(bar, t & 1);

    if (r0 < box_rows) {
      float di[2];  // Di = rowsum(dO * O), a fixed order
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = r0 + lane / 4 + 8 * hr;
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < kOU; ++i) {
          const int u8 = lane % 4 + 4 * i;
          if (u8 < D / 8) {
            const uint4 og = i < kPre ? ov[hr][i < kPre ? i : 0]
                             : row_off[hr] >= 0
                                 ? *reinterpret_cast<const uint4*>(o + row_off[hr] + 8 * u8)
                                 : make_uint4(0, 0, 0, 0);
            acc += dot8(og, *reinterpret_cast<const uint4*>(sm(at<D>(g_s, kRows, r, 8 * u8))));
          }
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        di[hr] = acc;
      }

      // S = Q.K^T and dP = dO.V^T
      float s[N / 8][4], dp[N / 8][4];
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int arow = r0 + lane % 8 + 8 * (lane / 8 % 2), acol = kk * 16 + 8 * (lane / 16);
        uint32_t aq[4], ag[4];
        hopper::ldsm_x4(aq, at<D>(q_s, kRows, arow, acol));
        hopper::ldsm_x4(ag, at<D>(g_s, kRows, arow, acol));
#pragma unroll
        for (int nb = 0; nb < N / 16; ++nb) {
          const int brow = nb * 16 + lane % 8 + 8 * (lane / 16);
          const int bcol = kk * 16 + 8 * (lane / 8 % 2);
          uint32_t bk[4], bv[4];
          hopper::ldsm_x4(bk, at<D>(k_s, N, brow, bcol));
          hopper::ldsm_x4(bv, at<D>(v_s, N, brow, bcol));
          hopper::mma_bf16(s[2 * nb], aq, bk[0], bk[1]);
          hopper::mma_bf16(s[2 * nb + 1], aq, bk[2], bk[3]);
          hopper::mma_bf16(dp[2 * nb], ag, bv[0], bv[1]);
          hopper::mma_bf16(dp[2 * nb + 1], ag, bv[2], bv[3]);
        }
      }
      // P = exp2(S c - lse2) (0 where masked), dS = P (dP - Di); both to
      // shared memory as bf16 rows for the dV and dK sums
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * (lane % 4) + (e & 1), hr = e >> 1;
          const float p =
              col >= lo[hr] && col < hi[hr] ? exp2f(fmaf(s[j][e], c, -lse2[hr])) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - di[hr]);
        }
      const int row = r0 + lane / 4;
      uint32_t da[N / 16][4];
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const uint32_t off = row * PS + (8 * j + 2 * (lane % 4)) * 2;
        *reinterpret_cast<uint32_t*>(sm(p_s + off)) = pack_bf16(s[j][0], s[j][1]);
        *reinterpret_cast<uint32_t*>(sm(p_s + off + 8 * PS)) = pack_bf16(s[j][2], s[j][3]);
        const uint32_t d01 = pack_bf16(dp[j][0], dp[j][1]), d23 = pack_bf16(dp[j][2], dp[j][3]);
        *reinterpret_cast<uint32_t*>(sm(ds_s + off)) = d01;
        *reinterpret_cast<uint32_t*>(sm(ds_s + off + 8 * PS)) = d23;
        da[j / 2][(j % 2) * 2] = d01;  // score tiles 2kk and 2kk + 1 are A fragment kk
        da[j / 2][(j % 2) * 2 + 1] = d23;
      }
      // dQ = scale dS.K, DC columns a pass, K read transposed, straight out
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += DC) {
        float aq[DC / 8][4];
#pragma unroll
        for (int j = 0; j < DC / 8; ++j) aq[j][0] = aq[j][1] = aq[j][2] = aq[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
          for (int nd = 0; nd < DC / 16; ++nd) {
            uint32_t b[4];
            hopper::ldsm_x4_trans(b, at<D>(k_s, N, kk * 16 + lane % 8 + 8 * (lane / 8 % 2),
                                           d0 + nd * 16 + 8 * (lane / 16)));
            hopper::mma_bf16(aq[2 * nd], da[kk], b[0], b[1]);
            hopper::mma_bf16(aq[2 * nd + 1], da[kk], b[2], b[3]);
          }
#pragma unroll
        for (int j = 0; j < DC / 8; ++j) {
          const int col = d0 + 8 * j + 2 * (lane % 4);
          if (row_off[0] >= 0)
            *reinterpret_cast<uint32_t*>(dq + row_off[0] + col) =
                pack_bf16(aq[j][0] * scale, aq[j][1] * scale);
          if (row_off[1] >= 0)
            *reinterpret_cast<uint32_t*>(dq + row_off[1] + col) =
                pack_bf16(aq[j][2] * scale, aq[j][3] * scale);
        }
      }
    }
    __syncthreads();  // every row of P and dS is in shared memory

    // dV += P^T.dO and dK += dS^T.Q over the band's rows, 16 a step, in
    // order: P^T and dS^T by ldmatrix.trans of the row-major P and dS, dO and
    // Q transposed as the B operand
#pragma unroll
    for (int i = 0; i < C::kPerWarp; ++i) {
      const int tile = warp * C::kPerWarp + i;
      if (tile < C::kTiles) {
        const int m0 = tile / (D / 8) * 16, d0 = tile % (D / 8) * 8;
        for (int ks = 0; ks < n_ks; ++ks) {
          const int k0 = 16 * ks, j = lane / 8;
          const uint32_t aoff = (k0 + lane % 8 + 8 * (j / 2)) * PS + (m0 + 8 * (j % 2)) * 2;
          const int brow = k0 + lane % 8 + 8 * (lane / 8 % 2);
          uint32_t ap[4], ad[4], bg0, bg1, bq0, bq1;
          hopper::ldsm_x4_trans(ap, p_s + aoff);
          hopper::ldsm_x4_trans(ad, ds_s + aoff);
          hopper::ldsm_x2_trans(bg0, bg1, at<D>(g_s, kRows, brow, d0));
          hopper::ldsm_x2_trans(bq0, bq1, at<D>(q_s, kRows, brow, d0));
          hopper::mma_bf16(acc_v[i], ap, bg0, bg1);
          hopper::mma_bf16(acc_k[i], ad, bq0, bq1);
        }
      }
    }
    __syncthreads();  // before the next band's loads and P, dS
  }

  // dK (scaled) and dV, bf16, staged in the K and V tiles (no longer read)
  // and written by TMA: rows past U * Sk stay out of the box, records past B
  // out of the tensor.
#pragma unroll
  for (int i = 0; i < C::kPerWarp; ++i) {
    const int tile = warp * C::kPerWarp + i;
    if (tile < C::kTiles) {
      const int row = tile / (D / 8) * 16 + lane / 4, col = tile % (D / 8) * 8 + 2 * (lane % 4);
      *reinterpret_cast<uint32_t*>(sm(at<D>(k_s, N, row, col))) =
          pack_bf16(acc_k[i][0] * scale, acc_k[i][1] * scale);
      *reinterpret_cast<uint32_t*>(sm(at<D>(k_s, N, row + 8, col))) =
          pack_bf16(acc_k[i][2] * scale, acc_k[i][3] * scale);
      *reinterpret_cast<uint32_t*>(sm(at<D>(v_s, N, row, col))) =
          pack_bf16(acc_v[i][0], acc_v[i][1]);
      *reinterpret_cast<uint32_t*>(sm(at<D>(v_s, N, row + 8, col))) =
          pack_bf16(acc_v[i][2], acc_v[i][3]);
    }
  }
  hopper::fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int cc = 0; cc < NC; ++cc) {
      hopper::tma_store_4d(&maps.dk, k_s + cc * N * SW, cc * CW, kv, 0, b0);
      hopper::tma_store_4d(&maps.dv, v_s + cc * N * SW, cc * CW, kv, 0, b0);
    }
    hopper::bulk_commit();
    hopper::bulk_wait_read<0>();
  }
}

template <int D, int N>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, void* dq, void* dk, void* dv, const Geo& g, int causal,
                   float scale, cudaStream_t st) {
  using C = BwdCfg<D, N>;
  BwdMaps maps{};
  if (packed::q_map(&maps.q, q, g, D) != CUDA_SUCCESS ||
      packed::q_map(&maps.g, dout, g, D) != CUDA_SUCCESS ||
      packed::kv_map(&maps.k, k, g, D) != CUDA_SUCCESS ||
      packed::kv_map(&maps.v, v, g, D) != CUDA_SUCCESS ||
      packed::kv_map(&maps.dk, dk, g, D) != CUDA_SUCCESS ||
      packed::kv_map(&maps.dv, dv, g, D) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(packed_bwd<D, N>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)((g.B + g.U - 1) / g.U) * g.K;
  packed_bwd<D, N><<<(unsigned)blocks, kThreads, C::kSmem, st>>>(
      maps, static_cast<const __nv_bfloat16*>(o), lse, static_cast<__nv_bfloat16*>(dq), g,
      causal, scale * kLog2e, scale);
  return cudaGetLastError();
}

template <int D, int N>
cudaError_t resources(cudaFuncAttributes* a, size_t* dyn) {
  *dyn = BwdCfg<D, N>::kSmem;
  return cudaFuncGetAttributes(a, packed_bwd<D, N>);
}

}  // namespace pk

cudaError_t dispatch_packed(int D, int N, const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const float* lse, void* dq,
                            void* dk, void* dv, const packed::Geo& g, int causal, float scale,
                            cudaStream_t st) {
  PACKED_DISPATCH(pk::launch, q, k, v, o, dout, lse, dq, dk, dv, g, causal, scale, st)
}

cudaError_t dispatch_packed_resources(int D, int N, cudaFuncAttributes* a, size_t* dyn) {
  PACKED_DISPATCH(pk::resources, a, dyn)
}

// The tensor-core route's head dims.
#define BWD_TC_DISPATCH(FN, ...)                 \
  switch (D) {                                   \
    case 16: return FN<16>(__VA_ARGS__);         \
    case 32: return FN<32>(__VA_ARGS__);         \
    case 64: return FN<64>(__VA_ARGS__);         \
    case 128: return FN<128>(__VA_ARGS__);       \
    case 256: return FN<256>(__VA_ARGS__);       \
    default: return cudaErrorInvalidValue;       \
  }

// The split route's head dims (D = 256 on the streamed-chunk kernels).
#define BWD_SPLIT_DISPATCH(FN, FN_WIDE, ...)     \
  switch (D) {                                   \
    case 16: return FN<16>(__VA_ARGS__);         \
    case 32: return FN<32>(__VA_ARGS__);         \
    case 64: return FN<64>(__VA_ARGS__);         \
    case 128: return FN<128>(__VA_ARGS__);       \
    case 256: return FN_WIDE<256>(__VA_ARGS__);  \
    default: return cudaErrorInvalidValue;       \
  }

bool bad_shape(int B, int Sq, int Sk, int H, int K) {
  return B < 1 || Sq < 1 || Sk < 1 || K < 1 || H % K != 0 || (long long)B * H > 2147483647LL;
}

cudaError_t dispatch_tc(int D, const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, float* stats, void* dq, void* dk,
                        void* dv, int B, int Sq, int Sk, int H, int K, int causal, float scale,
                        cudaStream_t st) {
  const int Sqp = (Sq + tc::kRows - 1) / tc::kRows * tc::kRows;
  if ((long long)B * H * Sqp > INT_MAX) return cudaErrorInvalidValue;
  const int rows = B * H * Sqp;
  float* const di = stats + rows;
  cudaError_t e = launch_prep<__nv_bfloat16>(o, dout, lse, stats, di, rows, Sq, Sqp, H, D,
                                             kLog2e, st);
  if (e != cudaSuccess) return e;
  BWD_TC_DISPATCH(tc::launch, q, k, v, dout, stats, di, dq, dk, dv, B, Sq, Sqp, Sk, H, K, causal,
                  scale, st)
}

// The split route: q, k, v and dout (f32) into their bf16 pieces in
// `pieces` ([q, k, v, dout][hi, mid, lo], each piece contiguous in its
// operand's shape), then the pre-pass and the kernels.
cudaError_t dispatch_split(int D, const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const float* lse, float* stats,
                           __nv_bfloat16* pieces, void* dq, void* dk, void* dv, int B, int Sq,
                           int Sk, int H, int K, int causal, float scale, cudaStream_t st) {
  const int Sqp = (Sq + tc::kRows - 1) / tc::kRows * tc::kRows;
  if ((long long)B * H * Sqp > INT_MAX) return cudaErrorInvalidValue;
  const long long nq = (long long)B * Sq * H * D, nk = (long long)B * Sk * K * D;
  const void* src[4] = {q, k, v, dout};
  const long long n[4] = {nq, nk, nk, nq};
  void* p[4][3];
  __nv_bfloat16* at = pieces;
  for (int t = 0; t < 4; ++t)
    for (int i = 0; i < 3; ++i, at += n[t]) p[t][i] = at;
  cudaError_t e = split::launch_segments(4, src, p, n, st);
  if (e != cudaSuccess) return e;
  const int rows = B * H * Sqp;
  float* const di = stats + rows;
  e = launch_prep<float>(o, dout, lse, stats, di, rows, Sq, Sqp, H, D, kLog2e, st);
  if (e != cudaSuccess) return e;
  const void* const* qp = p[0];
  const void* const* kp = p[1];
  const void* const* vp = p[2];
  const void* const* gp = p[3];
  BWD_SPLIT_DISPATCH(tc::launch_split, tc::launch_split_wide, qp, kp, vp, gp, stats, di, dq, dk,
                     dv, B, Sq, Sqp, Sk, H, K, causal, scale, st)
}

cudaError_t dispatch_resources(int D, int is_bf16, int which, cudaFuncAttributes* a,
                               size_t* dyn) {
  if (which == 0) {
    *dyn = 0;
    return is_bf16 ? cudaFuncGetAttributes(a, bwd_prep<__nv_bfloat16>)
                   : cudaFuncGetAttributes(a, bwd_prep<float>);
  }
  if (!is_bf16) BWD_SPLIT_DISPATCH(tc::split_resources, tc::split_wide_resources, which, a, dyn)
  BWD_TC_DISPATCH(tc::resources, which, a, dyn)
}

}  // namespace

extern "C" {

// The tensor-core route: bf16, D in {16, 32, 64, 128, 256}.  q, o, dout, dq:
// (B, Sq, H, D); k, v, dk, dv: (B, Sk, K, D); all contiguous, q, k, v and
// dout 16-byte aligned (TMA); lse: (B, H, Sq) f32, the forward's; stats:
// (2, B, H, Sqp) f32 scratch, Sqp = Sq rounded up to a multiple of 64,
// 16-byte aligned.  Launches
// bwd_prep, tc::dkdv_wgmma and tc::dq_wgmma on `stream`; any other D or a
// misaligned pointer returns cudaErrorInvalidValue and launches nothing.
int flash_attention_bwd_tc_launch(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, const void* lse, void* stats, void* dq,
                                  void* dk, void* dv, int B, int Sq, int Sk, int H, int K, int D,
                                  int causal, float scale, void* stream) {
  if (bad_shape(B, Sq, Sk, H, K) ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout | (uintptr_t)stats |
       (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch_tc(D, q, k, v, o, dout, static_cast<const float*>(lse),
                          static_cast<float*>(stats), dq, dk, dv, B, Sq, Sk, H, K, causal, scale,
                          static_cast<cudaStream_t>(stream));
}

// The split route: f32, D in {16, 32, 64, 128, 256}.  q, k, v, o, dout and
// the gradients f32, shaped and aligned as on the tensor-core route; lse,
// stats as there; pieces: bf16 scratch of 3 (2 B Sq H D + 2 B Sk K D)
// elements, 16-byte aligned.  Launches split_bf16_segments on q, k, v and
// dout (one launch, into pieces: [q, k, v, dout][hi, mid, lo]), bwd_prep,
// tc::dkdv_split and tc::dq_split (at D 256 tc::dkdv_split_wide and
// tc::dq_split_wide) on `stream`; any other D or a misaligned pointer
// returns cudaErrorInvalidValue and launches nothing.
int flash_attention_bwd_split_launch(const void* q, const void* k, const void* v, const void* o,
                                     const void* dout, const void* lse, void* stats, void* pieces,
                                     void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
                                     int K, int D, int causal, float scale, void* stream) {
  if (bad_shape(B, Sq, Sk, H, K) || (D != 16 && D != 32 && D != 64 && D != 128 && D != 256) ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout | (uintptr_t)stats |
       (uintptr_t)pieces | (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch_split(D, q, k, v, o, dout, static_cast<const float*>(lse),
                             static_cast<float*>(stats), static_cast<__nv_bfloat16*>(pieces), dq,
                             dk, dv, B, Sq, Sk, H, K, causal, scale,
                             static_cast<cudaStream_t>(stream));
}

// Registers a thread (at launch), shared memory a block (static plus
// dynamic) and local memory a thread (spills) of kernel `which` (0 prep, 1
// dK/dV, 2 dQ) of the tensor-core route (the split route in f32) at head dim D.
int flash_attention_bwd_resources(int D, int is_bf16, int which, int* regs, int* smem,
                                  int* local) {
  cudaFuncAttributes a;
  size_t dyn = 0;
  const cudaError_t e = dispatch_resources(D, is_bf16, which, &a, &dyn);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *smem = (int)(a.sharedSizeBytes + dyn);
  *local = (int)a.localSizeBytes;
  return 0;
}

// The packed route (bf16, short sequences), one kernel in one pass: q, o,
// dout, dq (B, Sq, H, D); k, v, dk, dv (B, Sk, K, D); all contiguous, q, k,
// v, dout, dk and dv 16-byte aligned (TMA), o and dq 4-byte aligned; lse
// (B, H, Sq) f32, the forward's; U, P, T and N the wrapper's packed_plan.  A
// plan or a head dim the kernel does not take returns cudaErrorInvalidValue
// and launches nothing.
int flash_attention_bwd_packed_launch(const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, const void* lse, void* dq, void* dk,
                                      void* dv, int B, int Sq, int Sk, int H, int K, int D,
                                      int U, int P, int T, int N, int causal, float scale,
                                      void* stream) {
  if (K < 1 || H % K != 0) return (int)cudaErrorInvalidValue;
  const packed::Geo g{B, Sq, Sk, H, K, H / K, U, P, T};
  if (packed::bad_geo(g, N) ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout | (uintptr_t)dk |
       (uintptr_t)dv | (uintptr_t)o % 4 | (uintptr_t)dq % 4) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch_packed(D, N, q, k, v, o, dout, static_cast<const float*>(lse), dq, dk, dv,
                              g, causal, scale, static_cast<cudaStream_t>(stream));
}

// The packed kernel's registers a thread, shared memory a block (static plus
// dynamic) and local memory a thread at (D, N).
int flash_attention_bwd_packed_resources(int D, int N, int* regs, int* smem, int* local) {
  cudaFuncAttributes a;
  size_t dyn = 0;
  const cudaError_t e = dispatch_packed_resources(D, N, &a, &dyn);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *smem = (int)(a.sharedSizeBytes + dyn);
  *local = (int)a.localSizeBytes;
  return 0;
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
