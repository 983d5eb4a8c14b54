// Fused whole-cascade proxy scoring for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `cascade_score` in
// src/repro/kernels/proxy_score.py (kernel body `_make_cascade_kernel`,
// pallas_call in `cascade_score`), together with the survivor compaction
// that function's wrapper assembles with a cumsum and a scatter.
//
// What it computes, for a record tile x (N, F) and a packed cascade of P
// stages with HP stacked hidden units (h-major, any readout matrix w2):
//
//   hid    = relu(x @ w1 + b1)                      (N, HP)  never stored
//   s      = (hid @ w2) * out_scale + b2            (N, P)   optional output
//   mask   = (s >= thr) & (row < n_valid)           (N, P)   bool
//   counts[p] = survivors of stage p                (P,)
//   packed[c] = ascending survivor rows of column cols[c], then -1   (C, N)
//
// all in ONE launch.  Each block scores kRows rows, counts its survivors
// per stage with warp ballots, and takes its first packed slot from the
// blocks before it by a decoupled look-back (Merrill & Garland, "Single-pass
// parallel prefix scan with decoupled look-back", 2016):
//
//   * a block's tile is the ticket it draws from a counter, not blockIdx,
//     so every block it waits on has started (forward progress);
//   * each (stage, tile) has a 64-bit status word: the call's epoch and a
//     flag (aggregate / inclusive prefix) in the high half, the count in
//     the low half.  The wrapper passes a new epoch each call, so a word
//     left by an earlier call never reads as ready, and nothing is cleared;
//   * a word is its own payload: no other memory is read on the strength of
//     it, so words are stored and loaded whole (single-copy atomic) and
//     relaxed at GPU scope.  Release / acquire would order nothing more,
//     and made each publish wait for the block's earlier stores (1.4-1.7 us
//     a call on the card, scripts/cascade_phases.py);
//   * a warp reads 128 predecessors' words at once and uses them up to the
//     nearest inclusive prefix, once every word before it is ready.
//
// A survivor of local rank k goes to slot base + k; a rejected row of local
// reject rank k goes to slot N - 1 - (rejects before the block + k), so the
// -1 tail [count, N) is written exactly once, by the blocks that own its
// rejects.  No atomic decides a slot: the output is deterministic.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s fp32 on CUDA cores): the
// main path scores one executor tile of N = 8192 records with F = 64.  x is
// 2 MiB (0.63 us); the fp32 work is 2*N*HP*(F+P) flops: 0.1 GFLOP (1.57 us)
// for three stages at hidden 32 (HP 96), 4 MFLOP for two linear stages.
// Either is below the chain of latencies a block walks (the ticket's
// atomic, x from memory, the weights' copy, the look-back's L2 round trips),
// so the kernel is latency-bound.  The design keeps that chain short and
// the FMAs off it:
//
//   * one launch per tile, a grid of about one wave (128 blocks on 132 SMs);
//   * the weights do not depend on the tile, so their first stage is copied
//     (cp.async) while the ticket's atomic is in flight; w1 then streams in
//     64-feature stages and w2 in chunk rows, double-buffered, the next
//     stage copying while this one computes; int8 codes stay int8 in shared
//     memory and widen in registers;
//   * x is read once with 16-byte loads where F and the address allow, and
//     kept transposed in shared memory;
//   * lane l of warp g holds rows l and l + 32 and chunk columns
//     [g NC, (g + 1) NC): per feature two conflict-free x words and NC / 4
//     broadcast vector loads of w feed 2 NC FMAs; a whole stage is unrolled
//     so loads run ahead.  Chunks of NC = 4 columns a warp are bound by
//     those loads, wider ones by the FMAs (pick_chunk);
//   * the readout runs from those registers: each warp sums its columns into
//     per-row partials, and the eight warps' partials are added in a fixed
//     order;
//   * b1, b2, thr and out_scale are read ahead of the step that needs them;
//     each stage's count is published before the block's mask and score
//     stores.
//
// Arithmetic is IEEE fp32 FMAs on CUDA cores.  The tensor cores are not
// used: TF32 flips keep / reject decisions near thresholds and is barred,
// and split-bf16 wgmma would add rounding error and code to save under a
// microsecond of the 1.6 us the fp32 FMAs take at peak.
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kRows = 64;         // rows per block: two warp ballots per stage
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStageRows = 64;    // feature rows of w1 per pipeline stage
constexpr int kRing = 2;          // stages in flight: the next loads during this one
constexpr int kQB = 4;            // stages a readout pass sums
constexpr int kWindows = 4;       // look-back words a lane reads per round trip
constexpr int kXStride = kRows;   // transposed x: a warp reads 32 consecutive rows
constexpr unsigned kFlagAggregate = 1u, kFlagPrefix = 2u;
static_assert(kRows == 64, "the survivor ballots assume two warps of rows");

struct Params {
  const float* x;
  const void* w1;
  const float* b1;
  const void* w2;
  const float* b2;
  const float* thr;
  const float* out_scale;  // may be null
  int N, F, HP, P, n_valid;
  float* scores;           // may be null
  uint8_t* mask;
  int* counts;             // null: no compaction (and no look-back)
  int* packed;
  const int* cols;
  int C;
  unsigned long long* status;
  unsigned* ticket;
  unsigned ticket_base, epoch;
  int vec_x, vec_w1, vec_w2;  // copy widths in elements (see pick_vec)
};

// Register tile of the hidden chunk: lane l holds rows l and l + 32, warp g
// holds columns [g * NC, (g + 1) * NC) of the chunk, so a warp's reads of
// w are one address (a broadcast) and its reads of x are 32 consecutive
// words; per feature a thread does 2 * NC FMAs on 2 + NC / 4 loads.
template <int HC>
struct Micro {
  static constexpr int NC = HC / kWarps;
  static_assert(NC * kWarps == HC && NC % 4 == 0, "bad chunk width");
  static_assert(kRows == 64, "two rows a lane");
};

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

struct Layout {
  size_t xs, ws, ws_buf, w2s, w2s_buf, red, acc, keep, bal, vec, scan, total;
};

template <typename WT, int HC>
__host__ __device__ inline Layout layout(int F, int P) {
  Layout L;
  size_t o = 0;
  L.xs = o;  o += align16(sizeof(float) * (size_t)F * kXStride);
  L.ws_buf = align16(sizeof(WT) * kStageRows * HC);
  L.ws = o;  o += kRing * L.ws_buf;
  L.w2s_buf = align16(sizeof(WT) * (size_t)HC * P);
  L.w2s = o; o += kRing * L.w2s_buf;
  L.red = o; o += align16(sizeof(float) * kWarps * kRows * kQB);
  L.acc = o; o += align16(sizeof(float) * (size_t)kRows * P);
  L.keep = o; o += align16((size_t)kRows * P);
  L.bal = o; o += align16(sizeof(unsigned) * 2 * (size_t)P);
  L.vec = o; o += align16(sizeof(float) * 3 * (size_t)P);  // b2, thr, out_scale
  L.scan = o; o += align16(sizeof(int) * (2 * (size_t)P + 1));  // agg, excl, tile
  L.total = o;
  return L;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// status words: whole 64-bit words, relaxed at GPU scope (see the note above)
__device__ __forceinline__ unsigned long long ld_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long status_word(unsigned epoch, unsigned flag,
                                                          int value) {
  return (static_cast<unsigned long long>((epoch << 2) | flag) << 32) |
         static_cast<unsigned>(value);
}

// Copy a rows x cols tile (source row stride src_ld elements) into shared
// memory (row stride cols) in units of vec elements: cp.async of 16 or 4
// bytes, or a plain load and store for a lone int8.  Rows from valid_rows
// and columns from valid_cols (both multiples of vec) are zero-filled.
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, size_t src_ld, int rows,
                                           int cols, int valid_rows, int valid_cols,
                                           int vec) {
  const int units = cols / vec;
  for (int u = threadIdx.x; u < rows * units; u += kThreads) {
    const int r = u / units, c = (u - r * units) * vec;
    T* d = dst + r * cols + c;
    if (r < valid_rows && c < valid_cols) {
      const T* s = src + r * src_ld + c;
      const int bytes = vec * (int)sizeof(T);
      if (bytes == 16) cp_async16(d, s);
      else if (bytes == 4) cp_async4(d, s);
      else *d = *s;
    } else {
      for (int i = 0; i < vec; ++i) d[i] = T(0);
    }
  }
}

// NC consecutive weights (4 * sizeof(WT)-byte aligned) widened to fp32
template <int NC>
__device__ __forceinline__ void load_w(const float* p, float (&w)[NC]) {
#pragma unroll
  for (int v = 0; v < NC / 4; ++v) {
    const float4 q = reinterpret_cast<const float4*>(p)[v];
    w[4 * v] = q.x; w[4 * v + 1] = q.y; w[4 * v + 2] = q.z; w[4 * v + 3] = q.w;
  }
}

template <int NC>
__device__ __forceinline__ void load_w(const int8_t* p, float (&w)[NC]) {
#pragma unroll
  for (int v = 0; v < NC / 4; ++v) {
    const char4 q = reinterpret_cast<const char4*>(p)[v];
    w[4 * v] = q.x; w[4 * v + 1] = q.y; w[4 * v + 2] = q.z; w[4 * v + 3] = q.w;
  }
}

template <typename WT, int HC>
__global__ void __launch_bounds__(kThreads) cascade_score_kernel(const Params p) {
  using M = Micro<HC>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int F = p.F, HP = p.HP, P = p.P;
  const Layout L = layout<WT, HC>(F, P);
  float* xs = reinterpret_cast<float*>(smem + L.xs);  // F x kXStride, transposed
  WT* ws = reinterpret_cast<WT*>(smem + L.ws);
  WT* w2s = reinterpret_cast<WT*>(smem + L.w2s);
  float* red = reinterpret_cast<float*>(smem + L.red);  // kWarps x kRows x kQB partials
  float* acc = reinterpret_cast<float*>(smem + L.acc);  // kRows x P
  uint8_t* keep = smem + L.keep;                          // kRows x P
  unsigned* bal = reinterpret_cast<unsigned*>(smem + L.bal);  // P x 2 ballots
  float* b2s = reinterpret_cast<float*>(smem + L.vec);        // P each: b2, thr, scale
  float* thrs = b2s + P;
  float* scales = thrs + P;
  int* agg = reinterpret_cast<int*>(smem + L.scan);           // P block counts
  int* excl = agg + P;                                        // P first slots
  int* tile_s = excl + P;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool compact = p.counts != nullptr;
  const WT* w1 = static_cast<const WT*>(p.w1);
  const WT* w2 = static_cast<const WT*>(p.w2);
  const int n_chunks = (HP + HC - 1) / HC, n_k = (F + kStageRows - 1) / kStageRows;
  const int n_stages = n_chunks * n_k;

  // stage s = (chunk c, feature step k): w1[k rows, c cols], plus w2's
  // rows of chunk c with its first step, into ring slots s and c modulo
  // kRing; one cp.async group per stage (empty past the last stage)
  auto issue = [&](int s) {
    if (s < n_stages) {
      const int c = s / n_k, k = s - c * n_k;
      const int c0 = c * HC, k0 = k * kStageRows;
      WT* dst = ws + (s % kRing) * (L.ws_buf / sizeof(WT));
      const WT* src = w1 + (size_t)k0 * HP + c0;
      const int kr = min(kStageRows, F - k0), kc = min(HC, HP - c0);
      // the chunk width is a constant here, so the unit arithmetic is too
      switch (p.vec_w1) {
        case 1: stage_tile(dst, src, (size_t)HP, kStageRows, HC, kr, kc, 1); break;
        case 4: stage_tile(dst, src, (size_t)HP, kStageRows, HC, kr, kc, 4); break;
        default: stage_tile(dst, src, (size_t)HP, kStageRows, HC, kr, kc, 16); break;  // int8
      }
      if (k == 0)
        stage_tile(w2s + (c % kRing) * (L.w2s_buf / sizeof(WT)), w2 + (size_t)c0 * P,
                   (size_t)P, HC, P, min(HC, HP - c0), P, p.vec_w2);
    }
    cp_async_commit();
  };
  // the ticket's round trip overlaps the weights' first stage, which does
  // not depend on the tile
  unsigned ticket = blockIdx.x;
  if (tid == 0 && compact) ticket = atomicAdd(p.ticket, 1u) - p.ticket_base;
  for (int s = 0; s < kRing - 1; ++s) issue(s);
  if (tid == 0) *tile_s = (int)ticket;
  for (int e = tid; e < kRows * P; e += kThreads) acc[e] = 0.f;
  for (int q = tid; q < P; q += kThreads) {
    b2s[q] = __ldg(p.b2 + q);
    thrs[q] = __ldg(p.thr + q);
    scales[q] = p.out_scale != nullptr ? __ldg(p.out_scale + q) : 1.f;
  }
  __syncthreads();
  const int t = *tile_s;
  const int r0 = t * kRows, rows = min(kRows, p.N - r0);

  // x tile, transposed: consecutive threads take consecutive rows, so the
  // shared-memory stores do not collide
  if (p.vec_x == 4) {
    const int q4 = F / 4;
    for (int u = tid; u < kRows * q4; u += kThreads) {
      const int r = u % kRows, q = u / kRows;
      const float4 v = r < rows
          ? __ldg(reinterpret_cast<const float4*>(p.x + (size_t)(r0 + r) * F) + q)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      float* d = xs + 4 * q * kXStride + r;
      d[0] = v.x; d[kXStride] = v.y; d[2 * kXStride] = v.z; d[3 * kXStride] = v.w;
    }
  } else {
    for (int u = tid; u < kRows * F; u += kThreads) {
      const int r = u % kRows, f = u / kRows;
      xs[f * kXStride + r] = r < rows ? __ldg(p.x + (size_t)(r0 + r) * F + f) : 0.f;
    }
  }

  float h[2][M::NC];
  for (int s = 0; s < n_stages; ++s) {
    const int c = s / n_k, k = s - c * n_k;
    float bias[M::NC];  // this chunk's b1, loaded while the FMAs run
    if (k == 0) {
#pragma unroll
      for (int j = 0; j < M::NC; ++j) h[0][j] = h[1][j] = 0.f;
    }
    if (k == n_k - 1) {
#pragma unroll
      for (int j = 0; j < M::NC; ++j) {
        const int col = c * HC + warp * M::NC + j;
        bias[j] = col < HP ? __ldg(p.b1 + col) : 0.f;
      }
    }
    issue(s + kRing - 1);
    cp_async_wait<kRing - 1>();
    __syncthreads();
    const WT* wb = ws + (s % kRing) * (L.ws_buf / sizeof(WT)) + warp * M::NC;
    const float* xb = xs + k * kStageRows * kXStride + lane;
    auto step = [&](int kk) {
      const float x0 = xb[kk * kXStride], x1 = xb[kk * kXStride + 32];
      float wv[M::NC];
      load_w<M::NC>(wb + kk * HC, wv);
#pragma unroll
      for (int j = 0; j < M::NC; ++j) {
        h[0][j] = fmaf(x0, wv[j], h[0][j]);
        h[1][j] = fmaf(x1, wv[j], h[1][j]);
      }
    };
    const int kf = min(kStageRows, F - k * kStageRows);
    if (kf == kStageRows) {  // a whole stage, unrolled: loads run ahead of the FMAs
#pragma unroll
      for (int kk = 0; kk < kStageRows; ++kk) step(kk);
    } else {
#pragma unroll 4
      for (int kk = 0; kk < kf; ++kk) step(kk);
    }
    if (k == n_k - 1) {
      // readout from registers: each warp sums its NC columns into per-row
      // partials for kQB stages at a time, and the eight warps' partials
      // are added in warp order (deterministic)
      const WT* w2b = w2s + (c % kRing) * (L.w2s_buf / sizeof(WT)) + warp * M::NC * P;
#pragma unroll
      for (int j = 0; j < M::NC; ++j) {
        h[0][j] = fmaxf(h[0][j] + bias[j], 0.f);
        h[1][j] = fmaxf(h[1][j] + bias[j], 0.f);
      }
      for (int qb = 0; qb < P; qb += kQB) {
        float a[2][kQB];
#pragma unroll
        for (int u = 0; u < kQB; ++u) a[0][u] = a[1][u] = 0.f;
#pragma unroll
        for (int j = 0; j < M::NC; ++j)
#pragma unroll
          for (int u = 0; u < kQB; ++u) {
            const float w = qb + u < P ? static_cast<float>(w2b[j * P + qb + u]) : 0.f;
            a[0][u] = fmaf(h[0][j], w, a[0][u]);
            a[1][u] = fmaf(h[1][j], w, a[1][u]);
          }
#pragma unroll
        for (int u = 0; u < kQB; ++u) {
          red[(warp * kRows + lane) * kQB + u] = a[0][u];
          red[(warp * kRows + lane + 32) * kQB + u] = a[1][u];
        }
        __syncthreads();
        for (int e = tid; e < kRows * kQB; e += kThreads) {
          const int r = e / kQB, q = qb + e % kQB;
          float v = 0.f;
#pragma unroll
          for (int g = 0; g < kWarps; ++g) v += red[g * kRows * kQB + e];
          if (q < P) acc[r * P + q] += v;
        }
        __syncthreads();
      }
    }
    __syncthreads();  // ring slot s is refilled next
  }

  const int O = kRows * P;
  for (int e = tid; e < O; e += kThreads) {
    const int r = e / P, q = e - r * P;
    float sc = acc[e];
    if (p.out_scale != nullptr) sc = __fmul_rn(sc, scales[q]);
    sc = __fadd_rn(sc, b2s[q]);
    acc[e] = sc;
    keep[e] = r < rows && r0 + r < p.n_valid && sc >= thrs[q];
  }
  __syncthreads();
  const int n_tiles = gridDim.x;  // status words: one row of n_tiles per stage
  if (compact) {
    for (int q = warp; q < P; q += kWarps) {
      const unsigned b0 = __ballot_sync(0xffffffffu, keep[lane * P + q]);
      const unsigned b1 = __ballot_sync(0xffffffffu, keep[(lane + 32) * P + q]);
      if (lane == 0) {
        bal[2 * q] = b0;
        bal[2 * q + 1] = b1;
        agg[q] = __popc(b0) + __popc(b1);
      }
    }
    __syncthreads();
    // publish every stage's aggregate (tile 0: its inclusive prefix) before
    // the block's stores, so that no publish waits on them
    for (int q = tid; q < P; q += kThreads)
      st_status(p.status + (size_t)q * n_tiles + t,
                 status_word(p.epoch, t == 0 ? kFlagPrefix : kFlagAggregate, agg[q]));
  }
  for (int e = tid; e < rows * P; e += kThreads) {
    if (p.scores != nullptr) p.scores[(size_t)r0 * P + e] = acc[e];
    p.mask[(size_t)r0 * P + e] = keep[e];
  }
  if (!compact) return;

  // look back, one stage per warp
  for (int q = warp; q < P; q += kWarps) {
    int prefix = 0;
    if (t > 0) {
      // lane l's word i is the predecessor at distance d = 32 i + l from
      // top; the window may be used up to its nearest inclusive prefix once
      // every word before that prefix is ready
      for (int top = t - 1;; top -= 32 * kWindows) {
        unsigned long long w[kWindows];
        int first_wait, first_prefix;
        for (;;) {
          first_wait = first_prefix = 32 * kWindows;
#pragma unroll
          for (int i = 0; i < kWindows; ++i) {
            const int j = top - 32 * i - lane;
            w[i] = j < 0 ? status_word(p.epoch, kFlagPrefix, 0)
                         : ld_status(p.status + (size_t)q * n_tiles + j);
          }
#pragma unroll
          for (int i = kWindows - 1; i >= 0; --i) {
            const unsigned hi = static_cast<unsigned>(w[i] >> 32);
            const bool ready = (hi >> 2) == p.epoch && (hi & 3u) != 0;
            const unsigned waiting = __ballot_sync(0xffffffffu, !ready);
            const unsigned prefixes = __ballot_sync(0xffffffffu, ready && (hi & 3u) == kFlagPrefix);
            if (waiting) first_wait = 32 * i + __ffs(waiting) - 1;
            if (prefixes) first_prefix = 32 * i + __ffs(prefixes) - 1;
          }
          if (first_prefix < first_wait || first_wait == 32 * kWindows) break;
        }
        int v = 0;
#pragma unroll
        for (int i = 0; i < kWindows; ++i)
          if (32 * i + lane <= first_prefix) v += static_cast<int>(static_cast<unsigned>(w[i]));
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        prefix += v;
        if (first_prefix < 32 * kWindows) break;
      }
      if (lane == 0)
        st_status(p.status + (size_t)q * n_tiles + t,
                   status_word(p.epoch, kFlagPrefix, prefix + agg[q]));
    }
    if (lane == 0) excl[q] = prefix;
  }
  __syncthreads();

  if (r0 + rows == p.N)  // the last tile holds every stage's total
    for (int q = tid; q < P; q += kThreads) p.counts[q] = excl[q] + agg[q];
  const unsigned below_lane = (1u << lane) - 1u;
  for (int c = warp; c < p.C; c += kWarps) {
    const int q = __ldg(p.cols + c);
    const int base = excl[q];
    const unsigned b0 = bal[2 * q], b1 = bal[2 * q + 1];
    int* out = p.packed + (size_t)c * p.N;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = half * 32 + lane;
      const unsigned bits = half ? b1 : b0;
      const int below = __popc(bits & below_lane) + (half ? __popc(b0) : 0);
      if (i < rows) {
        if ((bits >> lane) & 1u) out[base + below] = r0 + i;
        else out[p.N - 1 - (r0 - base) - (i - below)] = -1;
      }
    }
  }
}

// Widest copy unit (elements) of 16 or 4 bytes, else 1, that divides both
// extents and the pointer's alignment.
int pick_vec(const void* ptr, int esize, int a, int b) {
  for (int bytes : {16, 4}) {
    const int v = bytes / esize;
    if (v >= 1 && a % v == 0 && b % v == 0 && reinterpret_cast<uintptr_t>(ptr) % bytes == 0)
      return v;
  }
  return 1;
}

int smem_limit() {
  static int limit = 0;
  if (limit == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return limit;
}

constexpr int kChunks[] = {128, 96, 64, 32};  // hidden columns per chunk, widest first

template <typename WT>
size_t smem_bytes(int hc, int F, int P) {
  switch (hc) {
    case 128: return layout<WT, 128>(F, P).total;
    case 96: return layout<WT, 96>(F, P).total;
    case 64: return layout<WT, 64>(F, P).total;
    default: return layout<WT, 32>(F, P).total;
  }
}

// Hidden columns per chunk: of kChunks, the one whose shared memory fits a
// block and whose padded work, in FMA-issue cycles, is least.  A chunk of
// NC = 4 columns a warp is bound by its shared-memory loads (at about two
// thirds of the FMA rate); from NC = 8 the FMAs bound it.  Each chunk also
// costs a readout and its barriers (24 columns' worth).  0: none fits.
template <typename WT>
int pick_chunk(int F, int HP, int P) {
  int best = 0;
  double best_cost = 0;
  for (int hc : kChunks) {
    if (smem_bytes<WT>(hc, F, P) > (size_t)smem_limit()) continue;
    const double rate = hc == 32 ? 2.0 / 3 : 1.0;
    const double cost = (double)((HP + hc - 1) / hc) * (hc / rate + 24);
    if (best == 0 || cost < best_cost) {
      best = hc;
      best_cost = cost;
    }
  }
  return best;
}

template <typename WT>
size_t smem_for(int F, int HP, int P) {
  const int hc = pick_chunk<WT>(F, HP, P);
  return smem_bytes<WT>(hc == 0 ? 32 : hc, F, P);
}

template <typename WT, int HC>
int launch(Params p, cudaStream_t stream) {
  static size_t allowed[64] = {};  // per device: the attribute set so far
  const size_t smem = layout<WT, HC>(p.F, p.P).total;
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem > 48 * 1024 && (dev >= 64 || smem > allowed[dev])) {
    cudaError_t err = cudaFuncSetAttribute(cascade_score_kernel<WT, HC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) allowed[dev] = smem;
  }
  p.vec_w1 = pick_vec(p.w1, sizeof(WT), HC, p.HP);
  p.vec_w2 = pick_vec(p.w2, sizeof(WT), p.P, p.P);
  const int n_blocks = (p.N + kRows - 1) / kRows;
  cascade_score_kernel<WT, HC><<<n_blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename WT>
int launch_for(const Params& p, cudaStream_t stream) {
  switch (pick_chunk<WT>(p.F, p.HP, p.P)) {
    case 128: return launch<WT, 128>(p, stream);
    case 96: return launch<WT, 96>(p, stream);
    case 64: return launch<WT, 64>(p, stream);
    case 32: return launch<WT, 32>(p, stream);
    default: return (int)cudaErrorInvalidValue;  // no chunk fits shared memory
  }
}

}  // namespace

extern "C" {

// Rows per block: the look-back has ceil(N / rows) tiles.
int cascade_rows_per_block() { return kRows; }

// Dynamic shared memory a launch at these extents needs, and the most a
// block may have on the current device; the wrapper refuses a cascade
// whose need exceeds the limit before any launch.
long cascade_smem_bytes(int F, int HP, int P, int w_int8) {
  return (long)(w_int8 ? smem_for<int8_t>(F, HP, P) : smem_for<float>(F, HP, P));
}

int cascade_smem_limit() { return smem_limit(); }

// w_int8 = 1: w1 and w2 hold int8 codes; 0: float32.  out_scale and scores
// may be null.  counts null: scores and masks only, no look-back (packed,
// cols, status and ticket unused).  Otherwise status holds at least
// ceil(N / rows) * P words, zeroed when allocated; epoch (1 .. 2^30 - 1)
// differs from every earlier call's on that status array, and ticket_base
// is the ticket counter's value before this launch.  Returns
// cudaGetLastError() after the launch.
int cascade_score_launch(const void* x, const void* w1, const void* b1, const void* w2,
                         const void* b2, const void* thr, const void* out_scale, int w_int8,
                         int N, int F, int HP, int P, int n_valid, void* scores, void* mask,
                         void* counts, void* packed, const void* cols, int C, void* status,
                         void* ticket, unsigned ticket_base, unsigned epoch, void* stream) {
  if (N <= 0 || F <= 0 || HP <= 0 || P <= 0 || C < 0) return (int)cudaErrorInvalidValue;
  if (counts != nullptr && (status == nullptr || ticket == nullptr || epoch == 0 ||
                            epoch >= (1u << 30) || (C > 0 && (packed == nullptr || cols == nullptr))))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const float*>(x);
  p.w1 = w1;
  p.b1 = static_cast<const float*>(b1);
  p.w2 = w2;
  p.b2 = static_cast<const float*>(b2);
  p.thr = static_cast<const float*>(thr);
  p.out_scale = static_cast<const float*>(out_scale);
  p.N = N; p.F = F; p.HP = HP; p.P = P; p.n_valid = n_valid;
  p.scores = static_cast<float*>(scores);
  p.mask = static_cast<uint8_t*>(mask);
  p.counts = static_cast<int*>(counts);
  p.packed = static_cast<int*>(packed);
  p.cols = static_cast<const int*>(cols);
  p.C = counts != nullptr ? C : 0;
  p.status = static_cast<unsigned long long*>(status);
  p.ticket = static_cast<unsigned*>(ticket);
  p.ticket_base = ticket_base;
  p.epoch = epoch;
  p.vec_x = (F % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) ? 4 : 1;
  p.vec_w1 = p.vec_w2 = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w_int8 ? launch_for<int8_t>(p, s) : launch_for<float>(p, s);
}

const char* cascade_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
