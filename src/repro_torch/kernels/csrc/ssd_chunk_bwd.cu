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
// (chip_smoke.py `ssd_bwd_bound`): 0.09 ms at the bf16 tensor-core peak,
// 1.3 ms at the 67 TFLOP/s f32 CUDA-core peak this kernel runs on.
//
// Design: five kernels on the CUDA cores, IEEE f32, one launch a call from
// the wrapper's point of view.
//   1. `bwd_scores`: S = C B^T once per chunk and group (not per head), for
//      the rows of a 32-row tile and the columns that reach them, written
//      to a device scratch twice: row-major S and its transpose, so that the
//      per-head kernel reads both along a warp's 32 consecutive addresses.
//   2. `bwd_head`: one block per chunk and head, 512 threads, a pair of
//      threads owning row/column j with half the head dim each (their
//      partial dot products meet by a shuffle).  x and dy of the head sit
//      in shared memory (f32, 128 KB at P 64).  v comes from B and dst
//      staged 32 state columns at a time; then row j walks i >= j for dx_j
//      and G's column sum (the warp walks its 16 rows' span together, so
//      dy's row is a broadcast and S's row a coalesced load, 8 rows of S
//      loaded a group ahead), and row i walks j < i for G's row sum.  A fixed tree sums u; warp 0 scans cum
//      forward and dcum backward.  The head's cum goes to the scratch for
//      kernels 3 and 5.
//   3. `bwd_dssum`: the group reduction.  sum_h dS_h is a (Q, Q) f32 tile,
//      256 KB at Q 256, more than a block's shared memory, so one block owns
//      a 64 x 64 tile (I, J <= I) of it (10 blocks a chunk and group at Q
//      256) and sums dS_h over the group's heads in head order (mamba2 has
//      G 1: all 80 heads), each thread a 4 x 4 register tile of the
//      products dy_I x_J^T; the sums go to the scratch.
//   4. `bwd_dc`: 32 rows of dC a block from the scratch's rows.
//   5. `bwd_db`: one block owns 32 rows of dB: (sum_h dS_h)^T C over the
//      rows i >= j of the scratch, then the state term over the group's
//      heads in head order.
// B and C are read as `ssd_chunk` takes them, strided slices of the
// projection (a token stride each); x likewise; dy, dst, ddec and dA are
// contiguous and the outputs are written contiguous.
//
// Where it is slow: kernel 2 holds 177 KB of shared memory, one block (16
// warps) a SM, and its two triangular walks leave warps idle (warp 0 walks
// 256 rows in pass 1, warp 15 16); it takes most of a call.  Moving the
// products onto the tensor cores with a fixed-order group reduction is the
// next step (ROADMAP).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads a block (bwd_head: kHeadThreads)
constexpr int kMaxQ = 256;     // chunk length at most (and a multiple of 16)
constexpr int kMaxN = 128;     // state dim at most
constexpr int kTile = 32;      // rows (columns) of the group kernels' tiles
constexpr int kNStage = 32;    // state columns staged at a time in bwd_head
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

// 1. S = C B^T for rows [i0, i0 + 32) of chunk c, group g; columns j <=
// i0 + 31 (the others are never read).  grid (Q / 32, nc * G).
template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_scores(
    const T* __restrict__ C, const T* __restrict__ B, float* __restrict__ S,
    float* __restrict__ St, int Q, int G, int N, long long sB, long long sC) {
  __shared__ float Cs[kTile][kNStage + 1];
  __shared__ float Bs[kMaxQ][kNStage + 1];
  const int t = threadIdx.x;
  const int i0 = blockIdx.x * kTile;
  const int cg = blockIdx.y, c = cg / G, g = cg % G;
  const int j = t;
  const bool active = j < Q && j < i0 + kTile;
  float acc[kTile];
#pragma unroll
  for (int r = 0; r < kTile; ++r) acc[r] = 0.f;
  for (int n0 = 0; n0 < N; n0 += kNStage) {
    __syncthreads();
    for (int idx = t; idx < kTile * kNStage; idx += kThreads) {
      const int r = idx / kNStage, nn = idx % kNStage, i = i0 + r, n = n0 + nn;
      Cs[r][nn] = (i < Q && n < N) ? ld(C + ((long long)c * Q + i) * sC + (long long)g * N + n) : 0.f;
    }
    for (int idx = t; idx < Q * kNStage; idx += kThreads) {
      const int jj = idx / kNStage, nn = idx % kNStage, n = n0 + nn;
      Bs[jj][nn] = n < N ? ld(B + ((long long)c * Q + jj) * sB + (long long)g * N + n) : 0.f;
    }
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int nn = 0; nn < kNStage; ++nn) {
        const float b = Bs[j][nn];
#pragma unroll
        for (int r = 0; r < kTile; ++r) acc[r] += Cs[r][nn] * b;
      }
    }
  }
  if (!active) return;
  const long long base = (long long)cg * Q * Q;
#pragma unroll
  for (int r = 0; r < kTile; ++r) {
    const int i = i0 + r;
    if (i < Q) {
      S[base + (long long)i * Q + j] = acc[r];
      St[base + (long long)j * Q + i] = acc[r];
    }
  }
}

constexpr int kAhead = 8;  // rows of S (S^T) a thread loads one group ahead in bwd_head

// Shared memory of bwd_head<PB>, in floats.
__host__ __device__ constexpr int head_smem_floats(int PB) {
  return 2 * kMaxQ * PB            // xs, dys
         + kMaxQ * (kNStage + 1)   // Bs
         + kNStage * PB            // Ds (transposed: a state column's P values together)
         + 3 * kMaxQ;              // cum, w, red
}

// Rows i0 .. i0 + kAhead of column `col` of a (Q, Q) matrix at `base`
// (rows from `rows` on read as 0): a group of independent loads that
// bwd_head keeps in flight while it works on the group before.
__device__ __forceinline__ void load_group(float (&out)[kAhead], const float* __restrict__ S,
                                           long long base, int i0, int rows, int Q, int col) {
#pragma unroll
  for (int k = 0; k < kAhead; ++k)
    out[k] = i0 + k < rows ? S[base + (long long)(i0 + k) * Q + col] : 0.f;
}

// 2. dx and ddA of chunk c, head h (and the head's cum to `cum_out`).
// Row (column) j belongs to the thread pair 2j, 2j + 1, each holding half
// of the head dim (PB / 2 values of x_j, dy_j, dx_j), so a warp walks 16
// rows and a thread keeps half the registers; the pair's partial dot
// products meet by a shuffle.  grid (nc * H), kHeadThreads threads.
constexpr int kHeadThreads = 2 * kMaxQ;

template <typename T, int PB>
__global__ void __launch_bounds__(kHeadThreads) bwd_head(
    const T* __restrict__ x, const float* __restrict__ dA, const T* __restrict__ B,
    const float* __restrict__ dy, const float* __restrict__ dst, const float* __restrict__ ddec,
    const float* __restrict__ S, const float* __restrict__ St, T* __restrict__ dx,
    float* __restrict__ ddA, float* __restrict__ cum_out, int Q, int H, int G, int P, int N,
    long long sx, long long sB) {
  constexpr int PH = PB / 2;  // a thread's share of the head dim
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                         // (kMaxQ, PB)
  float* dys = xs + kMaxQ * PB;             // (kMaxQ, PB)
  float* Bs = dys + kMaxQ * PB;             // (kMaxQ, kNStage + 1)
  float* Ds = Bs + kMaxQ * (kNStage + 1);   // (kNStage, PB)
  float* cum = Ds + kNStage * PB;           // (kMaxQ)
  float* wv = cum + kMaxQ;                  // (kMaxQ)
  float* red = wv + kMaxQ;                  // (kMaxQ): u, then dcum
  const int t = threadIdx.x, j = t >> 1, hf = t & 1, p0 = hf * PH;
  const int c = blockIdx.x / H, h = blockIdx.x % H, g = h / (H / G);
  const long long cg = (long long)c * G + g;
  const long long sbase = cg * Q * Q;

  for (int idx = t; idx < Q * PB; idx += kHeadThreads) {
    const int i = idx / PB, p = idx % PB;
    const long long tok = (long long)c * Q + i;
    xs[idx] = p < P ? ld(x + tok * sx + (long long)h * P + p) : 0.f;
    dys[idx] = p < P ? dy[(tok * H + h) * P + p] : 0.f;
  }
  if (t < Q) cum[t] = dA[((long long)c * Q + t) * H + h];
  __syncthreads();
  if (t < 32) warp_scan(cum, Q, false);
  __syncthreads();
  const float cum_last = cum[Q - 1];
  if (t < Q) {
    wv[t] = expf(cum_last - cum[t]);
    cum_out[((long long)c * H + h) * Q + t] = cum[t];
  }

  // v_j = B_j dst^T (this thread's half of p), 32 state columns at a time
  float acc[PH];
#pragma unroll
  for (int p = 0; p < PH; ++p) acc[p] = 0.f;
  for (int n0 = 0; n0 < N; n0 += kNStage) {
    __syncthreads();
    for (int idx = t; idx < Q * kNStage; idx += kHeadThreads) {
      const int jj = idx / kNStage, nn = idx % kNStage, n = n0 + nn;
      Bs[jj * (kNStage + 1) + nn] =
          n < N ? ld(B + ((long long)c * Q + jj) * sB + (long long)g * N + n) : 0.f;
    }
    for (int idx = t; idx < PB * kNStage; idx += kHeadThreads) {
      const int p = idx / kNStage, nn = idx % kNStage, n = n0 + nn;
      Ds[nn * PB + p] = (p < P && n < N) ? dst[(((long long)c * H + h) * P + p) * N + n] : 0.f;
    }
    __syncthreads();
    if (j < Q) {
      for (int nn = 0; nn < kNStage; ++nn) {
        const float b = Bs[j * (kNStage + 1) + nn];
        const float4* d = reinterpret_cast<const float4*>(Ds + nn * PB + p0);
#pragma unroll
        for (int p4 = 0; p4 < PH / 4; ++p4) {
          const float4 v = d[p4];
          acc[4 * p4] += b * v.x;
          acc[4 * p4 + 1] += b * v.y;
          acc[4 * p4 + 2] += b * v.z;
          acc[4 * p4 + 3] += b * v.w;
        }
      }
    }
  }

  // the state terms: u_j, and dx_j starts at w_j v_j
  const int jc = j < Q ? j : 0;  // a row to read for threads past Q
  float xr[PH];
#pragma unroll
  for (int p = 0; p < PH; ++p) xr[p] = xs[jc * PB + p0 + p];
  float u = 0.f;
#pragma unroll
  for (int p = 0; p < PH; ++p) u += xr[p] * acc[p];
  u += __shfl_xor_sync(0xffffffffu, u, 1);
  const float wj = j < Q ? wv[j] : 0.f;
  u *= wj;
#pragma unroll
  for (int p = 0; p < PH; ++p) acc[p] *= wj;
  if (hf == 0) red[j] = u;  // rows past Q hold 0

  // pass 1: row j walks the rows i >= j with its warp (the warp starts at
  // its first row): dx_j += M_ij dy_i, colG_j += G_ij for i > j
  float colG = 0.f;
  {
    const float cj = cum[jc];
    const int start = j & ~15;
    float cur[kAhead], nxt[kAhead];
    load_group(cur, S, sbase, start, Q, Q, jc);
    for (int g0 = start; g0 < Q; g0 += kAhead) {
      load_group(nxt, S, sbase, g0 + kAhead, Q, Q, jc);
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        const int i = g0 + k;
        const bool on = j < Q && i < Q && i >= j;
        const int ic = i < Q ? i : 0;
        const float m = on ? cur[k] * expf(cum[ic] - cj) : 0.f;
        const float4* dyi = reinterpret_cast<const float4*>(dys + ic * PB + p0);
        float dm = 0.f;
#pragma unroll
        for (int p4 = 0; p4 < PH / 4; ++p4) {
          const float4 d = dyi[p4];
          dm += d.x * xr[4 * p4] + d.y * xr[4 * p4 + 1] + d.z * xr[4 * p4 + 2] +
                d.w * xr[4 * p4 + 3];
          acc[4 * p4] += m * d.x;
          acc[4 * p4 + 1] += m * d.y;
          acc[4 * p4 + 2] += m * d.z;
          acc[4 * p4 + 3] += m * d.w;
        }
        dm += __shfl_xor_sync(0xffffffffu, dm, 1);
        colG += (on && i > j) ? dm * m : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kAhead; ++k) cur[k] = nxt[k];
    }
  }
  if (j < Q) {
    T* out = dx + ((long long)c * Q + j) * H * P + (long long)h * P + p0;
#pragma unroll
    for (int p = 0; p < PH; ++p)
      if (p0 + p < P) st(out + p, acc[p]);
  }

  // pass 2: row i = j walks the columns jj < i with its warp: rowG_i += G_i,jj
  float rowG = 0.f;
  {
    float dyr[PH];
#pragma unroll
    for (int p = 0; p < PH; ++p) dyr[p] = dys[jc * PB + p0 + p];
    const float ci = cum[jc];
    const int stop = min((j | 15) + 1, Q);  // the warp's last row + 1
    float cur[kAhead], nxt[kAhead];
    load_group(cur, St, sbase, 0, stop, Q, jc);
    for (int g0 = 0; g0 < stop; g0 += kAhead) {
      load_group(nxt, St, sbase, g0 + kAhead, stop, Q, jc);
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        const int jj = g0 + k;
        const bool on = j < Q && jj < j;
        const int jjc = jj < Q ? jj : 0;
        const float m = on ? cur[k] * expf(ci - cum[jjc]) : 0.f;
        const float4* xj = reinterpret_cast<const float4*>(xs + jjc * PB + p0);
        float dm = 0.f;
#pragma unroll
        for (int p4 = 0; p4 < PH / 4; ++p4) {
          const float4 v = xj[p4];
          dm += dyr[4 * p4] * v.x + dyr[4 * p4 + 1] * v.y + dyr[4 * p4 + 2] * v.z +
                dyr[4 * p4 + 3] * v.w;
        }
        dm += __shfl_xor_sync(0xffffffffu, dm, 1);
        rowG += on ? dm * m : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kAhead; ++k) cur[k] = nxt[k];
    }
  }

  // sum of u in a fixed tree
  __syncthreads();
  for (int s = kMaxQ / 2; s > 0; s >>= 1) {
    if (t < s) red[t] += red[t + s];
    __syncthreads();
  }
  const float u_sum = red[0];
  __syncthreads();
  float dc = rowG - colG - u;
  if (j == Q - 1) dc += u_sum + ddec[(long long)c * H + h] * expf(cum_last);
  if (hf == 0) red[j] = j < Q ? dc : 0.f;
  __syncthreads();
  if (t < 32) warp_scan(red, Q, true);
  __syncthreads();
  if (t < Q) ddA[((long long)c * Q + t) * H + h] = red[t];
}

// 3. sum_h dS_h over the group's heads, in head order, for one 64 x 64
// tile (I, J <= I) of chunk c, group g, to the scratch: a register-tiled
// product.  Thread (ty, tx) owns rows ty + 16 r and columns tx + 16 c
// (r, c < 4) of the tile: its loads of a row of dy are float4 broadcasts
// across the warp's 16 threads of one ty, those of x float4 rows 68 floats
// apart (at most two threads a bank), and its stores of a tile row are
// coalesced.  Per head: dM = dy_I x_J^T over P from shared
// memory, times L selected to 0 above the diagonal (the exp there may
// overflow).  grid (tile pairs, nc * G).
constexpr int kSq = 64;                 // the tile's rows and columns
constexpr int kSqPad = kPMax + 4;       // a row of P floats, 16-byte aligned

template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_dssum(
    const T* __restrict__ x, const float* __restrict__ dy, const float* __restrict__ cum,
    float* __restrict__ dSsum, int Q, int H, int G, int P, long long sx) {
  __shared__ __align__(16) float dys[kSq][kSqPad];  // dy_h rows of I
  __shared__ __align__(16) float xs[kSq][kSqPad];   // x_h rows of J
  __shared__ float cumI[kSq], cumJ[kSq];
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  int I = 0, pair = blockIdx.x;
  while (pair > I) pair -= ++I;  // (I, J) from the pair index: J = pair <= I
  const int J = pair, i0 = I * kSq, j0 = J * kSq;
  const int cg = blockIdx.y, c = cg / G, g = cg % G;
  const int rep = H / G;
  const int P4 = (P + 3) / 4;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) acc[r][cc] = 0.f;
  for (int k = 0; k < rep; ++k) {
    const int h = g * rep + k;
    __syncthreads();
    for (int idx = t; idx < kSq * P4 * 4; idx += kThreads) {
      const int row = idx / (P4 * 4), p = idx % (P4 * 4);
      const int i = i0 + row, jr = j0 + row;
      dys[row][p] = (i < Q && p < P) ? dy[(((long long)c * Q + i) * H + h) * P + p] : 0.f;
      xs[row][p] = (jr < Q && p < P)
                       ? ld(x + ((long long)c * Q + jr) * sx + (long long)h * P + p) : 0.f;
    }
    if (t < kSq) {
      const float* cumh = cum + ((long long)c * H + h) * Q;
      cumI[t] = i0 + t < Q ? cumh[i0 + t] : 0.f;
      cumJ[t] = j0 + t < Q ? cumh[j0 + t] : 0.f;
    }
    __syncthreads();
    float dm[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) dm[r][cc] = 0.f;
    for (int p4 = 0; p4 < P4; ++p4) {
      float4 a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = *reinterpret_cast<const float4*>(&dys[ty + 16 * r][4 * p4]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        b[cc] = *reinterpret_cast<const float4*>(&xs[tx + 16 * cc][4 * p4]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          dm[r][cc] += a[r].x * b[cc].x + a[r].y * b[cc].y + a[r].z * b[cc].z + a[r].w * b[cc].w;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int j = j0 + tx + 16 * cc;
        const bool keep = j <= i && i < Q;
        const float l = keep ? expf(cumI[ty + 16 * r] - cumJ[tx + 16 * cc]) : 0.f;
        acc[r][cc] += keep ? dm[r][cc] * l : 0.f;
      }
    }
  }
  const long long base = (long long)cg * Q * Q;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int j = j0 + tx + 16 * cc;
      if (i < Q && j < Q) dSsum[base + (long long)i * Q + j] = acc[r][cc];
    }
  }
}

// 4. Rows [i0, i0 + 32) of dC = (sum_h dS_h) B over j <= i, for chunk c
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

// 5. Rows [j0, j0 + 32) of dB for chunk c and group g: (sum_h dS_h)^T C
// over i >= j, then sum over the group's heads of (w_h x_h) dst_h.  A
// thread owns column n and 16 rows; their operands are read as float4
// broadcasts.  grid (Q / 32, nc * G).

template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_db(
    const T* __restrict__ x, const T* __restrict__ C, const float* __restrict__ dst,
    const float* __restrict__ cum, const float* __restrict__ dSsum, T* __restrict__ dB, int Q,
    int H, int G, int P, int N, long long sx, long long sC) {
  __shared__ __align__(16) float dSc[kTile][kRowPad];  // [i][j]
  __shared__ float Cc[kTile][kMaxN];                     // [i][n]
  __shared__ __align__(16) float xw[kPMax][kRowPad];    // [p][j]: w_h(j) x_h[j, p]
  const int t = threadIdx.x;
  const int j0 = blockIdx.x * kTile;
  const int cg = blockIdx.y, c = cg / G, g = cg % G;
  const int rep = H / G;
  const int n = t & 127, half = t >> 7;
  const long long base = (long long)cg * Q * Q;
  float acc[kTile / 2];
#pragma unroll
  for (int rr = 0; rr < kTile / 2; ++rr) acc[rr] = 0.f;
  for (int ib = j0; ib < Q; ib += kTile) {
    __syncthreads();
    for (int idx = t; idx < kTile * kTile; idx += kThreads) {
      const int ii = idx / kTile, jj = idx % kTile, i = ib + ii, jcol = j0 + jj;
      dSc[ii][jj] = (i < Q && jcol < Q) ? dSsum[base + (long long)i * Q + jcol] : 0.f;
    }
    for (int idx = t; idx < kTile * kMaxN; idx += kThreads) {
      const int ii = idx / kMaxN, nn = idx % kMaxN, i = ib + ii;
      Cc[ii][nn] = (i < Q && nn < N) ? ld(C + ((long long)c * Q + i) * sC + (long long)g * N + nn) : 0.f;
    }
    __syncthreads();
    for (int ii = 0; ii < kTile; ++ii) {
      const float cv = Cc[ii][n];
      const float4* d = reinterpret_cast<const float4*>(&dSc[ii][half * (kTile / 2)]);
#pragma unroll
      for (int q = 0; q < kTile / 8; ++q) {
        const float4 v = d[q];
        acc[4 * q] += v.x * cv;
        acc[4 * q + 1] += v.y * cv;
        acc[4 * q + 2] += v.z * cv;
        acc[4 * q + 3] += v.w * cv;
      }
    }
  }
  for (int k = 0; k < rep; ++k) {
    const int h = g * rep + k;
    const float* cumh = cum + ((long long)c * H + h) * Q;
    const float last = cumh[Q - 1];
    __syncthreads();
    for (int idx = t; idx < kTile * P; idx += kThreads) {
      const int jj = idx / P, p = idx % P, jrow = j0 + jj;
      xw[p][jj] = jrow < Q ? expf(last - cumh[jrow]) *
                                 ld(x + ((long long)c * Q + jrow) * sx + (long long)h * P + p)
                           : 0.f;
    }
    __syncthreads();
    if (n < N) {
      const float* dh = dst + ((long long)c * H + h) * P * N + n;
#pragma unroll 4
      for (int p = 0; p < P; ++p) {
        const float d = dh[(long long)p * N];
        const float4* xv = reinterpret_cast<const float4*>(&xw[p][half * (kTile / 2)]);
#pragma unroll
        for (int q = 0; q < kTile / 8; ++q) {
          const float4 v = xv[q];
          acc[4 * q] += v.x * d;
          acc[4 * q + 1] += v.y * d;
          acc[4 * q + 2] += v.z * d;
          acc[4 * q + 3] += v.w * d;
        }
      }
    }
  }
  if (n >= N) return;
#pragma unroll
  for (int rr = 0; rr < kTile / 2; ++rr) {
    const int jrow = j0 + half * (kTile / 2) + rr;
    if (jrow < Q) st(dB + (((long long)c * Q + jrow) * G + g) * N + n, acc[rr]);
  }
}

int pb_for(int P) { return P <= 16 ? 16 : P <= 32 ? 32 : 64; }

template <typename T, int PB>
cudaError_t run(const void* x, const float* dA, const void* B, const void* C, const float* dy,
                const float* dst, const float* ddec, void* dx, float* ddA, void* dB, void* dC,
                float* scratch, int nc, int Q, int H, int G, int P, int N, long long sx,
                long long sB, long long sC, cudaStream_t stream) {
  const long long qq = (long long)nc * G * Q * Q;
  float* S = scratch;
  float* St = S + qq;
  float* dSsum = St + qq;
  float* cum = dSsum + qq;
  const dim3 tiles((Q + kTile - 1) / kTile, nc * G);
  const T* xt = static_cast<const T*>(x);
  const T* Bt = static_cast<const T*>(B);
  const T* Ct = static_cast<const T*>(C);
  bwd_scores<T><<<tiles, kThreads, 0, stream>>>(Ct, Bt, S, St, Q, G, N, sB, sC);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = head_smem_floats(PB) * (int)sizeof(float);
  err = cudaFuncSetAttribute(bwd_head<T, PB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  bwd_head<T, PB><<<nc * H, kHeadThreads, smem, stream>>>(
      xt, dA, Bt, dy, dst, ddec, S, St, static_cast<T*>(dx), ddA, cum, Q, H, G, P, N, sx, sB);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int sq = (Q + kSq - 1) / kSq;
  bwd_dssum<T><<<dim3(sq * (sq + 1) / 2, nc * G), kThreads, 0, stream>>>(xt, dy, cum, dSsum, Q,
                                                                        H, G, P, sx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dc<T><<<tiles, kThreads, 0, stream>>>(Bt, dSsum, static_cast<T*>(dC), Q, G, N, sB);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_db<T><<<tiles, kThreads, 0, stream>>>(xt, Ct, dst, cum, dSsum, static_cast<T*>(dB), Q, H,
                                            G, P, N, sx, sC);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int PB, const void* x, const float* dA, const void* B, const void* C,
                     const float* dy, const float* dst, const float* ddec, void* dx, float* ddA,
                     void* dB, void* dC, float* scratch, int nc, int Q, int H, int G, int P,
                     int N, long long sx, long long sB, long long sC, cudaStream_t stream) {
  switch (PB) {
    case 16:
      return run<T, 16>(x, dA, B, C, dy, dst, ddec, dx, ddA, dB, dC, scratch, nc, Q, H, G, P, N,
                        sx, sB, sC, stream);
    case 32:
      return run<T, 32>(x, dA, B, C, dy, dst, ddec, dx, ddA, dB, dC, scratch, nc, Q, H, G, P, N,
                        sx, sB, sC, stream);
    default:
      return run<T, 64>(x, dA, B, C, dy, dst, ddec, dx, ddA, dB, dC, scratch, nc, Q, H, G, P, N,
                        sx, sB, sC, stream);
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

template <typename T, int PB>
cudaError_t resources_of(int which, int* regs, int* smem) {
  switch (which) {
    case 0: return attrs(bwd_scores<T>, 0, regs, smem);
    case 1: return attrs(bwd_head<T, PB>, head_smem_floats(PB) * (int)sizeof(float), regs, smem);
    case 2: return attrs(bwd_dssum<T>, 0, regs, smem);
    case 3: return attrs(bwd_dc<T>, 0, regs, smem);
    default: return attrs(bwd_db<T>, 0, regs, smem);
  }
}

template <typename T>
cudaError_t resources_pb(int PB, int which, int* regs, int* smem) {
  switch (PB) {
    case 16: return resources_of<T, 16>(which, regs, smem);
    case 32: return resources_of<T, 32>(which, regs, smem);
    default: return resources_of<T, 64>(which, regs, smem);
  }
}

}  // namespace

extern "C" {

// Floats of device scratch a call needs: S, S^T and sum_h dS_h, (nc * G, Q,
// Q) each, and cum (nc, H, Q).
long long ssd_chunk_bwd_scratch_floats(int nc, int Q, int H, int G) {
  return 3LL * nc * G * Q * Q + (long long)nc * H * Q;
}

// x: (nc, Q, H, P) and B, C: (nc, Q, G, N) of one type (bf16 when is_bf16,
// else f32), each token's row packed, tokens `s*` elements apart; dA (nc, Q,
// H), dy (nc, Q, H, P), dst (nc, H, P, N) and ddec (nc, H) contiguous f32.
// Writes dx (nc, Q, H, P), dB and dC (nc, Q, G, N) contiguous in the inputs'
// type and ddA (nc, Q, H) f32.  Q a multiple of 16 up to 256, P <= 64, N <=
// 128, H % G == 0.  Returns a cudaError_t (0 on success), after checking
// cudaGetLastError() behind every launch.
int ssd_chunk_bwd_launch(const void* x, const float* dA, const void* B, const void* C,
                         const float* dy, const float* dst, const float* ddec, void* dx,
                         float* ddA, void* dB, void* dC, float* scratch,
                         long long scratch_floats, int nc, int Q, int H, int G, int P, int N,
                         long long sx, long long sB, long long sC, int is_bf16,
                         cudaStream_t stream) {
  if (nc < 1 || Q < 16 || Q > kMaxQ || Q % 16 || P < 1 || P > kPMax || N < 1 || N > kMaxN ||
      G < 1 || H % G || scratch_floats < ssd_chunk_bwd_scratch_floats(nc, Q, H, G))
    return (int)cudaErrorInvalidValue;
  const int PB = pb_for(P);
  if (is_bf16)
    return (int)dispatch<__nv_bfloat16>(PB, x, dA, B, C, dy, dst, ddec, dx, ddA, dB, dC, scratch,
                                        nc, Q, H, G, P, N, sx, sB, sC, stream);
  return (int)dispatch<float>(PB, x, dA, B, C, dy, dst, ddec, dx, ddA, dB, dC, scratch, nc, Q, H,
                              G, P, N, sx, sB, sC, stream);
}

// Registers a thread and shared memory a block (static plus dynamic) of
// kernel `which` (0 bwd_scores, 1 bwd_head, 2 bwd_dssum, 3 bwd_dc, 4
// bwd_db) for head dim P and the input type.
int ssd_chunk_bwd_resources(int which, int is_bf16, int P, int* regs, int* smem) {
  const int PB = pb_for(P);
  if (is_bf16) return (int)resources_pb<__nv_bfloat16>(PB, which, regs, smem);
  return (int)resources_pb<float>(PB, which, regs, smem);
}

const char* ssd_chunk_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
