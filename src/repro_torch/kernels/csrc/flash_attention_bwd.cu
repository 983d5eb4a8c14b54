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
//   lse = logsumexp(s)                   (row, f32)
//   p   = exp(s - lse)                   (f32)
//   Di  = rowsum(f32(dO) * f32(O))       (row, f32)
//   dP  = f32(dO) @ f32(v)^T
//   dS  = p * (dP - Di)
//   dV  = round_v(p)^T @ f32(dO)         (p rounded to v's type, as the
//                                         forward rounds it before P.V)
//   dK  = dS^T @ (f32(q) * scale)
//   dQ  = scale * dS @ f32(k)
//
// all sums in f32 (IEEE FMAs on the CUDA cores: no TF32, no bf16 products),
// each gradient rounded once to the operand type at the end.
//
// Bound on an H100 SXM: operations.  FlashAttention-2 counts the backward
// as 2.5 times the forward's 4*B*H*Sq*Sk*D flops (halved when causal): five
// products of the forward's two.  At (B 1, S 4096, H 64, K 8, D 128) that
// is 6.9e11 flops, 0.69 ms at the 989 TFLOP/s bf16 tensor-core peak.  This
// kernel runs eight products' worth on the CUDA cores (the stats pass
// recomputes S once more, and dK/dV and dQ each recompute S and dP), so it
// is far from that bound: a simple right kernel first; wgmma and TMA are
// later work.
//
// Three kernels, launched in order on one stream by one C call:
//
// `bwd_stats`: one block per (batch * head, 64-row q tile).  Di from O and
//   dO; lse by an online max and sum over the KV tiles up to the causal
//   frontier (the forward kernel keeps neither, so the forward stays as it
//   is).  Writes lse and Di, (B, H, Sq) f32 scratch the wrapper allocates.
// `bwd_dkdv`: one block per (batch * kv head, BK-row KV tile), K and V tiles
//   held in shared memory.  It loops over the G = H / K query heads of its
//   group and over the q tiles at or past the causal frontier, recomputes S
//   and dP for each, and accumulates dV and dK in registers.  One block owns
//   its KV tile across the whole group, so no atomics are needed and the
//   sums run in a fixed order: the result does not depend on scheduling.
// `bwd_dq`: one block per (batch * head, 64-row q tile), over the KV tiles
//   up to the frontier; dQ accumulates in registers.
//
// 256 threads a block as 16 x 16: for S and dP a thread holds rows
// ty + 16 i and columns tx + 16 c; for an accumulated gradient rows
// ty + 16 i and head-dim columns tx + 16 j.  Operands are converted to f32
// as they are staged into shared memory (rows padded by one float, so a
// column walk hits 16 banks); BK is 64 rows, 32 at D = 256, where the dK/dV
// block's tiles take 214,784 bytes of shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;

__device__ inline float ld(const float* p) { return *p; }
__device__ inline float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ inline void st(float* p, float x) { *p = x; }
__device__ inline void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
// x rounded to T (to nearest even), back in f32: p as the P.V product sees it
__device__ inline float round_to(float x, const float*) { return x; }
__device__ inline float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int D>
struct Tile {
  static constexpr int BQ = 64;                  // query rows a tile
  static constexpr int BK = D >= 256 ? 32 : 64;  // key rows a tile
  static constexpr int DS = D + 1;               // padded row stride of an operand tile
  static constexpr int PS = BK + 1;              // padded row stride of a p / dS tile
  static constexpr int R = BQ / 16;              // query rows a thread (S, dP, dQ)
  static constexpr int C = BK / 16;              // key columns a thread (S, dP)
  static constexpr int RK = BK / 16;             // key rows a thread (dK, dV)
  static constexpr int DJ = D / 16;              // head-dim columns a thread
};

template <int D>
size_t stats_smem() {
  using T = Tile<D>;
  return sizeof(float) * (size_t)(T::BQ + T::BK) * T::DS;
}

template <int D>
size_t dkdv_smem() {
  using T = Tile<D>;
  return sizeof(float) * ((size_t)(2 * T::BK + 2 * T::BQ) * T::DS + 2 * T::BQ * T::PS + 2 * T::BQ);
}

template <int D>
size_t dq_smem() {
  using T = Tile<D>;
  return sizeof(float) * ((size_t)(2 * T::BK + 2 * T::BQ) * T::DS + T::BQ * T::PS + 2 * T::BQ);
}

__device__ inline float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ inline float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// rows [row0, row0 + rows) of one head of a (S, heads, D) slab into dst
// (f32, row stride D + 1), times mul; rows at or past S as zeros.
template <int D, typename T>
__device__ inline void stage(float* dst, const T* src, int row0, int rows, int S,
                             size_t row_stride, float mul) {
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    dst[r * (D + 1) + d] = row0 + r < S ? ld(src + (size_t)(row0 + r) * row_stride + d) * mul : 0.f;
  }
}

// s = qs . ks^T and dp = gs . vs^T for a thread's R x C entries.
template <int D>
__device__ inline void scores(const float* qs, const float* gs, const float* ks,
                              const float* vs, int tx, int ty,
                              float (&s)[Tile<D>::R][Tile<D>::C],
                              float (&dp)[Tile<D>::R][Tile<D>::C]) {
  constexpr int R = Tile<D>::R, C = Tile<D>::C, DS = Tile<D>::DS;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[R], gv[R], kv[C], vv[C];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      qv[i] = qs[(ty + 16 * i) * DS + d];
      gv[i] = gs[(ty + 16 * i) * DS + d];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      kv[c] = ks[(tx + 16 * c) * DS + d];
      vv[c] = vs[(tx + 16 * c) * DS + d];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
        dp[i][c] = fmaf(gv[i], vv[c], dp[i][c]);
      }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) bwd_stats(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ o,
    const T* __restrict__ dout, float* __restrict__ lse, float* __restrict__ di, int Sq, int Sk,
    int H, int K, int causal, float scale) {
  using Tl = Tile<D>;
  constexpr int BQ = Tl::BQ, BK = Tl::BK, DS = Tl::DS, R = Tl::R, C = Tl::C;
  extern __shared__ float smem[];
  float* qs = smem;          // BQ x DS  scaled queries
  float* ks = qs + BQ * DS;  // BK x DS  keys
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H, kvh = h / (H / K);
  const int q0 = blockIdx.x * BQ;
  const size_t q_row = (size_t)H * D, kv_row = (size_t)K * D;
  const size_t q_off = (size_t)b * Sq * q_row + (size_t)h * D;
  const T* kb = k + (size_t)b * Sk * kv_row + (size_t)kvh * D;

#pragma unroll
  for (int i = 0; i < R; ++i) {  // Di: 16 threads a row
    const int qpos = q0 + ty + 16 * i;
    float acc = 0.f;
    if (qpos < Sq)
      for (int d = tx; d < D; d += 16) {
        const size_t off = q_off + (size_t)qpos * q_row + d;
        acc = fmaf(ld(dout + off), ld(o + off), acc);
      }
    acc = row_sum16(acc);
    if (tx == 0 && qpos < Sq) di[(size_t)bh * Sq + qpos] = acc;
  }

  stage<D>(qs, q + q_off, q0, BQ, Sq, q_row, scale);
  float m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  int n_kv = (Sk + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (q0 + BQ + BK - 1) / BK);
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // qs staged (first tile); the last tile's ks read
    stage<D>(ks, kb, k0, BK, Sk, kv_row, 1.f);
    __syncthreads();
    float s[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[R], kv[C];
#pragma unroll
      for (int i = 0; i < R; ++i) qv[i] = qs[(ty + 16 * i) * DS + d];
#pragma unroll
      for (int c = 0; c < C; ++c) kv[c] = ks[(tx + 16 * c) * DS + d];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int kpos = k0 + tx + 16 * c;
        if (kpos >= Sk || (causal && kpos > qpos)) s[i][c] = kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) sum += s[i][c] == kNegInf ? 0.f : expf(s[i][c] - m_new);
      l[i] = (m[i] == kNegInf ? 0.f : expf(m[i] - m_new) * l[i]) + row_sum16(sum);
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (tx == 0 && qpos < Sq) lse[(size_t)bh * Sq + qpos] = m[i] + logf(l[i]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) bwd_dkdv(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ di,
    T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H, int K, int causal,
    float scale) {
  using Tl = Tile<D>;
  constexpr int BQ = Tl::BQ, BK = Tl::BK, DS = Tl::DS, PS = Tl::PS, R = Tl::R, C = Tl::C,
                RK = Tl::RK, DJ = Tl::DJ;
  extern __shared__ float smem[];
  float* ks = smem;           // BK x DS  keys
  float* vs = ks + BK * DS;   // BK x DS  values
  float* qs = vs + BK * DS;   // BQ x DS  scaled queries
  float* gs = qs + BQ * DS;   // BQ x DS  output gradient dO
  float* ps = gs + BQ * DS;   // BQ x PS  p rounded to v's type
  float* dss = ps + BQ * PS;  // BQ x PS  dS
  float* ls = dss + BQ * PS;  // BQ       lse
  float* dis = ls + BQ;       // BQ       Di
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bk = blockIdx.y, b = bk / K, kvh = bk - b * K, G = H / K;
  const int k0 = blockIdx.x * BK;  // blocks of the first KV tiles, the longest, first
  const size_t q_row = (size_t)H * D, kv_row = (size_t)K * D;
  const size_t kv_off = (size_t)b * Sk * kv_row + (size_t)kvh * D;
  stage<D>(ks, k + kv_off, k0, BK, Sk, kv_row, 1.f);
  stage<D>(vs, v + kv_off, k0, BK, Sk, kv_row, 1.f);

  float acc_k[RK][DJ], acc_v[RK][DJ];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int n_q = (Sq + BQ - 1) / BQ;
  const int first_q = causal ? min(k0 / BQ, n_q) : 0;  // q tiles holding a row >= k0
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t q_off = (size_t)b * Sq * q_row + (size_t)h * D;
    const size_t row_off = ((size_t)b * H + h) * Sq;
    for (int qt = first_q; qt < n_q; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // ks, vs staged (first pass); the last pass's tiles read
      stage<D>(qs, q + q_off, q0, BQ, Sq, q_row, scale);
      stage<D>(gs, dout + q_off, q0, BQ, Sq, q_row, 1.f);
      for (int r = tid; r < BQ; r += kThreads) {
        const bool in = q0 + r < Sq;
        ls[r] = in ? lse[row_off + q0 + r] : 0.f;
        dis[r] = in ? di[row_off + q0 + r] : 0.f;
      }
      __syncthreads();
      float s[R][C], dp[R][C];
      scores<D>(qs, gs, ks, vs, tx, ty, s, dp);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = ty + 16 * i, qpos = q0 + r;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int col = tx + 16 * c, kpos = k0 + col;
          const bool masked = qpos >= Sq || kpos >= Sk || (causal && kpos > qpos);
          const float p = masked ? 0.f : expf(s[i][c] - ls[r]);
          ps[r * PS + col] = round_to(p, v);
          dss[r * PS + col] = p * (dp[i][c] - dis[r]);
        }
      }
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pv[RK], sv[RK], gv[DJ], qv[DJ];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pv[i] = ps[r * PS + ty + 16 * i];
          sv[i] = dss[r * PS + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          gv[j] = gs[r * DS + tx + 16 * j];
          qv[j] = qs[r * DS + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            acc_v[i][j] = fmaf(pv[i], gv[j], acc_v[i][j]);
            acc_k[i][j] = fmaf(sv[i], qv[j], acc_k[i][j]);
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= Sk) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const size_t off = kv_off + (size_t)kpos * kv_row + tx + 16 * j;
      st(dk + off, acc_k[i][j]);
      st(dv + off, acc_v[i][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) bwd_dq(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ di,
    T* __restrict__ dq, int Sq, int Sk, int H, int K, int causal, float scale) {
  using Tl = Tile<D>;
  constexpr int BQ = Tl::BQ, BK = Tl::BK, DS = Tl::DS, PS = Tl::PS, R = Tl::R, C = Tl::C,
                DJ = Tl::DJ;
  extern __shared__ float smem[];
  float* qs = smem;           // BQ x DS  scaled queries
  float* gs = qs + BQ * DS;   // BQ x DS  dO
  float* ks = gs + BQ * DS;   // BK x DS  keys
  float* vs = ks + BK * DS;   // BK x DS  values
  float* dss = vs + BK * DS;  // BQ x PS  dS
  float* ls = dss + BQ * PS;  // BQ       lse
  float* dis = ls + BQ;       // BQ       Di
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H, kvh = h / (H / K);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest causal rows first
  const size_t q_row = (size_t)H * D, kv_row = (size_t)K * D;
  const size_t q_off = (size_t)b * Sq * q_row + (size_t)h * D;
  const size_t kv_off = (size_t)b * Sk * kv_row + (size_t)kvh * D;
  const size_t row_off = (size_t)bh * Sq;
  stage<D>(qs, q + q_off, q0, BQ, Sq, q_row, scale);
  stage<D>(gs, dout + q_off, q0, BQ, Sq, q_row, 1.f);
  for (int r = tid; r < BQ; r += kThreads) {
    const bool in = q0 + r < Sq;
    ls[r] = in ? lse[row_off + q0 + r] : 0.f;
    dis[r] = in ? di[row_off + q0 + r] : 0.f;
  }

  float acc[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  int n_kv = (Sk + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (q0 + BQ + BK - 1) / BK);
  for (int jt = 0; jt < n_kv; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();  // qs, gs, ls, dis staged (first tile); the last tile's ks, vs, dss read
    stage<D>(ks, k + kv_off, k0, BK, Sk, kv_row, 1.f);
    stage<D>(vs, v + kv_off, k0, BK, Sk, kv_row, 1.f);
    __syncthreads();
    float s[R][C], dp[R][C];
    scores<D>(qs, gs, ks, vs, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + 16 * i, qpos = q0 + r;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = tx + 16 * c, kpos = k0 + col;
        const bool masked = qpos >= Sq || kpos >= Sk || (causal && kpos > qpos);
        const float p = masked ? 0.f : expf(s[i][c] - ls[r]);
        dss[r * PS + col] = p * (dp[i][c] - dis[r]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float sv[R], kv[DJ];
#pragma unroll
      for (int i = 0; i < R; ++i) sv[i] = dss[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = ks[c * DS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(sv[i], kv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Sq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      st(dq + q_off + (size_t)qpos * q_row + tx + 16 * j, acc[i][j] * scale);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   float* lse, float* di, void* dq, void* dk, void* dv, int B, int Sq, int Sk,
                   int H, int K, int causal, float scale, cudaStream_t st) {
  using Tl = Tile<D>;
  const size_t s1 = stats_smem<D>(), s2 = dkdv_smem<D>(), s3 = dq_smem<D>();
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(bwd_stats<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)s1)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(bwd_dkdv<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)s2)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(bwd_dq<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)s3)) != cudaSuccess)
    return e;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const int nq = (Sq + Tl::BQ - 1) / Tl::BQ, nk = (Sk + Tl::BK - 1) / Tl::BK;
  bwd_stats<T, D><<<dim3(nq, B * H), kThreads, s1, st>>>(
      qt, kt, static_cast<const T*>(o), gt, lse, di, Sq, Sk, H, K, causal, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  bwd_dkdv<T, D><<<dim3(nk, B * K), kThreads, s2, st>>>(
      qt, kt, vt, gt, lse, di, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, K, causal,
      scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  bwd_dq<T, D><<<dim3(nq, B * H), kThreads, s3, st>>>(qt, kt, vt, gt, lse, di,
                                                      static_cast<T*>(dq), Sq, Sk, H, K, causal,
                                                      scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t resources(int which, int* regs, int* smem, int* local) {
  cudaFuncAttributes a;
  cudaError_t e;
  size_t dyn;
  if (which == 0) {
    e = cudaFuncGetAttributes(&a, bwd_stats<T, D>);
    dyn = stats_smem<D>();
  } else if (which == 1) {
    e = cudaFuncGetAttributes(&a, bwd_dkdv<T, D>);
    dyn = dkdv_smem<D>();
  } else {
    e = cudaFuncGetAttributes(&a, bwd_dq<T, D>);
    dyn = dq_smem<D>();
  }
  if (e != cudaSuccess) return e;
  *regs = a.numRegs;
  *smem = (int)(a.sharedSizeBytes + dyn);
  *local = (int)a.localSizeBytes;
  return cudaSuccess;
}

#define BWD_DISPATCH(FN, T, ...)                 \
  switch (D) {                                   \
    case 16: return FN<T, 16>(__VA_ARGS__);      \
    case 32: return FN<T, 32>(__VA_ARGS__);      \
    case 64: return FN<T, 64>(__VA_ARGS__);      \
    case 128: return FN<T, 128>(__VA_ARGS__);    \
    case 256: return FN<T, 256>(__VA_ARGS__);    \
    default: return cudaErrorInvalidValue;       \
  }

}  // namespace

extern "C" {

// q, o, dout, dq: (B, Sq, H, D); k, v, dk, dv: (B, Sk, K, D); all contiguous
// and of one type (bf16 when is_bf16, else f32); lse, di: (B, H, Sq) f32
// scratch.  Launches the three kernels on `stream`; returns the first
// launch's cudaError_t that is not cudaSuccess, else cudaSuccess.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, void* lse, void* di, void* dq, void* dk,
                               void* dv, int B, int Sq, int Sk, int H, int K, int D, int causal,
                               int is_bf16, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || K < 1 || H % K != 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* d = static_cast<float*>(di);
  if (is_bf16) {
    BWD_DISPATCH(launch, __nv_bfloat16, q, k, v, o, dout, l, d, dq, dk, dv, B, Sq, Sk, H, K,
                 causal, scale, st)
  }
  BWD_DISPATCH(launch, float, q, k, v, o, dout, l, d, dq, dk, dv, B, Sq, Sk, H, K, causal, scale,
               st)
}

// Registers a thread, shared memory a block (static plus dynamic) and local
// memory a thread (spills) of kernel `which` (0 stats, 1 dK/dV, 2 dQ) at
// head dim D.
int flash_attention_bwd_resources(int D, int is_bf16, int which, int* regs, int* smem,
                                  int* local) {
  if (is_bf16) BWD_DISPATCH(resources, __nv_bfloat16, which, regs, smem, local)
  BWD_DISPATCH(resources, float, which, regs, smem, local)
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
