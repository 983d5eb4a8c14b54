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
//
// Bound on an H100 SXM: operations.  The two products are 2*B*H*Sq*Sk*D
// multiply-adds (4*B*H*Sq*Sk*D flops), halved when causal; at the serving
// path's prefill shape (B 4, S 4096, H 64, K 8, D 128, bf16) that is
// 1.1e12 flops, 1.1 ms at the 989 TFLOP/s bf16 tensor-core peak, while each
// input read once and the output written once is 0.6 GB, 0.18 ms at
// 3.35 TB/s.  This first kernel does not reach that bound: it works in
// IEEE f32 on CUDA cores (q is scaled in f32 and the scores are f32, as the
// reference has them), whose peak is 67 TFLOP/s, so 16 ms is its floor at
// that shape.  wgmma, TMA and warp specialisation are later work.
//
// Design.  One block of 256 threads per (batch*head, 64-row query tile).
// The block keeps its scaled queries, one KV tile (64 rows, or 32 at
// D = 256) of K and V, and the tile's probabilities in shared memory as f32
// (115 KB at D = 128, 137 KB at D = 256: dynamic shared memory above 48 KB,
// opted into with cudaFuncSetAttribute before each launch).  Each thread
// owns four query rows and a 4 x (BK / 16) register tile of scores, then a
// 4 x (D / 16) register tile of the f32 accumulator; a row's running max
// and sum are reduced across the 16 threads that share it with warp
// shuffles.  Row strides are padded by one float so that the score loop's
// shared-memory reads do not collide in a bank.  Under causal masking the
// KV loop stops at the tile that holds the block's last query position, and
// blocks are issued longest-first so the causal triangle's heavy tiles do
// not trail.  GQA maps the head by index and reads K and V through their
// (B, S, K, D) strides: nothing is repeated or transposed.  The ragged edge
// (Sq or Sk not a multiple of the tile) is masked in the kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;           // query rows per block
constexpr int kThreads = 256;     // 16 x 16: ty picks rows, tx picks columns
constexpr int kRows = kBQ / 16;   // query rows per thread
constexpr float kNegInf = -1e30f; // the reference's masked score

template <int D>
struct Tile {
  static constexpr int BK = D >= 256 ? 32 : 64;  // KV rows per shared-memory tile
};

template <int D>
size_t smem_bytes() {
  constexpr int BK = Tile<D>::BK;
  return sizeof(float) * ((size_t)kBQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D +
                          (size_t)kBQ * (BK + 1));
}

__device__ inline float to_f32(float x) { return x; }
__device__ inline float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ inline T from_f32(float x);
template <>
__device__ inline float from_f32<float>(float x) { return x; }
template <>
__device__ inline __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// p rounded to v's type, back in f32 for the accumulation
template <typename T>
__device__ inline float round_to(float x) { return to_f32(from_f32<T>(x)); }

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Sq, int Sk, int H, int K, int causal, float scale) {
  constexpr int BK = Tile<D>::BK;
  constexpr int CJ = BK / 16;  // score columns per thread
  constexpr int DJ = D / 16;   // accumulator columns per thread
  constexpr int QS = D + 1;    // padded row stride of qs and ks
  constexpr int PS = BK + 1;   // padded row stride of ps
  extern __shared__ float smem[];
  float* qs = smem;             // kBQ x QS  scaled queries
  float* ks = qs + kBQ * QS;    // BK x QS   keys
  float* vs = ks + BK * QS;     // BK x D    values
  float* ps = vs + BK * D;      // kBQ x PS  probabilities, rounded to v's type

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / H, h = blockIdx.y - b * H;
  const int kvh = h / (H / K);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest causal rows first
  const size_t q_row = (size_t)H * D, kv_row = (size_t)K * D;
  const T* qb = q + (size_t)b * Sq * q_row + (size_t)h * D;
  const T* kb = k + (size_t)b * Sk * kv_row + (size_t)kvh * D;
  const T* vb = v + (size_t)b * Sk * kv_row + (size_t)kvh * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    qs[r * QS + d] = q0 + r < Sq ? to_f32(qb[(size_t)(q0 + r) * q_row + d]) * scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int dj = 0; dj < DJ; ++dj) acc[i][dj] = 0.f;
  }

  int n_kv = (Sk + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (q0 + kBQ + BK - 1) / BK);  // tiles at or before the last row

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // qs written (first tile); last tile's ks, vs, ps read
    for (int e = tid; e < BK * D; e += kThreads) {
      const int c = e / D, d = e - c * D;
      const bool in = k0 + c < Sk;
      const size_t off = (size_t)(k0 + c) * kv_row + d;
      ks[c * QS + d] = in ? to_f32(kb[off]) : 0.f;
      vs[c * D + d] = in ? to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    float s[kRows][CJ];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < CJ; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[CJ];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int c = 0; c < CJ; ++c) kv[c] = ks[(tx + 16 * c) * QS + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < CJ; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        const int kpos = k0 + tx + 16 * c;
        if (kpos >= Sk || (causal && kpos > qpos)) s[i][c] = kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        const float p = expf(s[i][c] - m_new);
        sum += p;
        ps[r * PS + tx + 16 * c] = round_to<T>(p);
      }
      const float corr = expf(m[i] - m_new);
      l[i] = corr * l[i] + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int dj = 0; dj < DJ; ++dj) acc[i][dj] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[kRows], vv[DJ];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int dj = 0; dj < DJ; ++dj) vv[dj] = vs[c * D + tx + 16 * dj];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int dj = 0; dj < DJ; ++dj) acc[i][dj] = fmaf(pv[i], vv[dj], acc[i][dj]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-20f);
    T* orow = o + ((size_t)b * Sq + r) * q_row + (size_t)h * D;
#pragma unroll
    for (int dj = 0; dj < DJ; ++dj) orow[tx + 16 * dj] = from_f32<T>(acc[i][dj] / den);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                   int H, int K, int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, H, K, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v, void* o, int B, int Sq,
                     int Sk, int H, int K, int causal, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Sk, H, K, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Sk, H, K, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, K, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, K, causal, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, Sq, Sk, H, K, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, o: (B, Sq, H, D); k, v: (B, Sk, K, D); all contiguous, of one type
// (bf16 when is_bf16, else f32).  Returns the launch's cudaError_t.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                           int Sk, int H, int K, int D, int causal, int is_bf16, float scale,
                           void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || K < 1 || H % K != 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch<__nv_bfloat16>(D, q, k, v, o, B, Sq, Sk, H, K, causal, scale, st)
                       : dispatch<float>(D, q, k, v, o, B, Sq, Sk, H, K, causal, scale, st));
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
