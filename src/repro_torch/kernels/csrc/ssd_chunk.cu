// Mamba-2 SSD intra-chunk block for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `ssd_chunk` in src/repro/kernels/ssd_scan.py
// (kernel body `_kernel`, pallas_call in `ssd_chunk`).  What it computes, for
// x (nc, Q, H, P), dA (nc, Q, H) and B, C (nc, Q, G, N) with H % G == 0,
// head h reading group g = h / (H / G), per chunk c and head h:
//
//   cum         = cumsum(dA[c, :, h])                      f32, in sequence
//   L[i, j]     = exp(cum[i] - cum[j]) if j <= i else 0    selected, never masked by a product
//   y_diag      = ((C B^T) * L) @ x                        (Q, P) f32
//   states      = (x * exp(cum[Q-1] - cum))^T @ B          (P, N) f32
//   chunk_decay = exp(cum[Q-1])
//
// with x, B and C widened to f32 in registers and every sum in f32.  Outputs
// are y_diag (nc, Q, H, P), states (nc, H, P, N) and chunk_decay (nc, H).
//
// Bound on an H100 SXM: bytes.  At the SSM path's prefill shape (mamba2-2.7b,
// batch 4 x 4096 tokens in chunks of 256: nc 64, Q 256, H 80, G 1, P 64,
// N 128, bf16 inputs) the function reads x (168 MB), B, C and dA (14 MB) and
// writes y_diag (336 MB) and states (168 MB): 0.69 GB, 0.20 ms at 3.35 TB/s.
// Its 8.6e10 flops on the causal half take 0.09 ms at the 989 TFLOP/s bf16
// tensor-core peak.  This first kernel works in IEEE f32 on CUDA cores
// (67 TFLOP/s, 1.3 ms at that shape), as the reference computes in f32;
// wgmma, TMA and a fused inter-chunk pass are later work.
//
// Design.  One block of 256 threads per (chunk, head): 5,120 blocks at that
// shape.  dA's chunk goes to shared memory and one thread sums it in
// sequence (the CPU's order).  y_diag runs over 64 x 64 tiles (i, j) with
// j <= i only: L is exactly 0 above the diagonal, so the skipped tiles are
// exact.  For each row tile i the block keeps C_i in shared memory and a
// 4 x 4 register tile of y per thread; for each j it loads B_j and x_j,
// forms the 64 x 64 scores C_i B_j^T over N in registers, multiplies by L
// (selected to 0 where j > i), parks them in shared memory, and accumulates
// scores @ x_j.  Then states: x_j scaled by exp(cum[Q-1] - cum) and B_j per
// tile, a 4 x 8 register tile of the (P, N) state per thread.  Row strides of
// the score and B/C tiles are padded to an odd number of floats, so that the
// inner loops read shared memory without bank conflicts.  B and C are read
// through their group's offset and the token strides the wrapper passes:
// groups are never repeated to heads, and slices of one projection need no
// copy.  Shared memory is 100 KB (dynamic, opted into before each launch).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;            // rows and columns of one (i, j) tile
constexpr int kThreads = 256;     // 16 x 16: ty picks rows, tx picks columns
constexpr int kMaxQ = 256;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kBS = kMaxN + 1;    // padded row stride of the B and C tiles
constexpr int kXS = kMaxP;        // row stride of the x tile
constexpr int kSS = kT + 1;       // padded row stride of the score tile
constexpr size_t kSmemFloats = kMaxQ + 2 * kT * kBS + kT * kXS + kT * kSS;
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;

__device__ inline float to_f32(float x) { return x; }
__device__ inline float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// rows [r0, r0 + kT) of a (Q, width) operand with token stride `tok` into
// `dst` (row stride `ds`), zeros past Q and past `width`; `scale` (may be
// null) multiplies row r by scale[r0 + r].
template <typename T, int kW>
__device__ inline void load_tile(float* dst, int ds, const T* src, long long tok, int r0, int Q,
                                 int width, const float* scale, float scale_ref) {
  for (int e = threadIdx.x; e < kT * kW; e += kThreads) {
    const int r = e / kW, col = e - r * kW;
    const int t = r0 + r;
    float v = 0.f;
    if (t < Q && col < width) {
      v = to_f32(src[(size_t)t * tok + col]);
      if (scale != nullptr) v *= expf(scale_ref - scale[t]);
    }
    dst[r * ds + col] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ssd_chunk_kernel(
    const T* __restrict__ x, const float* __restrict__ dA, const T* __restrict__ B,
    const T* __restrict__ C, float* __restrict__ y, float* __restrict__ states,
    float* __restrict__ decay, int Q, int H, int G, int P, int N, long long x_tok,
    long long b_tok, long long c_tok) {
  extern __shared__ float smem[];
  float* cum = smem;              // kMaxQ      cumsum of dA
  float* cs = cum + kMaxQ;        // kT x kBS   C rows of tile i
  float* bs = cs + kT * kBS;      // kT x kBS   B rows of tile j
  float* xs = bs + kT * kBS;      // kT x kXS   x rows of tile j
  float* ss = xs + kT * kXS;      // kT x kSS   scores * L of tile (i, j)

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int blk = blockIdx.x;
  const int c = blk / H, h = blk - c * H;
  const int g = h / (H / G);
  const T* xc = x + (size_t)c * Q * x_tok + (size_t)h * P;
  const T* bc = B + (size_t)c * Q * b_tok + (size_t)g * N;
  const T* cc = C + (size_t)c * Q * c_tok + (size_t)g * N;

  for (int t = tid; t < Q; t += kThreads) cum[t] = dA[((size_t)c * Q + t) * H + h];
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int t = 0; t < Q; ++t) {
      s += cum[t];
      cum[t] = s;
    }
    decay[blk] = expf(s);
  }
  __syncthreads();
  const float cum_end = cum[Q - 1];
  const int nt = (Q + kT - 1) / kT;

  // ---- y_diag over the causal tiles (i, j), j <= i
  for (int it = 0; it < nt; ++it) {
    const int i0 = it * kT;
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kT;
      __syncthreads();  // the last pass's readers of cs, bs, xs and ss are done
      if (jt == 0) load_tile<T, kMaxN>(cs, kBS, cc, c_tok, i0, Q, N, nullptr, 0.f);
      load_tile<T, kMaxN>(bs, kBS, bc, b_tok, j0, Q, N, nullptr, 0.f);
      load_tile<T, kMaxP>(xs, kXS, xc, x_tok, j0, Q, P, nullptr, 0.f);
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = cs[(ty + 16 * a) * kBS + n];
#pragma unroll
        for (int b = 0; b < 4; ++b) bv[b] = bs[(tx + 16 * b) * kBS + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) s[a][b] = fmaf(cv[a], bv[b], s[a][b]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = i0 + ty + 16 * a;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int col = j0 + tx + 16 * b;
          // select, then exp: above the diagonal cum[r] - cum[col] > 0 may overflow
          const float l = (col <= r && r < Q) ? expf(cum[r] - cum[col]) : 0.f;
          ss[(ty + 16 * a) * kSS + tx + 16 * b] = s[a][b] * l;
        }
      }
      __syncthreads();

      const int jn = min(kT, Q - j0);
#pragma unroll 4
      for (int k = 0; k < jn; ++k) {
        float sv[4], xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) sv[a] = ss[(ty + 16 * a) * kSS + k];
#pragma unroll
        for (int b = 0; b < 4; ++b) xv[b] = xs[k * kXS + tx + 16 * b];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(sv[a], xv[b], acc[a][b]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = i0 + ty + 16 * a;
      if (r >= Q) continue;
      float* yrow = y + (((size_t)c * Q + r) * H + h) * P;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int p = tx + 16 * b;
        if (p < P) yrow[p] = acc[a][b];
      }
    }
  }

  // ---- states[p][n] = sum_t x[t][p] * exp(cum_end - cum[t]) * B[t][n]
  float st[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) st[a][b] = 0.f;
  for (int jt = 0; jt < nt; ++jt) {
    const int j0 = jt * kT;
    __syncthreads();
    load_tile<T, kMaxN>(bs, kBS, bc, b_tok, j0, Q, N, nullptr, 0.f);
    load_tile<T, kMaxP>(xs, kXS, xc, x_tok, j0, Q, P, cum, cum_end);
    __syncthreads();
    const int jn = min(kT, Q - j0);
#pragma unroll 4
    for (int k = 0; k < jn; ++k) {
      float xv[4], bv[8];
#pragma unroll
      for (int a = 0; a < 4; ++a) xv[a] = xs[k * kXS + ty + 16 * a];
#pragma unroll
      for (int b = 0; b < 8; ++b) bv[b] = bs[k * kBS + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) st[a][b] = fmaf(xv[a], bv[b], st[a][b]);
    }
  }
  float* sblk = states + (size_t)blk * P * N;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int p = ty + 16 * a;
    if (p >= P) continue;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int n = tx + 16 * b;
      if (n < N) sblk[(size_t)p * N + n] = st[a][b];
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dA, const void* B, const void* C, void* y,
                   void* states, void* decay, int nc, int Q, int H, int G, int P, int N,
                   long long x_tok, long long b_tok, long long c_tok, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  ssd_chunk_kernel<T><<<nc * H, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dA), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<float*>(y), static_cast<float*>(states),
      static_cast<float*>(decay), Q, H, G, P, N, x_tok, b_tok, c_tok);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (nc, Q, H, P) and B, C: (nc, Q, G, N) of one type (bf16 when is_bf16,
// else f32), each token's row packed, tokens `*_tok` elements apart; dA:
// (nc, Q, H) contiguous f32.  Writes y (nc, Q, H, P), states (nc, H, P, N)
// and decay (nc, H), contiguous f32.  Returns the launch's cudaError_t.
int ssd_chunk_launch(const void* x, const void* dA, const void* B, const void* C, void* y,
                     void* states, void* decay, int nc, int Q, int H, int G, int P, int N,
                     long long x_tok, long long b_tok, long long c_tok, int is_bf16,
                     void* stream) {
  if (nc < 1 || Q < 16 || Q > kMaxQ || Q % 16 != 0 || G < 1 || H % G != 0 || P < 1 ||
      P > kMaxP || N < 1 || N > kMaxN || (long long)nc * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<__nv_bfloat16>(x, dA, B, C, y, states, decay, nc, Q, H, G, P, N,
                                               x_tok, b_tok, c_tok, st)
                       : launch<float>(x, dA, B, C, y, states, decay, nc, Q, H, G, P, N, x_tok,
                                       b_tok, c_tok, st));
}

const char* ssd_chunk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
