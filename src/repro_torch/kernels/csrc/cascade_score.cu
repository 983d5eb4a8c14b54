// Fused whole-cascade proxy scoring for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `cascade_score` in
// src/repro/kernels/proxy_score.py (kernel body `_make_cascade_kernel`,
// pallas_call in `cascade_score`), together with the survivor compaction
// that function's wrapper assembles with an inter-block scan and a scatter.
//
// What it computes, for a record tile x (N, F) and a packed cascade of P
// stages with H*P stacked hidden units (h-major, any weight matrix w2):
//
//   hid   = relu(x @ w1 + b1)                       (N, HP)  never stored
//   s     = (hid @ w2) * out_scale + b2             (N, P)   optional output
//   mask  = (s >= thr) & (row < n_valid)            (N, P)   bool
//   block_counts[b, p] = survivors of stage p in row block b
//
// and, in a second launch, dense ascending survivor row lists per selected
// column: packed[c, base_b + rank within block] = row, tail filled with -1.
// `base_b` is the exclusive scan of block_counts over blocks, which the
// wrapper takes with torch.cumsum between the two launches.  Both outputs
// are deterministic: no atomics, every slot written by exactly one thread.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s fp32 on CUDA cores): the
// main path scores one executor tile of N = 8192 records with F = 64 and
// a few stages.  x is 2 MiB and dominates the bytes (about 0.6 us); the
// fp32 work is 2*N*HP*(F+P) flops, e.g. 0.1 GFLOP (1.6 us) for three
// stages at hidden 32, or 4 MFLOP (0.06 us) for two linear stages.  Both
// are below the few microseconds a launch costs, so at these shapes the
// kernel is latency-bound: launch cost plus the chains of dependent shared-
// and global-memory loads behind each thread's FMAs, not bandwidth or FLOP
// rate.  The design answers that by doing the whole cascade in one launch
// that reads x once: the hidden activations live only in shared memory,
// scores are written only when asked for, and the per-block survivor
// counts come out of the same pass.  Arithmetic is IEEE fp32 FMAs on CUDA
// cores; int8 weight codes widen to fp32 in registers.  Register tiling,
// tensor cores (wgmma) and TMA are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;      // rows per block: one warp's ballot in the compaction
constexpr int kChunk = 32;     // stacked hidden columns per shared-memory chunk
constexpr int kThreads = 256;  // threads per scoring block

__host__ __device__ inline int x_stride(int F) { return F + 1; }  // +1: no bank conflicts across rows
constexpr int kHidStride = kChunk + 1;

size_t scoring_smem_bytes(int F, int P) {
  return sizeof(float) * ((size_t)kRows * x_stride(F) + (size_t)kRows * kHidStride +
                          (size_t)kRows * P) +
         (size_t)kRows * P;
}

template <typename WT>
__global__ void __launch_bounds__(kThreads) cascade_score_kernel(
    const float* __restrict__ x, const WT* __restrict__ w1, const float* __restrict__ b1,
    const WT* __restrict__ w2, const float* __restrict__ b2, const float* __restrict__ thr,
    const float* __restrict__ out_scale, int N, int F, int HP, int P, int n_valid,
    float* __restrict__ scores, uint8_t* __restrict__ mask, int* __restrict__ block_counts) {
  extern __shared__ float smem[];
  const int xs_stride = x_stride(F);
  float* xs = smem;                          // kRows x (F + 1)
  float* hid = xs + kRows * xs_stride;       // kRows x (kChunk + 1)
  float* acc = hid + kRows * kHidStride;     // kRows x P readout sums
  uint8_t* keep = reinterpret_cast<uint8_t*>(acc + kRows * P);  // kRows x P

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, N - r0);

  for (int e = tid; e < kRows * F; e += kThreads) {
    const int r = e / F, f = e - r * F;
    xs[r * xs_stride + f] = r < rows ? x[(size_t)(r0 + r) * F + f] : 0.f;
  }
  for (int e = tid; e < kRows * P; e += kThreads) acc[e] = 0.f;
  __syncthreads();

  for (int c0 = 0; c0 < HP; c0 += kChunk) {
    const int hc = min(kChunk, HP - c0);
    // hidden chunk: consecutive threads take consecutive columns of one
    // row, so a warp's w1 loads are contiguous and its x reads broadcast
    for (int e = tid; e < kRows * hc; e += kThreads) {
      const int r = e / hc, j = e - r * hc;
      const float* xr = xs + r * xs_stride;
      const WT* wc = w1 + c0 + j;
      float h = 0.f;
      for (int f = 0; f < F; ++f) h = fmaf(xr[f], static_cast<float>(wc[(size_t)f * HP]), h);
      hid[r * kHidStride + j] = fmaxf(h + b1[c0 + j], 0.f);
    }
    __syncthreads();
    // readout: each (row, stage) sum is owned by one thread across chunks
    for (int e = tid; e < kRows * P; e += kThreads) {
      const int r = e / P, p = e - r * P;
      const float* hr = hid + r * kHidStride;
      const WT* wc = w2 + (size_t)c0 * P + p;
      float a = acc[e];
      for (int j = 0; j < hc; ++j) a = fmaf(hr[j], static_cast<float>(wc[(size_t)j * P]), a);
      acc[e] = a;
    }
    __syncthreads();
  }

  for (int e = tid; e < kRows * P; e += kThreads) {
    const int r = e / P, p = e - r * P;
    const int row = r0 + r;
    float s = acc[e];
    if (out_scale != nullptr) s = __fmul_rn(s, out_scale[p]);
    s = __fadd_rn(s, b2[p]);
    const bool m = r < rows && row < n_valid && s >= thr[p];
    keep[e] = m;
    if (r < rows) {
      if (scores != nullptr) scores[(size_t)row * P + p] = s;
      mask[(size_t)row * P + p] = m;
    }
  }
  if (block_counts != nullptr) {
    __syncthreads();
    for (int p = tid; p < P; p += kThreads) {
      int c = 0;
      for (int r = 0; r < kRows; ++r) c += keep[r * P + p];
      block_counts[(size_t)blockIdx.x * P + p] = c;
    }
  }
}

// One warp per kRows-row block (the scoring kernel's blocks), blockIdx.y
// is the selected column.  A ballot ranks the block's survivors; the tail
// slots [totals[c], N) are filled with -1 by the thread whose row index
// equals the slot, so every slot of packed[c] is written exactly once.
__global__ void cascade_compact_kernel(const uint8_t* __restrict__ mask,
                                       const int* __restrict__ block_base,
                                       const int* __restrict__ cols,
                                       const int* __restrict__ totals, int N, int P, int C,
                                       int n_blocks, int* __restrict__ packed) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int c = blockIdx.y;
  if (b >= n_blocks) return;  // whole warps leave together
  const int row = b * kRows + lane;
  const bool m = row < N && mask[(size_t)row * P + cols[c]];
  const unsigned ballot = __ballot_sync(0xffffffffu, m);
  int* out = packed + (size_t)c * N;
  if (m) out[block_base[(size_t)b * C + c] + __popc(ballot & ((1u << lane) - 1u))] = row;
  if (row < N && row >= totals[c]) out[row] = -1;
}

template <typename WT>
int launch_scoring(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, const void* thr, const void* out_scale, int N, int F,
                   int HP, int P, int n_valid, void* scores, void* mask, void* block_counts,
                   cudaStream_t stream) {
  const size_t smem = scoring_smem_bytes(F, P);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(cascade_score_kernel<WT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_blocks = (N + kRows - 1) / kRows;
  cascade_score_kernel<WT><<<n_blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const WT*>(w1), static_cast<const float*>(b1),
      static_cast<const WT*>(w2), static_cast<const float*>(b2), static_cast<const float*>(thr),
      static_cast<const float*>(out_scale), N, F, HP, P, n_valid, static_cast<float*>(scores),
      static_cast<uint8_t*>(mask), static_cast<int*>(block_counts));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per scoring block: block_counts has ceil(N / rows) rows.
int cascade_rows_per_block() { return kRows; }

// w_int8 = 1: w1 and w2 hold int8 codes; 0: float32.  out_scale, scores and
// block_counts may be null.  Returns cudaGetLastError() after the launch.
int cascade_score_launch(const void* x, const void* w1, const void* b1, const void* w2,
                         const void* b2, const void* thr, const void* out_scale, int w_int8,
                         int N, int F, int HP, int P, int n_valid, void* scores, void* mask,
                         void* block_counts, void* stream) {
  if (N <= 0 || F <= 0 || HP <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w_int8 ? launch_scoring<int8_t>(x, w1, b1, w2, b2, thr, out_scale, N, F, HP, P,
                                         n_valid, scores, mask, block_counts, s)
                : launch_scoring<float>(x, w1, b1, w2, b2, thr, out_scale, N, F, HP, P,
                                        n_valid, scores, mask, block_counts, s);
}

int cascade_compact_launch(const void* mask, const void* block_base, const void* cols,
                           const void* totals, int N, int P, int C, void* packed,
                           void* stream) {
  if (N <= 0 || P <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const int n_blocks = (N + kRows - 1) / kRows;
  const int warps = kThreads / 32;
  dim3 grid((n_blocks + warps - 1) / warps, C);
  cascade_compact_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<const int*>(block_base),
      static_cast<const int*>(cols), static_cast<const int*>(totals), N, P, C, n_blocks,
      static_cast<int*>(packed));
  return (int)cudaGetLastError();
}

const char* cascade_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
