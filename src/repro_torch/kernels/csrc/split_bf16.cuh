// The f32 routes' pre-pass, shared by flash_attention.cu (K and V, one
// launch each) and flash_attention_bwd.cu (q, k, v and dO in one launch):
// f32 -> bf16 hi, mid and lo (hopper::split3_bf16), 4 elements a thread.
// Internal linkage: each library that includes it has its own copy.
// Include after hopper.cuh.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace split {
namespace {

// Up to four tensors in one launch: segment t's blocks are [first[t],
// first[t + 1]).
struct Segments {
  const float* src[4];
  __nv_bfloat16* hi[4];
  __nv_bfloat16* mid[4];
  __nv_bfloat16* lo[4];
  long long n[4];
  unsigned first[5];
};

__global__ void split_bf16_segments(const __grid_constant__ Segments sg) {
  int t = 0;
  while (blockIdx.x >= sg.first[t + 1]) ++t;
  const long long n = sg.n[t];
  const long long i = (long long)(blockIdx.x - sg.first[t]) * blockDim.x + threadIdx.x;
  if (4 * i >= n) return;
  const float* src = sg.src[t];
  if (4 * i + 4 <= n) {
    const float4 v = reinterpret_cast<const float4*>(src)[i];
    uint2 h, m, l;
    hopper::split3_bf16(v.x, v.y, h.x, m.x, l.x);
    hopper::split3_bf16(v.z, v.w, h.y, m.y, l.y);
    reinterpret_cast<uint2*>(sg.hi[t])[i] = h;
    reinterpret_cast<uint2*>(sg.mid[t])[i] = m;
    reinterpret_cast<uint2*>(sg.lo[t])[i] = l;
    return;
  }
  for (long long e = 4 * i; e < n; ++e) {
    uint32_t h, m, l;
    hopper::split3_bf16(src[e], 0.f, h, m, l);
    sg.hi[t][e] = __ushort_as_bfloat16((unsigned short)(h & 0xFFFFu));
    sg.mid[t][e] = __ushort_as_bfloat16((unsigned short)(m & 0xFFFFu));
    sg.lo[t][e] = __ushort_as_bfloat16((unsigned short)(l & 0xFFFFu));
  }
}

// `count` (<= 4) tensors src[t] (n[t] f32) -> pieces[t][0..2] (bf16), all
// 16-byte aligned, in one launch on `st`; the launch's cudaError_t.
inline cudaError_t launch_segments(int count, const void* const* src, void* (*pieces)[3],
                                   const long long* n, cudaStream_t st) {
  constexpr int threads = 256;
  Segments sg{};
  sg.first[0] = 0;
  for (int t = 0; t < 4; ++t) {
    const bool on = t < count;
    sg.src[t] = on ? static_cast<const float*>(src[t]) : nullptr;
    sg.hi[t] = on ? static_cast<__nv_bfloat16*>(pieces[t][0]) : nullptr;
    sg.mid[t] = on ? static_cast<__nv_bfloat16*>(pieces[t][1]) : nullptr;
    sg.lo[t] = on ? static_cast<__nv_bfloat16*>(pieces[t][2]) : nullptr;
    sg.n[t] = on ? n[t] : 0;
    const long long blocks = ((sg.n[t] + 3) / 4 + threads - 1) / threads;
    if (sg.first[t] + blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    sg.first[t + 1] = sg.first[t] + (unsigned)blocks;
  }
  if (sg.first[4] == 0) return cudaSuccess;
  split_bf16_segments<<<sg.first[4], threads, 0, st>>>(sg);
  return cudaGetLastError();
}

// src (n f32) -> hi, mid, lo (n bf16 each), all 16-byte aligned, on `st`;
// the launch's cudaError_t.
inline cudaError_t launch(const void* src, void* hi, void* mid, void* lo, long long n,
                          cudaStream_t st) {
  void* pieces[1][3] = {{hi, mid, lo}};
  return launch_segments(1, &src, pieces, &n, st);
}

}  // namespace
}  // namespace split
