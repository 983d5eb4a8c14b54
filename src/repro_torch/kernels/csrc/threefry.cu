// jax.random's threefry2x32 draws on the card: one launch fills one tensor.
//
// Replaces no TPU kernel.  The JAX package draws its initial weights and
// batches with XLA's threefry2x32 primitive (jax.random), not through
// Pallas; the port draws the same numbers on the card so that one key gives
// the JAX package's weights at widths the host cannot draw (billions of
// parameters: the host generator, util/prng.py, draws about half a million
// normals a second).  Its plain version is util/prng.py's numpy path
// (Draw.at), which equals jax 0.9.0 on the CPU bit for bit; this kernel
// equals that bit for bit by construction:
//
//  * element i of a draw is threefry2x32 (20 rounds) of the key over the
//    partitionable counter pair (i >> 32, i & 0xffffffff), the draw's bits
//    its two output words xor-ed;
//  * every f32 operation is rounded on its own (__fmul_rn, __fadd_rn,
//    __fsub_rn, __fdiv_rn, __fsqrt_rn), and a fused multiply-add
//    (__fmaf_rn) stands exactly where prng.py calls _fma32: where XLA's CPU
//    compiler fuses one.  nvcc's default --fmad=true would otherwise contract
//    products and sums that XLA did not fuse;
//  * log, log1p and erfinv are prng.py's own polynomials (_log32, _log1p32,
//    _erfinv32: XLA's CPU functions), not libdevice's logf or erfinvf;
//  * bf16 results are rounded with __float2bfloat16_rn.
//
// Bound: integer operations.  A threefry2x32 block is 20 rounds of add,
// rotate (one funnel shift) and xor plus five key injections, about 73
// INT32 operations an element (two blocks for randint), against 2 or 4
// bytes written; on an H100 the INT32 rate is a quarter of the f32 FMA
// rate in operations, so the operations, not the writes, bound it.  The
// design does nothing clever: a grid-stride loop, one element a thread an
// iteration, each thread recomputing the key schedule once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf {

enum Kind : int { BITS = 0, UNIFORM = 1, NORMAL = 2, TRUNC_NORMAL = 3, RANDINT = 4,
                  NORMAL_BF16 = 5 };
enum Out : int { OUT_I32 = 0, OUT_F32 = 1, OUT_BF16 = 2, OUT_I64 = 3 };

struct Args {
  uint32_t k0, k1;  // the key
  uint32_t k2, k3;  // randint's second key (the first is k0, k1)
  float f[6];       // the transform's f32 constants (prng.Draw.f)
  uint32_t i[3];    // randint's lo, span, multiplier (prng.Draw.i)
};

__device__ __forceinline__ uint32_t rotl(uint32_t v, int d) { return __funnelshift_l(v, v, d); }

// threefry2x32 of (k0, k1) over (hi, lo), the two output words xor-ed.
__device__ __forceinline__ uint32_t block_bits(uint32_t k0, uint32_t k1, uint64_t idx) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  uint32_t x0 = static_cast<uint32_t>(idx >> 32) + ks[0];
  uint32_t x1 = static_cast<uint32_t>(idx) + ks[1];
#define TF_ROUND(r) x0 += x1; x1 = rotl(x1, r) ^ x0;
#define TF_EVEN TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_ODD TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  TF_EVEN x0 += ks[1]; x1 += ks[2] + 1u;
  TF_ODD  x0 += ks[2]; x1 += ks[0] + 2u;
  TF_EVEN x0 += ks[0]; x1 += ks[1] + 3u;
  TF_ODD  x0 += ks[1]; x1 += ks[2] + 4u;
  TF_EVEN x0 += ks[2]; x1 += ks[0] + 5u;
#undef TF_ODD
#undef TF_EVEN
#undef TF_ROUND
  return x0 ^ x1;
}

// prng._uniform_bits: max(lo, (mantissa in [1, 2) - 1) * span + lo), fused.
__device__ __forceinline__ float uniform_bits(uint32_t b, float lo, float span) {
  const float floats = __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.0f);
  return fmaxf(lo, __fmaf_rn(floats, span, lo));
}

// prng._log32: XLA's CPU log of a positive float.
__device__ float log32(float x) {
  x = fmaxf(1.17549435e-38f, x);
  const uint32_t b = __float_as_uint(x);
  float e = __fadd_rn(static_cast<float>(static_cast<int>(b >> 23) - 0x7F), 1.0f);
  float m = __uint_as_float((b & 0x807FFFFFu) | 0x3F000000u);
  const bool low = m < 0.707106781186547524f;
  e = __fsub_rn(e, low ? 1.0f : 0.0f);
  m = __fadd_rn(__fsub_rn(m, 1.0f), low ? m : 0.0f);
  const float m2 = __fmul_rn(m, m);
  const float m3 = __fmul_rn(m2, m);
  float y = __fmaf_rn(__fmaf_rn(m, 7.0376836292e-2f, -1.1514610310e-1f), m, 1.1676998740e-1f);
  const float y1 =
      __fmaf_rn(__fmaf_rn(m, -1.2420140846e-1f, 1.4249322787e-1f), m, -1.6668057665e-1f);
  const float y2 =
      __fmaf_rn(__fmaf_rn(m, 2.0000714765e-1f, -2.4999993993e-1f), m, 3.3333331174e-1f);
  y = __fmaf_rn(__fmaf_rn(y, m3, y1), m3, y2);
  y = __fmaf_rn(y, m3, __fmul_rn(-2.12194440e-4f, e));
  m = __fadd_rn(__fmaf_rn(-0.5f, m2, m), y);
  return __fmaf_rn(0.693359375f, e, m);
}

// prng._log1p32: XLA's CPU log1p for x > -1.
__device__ float log1p32(float x) {
  if (!(fabsf(x) < 0.41421356237309504880f)) return log32(__fadd_rn(x, 1.0f));
  const float num[7] = {4.5270000862445199635215e-5f, 4.9854102823193375972212e-1f,
                        6.5787325942061044846969e0f,  2.9911919328553073277375e1f,
                        6.0949667980987787057556e1f,  5.7112963590585538103336e1f,
                        2.0039553499201281259648e1f};
  const float den[7] = {1.0f,
                        1.5062909083469192043167e1f, 8.3047565967967209469434e1f,
                        2.2176239823732856465394e2f, 3.0909872225312059774938e2f,
                        2.1642788614495947685003e2f, 6.0118660497603843919306e1f};
  float pn = 0.0f, pd = 0.0f;
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    pn = __fmaf_rn(pn, x, num[k]);
    pd = __fmaf_rn(pd, x, den[k]);
  }
  const float x2 = __fmul_rn(x, x);
  const float r = __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(pn, pd));
  return __fadd_rn(x, __fmaf_rn(-0.5f, x2, r));
}

// prng._erfinv32: XLA's f32 erfinv for |x| < 1.
__device__ float erfinv32(float x) {
  float w = -log1p32(__fmul_rn(-x, x));
  float p;
  if (w < 5.0f) {
    w = __fsub_rn(w, 2.5f);
    p = 2.81022636e-08f;
    p = __fmaf_rn(p, w, 3.43273939e-07f);
    p = __fmaf_rn(p, w, -3.5233877e-06f);
    p = __fmaf_rn(p, w, -4.39150654e-06f);
    p = __fmaf_rn(p, w, 0.00021858087f);
    p = __fmaf_rn(p, w, -0.00125372503f);
    p = __fmaf_rn(p, w, -0.00417768164f);
    p = __fmaf_rn(p, w, 0.246640727f);
    p = __fmaf_rn(p, w, 1.50140941f);
  } else {
    w = __fsub_rn(__fsqrt_rn(w), 3.0f);
    p = -0.000200214257f;
    p = __fmaf_rn(p, w, 0.000100950558f);
    p = __fmaf_rn(p, w, 0.00134934322f);
    p = __fmaf_rn(p, w, -0.00367342844f);
    p = __fmaf_rn(p, w, 0.00573950773f);
    p = __fmaf_rn(p, w, -0.0076224613f);
    p = __fmaf_rn(p, w, 0.00943887047f);
    p = __fmaf_rn(p, w, 1.00167406f);
    p = __fmaf_rn(p, w, 2.83297682f);
  }
  return __fmul_rn(p, x);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ void store(T* out, uint64_t i, float v);
template <>
__device__ __forceinline__ void store<float>(float* out, uint64_t i, float v) { out[i] = v; }
template <>
__device__ __forceinline__ void store<__nv_bfloat16>(__nv_bfloat16* out, uint64_t i, float v) {
  out[i] = __float2bfloat16_rn(v);
}

template <int KIND, typename T>
__global__ void __launch_bounds__(256) fill(T* __restrict__ out, uint64_t n, Args a) {
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t b = block_bits(a.k0, a.k1, i);
    if constexpr (KIND == BITS) {
      out[i] = static_cast<T>(static_cast<int32_t>(b));
    } else if constexpr (KIND == RANDINT) {
      // jax's _randint: uint32 wrap-around in the product and the sums
      const uint32_t lo_bits = block_bits(a.k2, a.k3, i);
      const uint32_t span = a.i[1];
      const uint32_t off = ((b % span) * a.i[2] + lo_bits % span) % span;
      out[i] = static_cast<T>(static_cast<int32_t>(a.i[0] + off));
    } else if constexpr (KIND == UNIFORM) {
      store<T>(out, i, uniform_bits(b, a.f[0], a.f[1]));
    } else if constexpr (KIND == NORMAL) {
      const float z = __fmul_rn(a.f[2], erfinv32(uniform_bits(b, a.f[0], a.f[1])));
      store<T>(out, i, __fmul_rn(z, a.f[3]));
    } else if constexpr (KIND == TRUNC_NORMAL) {
      float z = __fmul_rn(1.41421353816986083984375f, erfinv32(uniform_bits(b, a.f[0], a.f[1])));
      z = fminf(fmaxf(z, a.f[2]), a.f[3]);
      float v = __fmul_rn(z, a.f[4]);
      if constexpr (sizeof(T) == 2) {
        v = __fmul_rn(round_bf16(v), a.f[5]);
      } else {
        v = __fmul_rn(v, a.f[5]);
      }
      store<T>(out, i, v);
    } else {  // NORMAL_BF16: 8 random bits make a bf16 uniform; bf16 products
      const uint32_t m = ((b & 0xFFu) >> 1) | 0x3F80u;
      const float floats = __fsub_rn(__uint_as_float(m << 16), 1.0f);
      const float u = fmaxf(a.f[0], __fadd_rn(__fmul_rn(floats, a.f[1]), a.f[0]));
      store<T>(out, i, __fmul_rn(a.f[2], round_bf16(erfinv32(u))));
    }
  }
}

template <int KIND, typename T>
cudaError_t launch(void* out, uint64_t n, const Args& a, cudaStream_t stream) {
  const int threads = 256;
  const uint64_t want = (n + threads - 1) / threads;
  const unsigned blocks = static_cast<unsigned>(want < 132ull * 16 ? want : 132ull * 16);
  fill<KIND, T><<<blocks, threads, 0, stream>>>(static_cast<T*>(out), n, a);
  return cudaGetLastError();
}

}  // namespace tf

extern "C" {

// Fill out[0, n) with the draw ``kind`` of the key (k0, k1) (randint's
// second key k2, k3), its constants f[6] and i[3], as out_type.  Returns a
// cudaError_t; an unsupported kind / out_type pair returns
// cudaErrorInvalidValue and launches nothing.
int threefry_fill(void* out, unsigned long long n, int kind, int out_type, unsigned k0,
                  unsigned k1, unsigned k2, unsigned k3, const float* f, const unsigned* iv,
                  void* stream) {
  using namespace tf;
  if (n == 0) return 0;
  Args a;
  a.k0 = k0; a.k1 = k1; a.k2 = k2; a.k3 = k3;
  for (int j = 0; j < 6; ++j) a.f[j] = f[j];
  for (int j = 0; j < 3; ++j) a.i[j] = iv[j];
  if (kind == RANDINT && a.i[1] == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind * 4 + out_type) {
    case BITS * 4 + OUT_I32: return launch<BITS, int32_t>(out, n, a, s);
    case UNIFORM * 4 + OUT_F32: return launch<UNIFORM, float>(out, n, a, s);
    case NORMAL * 4 + OUT_F32: return launch<NORMAL, float>(out, n, a, s);
    case TRUNC_NORMAL * 4 + OUT_F32: return launch<TRUNC_NORMAL, float>(out, n, a, s);
    case TRUNC_NORMAL * 4 + OUT_BF16: return launch<TRUNC_NORMAL, __nv_bfloat16>(out, n, a, s);
    case RANDINT * 4 + OUT_I32: return launch<RANDINT, int32_t>(out, n, a, s);
    case RANDINT * 4 + OUT_I64: return launch<RANDINT, int64_t>(out, n, a, s);
    case NORMAL_BF16 * 4 + OUT_BF16: return launch<NORMAL_BF16, __nv_bfloat16>(out, n, a, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* threefry_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
