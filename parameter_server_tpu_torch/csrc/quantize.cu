// Hand-written Hopper (sm_90a) kernel for the stochastic fixed-point
// quantizer of the gradient codec (filters/fixed_point.py).
//
// Built by parameter_server_tpu_torch/ops/cuda_build.py with the other
// csrc/*.cu into one shared library with a plain C interface, loaded with
// ctypes. The entry point launches on the caller's stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().
//
// ---------------------------------------------------------------------------
// quantize_stochastic — replaces quantize_stochastic_pallas
// (parameter_server_tpu/ops/pallas_kernels.py:143, kernel _quantize_kernel).
//
// int8/int16 fixed-point encode with stochastic rounding. lo = min x and
// scale = max(hi - lo, 1e-30) / levels are computed before the launch (as
// the TPU version computes them outside its kernel) and reach the kernel
// as a 2-element device array params = (lo, scale), never as host values,
// so an encode never waits for the device. Per element, in the TPU
// kernel's order:
//   t = (x - lo) / scale;  fl = floor(t);  frac = t - fl
//   q = fl + (u < frac);   out = clamp(q - levels/2, int range)
// with u uniform in [0, 1) from the top 24 bits of a 32-bit random word,
// the TPU kernel's granularity. The clamp is fault F1 of the port: the
// maximum element gives q - levels/2 = 128 (32768 for int16); XLA's cast
// saturates it to 127 (32767), a plain C or PyTorch cast wraps it to -128.
//
// Random bits: Philox4x32-10 (Salmon et al., SC'11), written out below,
// keyed by the 64-bit seed (k0 = low word, k1 = high word) with counter
// (g mod 2^32, g / 2^32, 0, 0) for the group g of 4 consecutive elements;
// element i takes word i % 4 of group i / 4. The plain PyTorch version
// (ops/quantize_kernels.py) emulates the same stream in int64 tensors, so
// the kernel's q equals the plain version's bit for bit: the division is
// IEEE (no fast-math in the build flags) and no multiply-add can be
// contracted. The TPU's per-tile hardware stream is not reproducible and
// is not imitated.
//
// Bound (2^24 elements, the encode_fast payload): device-memory bytes.
// Each element reads 4 bytes and writes 1 (int8) or 2 (int16): 84 MB in
// 25 us, 101 MB in 30 us at 3.35 TB/s. Philox costs 10 rounds of two
// 32x32->64 multiplies and four xors, plus 9 key bumps, for 4 elements:
// about 20 integer operations an element, ~20 us on the 64 INT32 lanes of
// each SM; the float work (division, floor, compare, clamp) takes a few us
// on the 128 FP32 lanes. Design: one thread per group of 4 elements, one
// Philox call, one 16-byte float4 load and one 4- or 8-byte store, in a
// grid-stride loop, so every warp access is whole 128-byte lines; the
// ragged tail (n % 4) and unaligned inputs take scalar accesses.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// grid-stride loop: cap the grid, each thread walks the rest
constexpr int64_t kMaxBlocks = 1 << 16;

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// one element: the TPU kernel's arithmetic, then the clamp before the cast
__device__ __forceinline__ float quantize_one(float x, float lo, float scale,
                                              uint32_t bits, float half,
                                              float qmin, float qmax) {
  const float t = (x - lo) / scale;
  const float fl = floorf(t);
  const float frac = t - fl;
  const float u = (float)(bits >> 8) * 0x1p-24f;
  const float q = fl + (u < frac ? 1.f : 0.f);
  return fminf(fmaxf(q - half, qmin), qmax);
}

template <typename Q> struct Vec4;
template <> struct Vec4<int8_t> { using type = char4; };
template <> struct Vec4<int16_t> { using type = short4; };

template <typename Q>
__global__ void __launch_bounds__(kThreads)
quantize_stochastic_kernel(const float* __restrict__ x,
                           const float* __restrict__ params,
                           Q* __restrict__ q, int64_t n, uint32_t k0,
                           uint32_t k1, float half, float qmin, float qmax,
                           bool vec) {
  const float lo = params[0];
  const float scale = params[1];
  const int64_t groups = (n + 3) / 4;
  const int64_t stride = (int64_t)blockDim.x * gridDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; g < groups;
       g += stride) {
    const uint4 r = philox4x32_10(
        make_uint4((uint32_t)g, (uint32_t)((uint64_t)g >> 32), 0u, 0u), k0, k1);
    const int64_t i = 4 * g;
    if (vec && i + 4 <= n) {
      const float4 v = reinterpret_cast<const float4*>(x)[g];
      typename Vec4<Q>::type out;
      out.x = (Q)quantize_one(v.x, lo, scale, r.x, half, qmin, qmax);
      out.y = (Q)quantize_one(v.y, lo, scale, r.y, half, qmin, qmax);
      out.z = (Q)quantize_one(v.z, lo, scale, r.z, half, qmin, qmax);
      out.w = (Q)quantize_one(v.w, lo, scale, r.w, half, qmin, qmax);
      reinterpret_cast<typename Vec4<Q>::type*>(q)[g] = out;
    } else {
      const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
      for (int j = 0; j < 4 && i + j < n; ++j)
        q[i + j] = (Q)quantize_one(x[i + j], lo, scale, bits[j], half, qmin, qmax);
    }
  }
}

int blocks_for(int64_t count) {
  int64_t b = (count + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

extern "C" {

// x (n,) float32, params (2,) float32 = (lo, scale), q (n,) int8 when
// num_bytes is 1, int16 when it is 2; all on `device`.
int ps_quantize_stochastic(const float* x, const float* params, void* q,
                           long long n, int num_bytes, unsigned int k0,
                           unsigned int k1, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaSuccess;
  if (num_bytes != 1 && num_bytes != 2) return (int)cudaErrorInvalidValue;
  const int64_t groups = ((int64_t)n + 3) / 4;
  // float4 loads need 16-byte alignment, char4 / short4 stores 4 / 8
  const bool vec = (uintptr_t)x % 16 == 0 && (uintptr_t)q % (4 * num_bytes) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (num_bytes == 1) {
    quantize_stochastic_kernel<int8_t><<<blocks_for(groups), kThreads, 0, s>>>(
        x, params, (int8_t*)q, n, k0, k1, 127.f, -128.f, 127.f, vec);
  } else {
    quantize_stochastic_kernel<int16_t><<<blocks_for(groups), kThreads, 0, s>>>(
        x, params, (int16_t*)q, n, k0, k1, 32767.f, -32768.f, 32767.f, vec);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
