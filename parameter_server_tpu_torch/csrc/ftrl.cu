// Hand-written Hopper (sm_90a) kernels for the FTRL-proximal server update.
//
// Built by parameter_server_tpu_torch/ops/ftrl_kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes. Each
// entry point launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() so the wrapper can raise on a
// launch the runtime refused.
//
// The math is the JAX package's, op for op (kv/updaters.py Ftrl.delta and
// ops/pallas_kernels.py _ftrl_update_rows):
//   w      = -sign(z) * max(|z| - l1, 0) / ((beta + sqrt(n)) / alpha + l2)
//   sigma  = (sqrt(n + g*g) - sqrt(n)) / alpha
//   dz     = g - sigma * w,   dn = g*g
// nvcc contracts some multiply-adds into FMAs, so results agree with the
// plain PyTorch version to a few ULPs, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// grid-stride loops: cap the grid, each thread walks the rest
constexpr int64_t kMaxBlocks = 1 << 20;

__device__ __forceinline__ float ftrl_weight(float z, float n, float alpha,
                                             float beta, float l1, float l2) {
  const float sgn = z > 0.f ? 1.f : (z < 0.f ? -1.f : 0.f);
  const float shrunk = sgn * fmaxf(fabsf(z) - l1, 0.f);
  return -shrunk / ((beta + sqrtf(n)) / alpha + l2);
}

// ---------------------------------------------------------------------------
// ftrl_delta — replaces ftrl_delta_pallas
// (parameter_server_tpu/ops/pallas_kernels.py:84, kernel _ftrl_delta_kernel).
//
// Elementwise over flat (N,) arrays: reads z, n, g and writes dz, dn, 20 bytes
// per element for about 15 flops, so it is bound by device-memory bytes
// (3.35 TB/s on an H100 SXM), never by arithmetic. Design: one thread per
// element, neighbouring threads on neighbouring addresses so every warp
// access is one fully used 128-byte line; the lazy weight, sigma and both
// deltas stay in registers, so nothing but the five arrays touches memory.
// The TPU version's (M, 128) lane padding is a VPU layout and is not needed.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
ftrl_delta_kernel(const float* __restrict__ z, const float* __restrict__ n,
                  const float* __restrict__ g, float* __restrict__ dz,
                  float* __restrict__ dn, int64_t count, float alpha,
                  float beta, float l1, float l2) {
  const int64_t stride = (int64_t)blockDim.x * gridDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += stride) {
    const float zi = z[i];
    const float ni = n[i];
    const float gi = g[i];
    const float w = ftrl_weight(zi, ni, alpha, beta, l1, l2);
    const float g2 = gi * gi;
    const float sigma = (sqrtf(ni + g2) - sqrtf(ni)) / alpha;
    dz[i] = gi - sigma * w;
    dn[i] = g2;
  }
}

// ---------------------------------------------------------------------------
// ftrl_push — replaces ftrl_push_pallas
// (parameter_server_tpu/ops/pallas_kernels.py:335; scaffold _push2_pallas,
// DMA kernel _make_push2_kernel, math _ftrl_update_rows).
//
// In-place fused push over the U touched rows of (K, vdim) tables: gather
// z[idx], n[idx], apply the FTRL update in registers, store both rows back.
// Each touched row makes one round trip to device memory, where the
// gather -> delta -> index_add_ composite makes two. Bound: device-memory
// traffic of scattered rows. The useful bytes are 4 (idx) + 4*vdim (g) +
// 16*vdim (z, n read and written) per row, but at vdim 1 every 4-byte row
// access moves a whole 32-byte sector, so the hardware moves about
// 4 + 4 + 4*32 = 136 bytes per row; the kernel is latency- and
// sector-bound, not arithmetic-bound. Design: one thread per (row, column)
// element, so for vdim > 1 neighbouring threads read neighbouring columns
// of one row (coalesced within the row), and many independent loads are in
// flight per SM to cover the latency of the random gathers.
//
// Real keys are unique (the store's contract), so plain stores suffice and
// no atomics are needed. Repeated pad slots (idx 0, grad 0) all store row
// 0's unchanged value, bit-identical, so their concurrent writes are
// benign. A row index outside [0, K) is skipped, never written.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
ftrl_push_kernel(float* z, float* n, const int32_t* __restrict__ idx,
                 const float* __restrict__ g, int64_t total, int64_t vdim,
                 int64_t num_rows, float alpha, float beta, float l1,
                 float l2) {
  const int64_t stride = (int64_t)blockDim.x * gridDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t slot = i / vdim;
    const int64_t row = idx[slot];
    if (row < 0 || row >= num_rows) continue;
    const int64_t off = row * vdim + (i - slot * vdim);
    const float zi = z[off];
    const float ni = n[off];
    const float gi = g[i];
    const float w = ftrl_weight(zi, ni, alpha, beta, l1, l2);
    const float g2 = gi * gi;
    const float sigma = (sqrtf(ni + g2) - sqrtf(ni)) / alpha;
    z[off] = zi + (gi - sigma * w);
    n[off] = ni + g2;
  }
}

int blocks_for(int64_t count) {
  int64_t b = (count + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

extern "C" {

int ps_ftrl_delta(const float* z, const float* n, const float* g, float* dz,
                  float* dn, long long count, float alpha, float beta,
                  float l1, float l2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (count <= 0) return (int)cudaSuccess;
  ftrl_delta_kernel<<<blocks_for(count), kThreads, 0, (cudaStream_t)stream>>>(
      z, n, g, dz, dn, count, alpha, beta, l1, l2);
  return (int)cudaGetLastError();
}

int ps_ftrl_push(float* z, float* n, const int32_t* idx, const float* g,
                 long long num_slots, long long vdim, long long num_rows,
                 float alpha, float beta, float l1, float l2, int device,
                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)num_slots * vdim;
  if (total <= 0) return (int)cudaSuccess;
  ftrl_push_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      z, n, idx, g, total, vdim, num_rows, alpha, beta, l1, l2);
  return (int)cudaGetLastError();
}

const char* ps_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
