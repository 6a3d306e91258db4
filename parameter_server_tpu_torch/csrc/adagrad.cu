// Hand-written Hopper (sm_90a) kernel for the AdaGrad embedding-table push.
//
// Built by parameter_server_tpu_torch/ops/cuda_build.py with the other
// csrc/*.cu into one shared library with a plain C interface, loaded with
// ctypes. The entry point launches on the caller's stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().
//
// ---------------------------------------------------------------------------
// adagrad_push — replaces adagrad_push_pallas
// (parameter_server_tpu/ops/pallas_kernels.py:359; scaffold _push2_pallas
// and _make_push2_kernel, math _adagrad_update_rows).
//
// In-place fused push over the U touched rows of (K, vdim) tables w, n:
// gather w[idx], n[idx], apply AdaGrad in registers, store both rows back.
// The math is the JAX package's, op for op (kv/updaters.py Adagrad.delta
// plus the scatter-add):
//   g' = g + l2*w;  dn = g'*g';  n' = n + dn;  w' = w + (-eta*g'/(sqrt(n')+eps))
// nvcc contracts some multiply-adds into FMAs, so results agree with the
// plain PyTorch version to a few ULPs, not bit for bit.
//
// Bound: device-memory bytes. A touched row moves 4 (idx) + 4*vdim (g) +
// 16*vdim (w, n read and written) = 4 + 20*vdim bytes for about 8 flops
// per element, so at 3.35 TB/s the bytes, never the arithmetic, bound it.
// At vdim 16-64 a row is 64-256 contiguous bytes of each table, so unlike
// the vdim-1 FTRL push every sector it touches is fully used. Design: the
// FTRL push's layout (csrc/ftrl.cu ftrl_push_kernel), one thread per
// (row, column) element, so neighbouring threads read neighbouring columns
// of one row and a warp's access is whole 128-byte lines; many independent
// rows in flight cover the latency of random rows in a large table.
// Vectorised (float4) loads and one warp per row are later work.
//
// Real keys are unique (the store's contract), so plain stores suffice and
// no atomics are needed. Repeated pad slots (idx 0, grad 0) all store row
// 0 unchanged, and so their racing writes are benign, PROVIDED row 0 is
// zero when l2 > 0: a nonzero w[0] would give each pad slot g' = l2*w[0]
// and a real update, which the composite would scatter-ADD once per slot
// and this kernel overwrites once. The framework keeps row 0 zero (init
// zeroes it, pad slots never move it), the same invariant as
// pallas_kernels.py:288-294. A row index outside [0, K) is skipped, never
// written.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// grid-stride loop: cap the grid, each thread walks the rest
constexpr int64_t kMaxBlocks = 1 << 20;

__global__ void __launch_bounds__(kThreads)
adagrad_push_kernel(float* w, float* n, const int32_t* __restrict__ idx,
                    const float* __restrict__ g, int64_t total, int64_t vdim,
                    int64_t num_rows, float eta, float eps, float l2) {
  const int64_t stride = (int64_t)blockDim.x * gridDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t slot = i / vdim;
    const int64_t row = idx[slot];
    if (row < 0 || row >= num_rows) continue;
    const int64_t off = row * vdim + (i - slot * vdim);
    const float wi = w[off];
    const float gi = g[i] + l2 * wi;
    const float n_new = n[off] + gi * gi;
    w[off] = wi + (-eta * gi / (sqrtf(n_new) + eps));
    n[off] = n_new;
  }
}

int blocks_for(int64_t count) {
  int64_t b = (count + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

extern "C" {

int ps_adagrad_push(float* w, float* n, const int32_t* idx, const float* g,
                    long long num_slots, long long vdim, long long num_rows,
                    float eta, float eps, float l2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)num_slots * vdim;
  if (total <= 0) return (int)cudaSuccess;
  adagrad_push_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      w, n, idx, g, total, vdim, num_rows, eta, eps, l2);
  return (int)cudaGetLastError();
}

}  // extern "C"
