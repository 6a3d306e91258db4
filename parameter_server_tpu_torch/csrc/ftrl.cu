// Hand-written Hopper (sm_90a) kernels for the FTRL-proximal server update.
//
// Built by parameter_server_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC
// and linked with the other csrc/*.cu into one shared library with a plain
// C interface, loaded with ctypes; ps_cuda_error_string below serves them
// all. Each
// entry point launches on the caller's stream, allocates nothing, does not
// synchronise, and returns the first CUDA error (or cudaGetLastError()
// after the launch) so the wrapper can raise on a launch the runtime
// refused.
//
// The math is the JAX package's, op for op (kv/updaters.py Ftrl.delta and
// ops/pallas_kernels.py _ftrl_update_rows):
//   w      = -sign(z) * max(|z| - l1, 0) / ((beta + sqrt(n)) / alpha + l2)
//   sigma  = (sqrt(n + g*g) - sqrt(n)) / alpha
//   dz     = g - sigma * w,   dn = g*g
// The three divisions stay IEEE divisions. nvcc contracts some multiply-adds
// into FMAs, so results agree with the plain PyTorch version to a few ULPs,
// not bit for bit.
//
// Grids: every kernel walks its work in a grid-stride loop over a grid of
// the blocks the work needs, capped at kMaxBlocks.

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

// (dz, dn) of one element
__device__ __forceinline__ void ftrl_delta_one(float z, float n, float g,
                                               float alpha, float beta,
                                               float l1, float l2, float& dz,
                                               float& dn) {
  const float w = ftrl_weight(z, n, alpha, beta, l1, l2);
  const float g2 = g * g;
  const float sigma = (sqrtf(n + g2) - sqrtf(n)) / alpha;
  dz = g - sigma * w;
  dn = g2;
}

// ---------------------------------------------------------------------------
// ftrl_delta — replaces ftrl_delta_pallas
// (parameter_server_tpu/ops/pallas_kernels.py:84, kernel _ftrl_delta_kernel).
//
// Elementwise over flat (N,) arrays: reads z, n, g and writes dz, dn, 20 bytes
// per element for about 18 operations (three divisions and two square roots
// among them), so it is bound by device-memory bytes (3.35 TB/s on an H100
// SXM) when its inputs are cold. In the worker step they are not: it reads
// the rows index_select has just gathered, still in L2, and then latency
// and instruction throughput are the limit. Design:
// - one float4 of each array per thread and loop trip: a 16-byte load of
//   z, n and g each, neighbouring lanes on neighbouring vectors, so every
//   warp access is whole 128-byte lines. (Two or four vectors a thread
//   measured slower at the worker's shape on an H100: they take more
//   registers, so fewer threads fit on each SM to cover the latency; see
//   PERF.md and sweep_ftrl.py.)
// - z, n, g read with __ldcs (streamed: each is read once); dz, dn stored
//   plainly, since the step's index_add_ reads them next;
// - the vector body covers the first 4 * nvec elements and scalar code the
//   count % 4 after them. The body needs all five arrays 16-byte aligned;
//   where one is not (a view with a storage offset), nvec is 0 and every
//   element takes the scalar code.
// The TPU version's (M, 128) lane padding is a VPU layout and is not needed.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
ftrl_delta_kernel(const float* __restrict__ z, const float* __restrict__ n,
                  const float* __restrict__ g, float* __restrict__ dz,
                  float* __restrict__ dn, int64_t count, int64_t nvec,
                  float alpha, float beta, float l1, float l2) {
  const int64_t threads = (int64_t)gridDim.x * kThreads;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const float4* z4 = reinterpret_cast<const float4*>(z);
  const float4* n4 = reinterpret_cast<const float4*>(n);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* dz4 = reinterpret_cast<float4*>(dz);
  float4* dn4 = reinterpret_cast<float4*>(dn);
  for (int64_t v = first; v < nvec; v += threads) {
    const float4 vz = __ldcs(z4 + v);
    const float4 vn = __ldcs(n4 + v);
    const float4 vg = __ldcs(g4 + v);
    float4 a, b;
    ftrl_delta_one(vz.x, vn.x, vg.x, alpha, beta, l1, l2, a.x, b.x);
    ftrl_delta_one(vz.y, vn.y, vg.y, alpha, beta, l1, l2, a.y, b.y);
    ftrl_delta_one(vz.z, vn.z, vg.z, alpha, beta, l1, l2, a.z, b.z);
    ftrl_delta_one(vz.w, vn.w, vg.w, alpha, beta, l1, l2, a.w, b.w);
    dz4[v] = a;
    dn4[v] = b;
  }
  for (int64_t e = 4 * nvec + first; e < count; e += threads) {
    ftrl_delta_one(__ldcs(z + e), __ldcs(n + e), __ldcs(g + e), alpha, beta,
                   l1, l2, dz[e], dn[e]);
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
// 4 + 4 + 4*32 = 136 bytes per row, and each sector is a random access
// to DRAM, read and later written back. What bounds the kernel is the rate
// at which DRAM serves such accesses, not bytes or arithmetic: on an H100
// it runs within 1.2x of PyTorch's gather of the same z and n sectors at
// the server's push (chip_smoke.py's gather_floor_ms), and thread layouts
// that keep more such sectors in flight per thread, or cache hints, measured
// no faster (PERF.md, sweep_ftrl.py). Keeping z and n of one row in one
// sector, a layout change of the store's tables, would halve the accesses;
// the kernel takes the tables as the store holds them.
//
// Design: a 2-D walk with no division. The block is (lanes, kThreads /
// lanes) threads, lanes the power of two >= vdim up to 32: y walks the
// slots, grid-strided, and x the columns of one row, so neighbouring lanes
// read neighbouring columns (coalesced within the row). At vdim 1 (the FTRL
// server's table, and every table linear_method pushes) that is one thread
// a slot; the slots arrive sorted (the store's coalesce_pushes and
// np.unique emit ascending keys), so neighbouring threads hold neighbouring
// rows and dense key runs still coalesce.
//
// Contract: real keys are unique (the store's contract), so plain stores
// suffice and no atomics are needed. Repeated pad slots (idx 0, grad 0) all
// store row 0's unchanged value, bit-identical, so their concurrent writes
// are benign. A row index outside [0, K) is skipped, never written.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
ftrl_push_kernel(float* __restrict__ z, float* __restrict__ n,
                 const int32_t* __restrict__ idx, const float* __restrict__ g,
                 int64_t slots, int64_t vdim, int64_t num_rows, float alpha,
                 float beta, float l1, float l2) {
  const int64_t step = (int64_t)gridDim.x * blockDim.y;
  for (int64_t s = (int64_t)blockIdx.x * blockDim.y + threadIdx.y; s < slots;
       s += step) {
    const int32_t row = idx[s];
    if (row < 0 || row >= num_rows) continue;
    float* zr = z + (int64_t)row * vdim;
    float* nr = n + (int64_t)row * vdim;
    const float* gr = g + s * vdim;
    for (int64_t c = threadIdx.x; c < vdim; c += blockDim.x) {
      const float zi = zr[c];
      const float ni = nr[c];
      float dz, dn;
      ftrl_delta_one(zi, ni, gr[c], alpha, beta, l1, l2, dz, dn);
      zr[c] = zi + dz;
      nr[c] = ni + dn;
    }
  }
}

int blocks_for(int64_t work, int64_t per_block) {
  const int64_t b = (work + per_block - 1) / per_block;
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
  const bool aligned = ((uintptr_t)z | (uintptr_t)n | (uintptr_t)g |
                        (uintptr_t)dz | (uintptr_t)dn) % 16 == 0;
  const int64_t nvec = aligned ? count / 4 : 0;
  const int64_t scalar = count - 4 * nvec;
  ftrl_delta_kernel<<<blocks_for(nvec > scalar ? nvec : scalar, kThreads),
                      kThreads, 0, (cudaStream_t)stream>>>(
      z, n, g, dz, dn, count, nvec, alpha, beta, l1, l2);
  return (int)cudaGetLastError();
}

int ps_ftrl_push(float* z, float* n, const int32_t* idx, const float* g,
                 long long num_slots, long long vdim, long long num_rows,
                 float alpha, float beta, float l1, float l2, int device,
                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (num_slots <= 0 || vdim <= 0) return (int)cudaSuccess;
  int lanes = 1;
  while (lanes < vdim && lanes < 32) lanes *= 2;
  const dim3 block(lanes, kThreads / lanes);
  ftrl_push_kernel<<<blocks_for(num_slots, kThreads / lanes), block, 0,
                     (cudaStream_t)stream>>>(z, n, idx, g, num_slots, vdim,
                                             num_rows, alpha, beta, l1, l2);
  return (int)cudaGetLastError();
}

const char* ps_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
