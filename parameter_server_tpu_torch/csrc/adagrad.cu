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
// In-place fused push over the U slots of (K, vdim) tables w, n: gather
// w[idx], n[idx], apply AdaGrad in registers, store both rows back. The math
// is the JAX package's, op for op (kv/updaters.py Adagrad.delta plus the
// scatter-add):
//   g' = g + l2*w;  n' = n + g'*g';  w' = w + (-eta*g'/(sqrt(n')+eps))
// nvcc contracts some multiply-adds into FMAs, so results agree with the
// plain PyTorch version to a few ULPs, not bit for bit.
//
// Bound: device-memory bytes. A slot moves 4 (idx) + 4*vdim (g) bytes, and
// each distinct row 16*vdim (w, n read and written once), so a push of U
// slots over R distinct rows moves U*(4 + 4*vdim) + R*16*vdim bytes for
// about 8 flops an element: at 3.35 TB/s the bytes, never the arithmetic,
// bound it. Tensor cores and TMA have nothing to offer: this is a gather and
// scatter of random 64-256-byte rows. The levers are bytes in flight and
// whole-sector accesses.
//
// Design. The first version ran one thread an element: a 64-bit division
// for the slot of every element, idx reloaded by every element, and 4-byte
// scalar accesses. Now:
// - a group of LANES threads takes one slot, each lane one 16-byte float4
//   of g, w and n (vdim 16: 4 lanes, 8 slots a warp; vdim 64: 16 lanes, 2
//   slots a warp), so a row's accesses are whole sectors and each thread
//   keeps three 16-byte loads in flight. The slot and lane come from
//   shifts; idx[slot] is read once a slot (every lane of the group reads
//   the same address, one transaction) and the row offset row*vdim is
//   computed once, in 64 bits (2^27 rows x 64 does not fit in 31). The
//   apps' widths (vdim 16, 32, 64) each have an instantiation with one
//   float4 a lane and no column loop. One slot a lane group: two, with
//   all their loads issued first, took more registers and were slower.
// - g and idx are read once: streamed loads (__ldcs). w and n are plain
//   loads and stores.
// - a lane stores a float4 of w or n only where its bits changed. A slot
//   whose update is the identity (a zero gradient with l2*w == 0) then
//   writes nothing; the table ends the same as if it had stored, since a
//   store of unchanged bits is a no-op. This is for pad slots: they all
//   land on row 0, and their stores to one line serialise at one L2
//   slice. A matrix-factorization push keeps hundreds of them (a batch of
//   ratings touches fewer distinct items than it has slots) on rows its
//   step has just gathered into L2, where those stores cost most (PERF.md,
//   the MF push). A caller that can drop its pads pushes only its real
//   slots, as wd_train_step pushes unique_keys[:num_unique].
// - the float4 body needs vdim % 4 == 0 and w, n, g 16-byte aligned. Any
//   other width or view (an offset view w[1:-1] of vdim 7, a view one
//   element into its storage) takes the same walk with one float a lane;
//   there, and at other float4 widths, LANES is the power of two >= the
//   row's width up to 32, and a lane loops over columns.
//
// Row 0 gets no special case: a kv shard of a sharded table hands idx -
// begin to this kernel, and there local row 0 is a real key. Real keys are
// unique (the store's contract), so plain stores suffice and no atomics
// are needed. Repeated pad slots (idx 0, grad 0) leave row 0 unchanged,
// PROVIDED row 0 is zero when l2 > 0: a nonzero w[0] would give each pad
// slot g' = l2*w[0] and a real update, which the composite would
// scatter-ADD once per slot and this kernel overwrites once. The framework
// keeps row 0 zero (init zeroes it, pad slots never move it), the same
// invariant as pallas_kernels.py:288-294. A row index outside [0, K) is
// skipped, never written.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// grid-stride loop: cap the grid, each lane group walks the rest
constexpr int64_t kMaxBlocks = 1 << 20;

__device__ __forceinline__ void adagrad_one(float& w, float& n, float g,
                                            float eta, float eps, float l2) {
  const float gi = g + l2 * w;
  n = n + gi * gi;
  w = w + (-eta * gi / (sqrtf(n) + eps));
}

__device__ __forceinline__ void adagrad_one(float4& w, float4& n, float4 g,
                                            float eta, float eps, float l2) {
  adagrad_one(w.x, n.x, g.x, eta, eps, l2);
  adagrad_one(w.y, n.y, g.y, eta, eps, l2);
  adagrad_one(w.z, n.z, g.z, eta, eps, l2);
  adagrad_one(w.w, n.w, g.w, eta, eps, l2);
}

__device__ __forceinline__ bool same_bits(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b);
}

__device__ __forceinline__ bool same_bits(float4 a, float4 b) {
  return same_bits(a.x, b.x) && same_bits(a.y, b.y) && same_bits(a.z, b.z) &&
         same_bits(a.w, b.w);
}

__host__ __device__ constexpr int log2_of(int v) {
  return v <= 1 ? 0 : 1 + log2_of(v / 2);
}

// one T (float4 or float) of a slot: load w, n and the streamed g, update,
// store w and n only where their bits changed
template <typename T>
__device__ __forceinline__ void update(T* w, T* n, const T* g, float eta,
                                       float eps, float l2) {
  const T w0 = *w, n0 = *n;
  T w1 = w0, n1 = n0;
  adagrad_one(w1, n1, __ldcs(g), eta, eps, l2);
  if (!same_bits(w1, w0)) *w = w1;
  if (!same_bits(n1, n0)) *n = n1;
}

// LANES lanes a slot. WIDTH > 0: a row is exactly WIDTH == LANES T's, one a
// lane (the apps' widths); WIDTH == 0: ``width`` T's a row, a lane looping
template <typename T, int LANES, int WIDTH>
__global__ void __launch_bounds__(kThreads)
adagrad_push_kernel(T* __restrict__ w, T* __restrict__ n,
                    const int32_t* __restrict__ idx, const T* __restrict__ g,
                    int64_t slots, int64_t width, int64_t num_rows, float eta,
                    float eps, float l2) {
  constexpr int kShift = log2_of(LANES);
  const int lane = threadIdx.x & (LANES - 1);
  if constexpr (WIDTH > 0) width = WIDTH;
  const int64_t step = ((int64_t)gridDim.x * kThreads) >> kShift;
  for (int64_t s = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> kShift;
       s < slots; s += step) {
    const int32_t row = __ldcs(idx + s);
    if (row < 0 || row >= num_rows) continue;
    T* wr = w + (int64_t)row * width;
    T* nr = n + (int64_t)row * width;
    const T* gr = g + s * width;
    if constexpr (WIDTH > 0) {
      update(wr + lane, nr + lane, gr + lane, eta, eps, l2);
    } else {
      for (int64_t c = lane; c < width; c += LANES)
        update(wr + c, nr + c, gr + c, eta, eps, l2);
    }
  }
}

template <typename T, int LANES, int WIDTH>
int launch(T* w, T* n, const int32_t* idx, const T* g, int64_t slots,
           int64_t width, int64_t num_rows, float eta, float eps, float l2,
           cudaStream_t stream) {
  int64_t blocks = (slots * LANES + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  adagrad_push_kernel<T, LANES, WIDTH><<<(int)blocks, kThreads, 0, stream>>>(
      w, n, idx, g, slots, width, num_rows, eta, eps, l2);
  return (int)cudaGetLastError();
}

// any width: LANES the power of two >= width, at most 32
template <typename T>
int launch_any(T* w, T* n, const int32_t* idx, const T* g, int64_t slots,
               int64_t width, int64_t num_rows, float eta, float eps,
               float l2, cudaStream_t stream) {
#define ADAGRAD_ANY(L)                                                       \
  if (width <= L)                                                            \
    return launch<T, L, 0>(w, n, idx, g, slots, width, num_rows, eta, eps,   \
                           l2, stream);
  ADAGRAD_ANY(1) ADAGRAD_ANY(2) ADAGRAD_ANY(4) ADAGRAD_ANY(8) ADAGRAD_ANY(16)
#undef ADAGRAD_ANY
  return launch<T, 32, 0>(w, n, idx, g, slots, width, num_rows, eta, eps, l2,
                          stream);
}

}  // namespace

extern "C" {

int ps_adagrad_push(float* w, float* n, const int32_t* idx, const float* g,
                    long long num_slots, long long vdim, long long num_rows,
                    float eta, float eps, float l2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (num_slots <= 0 || vdim <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = vdim % 4 == 0 &&
                   ((uintptr_t)w | (uintptr_t)n | (uintptr_t)g) % 16 == 0;
  if (!vec)
    return launch_any(w, n, idx, g, num_slots, vdim, num_rows, eta, eps, l2, s);
  float4* w4 = reinterpret_cast<float4*>(w);
  float4* n4 = reinterpret_cast<float4*>(n);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  switch (vdim) {
    case 16:
      return launch<float4, 4, 4>(w4, n4, idx, g4, num_slots, 4, num_rows, eta,
                                  eps, l2, s);
    case 32:
      return launch<float4, 8, 8>(w4, n4, idx, g4, num_slots, 8, num_rows, eta,
                                  eps, l2, s);
    case 64:
      return launch<float4, 16, 16>(w4, n4, idx, g4, num_slots, 16, num_rows,
                                    eta, eps, l2, s);
    default:
      return launch_any(w4, n4, idx, g4, num_slots, vdim / 4, num_rows, eta,
                        eps, l2, s);
  }
}

}  // extern "C"
