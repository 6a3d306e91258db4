"""Variant sweep of the two FTRL kernels on the card: K2 (``ftrl_delta``)
and K1 (``ftrl_push``) of ``parameter_server_tpu_torch/csrc/ftrl.cu``.

Times the port's kernels, through their wrappers, beside variants of their
design compiled from the CUDA source in this file, on the same inputs in
one process, with ``chip_smoke.py``'s timing (CUDA events around calls
queued behind a spin kernel) and input sets:

- K2 at the linear worker's shape (1,048,577 x 1), cold (8 input sets
  cycled) and warm (one set repeated): float4 vectors a thread (1, 2, 4),
  32- or 64-bit indices, a grid of the blocks the work needs or of one
  resident wave (the occupancy API's blocks per SM x SMs), streamed
  (``__ldcs``) or plain loads, and the one-thread-per-element kernel that
  K2 was before its redesign.
- K1 into the FTRL server's (2^27, 1) tables at its push (the unique keys
  of 2^17 draws, ~131k rows) and at 4x it (2^19 draws, ~523k rows), cold
  (16 key sets cycled): slots a thread (1, 2, 4; all of a thread's idx, g,
  z and n loads issued before its math), z and n through L2 only
  (``__ldcg`` / ``__stcg``) or plain, the two grids, the
  one-thread-per-element kernel with a 64-bit division that K1 was before
  its redesign, and two floors of its access pattern, PyTorch calls at the
  same keys with none of its arithmetic: the gather of z and n
  (``index_select``) and their read-modify-write (``index_add_``).

Every variant is first held against the plain PyTorch version (rtol 1e-5,
atol 1e-6). Every time is taken twice, the variants in one order and then
in the reverse, so drift shows. Run from the repository's root on a
machine with one NVIDIA card and nvcc:

    python3 sweep_ftrl.py

It prints the card's name and power limit, each variant's registers
(``-Xptxas -v``) and its times in microseconds; it builds under
``parameter_server_tpu_torch/_build/`` and writes nothing else.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
from parameter_server_tpu_torch.ops import cuda_build
from parameter_server_tpu_torch.ops import ftrl_kernels as fk

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int kThreads = 256;

__device__ __forceinline__ void delta_one(float z, float n, float g, float alpha,
                                          float beta, float l1, float l2,
                                          float& dz, float& dn) {
  const float sgn = z > 0.f ? 1.f : (z < 0.f ? -1.f : 0.f);
  const float shrunk = sgn * fmaxf(fabsf(z) - l1, 0.f);
  const float w = -shrunk / ((beta + sqrtf(n)) / alpha + l2);
  const float g2 = g * g;
  const float sigma = (sqrtf(n + g2) - sqrtf(n)) / alpha;
  dz = g - sigma * w;
  dn = g2;
}

template <bool LDCS>
__device__ __forceinline__ float4 load4(const float4* p) {
  return LDCS ? __ldcs(p) : *p;
}
template <bool LDCS>
__device__ __forceinline__ float load1(const float* p) {
  return LDCS ? __ldcs(p) : *p;
}

// K2: V float4 of each array a thread and loop trip, index type I
template <typename I, int V, bool LDCS>
__global__ void __launch_bounds__(kThreads)
delta_v(const float* __restrict__ z, const float* __restrict__ n,
        const float* __restrict__ g, float* __restrict__ dz,
        float* __restrict__ dn, I count, float alpha, float beta, float l1,
        float l2) {
  const I nvec = count / 4;
  const I threads = (I)gridDim.x * kThreads;
  const I first = (I)blockIdx.x * kThreads + threadIdx.x;
  const float4* z4 = reinterpret_cast<const float4*>(z);
  const float4* n4 = reinterpret_cast<const float4*>(n);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* dz4 = reinterpret_cast<float4*>(dz);
  float4* dn4 = reinterpret_cast<float4*>(dn);
  for (I base = (I)blockIdx.x * kThreads * V + threadIdx.x; base < nvec;
       base += threads * V) {
    float4 vz[V], vn[V], vg[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const I v = base + (I)j * kThreads;
      if (v < nvec) {
        vz[j] = load4<LDCS>(z4 + v);
        vn[j] = load4<LDCS>(n4 + v);
        vg[j] = load4<LDCS>(g4 + v);
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const I v = base + (I)j * kThreads;
      if (v < nvec) {
        float4 a, b;
        delta_one(vz[j].x, vn[j].x, vg[j].x, alpha, beta, l1, l2, a.x, b.x);
        delta_one(vz[j].y, vn[j].y, vg[j].y, alpha, beta, l1, l2, a.y, b.y);
        delta_one(vz[j].z, vn[j].z, vg[j].z, alpha, beta, l1, l2, a.z, b.z);
        delta_one(vz[j].w, vn[j].w, vg[j].w, alpha, beta, l1, l2, a.w, b.w);
        dz4[v] = a;
        dn4[v] = b;
      }
    }
  }
  for (I e = 4 * nvec + first; e < count; e += threads)
    delta_one(load1<LDCS>(z + e), load1<LDCS>(n + e), load1<LDCS>(g + e),
              alpha, beta, l1, l2, dz[e], dn[e]);
}

// K1 at vdim 1: R slots a thread and loop trip, z and n via L2 only if CG
template <int R, bool CG>
__global__ void __launch_bounds__(kThreads)
push_v(float* __restrict__ z, float* __restrict__ n,
       const int32_t* __restrict__ idx, const float* __restrict__ g,
       int64_t slots, int64_t num_rows, float alpha, float beta, float l1,
       float l2) {
  const int64_t threads = (int64_t)gridDim.x * kThreads;
  for (int64_t base = (int64_t)blockIdx.x * kThreads * R + threadIdx.x;
       base < slots; base += threads * R) {
    int32_t row[R];
    float gi[R], zi[R], ni[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t s = base + (int64_t)r * kThreads;
      row[r] = s < slots ? __ldcs(idx + s) : -1;
      gi[r] = s < slots ? __ldcs(g + s) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (row[r] >= 0 && row[r] < num_rows) {
        zi[r] = CG ? __ldcg(z + row[r]) : z[row[r]];
        ni[r] = CG ? __ldcg(n + row[r]) : n[row[r]];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (row[r] >= 0 && row[r] < num_rows) {
        float dz, dn;
        delta_one(zi[r], ni[r], gi[r], alpha, beta, l1, l2, dz, dn);
        if (CG) {
          __stcg(z + row[r], zi[r] + dz);
          __stcg(n + row[r], ni[r] + dn);
        } else {
          z[row[r]] = zi[r] + dz;
          n[row[r]] = ni[r] + dn;
        }
      }
    }
  }
}

// K1 and K2 as they were before the redesign: one thread per element
__global__ void __launch_bounds__(kThreads)
delta_before(const float* __restrict__ z, const float* __restrict__ n,
             const float* __restrict__ g, float* __restrict__ dz,
             float* __restrict__ dn, int64_t count, float alpha, float beta,
             float l1, float l2) {
  const int64_t stride = (int64_t)blockDim.x * gridDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += stride)
    delta_one(z[i], n[i], g[i], alpha, beta, l1, l2, dz[i], dn[i]);
}

__global__ void __launch_bounds__(kThreads)
push_before(float* z, float* n, const int32_t* __restrict__ idx,
            const float* __restrict__ g, int64_t total, int64_t vdim,
            int64_t num_rows, float alpha, float beta, float l1, float l2) {
  const int64_t stride = (int64_t)blockDim.x * gridDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t slot = i / vdim;
    const int64_t row = idx[slot];
    if (row < 0 || row >= num_rows) continue;
    const int64_t off = row * vdim + (i - slot * vdim);
    const float zi = z[off];
    const float ni = n[off];
    float dz, dn;
    delta_one(zi, ni, g[i], alpha, beta, l1, l2, dz, dn);
    z[off] = zi + dz;
    n[off] = ni + dn;
  }
}

template <typename F>
int resident(F fn) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, 0);
  return sms * per_sm;
}

// grid: the blocks the work needs, at most max_blocks
unsigned grid(long long work, long long max_blocks) {
  const long long b = (work + kThreads - 1) / kThreads;
  return (unsigned)(b < 1 ? 1 : (b < max_blocks ? b : max_blocks));
}

template <typename I, int V, bool LDCS>
int run_delta(int query, const float* z, const float* n, const float* g,
              float* dz, float* dn, long long count, long long max_blocks,
              float alpha, float beta, float l1, float l2, void* s) {
  if (query) return resident(delta_v<I, V, LDCS>);
  const long long nvec = count / 4, vwork = (nvec + V - 1) / V;
  const long long work = vwork > count - 4 * nvec ? vwork : count - 4 * nvec;
  delta_v<I, V, LDCS><<<grid(work, max_blocks), kThreads, 0, (cudaStream_t)s>>>(
      z, n, g, dz, dn, (I)count, alpha, beta, l1, l2);
  return (int)cudaGetLastError();
}

template <int R, bool CG>
int run_push(int query, float* z, float* n, const int32_t* idx, const float* g,
             long long slots, long long num_rows, long long max_blocks,
             float alpha, float beta, float l1, float l2, void* s) {
  if (query) return resident(push_v<R, CG>);
  push_v<R, CG><<<grid((slots + R - 1) / R, max_blocks), kThreads, 0,
                  (cudaStream_t)s>>>(z, n, idx, g, slots, num_rows, alpha,
                                     beta, l1, l2);
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" {
// query != 0: return the resident blocks of the variant (SMs x blocks per SM)
int sweep_delta(int vectors, int wide, int ldcs, int query, const float* z,
                const float* n, const float* g, float* dz, float* dn,
                long long count, long long max_blocks, float alpha, float beta,
                float l1, float l2, void* s) {
#define DELTA(V)                                                            \
  if (vectors == V) {                                                       \
    if (wide)                                                               \
      return ldcs ? run_delta<uint64_t, V, true>(query, z, n, g, dz, dn,    \
                                                 count, max_blocks, alpha,  \
                                                 beta, l1, l2, s)           \
                  : run_delta<uint64_t, V, false>(query, z, n, g, dz, dn,   \
                                                  count, max_blocks, alpha, \
                                                  beta, l1, l2, s);         \
    return ldcs ? run_delta<uint32_t, V, true>(query, z, n, g, dz, dn, count, \
                                               max_blocks, alpha, beta, l1, \
                                               l2, s)                       \
                : run_delta<uint32_t, V, false>(query, z, n, g, dz, dn,     \
                                                count, max_blocks, alpha,   \
                                                beta, l1, l2, s);           \
  }
  DELTA(1) DELTA(2) DELTA(4)
#undef DELTA
  return -1;
}

int sweep_push(int slots_a_thread, int cg, int query, float* z, float* n,
               const int32_t* idx, const float* g, long long slots,
               long long num_rows, long long max_blocks, float alpha,
               float beta, float l1, float l2, void* s) {
#define PUSH(R)                                                              \
  if (slots_a_thread == R)                                                   \
    return cg ? run_push<R, true>(query, z, n, idx, g, slots, num_rows,      \
                                  max_blocks, alpha, beta, l1, l2, s)        \
              : run_push<R, false>(query, z, n, idx, g, slots, num_rows,     \
                                   max_blocks, alpha, beta, l1, l2, s);
  PUSH(1) PUSH(2) PUSH(4)
#undef PUSH
  return -1;
}

int sweep_delta_before(const float* z, const float* n, const float* g,
                       float* dz, float* dn, long long count, float alpha,
                       float beta, float l1, float l2, void* s) {
  delta_before<<<grid(count, 1 << 20), kThreads, 0, (cudaStream_t)s>>>(
      z, n, g, dz, dn, count, alpha, beta, l1, l2);
  return (int)cudaGetLastError();
}

int sweep_push_before(float* z, float* n, const int32_t* idx, const float* g,
                      long long slots, long long num_rows, float alpha,
                      float beta, float l1, float l2, void* s) {
  push_before<<<grid(slots, 1 << 20), kThreads, 0, (cudaStream_t)s>>>(
      z, n, idx, g, slots, 1, num_rows, alpha, beta, l1, l2);
  return (int)cudaGetLastError();
}
}  // extern "C"
"""

_P, _F, _I64, _INT = ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong, ctypes.c_int
# the grid of "needed" variants: the blocks the work needs, capped as
# csrc/ftrl.cu caps it
MAX_BLOCKS = 1 << 20


def build() -> ctypes.CDLL:
    """Compile SOURCE with the port's flags; print each kernel's registers."""
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = cuda_build.BUILD_DIR / "sweep_ftrl.cu"
    out = cuda_build.BUILD_DIR / "libsweep_ftrl.so"
    src.write_text(SOURCE)
    res = subprocess.run(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-shared", "-o", str(out), str(src)],
        capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    names = re.findall(r"Compiling entry function '(\w+)'", res.stdout + res.stderr)
    regs = re.findall(r"Used (\d+) registers", res.stdout + res.stderr)
    demangled = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                               text=True, check=False).stdout.split("\n")
    for i, r in enumerate(regs):
        name = demangled[i] if i < len(demangled) and demangled[i] else names[i]
        print(f"ptxas {name}: {r} registers", flush=True)
    lib = ctypes.CDLL(str(out))
    lib.sweep_delta.argtypes = [_INT, _INT, _INT, _INT, _P, _P, _P, _P, _P, _I64, _I64,
                                _F, _F, _F, _F, _P]
    lib.sweep_push.argtypes = [_INT, _INT, _INT, _P, _P, _P, _P, _I64, _I64, _I64,
                               _F, _F, _F, _F, _P]
    lib.sweep_delta_before.argtypes = [_P, _P, _P, _P, _P, _I64, _F, _F, _F, _F, _P]
    lib.sweep_push_before.argtypes = [_P, _P, _P, _P, _I64, _I64, _F, _F, _F, _F, _P]
    return lib


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def hyper() -> tuple:
    h = cs.HYPER
    return h["alpha"], h["beta"], h["l1"], h["l2"]


def ok(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def delta_variants(lib) -> dict:
    """name -> fn(z, n, g) -> (dz, dn), each launching one K2 variant."""
    def variant(vectors, wide, ldcs, cap):
        blocks = lib.sweep_delta(vectors, wide, ldcs, 1, *[None] * 5, 0, 0,
                                 *hyper(), None) if cap else MAX_BLOCKS

        def fn(z, n, g):
            dz, dn = torch.empty_like(z), torch.empty_like(n)
            ok(lib.sweep_delta(vectors, wide, ldcs, 0, z.data_ptr(), n.data_ptr(),
                               g.data_ptr(), dz.data_ptr(), dn.data_ptr(), z.numel(),
                               blocks, *hyper(), stream()), "sweep_delta")
            return dz, dn
        return fn

    def before(z, n, g):
        dz, dn = torch.empty_like(z), torch.empty_like(n)
        ok(lib.sweep_delta_before(z.data_ptr(), n.data_ptr(), g.data_ptr(), dz.data_ptr(),
                                  dn.data_ptr(), z.numel(), *hyper(), stream()),
           "sweep_delta_before")
        return dz, dn

    out = {"port ftrl_delta (V1, int64, __ldcs, needed grid)":
           lambda z, n, g: fk.ftrl_delta(z, n, g, **cs.HYPER)}
    for vectors, wide, ldcs, cap in [(1, 1, 1, 1), (1, 0, 1, 0), (1, 0, 1, 1), (1, 1, 0, 0),
                                     (2, 1, 1, 0), (2, 0, 1, 1), (4, 1, 1, 0), (4, 0, 1, 1)]:
        name = (f"V{vectors}, int{64 if wide else 32}, {'__ldcs' if ldcs else 'plain loads'}, "
                f"{'one-wave' if cap else 'needed'} grid")
        out[name] = variant(vectors, wide, ldcs, cap)
    out["before: one thread an element, int64"] = before
    return out


def push_variants(lib) -> dict:
    """name -> fn(z, n, idx, g), each launching one K1 variant in place."""
    def variant(r, cg, cap):
        blocks = lib.sweep_push(r, cg, 1, *[None] * 4, 0, 0, 0, *hyper(),
                                None) if cap else MAX_BLOCKS

        def fn(z, n, idx, g):
            ok(lib.sweep_push(r, cg, 0, z.data_ptr(), n.data_ptr(), idx.data_ptr(),
                              g.data_ptr(), idx.shape[0], z.shape[0], blocks, *hyper(),
                              stream()), "sweep_push")
        return fn

    def before(z, n, idx, g):
        ok(lib.sweep_push_before(z.data_ptr(), n.data_ptr(), idx.data_ptr(), g.data_ptr(),
                                 idx.shape[0], z.shape[0], *hyper(), stream()),
           "sweep_push_before")

    out = {"port ftrl_push (2-D walk, 1 lane, needed grid)":
           lambda z, n, idx, g: fk.ftrl_push(z, n, idx, g, **cs.HYPER)}
    for r, cg, cap in [(1, 1, 1), (1, 1, 0), (1, 0, 1), (1, 0, 0), (2, 1, 0), (4, 1, 1),
                       (4, 1, 0), (4, 0, 0)]:
        name = (f"R{r}, {'__ldcg/__stcg' if cg else 'plain'} z n, "
                f"{'one-wave' if cap else 'needed'} grid")
        out[name] = variant(r, cg, cap)
    out["before: one thread an element, 64-bit division"] = before
    return out


def check_delta(variants: dict, dev, gen) -> None:
    z = torch.randn(4097, generator=gen, device=dev) * 2
    n = torch.rand(4097, generator=gen, device=dev) * 4
    g = torch.randn(4097, generator=gen, device=dev)
    pz, pn = fk.ftrl_delta_plain(z, n, g, **cs.HYPER)
    for name, fn in variants.items():
        dz, dn = fn(z, n, g)
        cs.check_close(f"K2 {name} dz", dz, pz)
        cs.check_close(f"K2 {name} dn", dn, pn)


def check_push(variants: dict, dev, gen) -> None:
    rows = 1 << 16
    keys = np.unique(np.random.default_rng(3).integers(1, rows, 5000))
    idx = torch.from_numpy(np.concatenate([keys, [0, 0, 0]]).astype(np.int32)).to(dev)
    g = torch.randn((idx.shape[0], 1), generator=gen, device=dev)
    g[-3:] = 0
    z0 = torch.randn((rows, 1), generator=gen, device=dev) * 2
    n0 = torch.rand((rows, 1), generator=gen, device=dev) * 4
    zp, np_ = fk.ftrl_push_plain(z0.clone(), n0.clone(), idx, g, **cs.HYPER)
    for name, fn in variants.items():
        z, n = z0.clone(), n0.clone()
        fn(z, n, idx, g)
        cs.check_close(f"K1 {name} z", z, zp)
        cs.check_close(f"K1 {name} n", n, np_)


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_ftrl: needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    lib = build()
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    rng = np.random.default_rng(cs.SEED)
    deltas, pushes = delta_variants(lib), push_variants(lib)
    check_delta(deltas, dev, gen)
    check_push(pushes, dev, gen)
    print("every variant agrees with the plain version", flush=True)

    u = (1 << 20) + 1  # the linear worker's unique slots a step
    sets = [(torch.randn((u, 1), generator=gen, device=dev),
             torch.rand((u, 1), generator=gen, device=dev),
             torch.randn((u, 1), generator=gen, device=dev))
            for _ in range(cs.DELTA_SETS)]
    order = list(deltas)
    for names in (order, order[::-1]):
        for name in names:
            fn = deltas[name]
            cold, _ = cs.cuda_ms(lambda i: fn(*sets[i % cs.DELTA_SETS]), 200)
            warm, _ = cs.cuda_ms(lambda i: fn(*sets[0]), 200)
            print(f"K2 {u} x 1 {name}: cold {cold * 1e3:.2f} us, warm {warm * 1e3:.2f} us",
                  flush=True)
    del sets

    z = torch.zeros((cs.SERVER_KEYS, 1), device=dev)
    n = torch.zeros((cs.SERVER_KEYS, 1), device=dev)
    for draws in (cs.PUSH_DRAWS, cs.LARGE_PUSH_DRAWS):
        ksets, rows = cs.key_sets(rng, gen, dev, cs.PUSH_SETS, cs.SERVER_KEYS, draws, 1)
        timed = dict(pushes)
        timed["gather floor: index_select of z and n"] = (
            lambda z, n, idx, g: (z.index_select(0, idx), n.index_select(0, idx)))
        timed["read-modify-write floor: index_add_ into z and n"] = (
            lambda z, n, idx, g: (z.index_add_(0, idx, g), n.index_add_(0, idx, g)))
        order = list(timed)
        for names in (order, order[::-1]):
            for name in names:
                fn = timed[name]
                ms, _ = cs.cuda_ms(lambda i: fn(z, n, *ksets[i % cs.PUSH_SETS]), 200)
                print(f"K1 {rows:.1f} rows of {cs.SERVER_KEYS} {name}: {ms * 1e3:.2f} us",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
