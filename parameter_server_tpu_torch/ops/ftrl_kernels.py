"""The FTRL kernels: hand-written CUDA for Hopper, with their plain versions.

Two kernels replace the two Pallas kernels on the main path
(``parameter_server_tpu/ops/pallas_kernels.py``):

- ``ftrl_delta`` (CUDA ``ftrl_delta_kernel`` in ``csrc/ftrl.cu``) replaces
  ``ftrl_delta_pallas``: the elementwise FTRL delta ``(dz, dn)``.
- ``ftrl_push`` (CUDA ``ftrl_push_kernel``) replaces ``ftrl_push_pallas``:
  the in-place fused gather -> FTRL -> scatter over the touched rows.

Each wrapper checks its inputs (float32 tables and gradients, int32 row
indices, shapes, contiguity, one device) and raises on anything else. On
CPU tensors it runs its plain PyTorch version (``*_plain``); on CUDA
tensors it launches the kernel or raises — nothing falls back. The plain
versions repeat the JAX package's op order; the CPU tests hold them
against the JAX package, and ``chip_smoke.py`` holds each kernel against
its plain version on the card.

The CUDA source is compiled on first use with ``nvcc`` for ``sm_90a`` into
``parameter_server_tpu_torch/_build/`` and loaded with ``ctypes``. Every
successful launch adds one to ``LAUNCHES[name]``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "ftrl.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: launches of each kernel since the last ``reset_launches()``
LAUNCHES = {"ftrl_delta": 0, "ftrl_push": 0}

_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions (the JAX package's op order)
# ---------------------------------------------------------------------------


def ftrl_weights_plain(
    z: torch.Tensor, n: torch.Tensor, *, alpha: float, beta: float,
    l1: float, l2: float,
) -> torch.Tensor:
    """The lazy FTRL weight w(z, n): 0 where |z| <= l1, else
    -(z - sign(z)*l1) / ((beta + sqrt(n))/alpha + l2)."""
    shrunk = torch.sign(z) * torch.clamp(torch.abs(z) - l1, min=0.0)
    denom = (beta + torch.sqrt(n)) / alpha + l2
    return -shrunk / denom


def ftrl_delta_plain(
    z: torch.Tensor, n: torch.Tensor, g: torch.Tensor, *, alpha: float,
    beta: float, l1: float, l2: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dz, dn) of one FTRL step: sigma = (sqrt(n + g^2) - sqrt(n))/alpha,
    dz = g - sigma*w(z, n), dn = g^2."""
    w = ftrl_weights_plain(z, n, alpha=alpha, beta=beta, l1=l1, l2=l2)
    n_new = n + g * g
    sigma = (torch.sqrt(n_new) - torch.sqrt(n)) / alpha
    return g - sigma * w, g * g


def ftrl_push_plain(
    z: torch.Tensor, n: torch.Tensor, idx: torch.Tensor, grad: torch.Tensor,
    *, alpha: float, beta: float, l1: float, l2: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """gather -> delta -> ``index_add_``, in place on ``z`` and ``n``."""
    dz, dn = ftrl_delta_plain(
        z.index_select(0, idx), n.index_select(0, idx), grad,
        alpha=alpha, beta=beta, l1=l1, l2=l2,
    )
    z.index_add_(0, idx, dz)
    n.index_add_(0, idx, dn)
    return z, n


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        home and os.path.join(home, "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build() -> Path:
    """Compile ``csrc/ftrl.cu`` into ``_build/`` unless a library built from
    the same source and flags is there already; returns its path. The
    compiler's output (``-Xptxas -v``: registers, spills) is kept beside it
    in a ``.log`` file."""
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"libftrl-{key.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    out.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr
    )
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}) building {SOURCE}:\n{res.stderr}"
        )
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, f, i64 = ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong
            lib.ps_ftrl_delta.argtypes = [
                p, p, p, p, p, i64, f, f, f, f, ctypes.c_int, p,
            ]
            lib.ps_ftrl_delta.restype = ctypes.c_int
            lib.ps_ftrl_push.argtypes = [
                p, p, p, p, i64, i64, i64, f, f, f, f, ctypes.c_int, p,
            ]
            lib.ps_ftrl_push.restype = ctypes.c_int
            lib.ps_cuda_error_string.argtypes = [ctypes.c_int]
            lib.ps_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _raise_on(lib: ctypes.CDLL, code: int, name: str) -> None:
    if code != 0:
        msg = lib.ps_cuda_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} ({msg})")


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _device(**tensors: torch.Tensor) -> torch.device:
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        raise ValueError(f"{sorted(tensors)} lie on different devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def ftrl_delta(
    z: torch.Tensor, n: torch.Tensor, g: torch.Tensor, *, alpha: float,
    beta: float, l1: float, l2: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused FTRL delta ``(dz, dn)`` over row slices of any (equal) shape."""
    for name, t in (("z", z), ("n", n), ("g", g)):
        _check(name, t, torch.float32)
    if not z.shape == n.shape == g.shape:
        raise ValueError(
            f"z, n, g shapes differ: {tuple(z.shape)}, {tuple(n.shape)}, "
            f"{tuple(g.shape)}"
        )
    dev = _device(z=z, n=n, g=g)
    if dev.type == "cpu":
        return ftrl_delta_plain(z, n, g, alpha=alpha, beta=beta, l1=l1, l2=l2)
    lib = _load()
    dz = torch.empty_like(z)
    dn = torch.empty_like(n)
    if z.numel():
        code = lib.ps_ftrl_delta(
            z.data_ptr(), n.data_ptr(), g.data_ptr(), dz.data_ptr(),
            dn.data_ptr(), z.numel(), alpha, beta, l1, l2, dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _raise_on(lib, code, "ftrl_delta")
        LAUNCHES["ftrl_delta"] += 1
    return dz, dn


def ftrl_push(
    z: torch.Tensor, n: torch.Tensor, idx: torch.Tensor, grad: torch.Tensor,
    *, alpha: float, beta: float, l1: float, l2: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """In-place fused FTRL push over the touched rows: ``z``, ``n`` are
    (K, vdim) tables, updated in place and returned; ``idx`` (U,) int32 row
    indices, each real key at most once, pad slots idx 0 with zero
    ``grad``; ``grad`` (U, vdim)."""
    _check("z", z, torch.float32)
    _check("n", n, torch.float32)
    _check("idx", idx, torch.int32)
    _check("grad", grad, torch.float32)
    if z.dim() != 2 or z.shape != n.shape:
        raise ValueError(
            f"z and n must be equal (K, vdim) tables, got {tuple(z.shape)}, "
            f"{tuple(n.shape)}"
        )
    if idx.dim() != 1 or grad.shape != (idx.shape[0], z.shape[1]):
        raise ValueError(
            f"need idx (U,) and grad (U, {z.shape[1]}), got "
            f"{tuple(idx.shape)}, {tuple(grad.shape)}"
        )
    dev = _device(z=z, n=n, idx=idx, grad=grad)
    if dev.type == "cpu":
        return ftrl_push_plain(
            z, n, idx, grad, alpha=alpha, beta=beta, l1=l1, l2=l2
        )
    lib = _load()
    if idx.numel() and z.shape[1]:
        code = lib.ps_ftrl_push(
            z.data_ptr(), n.data_ptr(), idx.data_ptr(), grad.data_ptr(),
            idx.shape[0], z.shape[1], z.shape[0], alpha, beta, l1, l2,
            dev.index or 0, torch.cuda.current_stream(dev).cuda_stream,
        )
        _raise_on(lib, code, "ftrl_push")
        LAUNCHES["ftrl_push"] += 1
    return z, n
