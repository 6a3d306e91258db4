"""Build and load the port's hand-written CUDA kernels, and the input
checks their wrappers share.

Every ``csrc/*.cu`` is compiled on first use with ``nvcc`` for ``sm_90a``,
one ``nvcc -c`` per source, all started together, then linked into one
shared library with a plain C interface in ``parameter_server_tpu_torch/
_build/`` and loaded with ``ctypes``. The library's name carries a hash of
every source (name and bytes) and of the flags, so an edit to any source
builds a new one. The compiler's output (``-Xptxas -v``: registers, spills)
is kept beside it in a ``.log`` file.

Each entry point of the library returns ``cudaGetLastError()``;
``raise_on`` turns a nonzero code into an exception with CUDA's own message
(``ps_cuda_error_string``, defined in ``csrc/ftrl.cu``).
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
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: ctypes.CDLL | None = None
_fns: dict[str, ctypes._CFuncPtr] = {}
_lock = threading.Lock()


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


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


def library_path() -> Path:
    """Where the library built from the current sources and flags lives:
    its name hashes every source's name and bytes, and the flags."""
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources():
        key.update(s.name.encode() + b"\0" + s.read_bytes() + b"\0")
    return BUILD_DIR / f"libps-{key.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every ``csrc/*.cu`` into one library in ``_build/`` unless a
    library built from the same sources and flags is there already; returns
    its path."""
    out = library_path()
    if out.exists():
        return out
    srcs = sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)] for s, o in zip(srcs, objs)]
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for c in cmds
    ]
    results = []
    for c, p in zip(cmds, procs):
        stdout, stderr = p.communicate()
        results.append((c, p.returncode, stdout, stderr))
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    if all(rc == 0 for _, rc, _, _ in results):
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(link, capture_output=True, text=True, check=False)
        results.append((link, res.returncode, res.stdout, res.stderr))
    out.with_suffix(".log").write_text("".join(
        " ".join(c) + "\n" + stdout + stderr for c, _, stdout, stderr in results
    ))
    for o in objs:
        o.unlink(missing_ok=True)
    for c, rc, _, stderr in results:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(c)}\n{stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The kernels' library, built if need be, loaded once per process."""
    global _lib
    if _lib is not None:
        return _lib  # loaded: no lock taken (a launch may hold the caller's)
    with _lock:
        if _lib is None:
            # psl: ignore[blocking-under-lock]: _lock exists solely to serialize the process's one build and load of the kernel library: a racing first launch must wait for the library it is about to call, and nothing else is under the lock
            lib = ctypes.CDLL(str(build()))
            lib.ps_cuda_error_string.argtypes = [ctypes.c_int]
            lib.ps_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The library's C entry ``name`` with its argument types set; every
    entry returns a CUDA error code (``int``)."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(load(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def raise_on(code: int, name: str) -> None:
    if code != 0:
        msg = load().ps_cuda_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} ({msg})")


# ---------------------------------------------------------------------------
# the wrappers' input checks
# ---------------------------------------------------------------------------


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def common_device(**tensors: torch.Tensor) -> torch.device:
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        raise ValueError(f"{sorted(tensors)} lie on different devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_push(**tensors: torch.Tensor) -> torch.device:
    """Checks of a fused push's arguments, given by name in the order
    (table a, table b, idx, grad): two equal float32 (K, vdim) tables, int32
    (U,) row indices and a float32 (U, vdim) gradient, all contiguous on one
    device; returns that device."""
    (na, a), (nb, b), (_, idx), (_, grad) = tensors.items()
    check_tensor(na, a, torch.float32)
    check_tensor(nb, b, torch.float32)
    check_tensor("idx", idx, torch.int32)
    check_tensor("grad", grad, torch.float32)
    if a.dim() != 2 or a.shape != b.shape:
        raise ValueError(
            f"{na} and {nb} must be equal (K, vdim) tables, got "
            f"{tuple(a.shape)}, {tuple(b.shape)}"
        )
    if idx.dim() != 1 or grad.shape != (idx.shape[0], a.shape[1]):
        raise ValueError(
            f"need idx (U,) and grad (U, {a.shape[1]}), got "
            f"{tuple(idx.shape)}, {tuple(grad.shape)}"
        )
    return common_device(**tensors)
