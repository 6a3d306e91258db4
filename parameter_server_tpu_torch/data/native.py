"""ctypes bindings for the native (C++) text parsers.

A copy of the JAX package's ``data/native.py``: the same C++ source
(``parameter_server_tpu_torch/native/parser.cpp``, byte for byte the JAX
package's ``native/parser.cpp``) and the same wrapper. Only the build
differs: ``g++`` runs with the JAX Makefile's flags straight into the
gitignored ``parameter_server_tpu_torch/_build/``, as
``libpsdata-<hash of the source bytes, the flags and the host CPU's
feature flags>.so``. It writes a
per-pid temporary file and renames it into place under a lock, and keeps
g++'s output in a ``.log`` beside the library, so processes that build at
once never load a half-written library. ``PS_TPU_NATIVE_LIB`` names a
prebuilt library to load instead, as in the JAX package. If the library
cannot be built, callers fall back to the Python parsers in
``data/libsvm.py``, which produce identical rows.

Chunked protocol: files are read in ~2 MiB chunks cut at line boundaries;
each chunk is parsed in one C call into flat CSR arrays (labels,
row_splits, keys, vals, slots). The hot path is copy-free end to end:
readinto a reusable padded bytearray, AVX2 counts size the output arrays
exactly, and the C parser writes them directly."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from collections.abc import Iterator
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "parser.cpp"
BUILD_DIR = _PKG / "_build"
#: the JAX package's native/Makefile CXXFLAGS
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-Wall", "-Wextra", "-std=c++17")
_LIB_ENV = "PS_TPU_NATIVE_LIB"

FlatRows = tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, "np.ndarray | None"]
# (labels (R,), row_splits (R+1,), keys (N,), vals (N,), slots (N,) or
#  None for SLOTLESS_FORMATS — all slot ids are 0 there)

# Formats with a native fast path; the single source of truth for the
# reader's backend="auto" choice and parse_chunk dispatch.
NATIVE_FORMATS = {
    "libsvm": "ps_parse_libsvm",
    "criteo": "ps_parse_criteo",
    "adfea": "ps_parse_adfea",
}

_lib: ctypes.CDLL | None = None
_lib_tried = False
_build_lock = threading.Lock()


def _cpu_flags() -> bytes:
    """The host CPU's feature flags: ``-march=native`` builds for them, so
    a library built on another host (a copied checkout) is not reused."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return b""


def library_path() -> Path:
    """Where the library built from the current source and flags, for
    this host's CPU, lives."""
    key = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0" + _cpu_flags())
    key.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libpsdata-{key.hexdigest()[:16]}.so"


def _build() -> Path | None:
    """Compile ``parser.cpp`` with g++ unless the library of the same
    source and flags is there already; None if g++ fails or is missing
    (its output stays in the ``.log`` beside the library's path)."""
    if not SOURCE.exists():
        return None
    out = library_path()
    with _build_lock:
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp.so"
        cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        try:
            # psl: ignore[blocking-under-lock]: _build_lock exists solely to serialize this process's one g++ build of the parser library: a thread racing the build must wait for the library it is about to load, and nothing else is under the lock
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        except (subprocess.SubprocessError, OSError) as e:
            out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + repr(e) + "\n")
            return None
        out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0 or not tmp.exists():
            tmp.unlink(missing_ok=True)
            return None
        os.replace(tmp, out)
        return out


def build_log() -> str:
    """g++'s command line and output of the last build of this source."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _tune_malloc() -> None:
    """Raise glibc's mmap threshold so the multi-MB per-chunk output
    arrays are served from the (warm, reusable) heap instead of fresh
    mmaps — each fresh mmap pays a page-fault per 4 KiB on first touch.
    Process-wide, so honoring an escape hatch."""
    if os.environ.get("PS_TPU_NO_MALLOPT"):
        return
    try:
        libc = ctypes.CDLL(None)
        libc.mallopt(ctypes.c_int(-3), ctypes.c_int(256 << 20))  # M_MMAP_THRESHOLD
    except (OSError, AttributeError):
        pass  # non-glibc platform: harmless to skip


def load_native() -> ctypes.CDLL | None:
    """Load (building if needed) the native parser library, or None."""
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    _tune_malloc()
    path = os.environ.get(_LIB_ENV)
    so = Path(path) if path else _build()
    if so is None or not Path(so).exists():
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    i64, u64p = ctypes.c_int64, ctypes.POINTER(ctypes.c_uint64)
    f32p, i64p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64)
    for fn in NATIVE_FORMATS.values():
        f = getattr(lib, fn)
        f.restype = ctypes.c_int
        f.argtypes = [
            ctypes.c_char_p, i64,  # buf, len
            i64, i64,  # max_rows, max_nnz
            f32p, i64p,  # labels, row_splits
            u64p, f32p, u64p,  # keys, vals, slots
            i64p, i64p, i64p,  # out_rows, out_nnz, err_line
        ]
    try:
        c4 = lib.ps_count4
        c4.restype = None
        c4.argtypes = [
            ctypes.c_char_p, i64,
            ctypes.c_byte, ctypes.c_byte, ctypes.c_byte, ctypes.c_byte,
            i64p,
        ]
    except AttributeError:
        pass  # older prebuilt artifact: _counts falls back to bytes.count
    try:
        hl = lib.ps_hash_localize
    except AttributeError:
        hl = None  # older prebuilt artifact without the kernel
    if hl is not None:
        hl.restype = ctypes.c_int
        hl.argtypes = [
            u64p, u64p, i64,  # raw keys, slots (or None), n
            ctypes.c_uint64, ctypes.c_int,  # num_keys, identity flag
            i64p, ctypes.POINTER(ctypes.c_int32), i64p,  # unique, inverse, n_uniq
        ]
    _lib = lib
    return _lib


def native_available() -> bool:
    return load_native() is not None


def hash_localize(
    raw_keys: np.ndarray,
    slots: np.ndarray | None,
    num_keys: int,
    identity: bool = False,
) -> tuple[np.ndarray, np.ndarray] | None:
    """GIL-free hash + localize: hash raw keys into [1, num_keys) (or +1
    in identity mode) and return (sorted unique gids int64, 0-based
    inverse int32) — exactly ``np.unique(hash_keys(...),
    return_inverse=True)``. Returns None when the kernel is unavailable or
    inapplicable (no library, num_keys > 2^32, identity key out of range)
    — callers fall back to numpy, which also reproduces the exact error
    message for the range case."""
    lib = load_native()
    if lib is None or not hasattr(lib, "ps_hash_localize"):
        return None
    if num_keys < 2:
        return None  # numpy path owns the clean num_keys>=2 ValueError
    raw = np.ascontiguousarray(raw_keys, dtype=np.uint64)
    n = len(raw)
    unique = np.empty(max(n, 1), dtype=np.int64)
    inverse = np.empty(max(n, 1), dtype=np.int32)
    n_uniq = ctypes.c_int64()
    u64p = ctypes.POINTER(ctypes.c_uint64)
    sl = None
    if slots is not None:
        sl = np.ascontiguousarray(slots, dtype=np.uint64)
    rc = lib.ps_hash_localize(
        raw.ctypes.data_as(u64p),
        sl.ctypes.data_as(u64p) if sl is not None else None,
        n,
        ctypes.c_uint64(num_keys),
        1 if identity else 0,
        unique.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        inverse.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(n_uniq),
    )
    if rc == -4:
        raise MemoryError("ps_hash_localize: allocation failed")
    if rc != 0:  # -3 identity range error, -5 num_keys > 2^32
        return None
    u = n_uniq.value
    return unique[:u], inverse[:n]


# Formats whose slot id is constant 0 (libsvm): the slots array is pure
# zeros, so the wrapper returns None instead of copying megabytes of
# zeros per chunk — downstream (BatchBuilder.build_flat) treats None as
# salt 0, which hashes identically.
SLOTLESS_FORMATS = frozenset({"libsvm"})

# readable slack the C parsers may overread past the parse length (the
# AVX2 span parsers issue one unguarded 8-byte load per token)
_PAD = 8


# fourth needle per format for ps_count4 (first three are \n, \r, and the
# format's entry marker); counts[3] refines the entry bound for libsvm
# (space-preceded bare ``k`` entries) and adfea (ws-preceded entries)
_COUNT_NEEDLES = {"libsvm": b": ", "criteo": b"\t\0", "adfea": b" \t"}


def _counts(lib, fmt: str, ba: bytearray, length: int) -> tuple[int, int]:
    """(rows_cap, nnz_cap): exact row bound from the line-terminator
    count, entry bound from format-specific marker counts — one AVX2
    pass in C. The output arrays are then allocated EXACTLY once and
    written by C directly. libsvm's colon count is exact except for bare
    ``k`` entries (implicit 1.0) — those undershoot and take the grow
    retry in _parse_region."""
    c3, c4 = _COUNT_NEEDLES[fmt]
    if hasattr(lib, "ps_count4"):
        out = (ctypes.c_int64 * 4)()
        lib.ps_count4(
            (ctypes.c_char * len(ba)).from_buffer(ba), length,
            0x0A, 0x0D, c3, c4, out,
        )
        out = list(out)
    else:  # older prebuilt artifact
        out = [ba.count(bytes([c]), 0, length) for c in (0x0A, 0x0D, c3, c4)]
    rows_cap = out[0] + out[1] + 1
    if fmt == "libsvm":
        # colons are exact for ``k:v`` entries; bare ``k`` entries carry no
        # colon but are each preceded by >= 1 space, so the space count is
        # the complementary bound
        nnz_cap = max(out[2], out[3]) + 1
    elif fmt == "criteo":
        nnz_cap = 39 * rows_cap + 1  # hard bound: <= 39 features per row
    else:  # adfea: every entry is preceded by at least one ws byte
        nnz_cap = out[2] + out[3] + 1
    return rows_cap, nnz_cap


def _parse_region(fmt: str, ba: bytearray, length: int) -> FlatRows:
    """Parse ba[:length] (complete lines; last byte a line terminator;
    ba must extend >= _PAD bytes past length). The region is passed by
    POINTER — no slice copy — and outputs are written by the C parser
    straight into exactly-sized fresh arrays."""
    lib = load_native()
    if lib is None:
        raise RuntimeError("native parser not available")
    if fmt not in NATIVE_FORMATS:
        raise ValueError(f"native parser: unknown format {fmt!r}")
    fn = getattr(lib, NATIVE_FORMATS[fmt])
    rows_cap, nnz_cap = _counts(lib, fmt, ba, length)
    want_slots = fmt not in SLOTLESS_FORMATS
    buf_p = (ctypes.c_char * len(ba)).from_buffer(ba)
    while True:
        labels = np.empty(rows_cap, dtype=np.float32)
        splits = np.empty(rows_cap + 1, dtype=np.int64)
        keys = np.empty(nnz_cap, dtype=np.uint64)
        vals = np.empty(nnz_cap, dtype=np.float32)
        slots = np.empty(nnz_cap, dtype=np.uint64) if want_slots else None
        out_rows = ctypes.c_int64()
        out_nnz = ctypes.c_int64()
        err_line = ctypes.c_int64(-1)
        rc = fn(
            buf_p,
            length,
            rows_cap,
            nnz_cap,
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            splits.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            (
                slots.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
                if want_slots
                else None
            ),
            ctypes.byref(out_rows),
            ctypes.byref(out_nnz),
            ctypes.byref(err_line),
        )
        if rc == -1:
            # nnz bound undershoot (bare-key libsvm): rows_cap is exact, so
            # only the entry bound can overflow. Jump straight to a
            # bytes-per-entry estimate; the hard floor is 2 bytes/entry,
            # and hitting it twice means the C side's capacity accounting
            # is broken — raise, don't spin
            new_cap = min(max(2 * nnz_cap + 64, length // 6), length // 2 + 1)
            if new_cap == nnz_cap:
                raise RuntimeError("native parser capacity overflow (internal bug)")
            nnz_cap = new_cap
            continue
        break
    if rc == -2:
        raise ValueError(f"parse error at line {err_line.value} of chunk ({fmt})")
    if rc != 0:
        raise RuntimeError(f"native parser failed (rc={rc}, fmt={fmt})")
    r, n = out_rows.value, out_nnz.value
    # views, not copies: the arrays are freshly allocated per call
    return (
        labels[:r],
        splits[: r + 1],
        keys[:n],
        vals[:n],
        slots[:n] if want_slots else None,
    )


def parse_chunk(fmt: str, chunk: bytes, max_rows_hint: int = 0) -> FlatRows:
    """Parse a buffer of complete lines via the C parser. ``slots`` in the
    returned tuple is None for SLOTLESS_FORMATS. (max_rows_hint is
    retained for API compatibility; capacities are exact.)"""
    del max_rows_hint
    length = len(chunk)
    ba = bytearray(length + 1 + _PAD)
    ba[:length] = chunk
    if length == 0 or chunk[-1:] not in (b"\n", b"\r"):
        ba[length] = 0x0A  # the C parsers require closed lines
        length += 1
    return _parse_region(fmt, ba, length)


def iter_chunks(
    path: str | Path, fmt: str, chunk_bytes: int = 2 << 20
) -> Iterator[FlatRows]:
    """Stream a text file (optionally .gz) through the native parser.

    One reusable bytearray holds [carried tail | fresh read | pad]; reads
    land via readinto, the parsed region is passed to C by pointer, and
    only the sub-line tail is moved to the front between chunks."""
    import gzip

    p = Path(path)
    opener = gzip.open if p.suffix == ".gz" else open
    with opener(p, "rb") as f:
        cap = chunk_bytes + (chunk_bytes >> 2) + _PAD
        ba = bytearray(cap)
        mv = memoryview(ba)
        tail = 0
        while True:
            if tail + _PAD + 1 >= cap:  # single line longer than the buffer
                cap *= 2
                nba = bytearray(cap)
                nba[:tail] = mv[:tail]
                ba, mv = nba, memoryview(nba)
            # reserve _PAD + 1 bytes past the read: the EOF branch may
            # append a closing 0x0A and must still leave the _PAD slack
            n = f.readinto(mv[tail : cap - _PAD - 1])
            total = tail + (n or 0)
            if not n:
                if total and bytes(mv[:total]).strip():
                    if ba[total - 1] not in (0x0A, 0x0D):
                        ba[total] = 0x0A
                        total += 1
                    yield _parse_region(fmt, ba, total)
                return
            # cut at the last newline of either convention; a chunk ending
            # exactly at '\r' stays in the tail — the next read may begin
            # with '\n' (a CRLF split across chunk boundaries)
            stop = total - 1 if ba[total - 1] == 0x0D else total
            cut = max(ba.rfind(b"\n", 0, stop), ba.rfind(b"\r", 0, stop))
            if cut < 0:
                tail = total
                continue
            yield _parse_region(fmt, ba, cut + 1)
            rest = total - (cut + 1)
            if 0 < rest <= cut + 1:  # disjoint ranges: plain slice copy
                mv[:rest] = mv[cut + 1 : total]
            elif rest:  # tail longer than the parsed prefix (huge line):
                # materialize first — overlapping memoryview assignment
                mv[:rest] = bytes(mv[cut + 1 : total])
            tail = rest
