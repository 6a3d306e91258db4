"""Checker ``blocking-under-lock``: no blocking call while holding a lock.

A lock in this codebase protects nanosecond-scale state transitions
(counter bumps, dict swaps, window bookkeeping). Anything that can park
the holding thread — socket sends/receives, ``time.sleep``,
``Future.result``, an RPC ``call``/``call_async``, a jit dispatch or
device sync (``asarray``/``device_get``/``block_until_ready``), waiting
on a foreign Event/Condition — stalls every other thread contending for
that lock for the call's full duration, which is exactly how the reader
thread ends up unable to complete the reply the blocked send is waiting
for. The checker walks every function with the held-lock stack and flags
blocking primitives (directly, or through a call whose transitive
summary may block).

``cv.wait()`` / ``cv.wait_for()`` on the condition being held is NOT
flagged: a condition wait releases its lock — that's the one sanctioned
way to block "under" a lock.

Deliberate exceptions (a lock whose entire purpose is serializing a
blocking operation, like the client's socket-write lock) carry a
``# psl: ignore[blocking-under-lock]: <why>`` pragma at the call site.

A copy of the JAX package's ``analysis/blocking.py``. The JAX names stay;
the port adds what parks a host thread under PyTorch and CUDA:

- ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` and ``.nonzero()``:
  a copy to the host (``nonzero`` sizes its output from the device), which
  waits for every kernel queued before it;
- ``.synchronize()`` (``torch.cuda``, an ``Event``, a ``Stream``);
- ``.cuda()``, and ``.to(...)`` when an argument names a device (a
  ``device=`` keyword, a ``"cuda"``/``"cpu"`` string, ``torch.device(...)``,
  a ``.device`` attribute, or a name that says ``device``/``dev``): a
  copy between host and card (a dtype-only ``.to`` is not flagged);
- the kernel library's load or build, the counterpart of the JAX jit
  boundary: ``cuda_build.load``/``build``, ``ctypes.CDLL``,
  ``subprocess.run``/``check_call``/``check_output`` and ``.communicate()``
  (nvcc runs for seconds to minutes on a cold build).
"""

from __future__ import annotations

import ast
from typing import Callable

from parameter_server_tpu_torch.analysis.callgraph import (
    CallGraph,
    OwnerKey,
    shared_callgraph,
)
from parameter_server_tpu_torch.analysis.core import (
    Finding,
    HeldLockWalker,
    PackageIndex,
    iter_functions,
    unparse,
)

#: attribute / function names that park the calling thread
BLOCKING_ATTRS = frozenset({
    # sockets
    "sendall", "sendmsg", "send", "sendto",
    "recv", "recv_into", "recvfrom", "accept", "connect",
    # time
    "sleep",
    # futures / RPC round trips
    "result", "call", "call_async",
    # device sync / jit dispatch boundaries
    "asarray", "device_get", "block_until_ready",
    # torch: copies to the host and device syncs
    "item", "tolist", "cpu", "numpy", "nonzero", "synchronize",
    # torch: a copy onto the card
    "cuda",
    # the kernel library's load (ctypes) and its compiler's processes
    "CDLL", "communicate",
})

#: blocking only on the named receiver module: ``subprocess.run(...)``
#: is a child process's whole run, ``cuda_build.load()`` may build the
#: kernel library (``run``/``load``/``build`` are common method names)
BLOCKING_MODULE_ATTRS = {
    "subprocess": frozenset({"run", "call", "check_call", "check_output"}),
    "cuda_build": frozenset({"load", "build"}),
}

#: string arguments of ``.to(...)`` that name a device
_DEVICE_PREFIXES = ("cuda", "cpu")

#: blocking only when the receiver is NOT the lock being held (a
#: condition wait releases its own lock; an Event.wait under a DIFFERENT
#: lock holds that lock for the whole park)
WAIT_ATTRS = frozenset({"wait", "wait_for"})


#: host-copy names that numpy arrays share with tensors: on an array
#: known to live on the host they move nothing and wait for nothing
_HOST_COPY_ATTRS = frozenset({"item", "tolist", "nonzero"})
_NP_MODULES = frozenset({"np", "numpy"})


def _is_ndarray_annotation(ann: ast.AST | None) -> bool:
    if ann is None:
        return False
    for sub in ast.walk(ann):
        if isinstance(sub, ast.Attribute) and sub.attr == "ndarray":
            return True
        if isinstance(sub, ast.Name) and sub.id == "ndarray":
            return True
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str) and (
            "ndarray" in sub.value
        ):
            return True
    return False


def _args(fndef: ast.AST) -> list[ast.arg]:
    a = fndef.args  # type: ignore[attr-defined]
    return [*a.posonlyargs, *a.args, *a.kwonlyargs]


class _HostArrays:
    """Which receivers are numpy arrays, so that ``.tolist()`` /
    ``.item()`` / ``.nonzero()`` on them are not read as a copy off the
    card. Deliberately shallow: an ``np.`` call's result (and anything
    indexed or called off it), a parameter annotated ``np.ndarray``, a
    local bound to such a value, and a class attribute bound to one
    (``self.X = np.zeros(...)``, or ``x.X`` where ``x`` is annotated with
    that class). Anything else is assumed to be a tensor."""

    def __init__(self, graph: CallGraph):
        self._graph = graph
        #: class name -> its attributes that hold numpy arrays
        self.attrs: dict[str, set[str]] = {}
        for _ in range(2):  # attrs bound from other host attrs settle
            for info in graph.classes.values():
                got = self.attrs.setdefault(info.name, set())
                for fndef in info.methods.values():
                    names, typed = self.function_names(fndef, info.name)
                    for sub in ast.walk(fndef):
                        if not isinstance(sub, (ast.Assign, ast.AnnAssign)):
                            continue
                        targets = (
                            sub.targets if isinstance(sub, ast.Assign)
                            else [sub.target]
                        )
                        host = (
                            isinstance(sub, ast.AnnAssign)
                            and _is_ndarray_annotation(sub.annotation)
                        ) or (
                            sub.value is not None and self.on_host(
                                sub.value, names, typed, info.name
                            )
                        )
                        for t in targets:
                            if host and isinstance(t, ast.Attribute) and (
                                isinstance(t.value, ast.Name)
                                and t.value.id == "self"
                            ):
                                got.add(t.attr)

    def function_names(
        self, fndef: ast.AST, cls_name: str | None
    ) -> tuple[set[str], dict[str, str]]:
        """(local names holding numpy arrays, local names annotated with a
        package class -> that class) in one function body."""
        names: set[str] = set()
        typed: dict[str, str] = {}
        for a in _args(fndef):
            if _is_ndarray_annotation(a.annotation):
                names.add(a.arg)
            elif isinstance(a.annotation, ast.Name) and (
                a.annotation.id in self._graph.classes
            ):
                typed[a.arg] = a.annotation.id
        for _ in range(2):
            for sub in ast.walk(fndef):
                if not isinstance(sub, ast.Assign) or len(sub.targets) != 1:
                    continue
                t, v = sub.targets[0], sub.value
                pairs = (
                    list(zip(t.elts, v.elts))
                    if isinstance(t, ast.Tuple) and isinstance(v, ast.Tuple)
                    and len(t.elts) == len(v.elts)
                    else [(e, v) for e in t.elts] if isinstance(t, ast.Tuple)
                    else [(t, v)]
                )
                for te, ve in pairs:
                    if isinstance(te, ast.Name) and self.on_host(
                        ve, names, typed, cls_name
                    ):
                        names.add(te.id)
        return names, typed

    def on_host(
        self, expr: ast.AST, names: set[str], typed: dict[str, str],
        cls_name: str | None,
    ) -> bool:
        while True:
            if isinstance(expr, ast.Attribute):
                base = expr.value
                if isinstance(base, ast.Name):
                    if base.id == "self" and cls_name is not None:
                        return any(
                            expr.attr in self.attrs.get(i.name, ())
                            for i in self._graph.mro(cls_name)
                        )
                    if base.id in typed:
                        return expr.attr in self.attrs.get(typed[base.id], ())
                expr = base
            elif isinstance(expr, (ast.Subscript, ast.Starred)):
                expr = expr.value
            elif isinstance(expr, ast.Call):
                expr = expr.func
            elif isinstance(expr, ast.Name):
                return expr.id in _NP_MODULES or expr.id in names
            else:
                return False


def _blocks_directly(
    fndef: ast.AST, host: _HostArrays, cls_name: str | None
) -> bool:
    names, typed = host.function_names(fndef, cls_name)
    for sub in ast.walk(fndef):
        if isinstance(sub, ast.Call) and _blocking_name(
            sub, lambda e: host.on_host(e, names, typed, cls_name)
        ) is not None:
            return True
    return False


def _names_device(arg: ast.AST) -> bool:
    """Whether a ``.to(...)`` argument names a device rather than a
    dtype."""
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value.startswith(_DEVICE_PREFIXES)
    if isinstance(arg, ast.Call):
        f = arg.func
        return isinstance(f, ast.Attribute) and f.attr == "device"
    name = (
        arg.attr if isinstance(arg, ast.Attribute)
        else arg.id if isinstance(arg, ast.Name) else ""
    )
    return name == "dev" or "device" in name


def _blocking_name(
    call: ast.Call, on_host: Callable[[ast.AST], bool]
) -> str | None:
    fn = call.func
    if isinstance(fn, ast.Attribute):
        if fn.attr in BLOCKING_ATTRS:
            if fn.attr in _HOST_COPY_ATTRS and on_host(fn.value):
                return None
            return fn.attr
        recv = fn.value
        if isinstance(recv, ast.Name) and fn.attr in BLOCKING_MODULE_ATTRS.get(
            recv.id, ()
        ):
            return fn.attr
        if fn.attr == "to" and (
            any(kw.arg == "device" for kw in call.keywords)
            or any(_names_device(a) for a in call.args)
        ):
            return fn.attr
    elif isinstance(fn, ast.Name) and fn.id == "CDLL":
        return fn.id
    return None


def may_block_summaries(
    graph: CallGraph, host: _HostArrays | None = None
) -> dict[OwnerKey, bool]:
    host = host or _HostArrays(graph)
    return graph.summarize(
        direct=lambda owner, rp, cn, fd: _blocks_directly(fd, host, cn),
        merge=lambda a, b: a or b,
        bottom=lambda: False,
    )


class _BlockWalker(HeldLockWalker):
    def __init__(
        self,
        graph: CallGraph,
        relpath: str,
        cls_name: str | None,
        summaries: dict[OwnerKey, bool],
        out: list[Finding],
        host: _HostArrays,
    ):
        super().__init__(self._lock_key)
        self._graph = graph
        self._host = host
        self._host_names: tuple[set[str], dict[str, str]] = (set(), {})
        self._relpath = relpath
        self._cls = cls_name
        self._summaries = summaries
        self._out = out
        self._seen: set[int] = set()  # one finding per line

    def walk_function(self, fn: ast.FunctionDef | ast.AsyncFunctionDef) -> None:
        self._host_names = self._host.function_names(fn, self._cls)
        super().walk_function(fn)

    def _lock_key(self, expr: ast.AST) -> str | None:
        g = self._graph
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and self._cls is not None
        ):
            return g.lock_attr_key(self._cls, expr.attr)
        if isinstance(expr, ast.Name):
            return g.module_locks.get(expr.id)
        return None

    def on_call(self, node: ast.Call, held: list) -> None:
        if not held:
            return
        what: str | None = None
        names, typed = self._host_names
        name = _blocking_name(
            node, lambda e: self._host.on_host(e, names, typed, self._cls)
        )
        if name is not None:
            what = f"{unparse(node.func)}(...)"
        elif (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in WAIT_ATTRS
        ):
            recv = unparse(node.func.value)
            if all(recv != expr for _, expr, _ in held):
                what = (
                    f"{unparse(node.func)}(...) "
                    "(waits on an object that is not the held lock)"
                )
        else:
            for callee in self._graph.callees(self._relpath, self._cls, node):
                if self._summaries.get(callee):
                    what = (
                        f"{unparse(node.func)}(...) "
                        f"(transitively blocking via {callee[1]}.{callee[2]})"
                    )
                    break
        if what is None or node.lineno in self._seen:
            return
        self._seen.add(node.lineno)
        locks = ", ".join(sorted({k for k, _, _ in held}))
        self._out.append(Finding(
            "blocking-under-lock", self._relpath, node.lineno,
            f"{what} while holding {locks}: the holder parks every "
            "thread contending for the lock for the call's duration",
        ))


def check_blocking_under_lock(index: PackageIndex) -> list[Finding]:
    graph = shared_callgraph(index)
    host = _HostArrays(graph)
    summaries = may_block_summaries(graph, host)
    out: list[Finding] = []
    for f in index.files:
        for cls_name, fndef in iter_functions(f.tree):
            _BlockWalker(
                graph, f.relpath, cls_name, summaries, out, host
            ).walk_function(fndef)
    return out
