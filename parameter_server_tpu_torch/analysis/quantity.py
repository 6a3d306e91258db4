"""Checkers ``units`` / ``clockdomain`` / ``idtype``: quantity-flow
analysis over the telemetry and wire surface.

The repo's own history is the motivation: a sub-ms SSP wait floored to
0 and silenced an SLO rule, cross-node wall-clock skew drove
critical-path attribution negative until a hand-written clamp,
and the freshness plane threads µs publish-timestamps next to
ms budgets and second-granularity windows through five layers. All
three are *dimensional* bugs — invisible to tests unless the exact
magnitudes collide, trivially visible to a flow analysis that types
every value with its quantity. These checkers ride the tag
dataflow (``analysis/dataflow.py``): seeds at sources, propagation
through assignments/helpers/summaries, verdicts at arithmetic,
comparisons and sinks. All three compose into the ONE shared package
fixpoint (``analysis/flowrun.py``) under disjoint tag namespaces.

**units** — dimension lattice ``u:us u:ms u:s u:bytes u:count
u:clocks``, inferred from name suffixes (``_us``/``_ms``/``_s``/
``_bytes``/``_clocks``/``_count``, plus the whole words ``seconds`` and
``nbytes``), from ``time.time()``-family calls (seconds), from literal
factor conversions (``* 1000``: s->ms->us; ``/ 1e3``: us->ms->s;
``1e6`` jumps two rungs), and from the ``[tool.pslint]
unit-conversions`` whitelist (``"fn -> unit"``: a call to ``fn``
returns that unit whatever its body's tags say). Findings: cross-unit
``+``/``-``/comparison, unit-mismatched or unit-unknown durations
flowing into suffixed sinks (names, attributes, header/config keys,
keyword and positional parameters), and duration-valued telemetry
series whose literal name carries no unit suffix (the ``.n``
as-if-microseconds convention counts as a suffix).

**clockdomain** — ``ck:wall`` (``time.time``), ``ck:mono``
(``time.monotonic``), ``ck:perf`` (``time.perf_counter``) and
``ck:foreign`` (a PEER's wall clock echoed through a wire field:
``pts`` and anything in ``[tool.pslint] clock-foreign-keys``), also
seeded by the ``utils.clock`` helper naming convention
(``now_wall_*``/``now_mono_*``/``now_perf_*``). Timestamps are
same-domain-only: subtraction, comparison and min/max across domains
are findings UNLESS the expression sits inside a declared skew clamp —
a function whose name contains ``clamp`` (or is listed in
``[tool.pslint] clock-clamps``), either lexically inside its body or
anywhere inside its call arguments (the ``_clamp(serve_ts - t0,
op)`` idiom). A same-domain subtraction yields a domain-free duration,
so comparing two durations from different clocks is fine.

**idtype** — opaque identity spaces ``id:cid id:seq id:rank id:ver
id:key id:trace``, seeded from the package vocabulary (``cid``,
``seq``/``rseq``, ``rank``/``worker``, ``ver``/``version``, ``kid``/
``key_id``, ``tid``/``trace_id``) at loads of names, attributes and
header keys. Findings: comparison between different id spaces,
arithmetic on opaque ids (``cid``/``trace``/``key``, and ``ver`` which
is EQUALITY-ONLY — versions roll back on failover, so
ordering two versions is flagged too; ``seq``/``rank`` stay numeric),
and positional/keyword id swaps at call boundaries where an argument's
id tag contradicts the parameter's id-vocabulary name.
"""

from __future__ import annotations

import ast

from parameter_server_tpu_torch.analysis.callgraph import (
    CallGraph,
    shared_callgraph,
)
from parameter_server_tpu_torch.analysis.core import Finding, PackageIndex
from parameter_server_tpu_torch.analysis.dataflow import (
    EMPTY,
    FlowPolicy,
    Tags,
)
from parameter_server_tpu_torch.analysis.flowrun import (
    flow_policy,
    register_flow_policy,
)

# ---------------------------------------------------------------------------
# vocabularies
# ---------------------------------------------------------------------------

#: identifier suffix token -> unit (the token AFTER the last underscore;
#: single-token names are never suffix-matched except the whole words,
#: so a plain local ``s`` or ``ms`` string var can't pollute the lattice)
_UNIT_TOKENS = {
    "us": "us", "usec": "us",
    "ms": "ms", "msec": "ms",
    "s": "s", "sec": "s", "secs": "s", "seconds": "s",
    "bytes": "bytes",
    "clocks": "clocks",
    "count": "count",
}
_UNIT_WHOLE_WORDS = {"seconds": "s", "nbytes": "bytes"}
_TIME_UNITS = frozenset({"u:us", "u:ms", "u:s"})
_ALL_UNITS = frozenset({"u:us", "u:ms", "u:s", "u:bytes", "u:count",
                        "u:clocks"})

#: literal conversion factors: (unit, factor) -> unit after * / after /
_SCALE_UP = {
    ("u:s", 1000): "u:ms", ("u:ms", 1000): "u:us",
    ("u:s", 1000000): "u:us",
}
_SCALE_DOWN = {
    ("u:us", 1000): "u:ms", ("u:ms", 1000): "u:s",
    ("u:us", 1000000): "u:s",
}

#: numeric identity casts: quantity tags pass straight through
_CAST_FNS = frozenset({"int", "float", "round", "abs", "min", "max", "sum"})

_CLOCK_NAMES = {"ck:wall": "wall (time.time)", "ck:mono": "monotonic",
                "ck:perf": "perf_counter",
                "ck:foreign": "foreign-wall (peer-echoed wire field)"}
_DEFAULT_FOREIGN_KEYS = frozenset({"pts"})

#: id vocabulary: last name token -> id space
_ID_TOKENS = {
    "cid": "cid",
    "seq": "seq", "rseq": "seq",
    "rank": "rank", "worker": "rank",
    "ver": "ver", "version": "ver",
    "kid": "key",
    "tid": "trace",
}
#: two-token tails ``<what>_id``
_ID_PAIRS = {"key": "key", "trace": "trace", "client": "cid",
             "worker": "rank"}
#: id spaces where ANY arithmetic is a finding (ver additionally
#: forbids ordering; seq/rank are genuinely numeric and stay free)
_OPAQUE_IDS = frozenset({"id:cid", "id:ver", "id:key", "id:trace"})


def _tokens(name: str) -> list[str]:
    return [t for t in name.lower().split("_") if t]


def unit_of_name(name: str) -> str | None:
    """``svc_us`` -> "us", ``window_s`` -> "s", ``seconds`` -> "s";
    None when the name declares nothing."""
    low = name.lower()
    if low in _UNIT_WHOLE_WORDS:
        return _UNIT_WHOLE_WORDS[low]
    toks = _tokens(low)
    if len(toks) >= 2:
        return _UNIT_TOKENS.get(toks[-1])
    return None


def id_of_name(name: str) -> str | None:
    """``peer_cid`` -> "cid", ``trace_id`` -> "trace", ``worker`` ->
    "rank"; None when the name is outside the id vocabulary.
    ALL-CAPS names are module constants (bit masks like ``_BF_CID``,
    shift widths like ``NONCE_SHIFT``) — they describe the id's wire
    encoding, they do not HOLD an id value, so they never seed."""
    if name.upper() == name:
        return None
    toks = _tokens(name)
    if not toks:
        return None
    if toks[-1] == "id" and len(toks) >= 2:
        return _ID_PAIRS.get(toks[-2])
    return _ID_TOKENS.get(toks[-1])


def _call_name(call: ast.Call) -> str | None:
    fn = call.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


def _const_factor(expr: ast.expr) -> int | None:
    """1000/1e3/1000000/1e6 literal (the conversion rungs) or None."""
    if isinstance(expr, ast.Constant) and isinstance(
        expr.value, (int, float)
    ) and not isinstance(expr.value, bool):
        v = expr.value
        if v in (1000, 1000.0):
            return 1000
        if v in (1000000, 1000000.0):
            return 1000000
    return None


def _time_call_domain(call: ast.Call) -> str | None:
    """``time.time()`` -> ck:wall etc.; also the ``utils.clock`` helper
    naming convention so a snippet (or an unresolved import) still tags."""
    fn = call.func
    name = None
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name) \
            and fn.value.id == "time":
        name = fn.attr
    elif isinstance(fn, ast.Name):
        name = fn.id
    elif isinstance(fn, ast.Attribute):
        name = fn.attr
    if name is None:
        return None
    if name in ("time", "time_ns") or name.startswith("now_wall"):
        return "ck:wall"
    if name in ("monotonic", "monotonic_ns") or name.startswith("now_mono"):
        return "ck:mono"
    if name in ("perf_counter", "perf_counter_ns") or name.startswith(
        "now_perf"
    ):
        return "ck:perf"
    return None


def _time_call_unit(call: ast.Call) -> str | None:
    """The unit a clock call returns: seconds for the ``time`` module
    floats (the ``_ns`` variants are outside the lattice and stay
    untagged on purpose — nothing in this package uses them)."""
    d = _time_call_domain(call)
    if d is None:
        return None
    name = _call_name(call) or ""
    if name.endswith("_ns"):
        return None
    # now_wall_us / now_mono_us carry their unit in the suffix already
    return unit_of_name(name) or "s"


def _callee_params(
    graph: CallGraph, relpath: str, cls_name: str | None, call: ast.Call
) -> list[str] | None:
    """Positional parameter names (self excluded) of the first callee
    the graph resolves for this call; None when unresolved."""
    for owner in graph.callees(relpath, cls_name, call):
        kind, a, b = owner
        if kind == "f":
            fndef = graph.mod_funcs.get((a, b))
        else:
            info = graph.classes.get(a)
            fndef = info.methods.get(b) if info else None
        if fndef is None:
            continue
        args = fndef.args
        names = [p.arg for p in args.posonlyargs + args.args]
        return [n for n in names if n != "self"]
    return None


# ---------------------------------------------------------------------------
# shared policy plumbing
# ---------------------------------------------------------------------------


class _QuantityPolicy(FlowPolicy):
    """Common plumbing: position tracking + deduped finding capture
    (binop runs in both fixpoint passes; report gating plus the dedupe
    set keep each verdict single)."""

    prefix = ""  # tag namespace, e.g. "u:"

    def __init__(self, graph: CallGraph):
        self._graph = graph
        self._relpath = ""
        self._cls: str | None = None
        self._fn = ""
        self.findings: list[tuple[str, int, str]] = []
        self._seen: set[tuple[str, int, str]] = set()

    def owns(self, tag: str) -> bool:
        return tag.startswith(self.prefix)

    def begin_function(
        self, relpath: str, cls_name: str | None, fn_name: str
    ) -> None:
        self._relpath = relpath
        self._cls = cls_name
        self._fn = fn_name

    def _add(self, node: ast.AST, msg: str) -> None:
        key = (self._relpath, getattr(node, "lineno", 0), msg)
        if key not in self._seen:
            self._seen.add(key)
            self.findings.append(key)

    def _mine(self, tags: Tags) -> Tags:
        return frozenset(t for t in tags if t.startswith(self.prefix))


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------


def _parse_conversions(entries: list[str]) -> dict[str, str]:
    out: dict[str, str] = {}
    for e in entries:
        if "->" not in e:
            continue
        fn, _, unit = e.partition("->")
        fn, unit = fn.strip(), unit.strip()
        if fn and f"u:{unit}" in _ALL_UNITS:
            out[fn] = unit
    return out


class _UnitsPolicy(_QuantityPolicy):
    prefix = "u:"

    def __init__(self, graph: CallGraph, conversions: dict[str, str]):
        super().__init__(graph)
        self._conversions = conversions

    # -- sources -----------------------------------------------------------

    def seed(self, expr, cls_name, relpath):
        if isinstance(expr, ast.Name):
            u = unit_of_name(expr.id)
        elif isinstance(expr, ast.Attribute):
            u = unit_of_name(expr.attr)
        elif isinstance(expr, ast.Subscript) and isinstance(
            expr.slice, ast.Constant
        ) and isinstance(expr.slice.value, str):
            u = unit_of_name(expr.slice.value)
        else:
            u = None
        return frozenset({f"u:{u}"}) if u else EMPTY

    def call_result(self, call, recv_tags, arg_tags):
        name = _call_name(call)
        if name in _CAST_FNS:
            out = EMPTY
            for t in arg_tags:
                out |= self._mine(t)
            return out
        u = _time_call_unit(call)
        if u is None and name is not None:
            u = unit_of_name(name)
        if u is not None:
            return frozenset({f"u:{u}"})
        return super().call_result(call, recv_tags, arg_tags)

    def finish_call(self, call, tags):
        name = _call_name(call)
        conv = self._conversions.get(name or "")
        if conv is not None:
            return frozenset(
                t for t in tags if not t.startswith("u:")
            ) | {f"u:{conv}"}
        return tags

    # -- arithmetic --------------------------------------------------------

    def binop(self, node, op, ltags, rtags, report):
        lu, ru = self._mine(ltags), self._mine(rtags)
        if isinstance(op, ast.Mult):
            # literal rung factor on either side converts a single
            # time-unit operand up the lattice
            if isinstance(node, ast.BinOp):
                l_f = _const_factor(node.left)
                r_f = _const_factor(node.right)
            else:  # AugAssign: x_s *= 1000
                l_f, r_f = None, _const_factor(node.value)
            for f, tags in ((r_f, lu), (l_f, ru)):
                if f is not None and len(tags) == 1:
                    conv = _SCALE_UP.get((next(iter(tags)), f))
                    if conv:
                        return frozenset({conv})
            return lu | ru  # plain scaling keeps the unit
        if isinstance(op, (ast.Div, ast.FloorDiv)):
            value = node.right if isinstance(node, ast.BinOp) else node.value
            f = _const_factor(value)
            if f is not None and len(lu) == 1:
                conv = _SCALE_DOWN.get((next(iter(lu)), f))
                if conv:
                    return frozenset({conv})
            if lu and ru:
                return EMPTY  # ratio (same unit) or rate (cross): unitless
            return lu  # x_us / n stays µs
        if isinstance(op, ast.Mod):
            return lu
        if isinstance(op, (ast.Add, ast.Sub)):
            if lu and ru:
                inter = lu & ru
                if not inter:
                    if report:
                        opname = "+" if isinstance(op, ast.Add) else "-"
                        self._add(node, self._mix_msg(opname, lu, ru))
                    return lu | ru
                return inter
            return lu | ru
        return EMPTY

    def unary(self, node, op, tags, report):
        if isinstance(op, (ast.USub, ast.UAdd)):
            return self._mine(tags)
        return EMPTY

    def _mix_msg(self, what: str, lu: Tags, ru: Tags) -> str:
        return (
            f"cross-unit {what}: operands carry "
            f"{'/'.join(sorted(lu))} vs {'/'.join(sorted(ru))} — "
            "convert explicitly (* 1000, / 1e3, / 1e6) or route through "
            "a declared conversion ([tool.pslint] unit-conversions)"
        )

    def on_compare(self, node, operand_tags):
        tag_sets = [self._mine(t) for t in operand_tags]
        for a, b in zip(tag_sets, tag_sets[1:]):
            if a and b and not (a & b):
                self._add(node, self._mix_msg("comparison", a, b))
                return

    # -- sinks ---------------------------------------------------------------

    def _sink_check(
        self, node: ast.AST, kind: str, name: str, tags: Tags,
        value: ast.expr | None,
    ) -> None:
        want = unit_of_name(name)
        if want is None:
            return
        have = self._mine(tags)
        if have and f"u:{want}" not in have:
            self._add(node, (
                f"value carrying {'/'.join(sorted(have))} flows into "
                f"{kind} '{name}' whose suffix declares u:{want} — "
                "convert at the boundary or fix the name"
            ))
        elif (
            not have
            and f"u:{want}" in _TIME_UNITS
            and isinstance(value, ast.BinOp)
            and isinstance(value.op, ast.Sub)
        ):
            self._add(node, (
                f"duration of unknown unit flows into {kind} '{name}' "
                f"(declared u:{want}): the operands of the subtraction "
                "carry no unit — suffix them, or take the timestamps "
                "from the utils.clock helpers so the lattice can check "
                "this sink"
            ))

    def on_bind(self, name, tags, stmt):
        self._sink_check(stmt, "name", name, tags,
                         getattr(stmt, "value", None))

    def on_store(self, kind, name, tags, stmt):
        label = "attribute" if kind == "attr" else "key"
        self._sink_check(stmt, label, name, tags,
                         getattr(stmt, "value", None))

    def on_keyword(self, call, kw_name, tags):
        value = next(
            (kw.value for kw in call.keywords if kw.arg == kw_name), None
        )
        self._sink_check(call, "keyword argument", kw_name, tags, value)

    def on_call(self, call, arg_tags, held, eval_expr):
        params = _callee_params(self._graph, self._relpath, self._cls, call)
        if params:
            for i, tags in enumerate(arg_tags):
                if i >= len(params):
                    break
                self._sink_check(
                    call, "parameter", params[i], tags,
                    call.args[i] if i < len(call.args) else None,
                )
        # duration-valued telemetry series need a unit-suffixed name
        # (or the .n as-if-µs count convention): series names are how
        # dashboards/SLOs consume these values, so the unit must ride
        # the committed name, not tribal knowledge
        if (
            params
            and params[0] in ("name", "series")
            and call.args
            and isinstance(call.args[0], ast.Constant)
            and isinstance(call.args[0].value, str)
            and any(self._mine(t) & _TIME_UNITS for t in arg_tags[1:])
        ):
            series = call.args[0].value
            leaf = series.rsplit(".", 1)[-1]
            if not series.endswith(".n") and unit_of_name(leaf) is None \
                    and unit_of_name(f"x_{leaf}") is None:
                self._add(call, (
                    f"duration-valued series name {series!r} carries no "
                    "unit suffix (and is not a '.n' count) — readers "
                    "can't know the scale; name the unit "
                    f"(e.g. '{series}_s')"
                ))


# ---------------------------------------------------------------------------
# clockdomain
# ---------------------------------------------------------------------------


class _ClockPolicy(_QuantityPolicy):
    prefix = "ck:"

    def __init__(
        self,
        graph: CallGraph,
        foreign_keys: frozenset[str],
        clamp_names: frozenset[str],
        sanctioned: dict[str, set[int]],
    ):
        super().__init__(graph)
        self._foreign = foreign_keys
        self._clamps = clamp_names
        self._sanctioned = sanctioned  # relpath -> linenos inside clamp args
        self._in_clamp = False

    def begin_function(self, relpath, cls_name, fn_name):
        super().begin_function(relpath, cls_name, fn_name)
        self._in_clamp = "clamp" in fn_name.lower() or fn_name in self._clamps

    def _flag(self, node: ast.AST, what: str, a: Tags, b: Tags) -> None:
        if self._in_clamp:
            return
        line = getattr(node, "lineno", 0)
        if line in self._sanctioned.get(self._relpath, ()):
            return

        def names(ts: Tags) -> str:
            return "/".join(_CLOCK_NAMES.get(t, t) for t in sorted(ts))

        self._add(node, (
            f"cross-clock-domain {what}: operands carry {names(a)} vs "
            f"{names(b)} — timestamps are same-domain-only (skew makes "
            "the difference garbage); take both from one clock, or "
            "route the mixing through a declared skew clamp (a function "
            "whose name contains 'clamp', or one listed in "
            "[tool.pslint] clock-clamps)"
        ))

    # -- sources -----------------------------------------------------------

    def seed(self, expr, cls_name, relpath):
        name = None
        if isinstance(expr, ast.Name):
            name = expr.id
        elif isinstance(expr, ast.Attribute):
            name = expr.attr
        elif isinstance(expr, ast.Subscript) and isinstance(
            expr.slice, ast.Constant
        ) and isinstance(expr.slice.value, str):
            name = expr.slice.value
        if name is not None and (
            name in self._foreign or _tokens(name)[-1:] == ["pts"]
        ):
            return frozenset({"ck:foreign"})
        return EMPTY

    def call_result(self, call, recv_tags, arg_tags):
        d = _time_call_domain(call)
        if d is not None:
            return frozenset({d})
        if _call_name(call) in _CAST_FNS:
            out = EMPTY
            for t in arg_tags:
                out |= self._mine(t)
            return out
        return super().call_result(call, recv_tags, arg_tags)

    # -- same-domain-only operations -----------------------------------------

    def binop(self, node, op, ltags, rtags, report):
        lc, rc = self._mine(ltags), self._mine(rtags)
        if isinstance(op, ast.Sub):
            if lc and rc:
                if not (lc & rc) and report:
                    self._flag(node, "subtraction", lc, rc)
                return EMPTY  # ts - ts = duration: domain-free
            return EMPTY  # unknown mix: stay quiet, stay untagged
        if isinstance(op, ast.Add):
            return lc | rc  # ts + duration keeps the domain
        if isinstance(op, (ast.Mult, ast.Div)):
            return lc | rc  # unit rescaling keeps the domain
        return EMPTY

    def unary(self, node, op, tags, report):
        if isinstance(op, (ast.USub, ast.UAdd)):
            return self._mine(tags)
        return EMPTY

    def on_compare(self, node, operand_tags):
        tag_sets = [self._mine(t) for t in operand_tags]
        for a, b in zip(tag_sets, tag_sets[1:]):
            if a and b and not (a & b):
                self._flag(node, "comparison", a, b)
                return

    def on_call(self, call, arg_tags, held, eval_expr):
        name = _call_name(call)
        if name not in ("min", "max") or len(arg_tags) < 2:
            return
        domains = [self._mine(t) for t in arg_tags if self._mine(t)]
        for a, b in zip(domains, domains[1:]):
            if not (a & b):
                self._flag(call, f"{name}()", a, b)
                return


def _collect_clamp_sanctioned(
    index: PackageIndex, clamp_names: frozenset[str]
) -> dict[str, set[int]]:
    """relpath -> line numbers lexically inside the ARGUMENTS of a call
    to a declared skew clamp: ``_clamp(serve_ts - issue_ts, op)`` mixes
    domains inside the clamp call itself, and that is the sanctioned
    place to do it."""
    out: dict[str, set[int]] = {}
    for f in index.files:
        lines: set[int] = set()
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            if name is None or (
                "clamp" not in name.lower() and name not in clamp_names
            ):
                continue
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                for sub in ast.walk(arg):
                    if hasattr(sub, "lineno"):
                        lines.add(sub.lineno)
        if lines:
            out[f.relpath] = lines
    return out


# ---------------------------------------------------------------------------
# idtype
# ---------------------------------------------------------------------------


class _IdPolicy(_QuantityPolicy):
    prefix = "id:"

    def __init__(
        self, graph: CallGraph,
        setters: frozenset[tuple[str, str]] = frozenset(),
    ):
        super().__init__(graph)
        #: (class, method) of each in-place publisher's version setter:
        #: the one place a version is derived from the last one
        self._setters = setters

    def seed(self, expr, cls_name, relpath):
        if isinstance(expr, ast.Name):
            t = id_of_name(expr.id)
        elif isinstance(expr, ast.Attribute):
            t = id_of_name(expr.attr)
        elif isinstance(expr, ast.Subscript) and isinstance(
            expr.slice, ast.Constant
        ) and isinstance(expr.slice.value, str):
            t = id_of_name(expr.slice.value)
        else:
            t = None
        return frozenset({f"id:{t}"}) if t else EMPTY

    def call_result(self, call, recv_tags, arg_tags):
        if _call_name(call) in _CAST_FNS:
            out = EMPTY
            for t in arg_tags:
                out |= self._mine(t)
            return out
        return super().call_result(call, recv_tags, arg_tags)

    # -- capabilities --------------------------------------------------------

    def binop(self, node, op, ltags, rtags, report):
        li, ri = self._mine(ltags), self._mine(rtags)
        if isinstance(
            op, (ast.BitOr, ast.BitAnd, ast.BitXor, ast.LShift, ast.RShift)
        ):
            # bit packing/masking IS the encode/decode of an opaque id
            # (header flag words, the ver<<shift|nonce life stamp) —
            # structure, not arithmetic; the value keeps its space
            return li | ri
        opaque = (li | ri) & _OPAQUE_IDS
        if (self._cls, self._fn) in self._setters:
            opaque = opaque - {"id:ver"}
        if opaque and report:
            which = "/".join(sorted(opaque))
            extra = (
                " (id:ver is EQUALITY-ONLY: versions roll back on "
                "failover, so even +1 outside the publisher's setter "
                "forges a stamp)"
                if "id:ver" in opaque else ""
            )
            self._add(node, (
                f"arithmetic on opaque id {which}: identity tokens are "
                f"not numbers{extra} — derive a new id at its "
                "construction site instead"
            ))
        return li | ri  # id arith (where legal: seq/rank) keeps the space

    def unary(self, node, op, tags, report):
        if isinstance(op, (ast.USub, ast.UAdd)):
            return self._mine(tags)
        return EMPTY

    def on_compare(self, node, operand_tags):
        tag_sets = [self._mine(t) for t in operand_tags]
        ordered = any(
            isinstance(o, (ast.Lt, ast.LtE, ast.Gt, ast.GtE))
            for o in node.ops
        )
        for a, b in zip(tag_sets, tag_sets[1:]):
            if a and b and not (a & b):
                self._add(node, (
                    f"cross-identity comparison: {'/'.join(sorted(a))} "
                    f"vs {'/'.join(sorted(b))} — these id spaces never "
                    "intersect, so this is a type confusion the runtime "
                    "can't see (swapped variables?)"
                ))
                return
            if ordered and "id:ver" in a and "id:ver" in b:
                self._add(node, (
                    "ordering comparison between version stamps: id:ver "
                    "is equality-only (a failover can roll the published "
                    "version BACK, so 'newer' is undecidable) — "
                    "revalidate with ==/!="
                ))
                return

    # -- call-boundary swaps ---------------------------------------------------

    def _param_check(
        self, node: ast.AST, where: str, pname: str, tags: Tags
    ) -> None:
        want = id_of_name(pname)
        have = self._mine(tags)
        if want is None or not have:
            return
        if f"id:{want}" not in have:
            self._add(node, (
                f"{where} carries {'/'.join(sorted(have))} but the "
                f"parameter is named '{pname}' (id:{want}) — id spaces "
                "swapped at the call boundary"
            ))

    def on_call(self, call, arg_tags, held, eval_expr):
        params = _callee_params(self._graph, self._relpath, self._cls, call)
        if not params:
            return
        for i, tags in enumerate(arg_tags):
            if i >= len(params):
                break
            self._param_check(call, f"argument {i}", params[i], tags)

    def on_keyword(self, call, kw_name, tags):
        self._param_check(call, "keyword argument", kw_name, tags)


# ---------------------------------------------------------------------------
# factories + checkers
# ---------------------------------------------------------------------------


def _units_factory(index: PackageIndex) -> _UnitsPolicy:
    return _UnitsPolicy(
        shared_callgraph(index),
        _parse_conversions(index.config.unit_conversions),
    )


def _clock_factory(index: PackageIndex) -> _ClockPolicy:
    clamps = frozenset(index.config.clock_clamps)
    return _ClockPolicy(
        shared_callgraph(index),
        _DEFAULT_FOREIGN_KEYS | frozenset(index.config.clock_foreign_keys),
        clamps,
        _collect_clamp_sanctioned(index, clamps),
    )


def _id_factory(index: PackageIndex) -> _IdPolicy:
    from parameter_server_tpu_torch.analysis.rcu import (
        discover_inplace_publishers,
    )

    return _IdPolicy(shared_callgraph(index), frozenset(
        (p.cls, p.setter) for p in discover_inplace_publishers(index)
    ))


register_flow_policy("units", _units_factory)
register_flow_policy("clockdomain", _clock_factory)
register_flow_policy("idtype", _id_factory)


def _findings_of(index: PackageIndex, name: str) -> list[Finding]:
    policy = flow_policy(index, name)
    assert isinstance(policy, _QuantityPolicy)
    return [
        Finding(name, rel, line, msg)
        for rel, line, msg in policy.findings
    ]


def check_units(index: PackageIndex) -> list[Finding]:
    return _findings_of(index, "units")


def check_clockdomain(index: PackageIndex) -> list[Finding]:
    return _findings_of(index, "clockdomain")


def check_idtype(index: PackageIndex) -> list[Finding]:
    return _findings_of(index, "idtype")
