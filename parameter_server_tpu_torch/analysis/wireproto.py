"""Checker ``wireproto``: the binary-header codec, cmd-id table, feature
adverts and reply decoration stay mutually consistent — derived from the
AST, checked as dataflow facts, never hand-listed.

The wire module (parallel/control.py) carries four coupled inventories
that grew one change at a time:

1. **slot tables** — ``_encode_bin_header`` packs header fields under
   ``_BF_*``/``_BF2_*`` flag bits; ``_decode_bin_header`` unpacks them.
   A field encoded under one flag and decoded under another (or encoded
   and never decoded) is silent wire corruption that only a mixed-version
   cluster ever exercises. The checker derives the *field -> flags*
   table from each side's branch structure and diffs them.
2. **version gating** — v1's flag inventory is FROZEN wire contract
   (this checker embeds it, exactly the append-only rule the codec
   comments promise). Any flag beyond v1 must be OR-ed into the version
   mask (``*_V2_MASK``) the encoder stamps the version byte from;
   otherwise a frame using the new slot ships stamped ``version=1`` and
   a v1 peer misparses it. A v1 flag *in* the mask is the inverse bug:
   every ordinary frame gets stamped v2 and old peers reject it.
3. **cmd ids** — ``_CMD_IDS`` built from an enumerated name tuple must
   not repeat a name: dict construction dedups silently, which SHIFTS
   every later id and breaks the append-only id contract with deployed
   peers. (A literal dict form is checked for duplicate ids directly.)
4. **feature adverts** — ``features=`` literals at ``RpcServer(...)``
   sites are what servers can ack, ``features=`` at ``RpcClient(...)``
   sites (resolved one hop through ``self.<attr>`` assignments) are what
   clients advertise. A feature only one side knows is dead negotiation:
   the client silently never leaves its fallback path, or the server
   acks something nobody sends.
5. **reply decoration** — every reply queued to the wire must flow
   through the connection's ``decorated()`` helper (seq echo, ``_bh``
   codec ack, ``_feat`` ack), on the deferred and cached paths included.
   This is checked as a dataflow fact (analysis/dataflow.py): the first
   argument of every ``queue_reply(...)`` call must carry the provenance
   tag of a ``decorated(...)`` result — not a literal-name whitelist,
   so a reply that takes a detour through a local variable still counts
   and a raw dict sneaking in still fails.
"""

from __future__ import annotations

import ast

from parameter_server_tpu_torch.analysis.core import Finding, PackageIndex
from parameter_server_tpu_torch.analysis.dataflow import FlowPolicy, Tags
from parameter_server_tpu_torch.analysis.flowrun import (
    flow_policy,
    register_flow_policy,
)

_ENCODE_FN = "_encode_bin_header"
_DECODE_FN = "_decode_bin_header"

#: v1 flag inventory — FROZEN wire contract (the append-only rule). A
#: checker hardcoding a wire-frozen table is not a drifting hand-list:
#: changing v1 is exactly the event that must fail the build.
V1_FLAGS = frozenset({
    "_BF_CID", "_BF_SEQ", "_BF_RSEQ", "_BF_EXTRA", "_BF_OK_TRUE",
    "_BF_OK_FALSE", "_BF_ZIP", "_BF_CMD_STR",
    "_BF2_WORKER", "_BF2_SIG", "_BF2_CODEC", "_BF2_NEED_KEYS",
    "_BF2_TRANSIENT",
})


#: the flag-constant families across header generations: v1/v2 bits
#: live in the two original flag bytes; ``_BF3_*`` bits ride the
#: appended flags3 byte (version 3, the freshness slots) and are gated
#: by the ``_BVERSION3`` stamp instead of the v2 mask
_FLAG_PREFIXES = ("_BF_", "_BF2_", "_BF3_")


def _flag_names(node: ast.AST) -> set[str]:
    return {
        sub.id
        for sub in ast.walk(node)
        if isinstance(sub, ast.Name)
        and sub.id.startswith(_FLAG_PREFIXES)
        and not sub.id.endswith("_MASK")
    }


def _field_in_test(test: ast.AST) -> str | None:
    """``k == "<field>"`` (possibly inside an ``and`` chain) -> field."""
    for sub in ast.walk(test):
        if not isinstance(sub, ast.Compare) or len(sub.ops) != 1:
            continue
        if not isinstance(sub.ops[0], ast.Eq):
            continue
        left, right = sub.left, sub.comparators[0]
        if (
            isinstance(left, ast.Name)
            and left.id == "k"
            and isinstance(right, ast.Constant)
            and isinstance(right.value, str)
        ):
            return right.value
    return None


def _walk_own_body(if_node: ast.If):
    """Every node in an If's body (its elif chain lives in ``orelse``
    and is visited as its own If by the caller's ast.walk)."""
    for stmt in if_node.body:
        yield from ast.walk(stmt)


def encode_table(fndef: ast.FunctionDef) -> dict[str, frozenset[str]]:
    """field -> flag names OR-ed while encoding it."""
    out: dict[str, set[str]] = {}
    for node in ast.walk(fndef):
        if not isinstance(node, ast.If):
            continue
        field = _field_in_test(node.test)
        if field is None:
            continue
        flags: set[str] = set()
        for sub in _walk_own_body(node):
            if isinstance(sub, ast.AugAssign) and isinstance(
                sub.op, ast.BitOr
            ):
                flags |= _flag_names(sub.value)
        out.setdefault(field, set()).update(flags)
    return {f: frozenset(s) for f, s in out.items()}


def decode_table(fndef: ast.FunctionDef) -> dict[str, frozenset[str]]:
    """field -> flag names guarding its ``h["<field>"] = ...`` decode."""
    out: dict[str, set[str]] = {}
    for node in ast.walk(fndef):
        if not isinstance(node, ast.If):
            continue
        flags = _flag_names(node.test)
        if not flags:
            continue
        for sub in _walk_own_body(node):
            if not isinstance(sub, ast.Assign):
                continue
            for t in sub.targets:
                if (
                    isinstance(t, ast.Subscript)
                    and isinstance(t.slice, ast.Constant)
                    and isinstance(t.slice.value, str)
                ):
                    out.setdefault(t.slice.value, set()).update(flags)
    return {f: frozenset(s) for f, s in out.items()}


def _module_flags(tree: ast.Module) -> dict[str, int]:
    """Every module-level ``_BF*`` integer flag constant -> lineno
    (aggregate masks and derived expressions excluded)."""
    out: dict[str, int] = {}
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if not (
                isinstance(t, ast.Name)
                and t.id.startswith(_FLAG_PREFIXES)
                and not t.id.endswith("_MASK")
            ):
                continue
            if isinstance(node.value, ast.Constant):
                out[t.id] = node.lineno
    return out


def _mask_members(tree: ast.Module) -> tuple[set[str], int] | None:
    """Members of the ``*_V2_MASK`` OR-chain (None when absent)."""
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if isinstance(t, ast.Name) and t.id.endswith("_V2_MASK"):
                return _flag_names(node.value), node.lineno
    return None


def _check_codec_tables(
    f, enc: ast.FunctionDef, dec: ast.FunctionDef, out: list[Finding]
) -> None:
    et = encode_table(enc)
    dt = decode_table(dec)
    for field in sorted(set(et) | set(dt)):
        ef, df = et.get(field), dt.get(field)
        if ef is None:
            out.append(Finding(
                "wireproto", f.relpath, dec.lineno,
                f"binary header field {field!r} is decoded but never "
                "encoded — a slot no sender can fill is dead layout (or "
                "the encoder branch was dropped in a refactor)",
            ))
        elif df is None:
            out.append(Finding(
                "wireproto", f.relpath, enc.lineno,
                f"binary header field {field!r} is encoded but never "
                "decoded — every peer silently drops it off the wire",
            ))
        elif ef != df:
            out.append(Finding(
                "wireproto", f.relpath, enc.lineno,
                f"binary header field {field!r} is encoded under "
                f"{sorted(ef)} but decoded under {sorted(df)} — the two "
                "sides parse different layouts (silent corruption in "
                "any frame carrying the field)",
            ))
    # version gating: flags beyond the frozen v1 inventory must ride the
    # v2 mask the encoder stamps the version byte from — except the
    # ``_BF3_*`` family, which lives in the appended flags3 byte and is
    # gated by the _BVERSION3 stamp instead (checked below)
    flags = _module_flags(f.tree)
    mask = _mask_members(f.tree)
    bf3 = {n for n in flags if n.startswith("_BF3_")}
    if bf3:
        for side, fn in (("encoder", enc), ("decoder", dec)):
            if not any(
                isinstance(sub, ast.Name) and sub.id == "_BVERSION3"
                for sub in ast.walk(fn)
            ):
                n = sorted(bf3)[0]
                out.append(Finding(
                    "wireproto", f.relpath, flags[n],
                    f"flag {n} rides the flags3 byte but the {side} "
                    "never consults _BVERSION3 — v3-slot frames would "
                    "ship unstamped (or the flags3 byte would be "
                    "misparsed as a v1/v2 slot)",
                ))
    extra = {n for n in flags if n not in V1_FLAGS} - bf3
    if extra and mask is None:
        n = sorted(extra)[0]
        out.append(Finding(
            "wireproto", f.relpath, flags[n],
            f"flag {n} extends the frozen v1 layout but the module has "
            "no *_V2_MASK to version-gate it — frames using the new "
            "slot would ship stamped version=1 and v1 peers misparse "
            "them",
        ))
    elif mask is not None:
        members, mline = mask
        for n in sorted(extra - members):
            out.append(Finding(
                "wireproto", f.relpath, flags[n],
                f"flag {n} extends the frozen v1 layout but is missing "
                "from the version mask — a frame using this slot is "
                "stamped version=1 and a v1 peer misparses it (flag "
                "evolution is append-only AND gated)",
            ))
        for n in sorted(members & V1_FLAGS):
            out.append(Finding(
                "wireproto", f.relpath, mline,
                f"v1 flag {n} is in the version mask — every ordinary "
                "frame using it gets stamped v2 and old peers reject "
                "frames they used to decode",
            ))
        if not any(
            isinstance(sub, ast.Name) and sub.id.endswith("_V2_MASK")
            for sub in ast.walk(enc)
        ):
            out.append(Finding(
                "wireproto", f.relpath, enc.lineno,
                "the encoder never consults the version mask when "
                "stamping the version byte — v2-slot frames ship as v1",
            ))


def _check_cmd_ids(index: PackageIndex, out: list[Finding]) -> None:
    for f in index.files:
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Assign):
                continue
            if not any(
                isinstance(t, ast.Name) and t.id == "_CMD_IDS"
                for t in node.targets
            ):
                continue
            v = node.value
            if isinstance(v, ast.DictComp):
                # {c: i + 1 for i, c in enumerate((...))}: a duplicated
                # name dedups in the dict and SHIFTS every later id
                names = [
                    s.value
                    for s in ast.walk(v.generators[0].iter)
                    if isinstance(s, ast.Constant)
                    and isinstance(s.value, str)
                ]
                seen: set[str] = set()
                for n in names:
                    if n in seen:
                        out.append(Finding(
                            "wireproto", f.relpath, node.lineno,
                            f"_CMD_IDS name tuple repeats {n!r} — dict "
                            "construction dedups it and shifts every "
                            "later compact id, breaking the append-only "
                            "id contract with deployed peers",
                        ))
                    seen.add(n)
            elif isinstance(v, ast.Dict):
                ids: dict[int, str] = {}
                for k, val in zip(v.keys, v.values):
                    if not (
                        isinstance(k, ast.Constant)
                        and isinstance(val, ast.Constant)
                        and isinstance(val.value, int)
                    ):
                        continue
                    if val.value in ids:
                        out.append(Finding(
                            "wireproto", f.relpath, node.lineno,
                            f"_CMD_IDS maps both {ids[val.value]!r} and "
                            f"{k.value!r} to id {val.value} — two "
                            "commands on one wire id decode "
                            "interchangeably",
                        ))
                    else:
                        ids[val.value] = k.value
                    if val.value == 0:
                        out.append(Finding(
                            "wireproto", f.relpath, node.lineno,
                            f"_CMD_IDS gives {k.value!r} id 0 — 0 is "
                            "the reserved absent/unknown sentinel",
                        ))


def _features_in(expr: ast.AST) -> set[str]:
    return {
        s.value
        for s in ast.walk(expr)
        if isinstance(s, ast.Constant) and isinstance(s.value, str)
    }


def _ctor_features(
    index: PackageIndex, ctor_suffix: str
) -> dict[str, tuple[str, int]]:
    """feature -> first (relpath, line) advertising/acking it at a
    ``*RpcServer(...)`` / ``*RpcClient(...)`` construction site. A
    ``features=self.<attr>`` kwarg resolves one hop through the
    enclosing class's assignments to that attribute."""
    out: dict[str, tuple[str, int]] = {}
    for f in index.files:
        for cls in ast.walk(f.tree):
            if not isinstance(cls, (ast.ClassDef, ast.Module)):
                continue
            for node in ast.walk(cls):
                if not isinstance(node, ast.Call):
                    continue
                fn = node.func
                name = fn.id if isinstance(fn, ast.Name) else (
                    fn.attr if isinstance(fn, ast.Attribute) else ""
                )
                if not name.endswith(ctor_suffix):
                    continue
                for kw in node.keywords:
                    if kw.arg != "features":
                        continue
                    feats = _features_in(kw.value)
                    if not feats and isinstance(cls, ast.ClassDef):
                        # one-hop resolution: features=self._features
                        attr = None
                        if (
                            isinstance(kw.value, ast.Attribute)
                            and isinstance(kw.value.value, ast.Name)
                            and kw.value.value.id == "self"
                        ):
                            attr = kw.value.attr
                        if attr is not None:
                            for sub in ast.walk(cls):
                                if isinstance(sub, ast.Assign) and any(
                                    isinstance(t, ast.Attribute)
                                    and t.attr == attr
                                    for t in sub.targets
                                ):
                                    feats |= _features_in(sub.value)
                    for feat in feats:
                        out.setdefault(feat, (f.relpath, node.lineno))
    return out


def _check_features(index: PackageIndex, out: list[Finding]) -> None:
    # the generic RpcServer/RpcClient definitions themselves take a
    # ``features`` parameter — only CONSTRUCTION sites advertise
    srv = _ctor_features(index, "RpcServer")
    cli = _ctor_features(index, "RpcClient")
    if not srv and not cli:
        return
    for feat in sorted(set(cli) - set(srv)):
        rel, line = cli[feat]
        out.append(Finding(
            "wireproto", rel, line,
            f"clients advertise wire feature {feat!r} but no RpcServer "
            "construction site acks it — the negotiation can never "
            "succeed, so the feature's fast path is dead code",
        ))
    for feat in sorted(set(srv) - set(cli)):
        rel, line = srv[feat]
        out.append(Finding(
            "wireproto", rel, line,
            f"servers ack wire feature {feat!r} but no RpcClient "
            "construction site advertises it — nobody can negotiate it",
        ))


TAG_DECORATED = "decorated"


class _DecorationPolicy(FlowPolicy):
    """Dataflow: a value returned by ``decorated(...)`` carries
    TAG_DECORATED; every ``queue_reply(first_arg, ...)`` must receive a
    carrier (directly or through any number of assignments)."""

    def __init__(self, modules: set[str]):
        self._modules = modules  # relpaths defining both helpers
        self._relpath = ""
        self.findings: list[tuple[str, int]] = []
        self._seen: set[tuple[str, int]] = set()

    def owns(self, tag: str) -> bool:
        return tag == TAG_DECORATED

    def begin_function(
        self, relpath: str, cls_name: str | None, fn_name: str
    ) -> None:
        self._relpath = relpath

    def call_result(
        self, call: ast.Call, recv_tags: Tags, arg_tags: list[Tags]
    ) -> Tags:
        fn = call.func
        if isinstance(fn, ast.Name) and fn.id == "decorated":
            return frozenset({TAG_DECORATED})
        return super().call_result(call, recv_tags, arg_tags)

    def on_call(self, call, arg_tags, held, eval_expr) -> None:
        if self._relpath not in self._modules:
            return
        fn = call.func
        if not (isinstance(fn, ast.Name) and fn.id == "queue_reply"):
            return
        if not call.args:
            return
        if TAG_DECORATED not in arg_tags[0]:
            key = (self._relpath, call.lineno)
            if key not in self._seen:
                self._seen.add(key)
                self.findings.append(key)


def _decoration_factory(index: PackageIndex) -> _DecorationPolicy | None:
    modules: set[str] = set()
    for f in index.files:
        names = {
            n.name
            for n in ast.walk(f.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        if "decorated" in names and "queue_reply" in names:
            modules.add(f.relpath)
    if not modules:
        return None
    return _DecorationPolicy(modules)


register_flow_policy("wireproto-decoration", _decoration_factory)


def _check_decoration(index: PackageIndex, out: list[Finding]) -> None:
    policy = flow_policy(index, "wireproto-decoration")
    if policy is None:  # no module defines both helpers
        return
    assert isinstance(policy, _DecorationPolicy)
    for rel, line in sorted(policy.findings):
        out.append(Finding(
            "wireproto", rel, line,
            "reply queued without flowing through decorated(): the seq "
            "echo / _bh codec ack / _feat feature ack are lost on this "
            "path — a pipelined client can't match the reply and "
            "negotiation silently stalls (deferred and cached replies "
            "must decorate too)",
        ))


def check_wireproto(index: PackageIndex) -> list[Finding]:
    out: list[Finding] = []
    for f in index.files:
        enc = dec = None
        for node in ast.walk(f.tree):
            if isinstance(node, ast.FunctionDef):
                if node.name == _ENCODE_FN:
                    enc = node
                elif node.name == _DECODE_FN:
                    dec = node
        if enc is not None and dec is not None:
            _check_codec_tables(f, enc, dec, out)
    _check_cmd_ids(index, out)
    _check_features(index, out)
    _check_decoration(index, out)
    return out
