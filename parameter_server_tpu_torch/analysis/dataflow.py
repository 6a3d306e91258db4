"""Flow-sensitive alias/provenance dataflow for the v2 checkers.

The first checkers were *syntactic*: they matched idioms (a ``with`` over
a lock-typed attribute, a literal counter name) and folded one boolean
fact through the call graph. The RCU and wire-protocol invariants need
*provenance*: "does this name alias the published RCU snapshot?",
"did this reply dict flow through ``decorated()``?" — facts that travel
through assignments, tuple unpacking, subscripts and helper calls.

This module is that engine. It is deliberately a TAG dataflow, not a
points-to analysis: every expression evaluates to a ``frozenset[str]``
of provenance tags, assignments propagate tags into a per-function
environment, statements are walked in order (flow-sensitive), branches
merge by union (may-alias), and a fixpoint over the package computes
two interprocedural summaries per function through the SAME call edges
``callgraph.py`` already resolves (self-methods, known-instance
attributes, constructors, module aliases):

- ``ret``: the tags a call to this function may return, with
  ``param:<i>`` pseudo-tags substituted by the caller's argument tags
  (so an identity helper is transparent to provenance);
- ``mutated_params``: argument positions the function may mutate
  (subscript-store, del, augmented assign, or a mutating method like
  ``.update``/``.pop``), so passing a tagged value to a mutating callee
  is observable at the call site.

Checkers drive it through a :class:`FlowPolicy`: ``seed`` introduces
tags at source expressions, ``element``/``call_result`` shape
propagation, and ``on_mutation``/``on_load``/``on_call`` observe the
facts. The walker also tracks the held-lock stack (the same ``with``
discipline ``HeldLockWalker`` walks) so a policy can condition a rule
on "under a lock" — the RCU raw-attribute rule needs exactly that.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Callable

from parameter_server_tpu_torch.analysis.callgraph import CallGraph, OwnerKey
from parameter_server_tpu_torch.analysis.core import PackageIndex, iter_functions

Tags = frozenset[str]
EMPTY: Tags = frozenset()

#: methods that mutate their receiver in place (dict/list/set/ndarray)
MUTATING_METHODS = frozenset({
    "update", "pop", "popitem", "clear", "setdefault", "__setitem__",
    "append", "extend", "insert", "remove", "sort", "fill", "resize",
})

#: methods that return a view/iterator still aliasing the receiver's
#: contents (mutating what they yield mutates the receiver)
ACCESSOR_METHODS = frozenset({"items", "values", "get", "keys", "move_to_end"})

#: calls that return a FRESH container/buffer — provenance does not
#: survive them (np.array always copies; dict()/list() shallow-copy the
#: container itself, which is the alias the mutation checkers track)
FRESH_CALLS = frozenset({"dict", "list", "set", "tuple", "sorted", "copy",
                         "deepcopy", "array"})


def param_tag(i: int) -> str:
    return f"param:{i}"


def is_param_tag(t: str) -> bool:
    return t.startswith("param:")


@dataclass
class Summary:
    """Interprocedural facts for one function."""

    ret: Tags = EMPTY
    mutated_params: frozenset[int] = frozenset()

    def key(self) -> tuple:
        return (self.ret, self.mutated_params)


class FlowPolicy:
    """Checker-supplied semantics for the generic walker. Every hook has
    a conservative default; override what the invariant needs."""

    #: receiver methods treated as in-place mutation of a tagged value
    mutating_methods: frozenset[str] = MUTATING_METHODS

    def owns(self, tag: str) -> bool:
        """Whether ``tag`` belongs to this policy's namespace. Policies
        composed into one shared run (:class:`CompositePolicy`) must
        keep disjoint namespaces (``rcu*``, ``decorated``, ``u:*``,
        ``ck:*``, ``id:*``) and claim ONLY theirs, so a units tag never
        leaks into the RCU policy's element/call_result shaping."""
        return True

    def begin_function(
        self, relpath: str, cls_name: str | None, fn_name: str
    ) -> None:
        """Called before each function's walk (both passes) so a policy
        can anchor its findings without inferring position from seeds."""

    def seed(
        self, expr: ast.expr, cls_name: str | None, relpath: str
    ) -> Tags:
        """Source tags for a load of ``expr`` (attribute reads etc.)."""
        return EMPTY

    def element(self, tags: Tags, index: object) -> Tags:
        """Tags of one element read out of a tagged value (subscript
        read, tuple destructure position, attribute read, iteration).
        ``index`` is an int for destructure positions, the attribute
        name for attribute reads, or None. Default: provenance sticks
        to what a container yields (a row of a published table is still
        published state)."""
        return frozenset(t for t in tags if not is_param_tag(t))

    def call_result(
        self, call: ast.Call, recv_tags: Tags, arg_tags: list[Tags]
    ) -> Tags:
        """Tags of a call result the summaries could not resolve.
        ``recv_tags`` are the tags of ``X`` in ``X.m(...)`` (EMPTY for
        plain calls). Default: accessor methods keep the receiver's
        provenance, everything else is fresh."""
        fn = call.func
        if isinstance(fn, ast.Attribute) and fn.attr in ACCESSOR_METHODS:
            return self.element(recv_tags, fn.attr)
        return EMPTY

    def on_mutation(
        self, node: ast.AST, kind: str, tags: Tags,
        held: list[tuple[str, str, int]], desc: str,
    ) -> None:
        """A mutation (``kind`` in setitem/setattr/del/augassign/call/
        callee) observed on a value carrying ``tags``."""

    def on_load(
        self, expr: ast.expr, cls_name: str | None,
        held: list[tuple[str, str, int]], fn_name: str,
    ) -> None:
        """Every attribute/name load, with the held-lock stack (the RCU
        raw-attribute rule hooks here)."""

    def on_call(
        self, call: ast.Call, arg_tags: list[Tags],
        held: list[tuple[str, str, int]],
        eval_expr: Callable[[ast.expr], Tags],
    ) -> None:
        """Every call site, after argument evaluation."""

    # -- quantity-flow hooks ------------------------------------------------
    # binop/unary return RESULT tags and are called in BOTH passes (the
    # fixpoint needs them to propagate); any finding they record must be
    # gated on ``report`` — pass-1 tags are still growing, so a
    # "disjoint units" verdict before the fixpoint can be transiently
    # wrong. The on_* observers below are only called in the report
    # pass, so they may record findings unconditionally.

    def binop(
        self, node: ast.AST, op: ast.operator, ltags: Tags, rtags: Tags,
        report: bool,
    ) -> Tags:
        """Tags of ``l <op> r`` (also driven for ``AugAssign``, with the
        statement as ``node``). Default: arithmetic yields fresh values
        (the pre-v3 behavior)."""
        return EMPTY

    def unary(
        self, node: ast.UnaryOp, op: ast.unaryop, tags: Tags, report: bool
    ) -> Tags:
        """Tags of ``<op> x``. Default: fresh."""
        return EMPTY

    def on_compare(self, node: ast.Compare, operand_tags: list[Tags]) -> None:
        """A comparison chain, with the tags of ``[left, *comparators]``
        (``node.ops`` carries the operators)."""

    def on_bind(self, name: str, tags: Tags, stmt: ast.stmt) -> None:
        """A value carrying ``tags`` bound to local/global NAME ``name``
        (plain assignment targets; ``stmt.value`` is the source when the
        statement has one)."""

    def on_store(
        self, kind: str, name: str, tags: Tags, stmt: ast.stmt
    ) -> None:
        """A value carrying ``tags`` stored into an attribute
        (``kind="attr"``) or a constant-string subscript slot
        (``kind="key"``) named ``name`` — the sink side of the units
        suffix rules (wire header slots, config keys)."""

    def on_keyword(self, call: ast.Call, kw_name: str, tags: Tags) -> None:
        """A keyword argument ``kw_name=<value carrying tags>`` at a
        call site (named-parameter sink check)."""

    def finish_call(self, call: ast.Call, tags: Tags) -> Tags:
        """Last word on a call's result tags, applied on EVERY path
        (summary-resolved, fresh, and ``call_result``). This is where a
        declared conversion function overrides even a resolved callee's
        summary — ``to_ms(x)`` returns ms because the whitelist says so,
        whatever its body's tags computed. Default: identity."""
        return tags


@dataclass
class _FnCtx:
    relpath: str
    cls_name: str | None
    fndef: ast.FunctionDef | ast.AsyncFunctionDef
    owner: OwnerKey


class FlowWalker:
    """One function's flow-sensitive walk. Not reusable across calls."""

    def __init__(
        self,
        policy: FlowPolicy,
        graph: CallGraph,
        ctx: _FnCtx,
        summaries: dict[OwnerKey, Summary],
        is_lock_expr: Callable[[ast.expr], str | None],
        report: bool,
    ):
        self._p = policy
        self._g = graph
        self._ctx = ctx
        self._summaries = summaries
        self._is_lock = is_lock_expr
        self._report = report  # False during the summary fixpoint
        self.env: dict[str, Tags] = {}
        self.held: list[tuple[str, str, int]] = []
        self.ret_tags: Tags = EMPTY
        self.mutated_params: set[int] = set()
        self._param_names: dict[str, int] = {}

    # -- entry -------------------------------------------------------------

    def run(self) -> Summary:
        fndef = self._ctx.fndef
        args = fndef.args
        names = [a.arg for a in args.posonlyargs + args.args]
        # param indices are numbered EXCLUDING self, so they line up
        # with call.args at every call site this graph resolves — both
        # `mod.fn(a)` and bound `self.m(a)` pass the first real param
        # as args[0] (the receiver never rides the arg list)
        idx = 0
        for n in names:
            if n == "self":
                continue
            self._param_names[n] = idx
            self.env[n] = frozenset({param_tag(idx)})
            idx += 1
        self._walk_body(fndef.body)
        return Summary(self.ret_tags, frozenset(self.mutated_params))

    # -- statements --------------------------------------------------------

    def _walk_body(self, body: list[ast.stmt]) -> None:
        for stmt in body:
            self._walk_stmt(stmt)

    def _walk_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # nested defs run later, under their own walk
        if isinstance(stmt, ast.Assign):
            tags = self._eval(stmt.value)
            for t in stmt.targets:
                self._assign(t, tags, stmt)
            return
        if isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._assign(stmt.target, self._eval(stmt.value), stmt)
            return
        if isinstance(stmt, ast.AugAssign):
            vtags = self._eval(stmt.value)
            t = stmt.target
            if isinstance(t, ast.Name):
                # the target is a load+store: seed it so `total_ms +=
                # dur_us` sees the suffix tag even on first write
                cur = self.env.get(t.id, EMPTY) | self._p.seed(
                    t, self._ctx.cls_name, self._ctx.relpath
                )
                self._mutation(stmt, "augassign", cur, ast.unparse(t))
                self._p.binop(stmt, stmt.op, cur, vtags, self._report)
                self.env[t.id] = cur | vtags
            elif isinstance(t, (ast.Subscript, ast.Attribute)):
                base = self._eval(t.value)
                tgt = self._p.seed(t, self._ctx.cls_name, self._ctx.relpath)
                self._p.binop(stmt, stmt.op, tgt, vtags, self._report)
                self._mutation(stmt, "augassign", base, ast.unparse(t))
            return
        if isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                if isinstance(t, (ast.Subscript, ast.Attribute)):
                    base = self._eval(t.value)
                    self._mutation(stmt, "del", base, ast.unparse(t))
                elif isinstance(t, ast.Name):
                    self.env.pop(t.id, None)
            return
        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self.ret_tags = self.ret_tags | self._eval(stmt.value)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            pushed = 0
            for item in stmt.items:
                tags = self._eval(item.context_expr)
                key = self._is_lock(item.context_expr)
                if key is not None:
                    self.held.append(
                        (key, ast.unparse(item.context_expr), stmt.lineno)
                    )
                    pushed += 1
                if item.optional_vars is not None:
                    self._assign(item.optional_vars, tags, stmt)
            self._walk_body(stmt.body)
            for _ in range(pushed):
                self.held.pop()
            return
        if isinstance(stmt, ast.If):
            self._eval(stmt.test)
            self._branch([stmt.body, stmt.orelse])
            return
        if isinstance(stmt, (ast.While,)):
            self._eval(stmt.test)
            self._loop_body(stmt.body)
            self._branch([stmt.orelse])
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            it = self._eval(stmt.iter)
            self._assign(stmt.target, self._p.element(it, "iter"), stmt)
            self._loop_body(stmt.body)
            self._branch([stmt.orelse])
            return
        if isinstance(stmt, ast.Try):
            self._walk_body(stmt.body)
            merged = dict(self.env)
            for h in stmt.handlers:
                self._walk_body(h.body)
                for k, v in self.env.items():
                    merged[k] = merged.get(k, EMPTY) | v
                self.env = dict(merged)
            self._walk_body(stmt.orelse)
            self._walk_body(stmt.finalbody)
            return
        if isinstance(stmt, (ast.Expr, ast.Assert, ast.Raise)):
            for sub in ast.iter_child_nodes(stmt):
                if isinstance(sub, ast.expr):
                    self._eval(sub)
            return
        # anything else (pass, global, import...): evaluate embedded
        # expressions so call/mutation hooks still observe them
        for sub in ast.iter_child_nodes(stmt):
            if isinstance(sub, ast.expr):
                self._eval(sub)

    def _branch(self, bodies: list[list[ast.stmt]]) -> None:
        """Walk alternative bodies from the same entry env, union-merge
        the exits (may-alias join)."""
        entry = dict(self.env)
        merged = dict(self.env)
        for body in bodies:
            self.env = dict(entry)
            self._walk_body(body)
            for k, v in self.env.items():
                merged[k] = merged.get(k, EMPTY) | v
        self.env = merged

    def _loop_body(self, body: list[ast.stmt]) -> None:
        """Two passes so loop-carried tags reach their first use (tags
        only grow, so two monotone passes reach the fixpoint any
        assignment chain inside one body can build)."""
        self._branch([body])
        self._branch([body])

    # -- assignment / destructuring ----------------------------------------

    def _assign(self, target: ast.expr, tags: Tags, stmt: ast.stmt) -> None:
        if isinstance(target, ast.Name):
            self.env[target.id] = tags
            if self._report:
                self._p.on_bind(target.id, tags, stmt)
            return
        if isinstance(target, (ast.Tuple, ast.List)):
            for i, elt in enumerate(target.elts):
                if isinstance(elt, ast.Starred):
                    self._assign(elt.value, self._p.element(tags, None), stmt)
                else:
                    self._assign(elt, self._p.element(tags, i), stmt)
            return
        if isinstance(target, ast.Subscript):
            base = self._eval(target.value)
            self._eval(target.slice)
            self._mutation(stmt, "setitem", base, ast.unparse(target))
            if self._report and isinstance(target.slice, ast.Constant) \
                    and isinstance(target.slice.value, str):
                self._p.on_store("key", target.slice.value, tags, stmt)
            return
        if isinstance(target, ast.Attribute):
            base = self._eval(target.value)
            self._mutation(stmt, "setattr", base, ast.unparse(target))
            if self._report:
                self._p.on_store("attr", target.attr, tags, stmt)
            return
        if isinstance(target, ast.Starred):
            self._assign(target.value, tags, stmt)

    def _mutation(
        self, node: ast.AST, kind: str, tags: Tags, desc: str
    ) -> None:
        for t in tags:
            if is_param_tag(t):
                self.mutated_params.add(int(t.split(":", 1)[1]))
        if self._report and tags:
            self._p.on_mutation(node, kind, tags, self.held, desc)

    # -- expressions -------------------------------------------------------

    def _eval(self, expr: ast.expr) -> Tags:
        p = self._p
        if isinstance(expr, ast.Name):
            tags = self.env.get(expr.id, EMPTY)
            seeded = p.seed(expr, self._ctx.cls_name, self._ctx.relpath)
            if self._report:
                p.on_load(
                    expr, self._ctx.cls_name, self.held,
                    self._ctx.fndef.name,
                )
            return tags | seeded
        if isinstance(expr, ast.Attribute):
            base = self._eval(expr.value)
            seeded = p.seed(expr, self._ctx.cls_name, self._ctx.relpath)
            if self._report:
                p.on_load(
                    expr, self._ctx.cls_name, self.held,
                    self._ctx.fndef.name,
                )
            return p.element(base, expr.attr) | seeded
        if isinstance(expr, ast.Subscript):
            base = self._eval(expr.value)
            idx: object = None
            if isinstance(expr.slice, ast.Constant):
                idx = expr.slice.value
            self._eval(expr.slice)
            seeded = p.seed(expr, self._ctx.cls_name, self._ctx.relpath)
            return p.element(base, idx) | seeded
        if isinstance(expr, ast.Call):
            return self._eval_call(expr)
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            out = EMPTY
            for e in expr.elts:
                out |= self._eval(e)
            return out
        if isinstance(expr, ast.Dict):
            out = EMPTY
            for k in expr.keys:
                if k is not None:
                    self._eval(k)
            for v in expr.values:
                self._eval(v)
            return out  # fresh container; values' provenance not carried
        if isinstance(expr, ast.IfExp):
            self._eval(expr.test)
            return self._eval(expr.body) | self._eval(expr.orelse)
        if isinstance(expr, ast.BoolOp):
            out = EMPTY
            for v in expr.values:
                out |= self._eval(v)
            return out
        if isinstance(expr, ast.NamedExpr):
            tags = self._eval(expr.value)
            self._assign(expr.target, tags, expr)  # type: ignore[arg-type]
            return tags
        if isinstance(expr, ast.Starred):
            return self._eval(expr.value)
        if isinstance(expr, ast.Await):
            return self._eval(expr.value)
        if isinstance(expr, (ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp)):
            # comprehensions build fresh containers; still evaluate the
            # parts so call hooks observe them, binding iteration names
            for gen in expr.generators:
                it = self._eval(gen.iter)
                self._assign(gen.target, p.element(it, "iter"), expr)  # type: ignore[arg-type]
                for cond in gen.ifs:
                    self._eval(cond)
            if isinstance(expr, ast.DictComp):
                self._eval(expr.key)
                self._eval(expr.value)
            else:
                self._eval(expr.elt)
            return EMPTY
        if isinstance(expr, ast.BinOp):
            l = self._eval(expr.left)
            r = self._eval(expr.right)
            return p.binop(expr, expr.op, l, r, self._report)
        if isinstance(expr, ast.UnaryOp):
            t = self._eval(expr.operand)
            return p.unary(expr, expr.op, t, self._report)
        if isinstance(expr, ast.Compare):
            operand_tags = [self._eval(expr.left)]
            operand_tags.extend(self._eval(c) for c in expr.comparators)
            if self._report:
                p.on_compare(expr, operand_tags)
            return EMPTY  # booleans are unit-free
        if isinstance(expr, ast.Lambda):
            return EMPTY  # body runs later; out of intraprocedural scope
        # constants, f-strings, slices...
        for sub in ast.iter_child_nodes(expr):
            if isinstance(sub, ast.expr):
                self._eval(sub)
        return EMPTY

    def _eval_call(self, call: ast.Call) -> Tags:
        p = self._p
        fn = call.func
        recv_tags = EMPTY
        if isinstance(fn, ast.Attribute):
            recv_tags = self._eval(fn.value)
        arg_tags = [self._eval(a) for a in call.args]
        for kw in call.keywords:
            kw_tags = self._eval(kw.value)
            if self._report and kw.arg is not None:
                p.on_keyword(call, kw.arg, kw_tags)
        # receiver-mutating methods on a tagged value
        if (
            isinstance(fn, ast.Attribute)
            and fn.attr in p.mutating_methods
            and recv_tags
        ):
            self._mutation(call, "call", recv_tags,
                           f"{ast.unparse(fn)}(...)")
        if self._report:
            p.on_call(call, arg_tags, self.held, self._eval)
        # resolve through the call graph summaries
        out = EMPTY
        resolved = False
        for callee in self._g.callees(
            self._ctx.relpath, self._ctx.cls_name, call
        ):
            s = self._summaries.get(callee)
            if s is None:
                continue
            resolved = True
            # substitute param pseudo-tags with the caller's arg tags
            for t in s.ret:
                if is_param_tag(t):
                    i = int(t.split(":", 1)[1])
                    if i < len(arg_tags):
                        out |= arg_tags[i]
                else:
                    out |= frozenset({t})
            for i in s.mutated_params:
                if i < len(arg_tags) and arg_tags[i]:
                    self._mutation(
                        call, "callee", arg_tags[i],
                        f"{ast.unparse(fn)}(...) arg {i}",
                    )
        if not resolved:
            if (isinstance(fn, ast.Name) and fn.id in FRESH_CALLS) or (
                isinstance(fn, ast.Attribute) and fn.attr in FRESH_CALLS
            ):
                out = EMPTY
            else:
                out = p.call_result(call, recv_tags, arg_tags)
        return p.finish_call(call, out)


class DataflowAnalysis:
    """Package-wide driver: computes the interprocedural summaries to a
    fixpoint, then replays every function with reporting enabled so the
    policy's hooks observe the final facts."""

    def __init__(
        self,
        index: PackageIndex,
        policy: FlowPolicy,
        graph: CallGraph | None = None,
    ):
        self.index = index
        self.policy = policy
        self.graph = graph or CallGraph(index)
        self.summaries: dict[OwnerKey, Summary] = {}
        self._bodies: list[_FnCtx] = []
        for f in index.files:
            for cls_name, fndef in iter_functions(f.tree):
                owner: OwnerKey = (
                    ("m", cls_name, fndef.name)
                    if cls_name is not None
                    else ("f", f.relpath, fndef.name)
                )
                self._bodies.append(_FnCtx(f.relpath, cls_name, fndef, owner))

    def _lock_key_fn(self, ctx: _FnCtx) -> Callable[[ast.expr], str | None]:
        g = self.graph

        def key(expr: ast.expr) -> str | None:
            if (
                isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self"
                and ctx.cls_name is not None
            ):
                return g.lock_attr_key(ctx.cls_name, expr.attr)
            if isinstance(expr, ast.Name):
                return g.module_locks.get(expr.id)
            return None

        return key

    def run(self, max_rounds: int = 8) -> None:
        # pass 1: summaries to fixpoint (reporting off — a finding must
        # not fire once per fixpoint round)
        for _ in range(max_rounds):
            changed = False
            for ctx in self._bodies:
                self.policy.begin_function(
                    ctx.relpath, ctx.cls_name, ctx.fndef.name
                )
                w = FlowWalker(
                    self.policy, self.graph, ctx, self.summaries,
                    self._lock_key_fn(ctx), report=False,
                )
                s = w.run()
                old = self.summaries.get(ctx.owner)
                if old is None or old.key() != s.key():
                    # merge (owner keys can collide across same-named
                    # classes; union is the sound direction)
                    if old is not None:
                        s = Summary(
                            old.ret | s.ret,
                            old.mutated_params | s.mutated_params,
                        )
                    self.summaries[ctx.owner] = s
                    changed = True
            if not changed:
                break
        # pass 2: replay with the policy observing
        for ctx in self._bodies:
            self.policy.begin_function(
                ctx.relpath, ctx.cls_name, ctx.fndef.name
            )
            FlowWalker(
                self.policy, self.graph, ctx, self.summaries,
                self._lock_key_fn(ctx), report=True,
            ).run()


class CompositePolicy(FlowPolicy):
    """Fan one walk out to several policies with disjoint tag
    namespaces — the shared-fixpoint optimization: the
    package-wide summary fixpoint is the expensive half of every
    dataflow checker, and with N policies composed it runs ONCE instead
    of N times. Each sub-policy sees only the tags its :meth:`owns`
    claims (plus the shared ``param:<i>`` infrastructure handled by the
    walker itself), so composition cannot change any policy's verdict —
    tag sets here are the union of what each solo run would compute."""

    def __init__(self, policies: list[FlowPolicy]):
        self.policies = list(policies)
        mm: frozenset[str] = frozenset()
        for p in self.policies:
            mm |= p.mutating_methods
        self.mutating_methods = mm

    def _own(self, p: FlowPolicy, tags: Tags) -> Tags:
        return frozenset(t for t in tags if not is_param_tag(t) and p.owns(t))

    def begin_function(self, relpath, cls_name, fn_name):
        for p in self.policies:
            p.begin_function(relpath, cls_name, fn_name)

    def seed(self, expr, cls_name, relpath):
        out = EMPTY
        for p in self.policies:
            out |= p.seed(expr, cls_name, relpath)
        return out

    def element(self, tags, index):
        out = EMPTY
        for p in self.policies:
            out |= p.element(self._own(p, tags), index)
        return out

    def call_result(self, call, recv_tags, arg_tags):
        out = EMPTY
        for p in self.policies:
            out |= p.call_result(
                call, self._own(p, recv_tags),
                [self._own(p, a) for a in arg_tags],
            )
        return out

    def binop(self, node, op, ltags, rtags, report):
        out = EMPTY
        for p in self.policies:
            out |= p.binop(
                node, op, self._own(p, ltags), self._own(p, rtags), report
            )
        return out

    def unary(self, node, op, tags, report):
        out = EMPTY
        for p in self.policies:
            out |= p.unary(node, op, self._own(p, tags), report)
        return out

    def on_mutation(self, node, kind, tags, held, desc):
        for p in self.policies:
            own = self._own(p, tags)
            if own:
                p.on_mutation(node, kind, own, held, desc)

    def on_load(self, expr, cls_name, held, fn_name):
        for p in self.policies:
            p.on_load(expr, cls_name, held, fn_name)

    def on_call(self, call, arg_tags, held, eval_expr):
        for p in self.policies:
            own_eval = (
                lambda e, _p=p: self._own(_p, eval_expr(e))
            )
            p.on_call(
                call, [self._own(p, a) for a in arg_tags], held, own_eval
            )

    def on_compare(self, node, operand_tags):
        for p in self.policies:
            p.on_compare(node, [self._own(p, t) for t in operand_tags])

    def on_bind(self, name, tags, stmt):
        for p in self.policies:
            p.on_bind(name, self._own(p, tags), stmt)

    def on_store(self, kind, name, tags, stmt):
        for p in self.policies:
            p.on_store(kind, name, self._own(p, tags), stmt)

    def on_keyword(self, call, kw_name, tags):
        for p in self.policies:
            p.on_keyword(call, kw_name, self._own(p, tags))

    def finish_call(self, call, tags):
        # each policy rewrites only its own namespace slice; everything
        # else (other namespaces, param pseudo-tags) passes through
        for p in self.policies:
            own = self._own(p, tags)
            tags = (tags - own) | p.finish_call(call, own)
        return tags
