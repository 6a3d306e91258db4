"""The port's pslint (``parameter_server_tpu_torch/analysis``) against the
JAX package's, snippet by snippet.

Every crafted source of ``tests/test_pslint.py`` is copied here and run
through both analyzers: JAX's ``analyze_sources`` and the port's, told
that the snippet stands for the JAX tree (``root="parameter_server_tpu"``,
the name its absolute imports resolve against). The two must give the
same ``(checker, path, line, message)`` list, both with the checker the
JAX test runs and with the whole registry (the JAX registry's two psmc
ids, which the port does not have, give nothing on a snippet). Then the
port's own additions, positive and negative: the torch primitives the
blocking checker knows and the in-place publisher rules of the rcu
checker. Last, the port's ``main`` (baseline, changed-only, severity
tiers) against the JAX one on the same trees."""

from __future__ import annotations

import json
import subprocess
from pathlib import Path

import pytest

import parameter_server_tpu.analysis as J
import parameter_server_tpu_torch.analysis as P
from parameter_server_tpu.analysis import __main__ as j_main
from parameter_server_tpu.analysis.core import PackageIndex as JIndex
from parameter_server_tpu.analysis.core import PslintConfig as JConfig
from parameter_server_tpu.analysis.core import run_checkers as j_run
from parameter_server_tpu_torch.analysis import __main__ as p_main
from parameter_server_tpu_torch.analysis.core import PackageIndex as PIndex
from parameter_server_tpu_torch.analysis.core import PslintConfig as PConfig
from parameter_server_tpu_torch.analysis.core import run_checkers as p_run

#: the tree the JAX snippets stand for
JAX_TREE = "parameter_server_tpu"


def _key(findings) -> list[tuple[str, str, int, str]]:
    """The comparable form of a finding list. A stale pragma naming an
    unknown checker lists the registry's ids after "; known: ": that tail
    is cut here and checked on its own
    (``test_unknown_checker_lists_the_ports_registry``)."""
    return [(f.checker, f.path, f.line, f.message.split("; known: ")[0])
            for f in findings]


def _both(sources: dict[str, str], checker: str | None = None, config: dict | None = None):
    """(JAX findings, port findings) of one snippet, under one checker or
    the whole registry, with an optional ``[tool.pslint]`` config."""
    ids = [checker] if checker else list(J.CHECKERS)
    jchk = {i: J.CHECKERS[i] for i in ids}
    pchk = {i: P.CHECKERS[i] for i in ids if i in P.CHECKERS}
    jcfg, pcfg = JConfig(**(config or {})), PConfig(**(config or {}))
    jf = j_run(JIndex.from_sources(sources, config=jcfg), jchk, jcfg)
    pf = p_run(PIndex.from_sources(sources, root=Path(JAX_TREE), config=pcfg), pchk, pcfg)
    jf = [f for f in jf if f.checker in P.CHECKERS]
    return _key(jf), _key(pf)


# ---------------------------------------------------------------------------
# the snippets of tests/test_pslint.py, copied
# ---------------------------------------------------------------------------

_CYCLE = """
import threading

class D:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def m1(self):
        with self._a:
            with self._b:
                pass

    def m2(self):
        with self._b:
            with self._a:
                pass
"""

_NO_CYCLE = _CYCLE.replace(
    "        with self._b:\n            with self._a:",
    "        with self._a:\n            with self._b:",
)

_CYCLE_VIA_CALL = """
import threading

class D:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def helper(self):
        with self._a:
            pass

    def m1(self):
        with self._a:
            with self._b:
                pass

    def m2(self):
        with self._b:
            self.helper()
"""

_BLOCKING = """
import threading
import time

class C:
    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition()

    def bad_sleep(self):
        with self._lock:
            time.sleep(0.1)

    def helper(self):
        self.sock.sendall(b"x")

    def bad_transitive(self):
        with self._lock:
            self.helper()

    def bad_foreign_wait(self, ev):
        with self._lock:
            ev.wait()

    def ok_outside(self):
        time.sleep(0.1)
        with self._lock:
            pass

    def ok_condition_wait(self):
        with self._cv:
            self._cv.wait_for(lambda: True)
"""

_BLOCKING_CLEAN = """
import threading
import time

class C:
    def __init__(self):
        self._lock = threading.Lock()

    def ok(self):
        time.sleep(0.1)
        with self._lock:
            x = 1
        return x
"""

_UNSETTLED = """
class DeferredReply:
    pass

def serve(conn):
    deferred = []

    def settle_deferred():
        deferred.clear()

    try:
        while True:
            rep = conn.next()
            deferred.append(rep)
    except OSError:
        return
"""

_SETTLED_FINALLY = _UNSETTLED.replace(
    "    except OSError:\n        return",
    "    except OSError:\n        return\n"
    "    finally:\n        settle_deferred()",
)

_SETTLED_ON_EDGE = _UNSETTLED.replace(
    "    except OSError:\n        return",
    "    except OSError:\n        settle_deferred()\n        return",
)

_DROPPED_DEFERRED = """
def handler(fut):
    d = DeferredReply(fut)
    return {"ok": True}, {}
"""

_RETURNED_DEFERRED = """
def handler(fut):
    return DeferredReply(fut), {}
"""

_COUNTER_FORMS = """
wire_counters.inc("a_counter")
wire_counters.inc("b_counter", 3)
wire_counters.observe_max("c_peak", 7)
wire_counters.inc_many({"d_one": 1, "e_two": n})
"""

_CONFIG_ALIASED = """
def f(server_cfg):
    scfg = server_cfg or ServerConfig()
    return scfg.not_a_field
"""

_CONFIG_KNOWN = """
def f(cfg):
    scfg = cfg.server
    return cfg.wire.window + scfg.max_batch + cfg.solver.minibatch
"""

_BAD = (
    "import threading\nimport time\n"
    "class C:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "    def m(self):\n"
    "        with self._lock:\n"
    "            time.sleep(1){pragma}\n"
)

_STANDALONE_PRAGMA = (
    "import threading\nimport time\n"
    "class C:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "    def m(self):\n"
    "        with self._lock:\n"
    "            # psl: ignore[blocking-under-lock]: deliberate\n"
    "            time.sleep(1)\n"
)

_RC_BASE = """
class S:
    def __init__(self):
        self.server = RpcServer(
            self._handle,
            idempotent_cmds=frozenset({"pull", "stats"}),
            blocking_cmds=frozenset({"pull"}),
        )

    def _handle(self, h, arrays):
        cmd = h["cmd"]
        if cmd == "pull":
            return {}, {}
        if cmd == "push":
            return {}, {}
        if cmd == "stats":
            return {}, {}
        raise ValueError(cmd)


_CMD_IDS = {c: i + 1 for i, c in enumerate(("pull", "push", "stats"))}
"""

_RC_GETATTR = """
class C:
    def __init__(self):
        self.server = RpcServer(
            self._handle, idempotent_cmds=frozenset({"beat", "stale"}),
        )

    def _handle(self, h, arrays):
        return getattr(self, "_cmd_" + h.pop("cmd"))(h, arrays)

    def _cmd_beat(self, h, a):
        return {}, {}
"""

_RCU = """
import threading

class S:
    def __init__(self):
        self._pub = ({}, 1)
        self._lock = threading.Lock()

    @property
    def state(self):
        return self._pub[0]

    @state.setter
    def state(self, new):
        self._pub = (new, self._pub[1] + 1)

    def helper(self):
        return self.state

    def ok_locked_raw(self):
        with self._lock:
            st = self._pub[0]
        return st

    def ok_copy_mutate(self):
        c = dict(self.state)
        c["k"] = 1

    def ok_publish(self):
        self.state = {"k": 2}

    def ok_read_rows(self):
        st = self.state
        return {k: v for k, v in st.items()}
"""

_RCU_EXTRAS = {
    "subscript_store": (
        "    def bad(self):\n"
        "        snap = self.state\n"
        "        snap['k'] = 1\n"
    ),
    "mutating_method": (
        "    def bad(self):\n"
        "        self.state.update({'k': 2})\n"
    ),
    "alias_through_helper": (
        "    def bad(self):\n"
        "        s = self.helper()\n"
        "        del s['k']\n"
    ),
    "tuple_unpack": (
        "    def bad(self):\n"
        "        with self._lock:\n"
        "            st, ver = self._pub\n"
        "        st.pop('k')\n"
    ),
    "mutating_callee": (
        "    def bad(self):\n"
        "        scrub(self.state)\n"
        "\n"
        "def scrub(d):\n"
        "    d.clear()\n"
    ),
    "mutating_method_callee": (
        "    def scrub(self, d):\n"
        "        d.clear()\n"
        "    def bad(self):\n"
        "        self.scrub(self.state)\n"
    ),
    "identity_return": (
        "    def ident(self, d):\n"
        "        return d\n"
        "    def bad(self):\n"
        "        s = self.ident(self.state)\n"
        "        s['k'] = 1\n"
    ),
    "raw_read": (
        "    def bad(self):\n"
        "        return self._pub[0]\n"
    ),
    "raw_store": (
        "    def bad(self):\n"
        "        self._pub = ({}, 99)\n"
    ),
    "version_int": (
        "    def ok(self):\n"
        "        with self._lock:\n"
        "            st, ver = self._pub\n"
        "        ver += 1\n"
        "        return ver\n"
    ),
}

_WIRE = '''
_BF_CID = 1
_BF2_WORKER = 1
_BF2_VER = 64
_BF2_V2_MASK = _BF2_VER

def _encode_bin_header(h, metas):
    flags1 = flags2 = 0
    for k, v in h.items():
        if k == "_cid":
            flags1 |= _BF_CID
        elif k == "worker":
            flags2 |= _BF2_WORKER
        elif k == "ver":
            flags2 |= _BF2_VER
    ver_byte = 2 if flags2 & _BF2_V2_MASK else 1
    return bytes([ver_byte, flags1, flags2])

def _decode_bin_header(buf):
    h = {}
    flags1, flags2 = buf[1], buf[2]
    if flags1 & _BF_CID:
        h["_cid"] = "x"
    if flags2 & _BF2_WORKER:
        h["worker"] = 0
    if flags2 & _BF2_VER:
        h["ver"] = 1
    return h
'''

_FEATURES_DEAD = """
class S:
    def __init__(self):
        self.server = RpcServer(self._h, features=frozenset({"qwire"}))

class C:
    def __init__(self):
        self.client = RpcClient("a", features=frozenset({"zwire"}))
"""

_REPLY_FLOW = """
def serve(conn):
    def queue_reply(rep, arrays):
        pass

    def decorated(rep, seq):
        return dict(rep)

    rep = {"ok": True}
    queue_reply(decorated(rep, 1), None)
    d = decorated(rep, 2)
    queue_reply(d, None)
"""

_SHARED_FIXPOINT = (
    "import time\n"
    "class S:\n"
    "    def __init__(self):\n"
    "        self._pub = ({}, 1)\n"
    "    @property\n"
    "    def state(self):\n"
    "        return self._pub[0]\n"
    "    @state.setter\n"
    "    def state(self, new):\n"
    "        self._pub = (new, self._pub[1] + 1)\n"
    "def f(lat_ms, svc_us, cid, rank):\n"
    "    t0 = time.monotonic()\n"
    "    lat_ms + svc_us\n"
    "    cid == rank\n"
    "    return time.time() - t0\n"
)

_LIVE = (
    "import threading\nimport time\n"
    "class C:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "    def m(self):\n"
    "        with self._lock:\n"
    "            time.sleep(1)  # psl: ignore[blocking-under-lock]: deliberate\n"
)
_DEAD = _LIVE.replace("            time.sleep(1)  ", "            pass  ")

_FR_POSTMORTEM = '''
_CONTEXT_EVENTS = frozenset({"heartbeat.beat"})

def detect(timeline):
    return [e for e in timeline if e["etype"] == "apply.commit"]
'''

_FR_EMITTER = '''
from parameter_server_tpu.utils import flightrec

def apply(batch):
    flightrec.record("apply.commit", n=len(batch))

def beat():
    flightrec.record("heartbeat.beat")
'''


def _one(src: str) -> dict[str, str]:
    return {"snippet.py": src}


#: name -> (sources, checker the JAX test runs (None: the registry),
#: [tool.pslint] config)
SNIPPETS: dict[str, tuple[dict[str, str], str | None, dict | None]] = {
    "lock_cycle": (_one(_CYCLE), "lock-order", None),
    "lock_no_cycle": (_one(_NO_CYCLE), "lock-order", None),
    "lock_cycle_via_call": (_one(_CYCLE_VIA_CALL), "lock-order", None),
    "blocking": (_one(_BLOCKING), "blocking-under-lock", None),
    "blocking_clean": (_one(_BLOCKING_CLEAN), "blocking-under-lock", None),
    "settle_unsettled": (_one(_UNSETTLED), "settle-exactly-once", None),
    "settle_finally": (_one(_SETTLED_FINALLY), "settle-exactly-once", None),
    "settle_on_edge": (_one(_SETTLED_ON_EDGE), "settle-exactly-once", None),
    "settle_dropped": (_one(_DROPPED_DEFERRED), "settle-exactly-once", None),
    "settle_returned": (_one(_RETURNED_DEFERRED), "settle-exactly-once", None),
    "counter_forms": (_one(_COUNTER_FORMS), "counter-contract", None),
    "counter_registered": (
        _one('wire_counters.inc("wire_bytes_out")'), "counter-contract", None),
    "config_unknown_wire_key": (
        _one("def f(cfg):\n    return cfg.wire.bogus_key_xyz\n"), "config-contract", None),
    "config_aliased_unknown": (_one(_CONFIG_ALIASED), "config-contract", None),
    "config_known": (_one(_CONFIG_KNOWN), "config-contract", None),
    "trace_bare_span": (_one("sp = trace.span('x')\n"), "trace-hygiene", None),
    "trace_span_ctor": (_one("sp = Span('x', 'cat')\n"), "trace-hygiene", None),
    "trace_with_span": (_one(
        "with trace.activate(ctx), trace.span('x') as sp:\n"
        "    sp.set(a=1)\n"), "trace-hygiene", None),
    "pragma_justified": ({"s.py": _BAD.format(
        pragma="  # psl: ignore[blocking-under-lock]: serializing "
        "the sleep is this snippet's whole point")}, None, None),
    "pragma_bare": ({"s.py": _BAD.format(
        pragma="  # psl: ignore[blocking-under-lock]")}, None, None),
    "pragma_wrong_checker": ({"s.py": _BAD.format(
        pragma="  # psl: ignore[trace-hygiene]: wrong checker entirely")}, None, None),
    "pragma_standalone": ({"s.py": _STANDALONE_PRAGMA}, None, None),
    "pragma_disabled_tree_wide": (
        {"s.py": _BAD.format(pragma="")}, None, {"disable": ["blocking-under-lock"]}),
    "rc_base": (_one(_RC_BASE), "replycache-contract", None),
    "rc_stale_exemption": (_one(_RC_BASE.replace(
        '"pull", "stats"', '"pull", "stats", "gone"')), "replycache-contract", None),
    "rc_stale_blocking": (_one(_RC_BASE.replace(
        'blocking_cmds=frozenset({"pull"})', 'blocking_cmds=frozenset({"barrier"})')),
        "replycache-contract", None),
    "rc_no_binary_id": (_one(_RC_BASE.replace(
        '"pull", "push", "stats"', '"pull", "stats"')), "replycache-contract", None),
    "rc_getattr_dispatch": (_one(_RC_GETATTR), "replycache-contract", None),
    "rc_no_cmd_ids": (_one(_RC_BASE.split("_CMD_IDS")[0]), "replycache-contract", None),
    "rcu_base": (_one(_RCU), "rcu", None),
    **{f"rcu_{name}": (_one(_RCU + extra), "rcu", None)
       for name, extra in _RCU_EXTRAS.items()},
    "wire_clean": (_one(_WIRE), "wireproto", None),
    "wire_not_decoded": (_one(_WIRE.replace(
        '    if flags2 & _BF2_VER:\n        h["ver"] = 1\n', "")), "wireproto", None),
    "wire_pairing": (_one(_WIRE.replace(
        'if flags1 & _BF_CID:\n        h["_cid"] = "x"',
        'if flags2 & _BF2_WORKER:\n        h["_cid"] = "x"')), "wireproto", None),
    "wire_ungated_v2": (_one(_WIRE.replace(
        "_BF2_V2_MASK = _BF2_VER",
        "_BF2_IF_NEWER = 128\n_BF2_V2_MASK = _BF2_VER")), "wireproto", None),
    "wire_v1_in_mask": (_one(_WIRE.replace(
        "_BF2_V2_MASK = _BF2_VER",
        "_BF2_V2_MASK = _BF2_VER | _BF2_WORKER")), "wireproto", None),
    "wire_dup_cmd_name": (_one(
        '_CMD_IDS = {c: i + 1 for i, c in enumerate('
        '("push", "pull", "push"))}\n'), "wireproto", None),
    "wire_dup_literal_id": (_one('_CMD_IDS = {"push": 1, "pull": 1}\n'), "wireproto", None),
    "wire_dead_features": (_one(_FEATURES_DEAD), "wireproto", None),
    "wire_matched_features": (
        _one(_FEATURES_DEAD.replace('"zwire"', '"qwire"')), "wireproto", None),
    "wire_reply_flow": (_one(_REPLY_FLOW), "wireproto", None),
    "wire_undecorated_reply": (
        _one(_REPLY_FLOW + "    queue_reply(rep, None)\n"), "wireproto", None),
    "units_cross_add": (_one(
        "def f(lat_ms, svc_us):\n    return lat_ms + svc_us\n"), "units", None),
    "units_factor_add": (_one(
        "def f(lat_ms, svc_us):\n    return lat_ms * 1000 + svc_us\n"), "units", None),
    "units_factor_div": (_one(
        "def f(svc_us):\n    lat_ms = svc_us / 1000\n    return lat_ms\n"), "units", None),
    "units_cross_compare": (_one(
        "def f(budget_ms, wait_s):\n    return wait_s > budget_ms\n"), "units", None),
    "units_interproc_sink": (_one(
        "def _ident(x):\n    return x\n"
        "def g(wait_us):\n    budget_ms = _ident(wait_us)\n    return budget_ms\n"),
        "units", None),
    "units_interproc_converted": (_one(
        "def _ident(x):\n    return x\n"
        "def g(wait_us):\n    budget_ms = _ident(wait_us) / 1000\n    return budget_ms\n"),
        "units", None),
    "units_declared_conversion": (_one(
        "def to_ms(x):\n    return x\n"
        "def g(wait_us):\n    budget_ms = to_ms(wait_us)\n    return budget_ms\n"),
        "units", {"unit_conversions": ["to_ms -> ms"]}),
    "units_undeclared_conversion": (_one(
        "def to_ms(x):\n    return x\n"
        "def g(wait_us):\n    budget_ms = to_ms(wait_us)\n    return budget_ms\n"),
        "units", None),
    "units_real_conversion": (_one(
        "def to_ms(x):\n    return x / 1000\n"
        "def g(wait_us):\n    budget_ms = to_ms(wait_us)\n    return budget_ms\n"),
        "units", None),
    "units_unsuffixed_series": (_one(
        "def observe(name, seconds):\n    pass\n"
        "def book(age_s):\n    observe('serve.age', age_s)\n"), "units", None),
    "units_suffixed_series": (_one(
        "def observe(name, seconds):\n    pass\n"
        "def book(age_s):\n    observe('serve.age_s', age_s)\n"
        "    observe('ssp.lag_clocks.n', age_s)\n"), "units", None),
    "units_pragma_hot": ({"s.py": (
        "def f(lat_ms, svc_us):\n"
        "    return lat_ms + svc_us  # psl: ignore[units]: crafted\n")}, None, None),
    "units_pragma_cold": ({"s.py": (
        "def f(lat_ms, svc_ms):\n"
        "    return lat_ms + svc_ms  # psl: ignore[units]: crafted\n")}, None, None),
    "clock_wall_minus_mono": (_one(
        "import time\ndef f():\n    t0 = time.monotonic()\n"
        "    return time.time() - t0\n"), "clockdomain", None),
    "clock_same_domain": (_one(
        "import time\ndef f():\n    t0 = time.monotonic()\n"
        "    return time.monotonic() - t0\n"), "clockdomain", None),
    "clock_durations_compare": (_one(
        "import time\ndef f(a, b):\n    d1 = time.time() - a\n"
        "    d2 = time.monotonic() - b\n    return d1 > d2\n"), "clockdomain", None),
    "clock_interproc": (_one(
        "import time\ndef _wall():\n    return time.time()\n"
        "def _issue():\n    return _wall()\n"
        "def f():\n    t0 = time.monotonic()\n    return _issue() - t0\n"),
        "clockdomain", None),
    "clock_clamp_args": (_one(
        "import time\ndef _skew_clamp(raw_s):\n    return max(raw_s, 0.0)\n"
        "def f(pts):\n    return _skew_clamp(time.time() - pts / 1e6)\n"),
        "clockdomain", None),
    "clock_clamp_body": (_one(
        "import time\ndef age_clamped(pts):\n"
        "    return max(time.time() - pts / 1e6, 0.0)\n"), "clockdomain", None),
    "clock_foreign_pts": (_one(
        "import time\ndef f(pts):\n    return time.time() - pts / 1e6\n"),
        "clockdomain", None),
    "clock_cross_min": (_one(
        "import time\ndef f():\n    return min(time.time(), time.monotonic())\n"),
        "clockdomain", None),
    "clock_helpers": (_one(
        "from parameter_server_tpu.utils.clock import (\n"
        "    now_mono_s, now_wall_s)\n"
        "def f():\n    return now_wall_s() - now_mono_s()\n"), "clockdomain", None),
    "id_cross_space": (_one("def f(cid, rank):\n    return cid == rank\n"), "idtype", None),
    "id_same_space": (_one("def f(cid, peer_cid):\n    return cid == peer_cid\n"),
                      "idtype", None),
    "id_ver_arith": (_one("def f(ver):\n    return ver + 1\n"), "idtype", None),
    "id_numeric": (_one("def f(seq, rank):\n    return seq + 1 + rank\n"), "idtype", None),
    "id_ver_order": (_one("def f(ver, prev_ver):\n    return ver < prev_ver\n"),
                     "idtype", None),
    "id_ver_equality": (_one("def f(ver, prev_ver):\n    return ver == prev_ver\n"),
                        "idtype", None),
    "id_swapped_positional": (_one(
        "def route(rank, cid):\n    pass\ndef f(cid, rank):\n    route(cid, rank)\n"),
        "idtype", None),
    "id_correct_positional": (_one(
        "def route(rank, cid):\n    pass\ndef f(cid, rank):\n    route(rank, cid)\n"),
        "idtype", None),
    "id_swapped_keyword": (_one(
        "def route(rank, cid):\n    pass\ndef f(cid):\n    route(rank=cid, cid=0)\n"),
        "idtype", None),
    "id_bit_packing": (_one(
        "_BF_CID = 1\nNONCE_SHIFT = 40\n"
        "def enc(flags, cid_present):\n    if cid_present:\n"
        "        flags |= _BF_CID\n    return flags & _BF_CID\n"
        "def life(ver):\n    return ver >> NONCE_SHIFT\n"), "idtype", None),
    "shared_fixpoint": ({"s.py": _SHARED_FIXPOINT}, None, None),
    "stale_live": ({"s.py": _LIVE}, None, None),
    "stale_dead": ({"s.py": _DEAD}, None, None),
    "stale_unknown_checker": ({"s.py": _LIVE.replace(
        "ignore[blocking-under-lock]", "ignore[blocking-underlock]")}, None, None),
    "stale_wildcard": ({"s.py": _DEAD.replace(
        "ignore[blocking-under-lock]", "ignore[*]")}, None, None),
    "stale_explicit": ({"s.py": _DEAD.replace(
        "ignore[blocking-under-lock]",
        "ignore[blocking-under-lock, stale-pragma]")}, None, None),
    "stale_docstring": ({"s.py": (
        '"""Docs: use # psl: ignore[blocking-under-lock]: why."""\n'
        "x = 1\n")}, None, None),
    "fr_lockstep": ({
        "utils/postmortem.py": _FR_POSTMORTEM, "parallel/x.py": _FR_EMITTER,
    }, "flightrec-contract", None),
    "fr_unknown_event": ({
        "utils/postmortem.py": _FR_POSTMORTEM,
        "parallel/x.py": _FR_EMITTER + (
            '\ndef mystery():\n    flightrec.record("rpc.mystery", cid=1)\n'),
    }, "flightrec-contract", None),
    "fr_renamed_event": ({
        "utils/postmortem.py": _FR_POSTMORTEM,
        "parallel/x.py": _FR_EMITTER.replace('"apply.commit"', '"apply.commit2"'),
    }, "flightrec-contract", None),
    "fr_from_import_alias": ({
        "utils/postmortem.py": _FR_POSTMORTEM,
        "parallel/y.py": (
            "from parameter_server_tpu.utils.flightrec import record as rec\n"
            "def f():\n"
            '    rec("heartbeat.beat")\n'
            '    rec("apply.commit")\n'),
    }, "flightrec-contract", None),
    "fr_dotted_import": ({
        "utils/postmortem.py": _FR_POSTMORTEM,
        "parallel/y.py": (
            "import parameter_server_tpu.utils.flightrec\n"
            "import parameter_server_tpu.utils.flightrec as fr\n"
            "def f():\n"
            "    parameter_server_tpu.utils.flightrec.record("
            '"heartbeat.beat")\n'
            '    fr.record("apply.commit")\n'),
    }, "flightrec-contract", None),
    "fr_conditional_etype": ({
        "utils/postmortem.py": _FR_POSTMORTEM
        + '\n_MORE = [e for e in () if e["etype"] in ("a.good",)]\n',
        "parallel/x.py": _FR_EMITTER + (
            "\ndef either(ok):\n"
            '    flightrec.record("a.good" if ok else "a.bad")\n'),
    }, "flightrec-contract", None),
    "fr_no_postmortem": ({"parallel/x.py": _FR_EMITTER}, "flightrec-contract", None),
}


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_snippet_findings_equal_the_jax_analyzer(name):
    sources, checker, config = SNIPPETS[name]
    jf, pf = _both(sources, checker, config)
    assert pf == jf
    if checker is not None:
        jf_all, pf_all = _both(sources, None, config)
        assert pf_all == jf_all


def test_snippets_are_not_vacuous():
    """The parity above compares findings, so it is only as strong as the
    snippets that fire: most of them must (each JAX test's violating
    twin), and the clean twins must not."""
    fired = {name for name, (src, chk, cfg) in SNIPPETS.items() if _both(src, chk, cfg)[1]}
    assert {"lock_cycle", "blocking", "settle_dropped", "rc_stale_exemption",
            "rcu_raw_read", "wire_not_decoded", "units_cross_add", "clock_helpers",
            "id_swapped_positional", "stale_dead", "fr_unknown_event"} <= fired
    assert not {"lock_no_cycle", "blocking_clean", "rcu_base", "wire_clean",
                "units_real_conversion", "id_ver_equality", "fr_lockstep"} & fired
    assert len(fired) >= 50


def test_unregistered_counter_fires_in_both(monkeypatch):
    from parameter_server_tpu.utils import metrics as j_metrics
    from parameter_server_tpu_torch.utils import metrics as p_metrics

    # a dashboard that dropped the merged-counter block, in both packages
    monkeypatch.setattr(j_metrics, "format_cluster_stats", lambda rep: "nothing here")
    monkeypatch.setattr(p_metrics, "format_cluster_stats", lambda rep: "nothing here")
    jf, pf = _both(_one('wire_counters.inc("vanished_counter")'), "counter-contract")
    assert pf == jf and pf and "vanished_counter" in pf[0][3]


def test_derived_inventories_equal_on_snippets():
    src = {"x.py": _COUNTER_FORMS}
    j_inv = J.counter_inventory(JIndex.from_sources(src))
    p_inv = P.counter_inventory(PIndex.from_sources(src, root=Path(JAX_TREE)))
    assert p_inv == j_inv and set(p_inv) == {
        "a_counter", "b_counter", "c_peak", "d_one", "e_two"}
    src = {"y.py": _CONFIG_KNOWN}
    assert P.config_key_usage(PIndex.from_sources(src)) == J.config_key_usage(
        JIndex.from_sources(src))


def test_registry_is_the_jax_one_without_psmc():
    """All of the JAX registry's ids, the protocol model checker's two
    (``spec-conformance``, ``model-invariants``) included, in the JAX
    order."""
    assert list(P.CHECKERS) == list(J.CHECKERS)
    assert {"spec-conformance", "model-invariants"} <= set(P.CHECKERS)
    assert len(P.CHECKERS) == 17


def test_unknown_checker_lists_the_ports_registry():
    src = {"s.py": _LIVE.replace("ignore[blocking-under-lock]", "ignore[blocking-underlock]")}
    (f,) = [f for f in P.analyze_sources(src) if f.checker == "stale-pragma"]
    assert f.message.endswith("; known: " + ", ".join(sorted(P.CHECKERS)))


def test_snippet_resolves_against_the_port_by_default():
    """Under its default root a snippet is port source: the port's
    recorder module counts as the emitter, the JAX one does not."""
    pm = {"utils/postmortem.py": _FR_POSTMORTEM}
    port_emitter = _FR_EMITTER.replace("parameter_server_tpu.", "parameter_server_tpu_torch.")
    chk = {"flightrec-contract": P.CHECKERS["flightrec-contract"]}
    assert P.analyze_sources({**pm, "parallel/x.py": port_emitter}, checkers=chk) == []
    fs = P.analyze_sources({**pm, "parallel/x.py": _FR_EMITTER}, checkers=chk)
    assert {f.message.split("'")[1] for f in fs} == {"apply.commit", "heartbeat.beat"}


# ---------------------------------------------------------------------------
# the port's additions: torch primitives that park the host under a lock
# ---------------------------------------------------------------------------

_LOCKED = """
import ctypes
import subprocess
import threading

import numpy as np
import torch

from parameter_server_tpu_torch.ops import cuda_build

class C:
    def __init__(self):
        self._lock = threading.Lock()
        self.device = torch.device("cuda")
        self._counts = np.zeros(8, np.int64)

    def m(self, t, arr: np.ndarray, dev, proc):
        with self._lock:
            {stmt}
"""

#: statement under the lock -> whether the blocking checker fires
TORCH_PRIMITIVES = {
    "t.item()": True,
    "t.tolist()": True,
    "t.cpu()": True,
    "t.numpy()": True,
    "t.nonzero()": True,
    "torch.cuda.synchronize()": True,
    "t.cuda()": True,
    "t.to(self.device)": True,
    "t.to(dev)": True,
    "t.to('cuda:0')": True,
    "t.to(device='cpu')": True,
    "t.to(torch.device('cuda'))": True,
    "t.to(torch.float32)": False,
    "t.add_(1)": False,
    "cuda_build.load()": True,
    "cuda_build.build()": True,
    "ctypes.CDLL('libx.so')": True,
    "subprocess.run(['nvcc'])": True,
    "subprocess.check_call(['nvcc'])": True,
    "subprocess.check_output(['nvcc'])": True,
    "proc.communicate()": True,
    # numpy arrays on the host: the shared method names move nothing
    "arr.tolist()": False,
    "np.nonzero(arr)[0].tolist()": False,
    "self._counts.item(0)": False,
    "(arr + 1).tolist()": True,  # not inferred: assumed a tensor
}


@pytest.mark.parametrize("stmt", sorted(TORCH_PRIMITIVES))
def test_torch_primitive_under_a_lock(stmt):
    src = _LOCKED.replace("{stmt}", stmt)
    fs = P.analyze_sources({"s.py": src}, checkers={
        "blocking-under-lock": P.CHECKERS["blocking-under-lock"]})
    assert bool(fs) == TORCH_PRIMITIVES[stmt], [f.render() for f in fs]
    if fs:
        assert len(fs) == 1 and fs[0].line == src.splitlines().index(
            f"            {stmt}") + 1
    # outside the lock the same call is never a finding
    free = src.replace("        with self._lock:\n            ", "        ")
    assert P.analyze_sources({"s.py": free}, checkers={
        "blocking-under-lock": P.CHECKERS["blocking-under-lock"]}) == []


def test_torch_primitive_blocks_transitively():
    """A helper that copies to the host blocks its caller's hold, and an
    annotated host array passed on stays a host array in the callee."""
    src = (
        "import threading\nimport numpy as np\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def _host(self, t):\n"
        "        return t.cpu().numpy()\n"
        "    def _keys(self, keys: np.ndarray):\n"
        "        return keys.tolist()\n"
        "    def m(self, t, keys):\n"
        "        with self._lock:\n"
        "            self._host(t)\n"
        "            self._keys(keys)\n"
    )
    fs = P.analyze_sources({"s.py": src}, checkers={
        "blocking-under-lock": P.CHECKERS["blocking-under-lock"]})
    assert [f.line for f in fs] == [12] and "C._host" in fs[0].message


def test_the_jax_names_still_block():
    """The port keeps every JAX blocking name: the JAX snippet's three
    findings, and ``np.asarray`` (the JAX jit boundary's name) still counts."""
    src = _LOCKED.replace("{stmt}", "np.asarray(arr)")
    assert len(P.analyze_sources({"s.py": src}, checkers={
        "blocking-under-lock": P.CHECKERS["blocking-under-lock"]})) == 1


# ---------------------------------------------------------------------------
# the port's additions: the in-place publisher (rcu)
# ---------------------------------------------------------------------------

_INPLACE = """
import threading

from parameter_server_tpu_torch.kv import store as kv_store

class Srv:
    def __init__(self):
        self.state = {"w": make(), "n": make()}
        self._pub_lock = threading.Lock()
        self._lock = threading.Lock()
        self._version = 1
        self._pts = 0

    def _publish(self):
        self._version += 1
        self._pts = now()

    def _apply(self, idx, g):
        with self._pub_lock:
            for k, v in self.state.items():
                v.index_add_(0, idx, g)
            self._publish()
            return self._version

    def apply_batch(self, idx, g):
        with self._lock:
            return self._apply(idx, g)

    def _rows(self, idx):
        return {k: v.index_select(0, idx) for k, v in self.state.items()}

    def pull(self, idx):
        with self._pub_lock:
            ver = self._version
            rows = self._rows(idx)
        return rows, ver

    def layout(self):
        return set(self.state), "w" in self.state, self.state["w"].shape

    def load_state(self, new):
        with self._lock, self._pub_lock:
            self.state = new
            self._version = fresh_nonce()
            self._publish()
"""


def _rcu(src: str):
    return P.analyze_sources({"s.py": src}, checkers={"rcu": P.CHECKERS["rcu"]})


def test_inplace_publisher_is_discovered():
    from parameter_server_tpu_torch.analysis.rcu import discover_inplace_publishers

    (pub,) = discover_inplace_publishers(PIndex.from_sources({"s.py": _INPLACE}))
    assert (pub.cls, pub.setter, pub.pub_lock) == ("Srv", "_publish", "_pub_lock")
    assert pub.apply_locks == {"_lock"} and pub.stamps == {"_version", "_pts"}
    assert pub.caller_held == {"_publish", "_rows"}


def test_inplace_base_is_clean_under_every_checker():
    assert P.analyze_sources({"s.py": _INPLACE}) == []


#: an edit of the base snippet -> the message the rcu checker gives
INPLACE_VIOLATIONS = {
    "write_without_publish": (
        ("            self._publish()\n            return self._version\n",
         "            return self._version\n"),
        "without _publish() in the same _pub_lock hold"),
    "write_outside_the_lock": (
        ("    def layout(self):",
         "    def bad(self, idx, g):\n        self.state['w'].index_add_(0, idx, g)\n\n"
         "    def layout(self):"),
        "outside the publish lock"),
    "push_outside_the_lock": (
        ("    def layout(self):",
         "    def bad(self, idx, g):\n"
         "        kv_store.push(self.updater, self.state, idx, g)\n\n    def layout(self):"),
        "in-place kv_store.push(..., self.state, ...)"),
    "subscript_store_without_publish": (
        ("    def layout(self):",
         "    def bad(self, idx):\n        with self._pub_lock:\n"
         "            self.state['w'][idx] = 0\n\n    def layout(self):"),
        "subscript store self.state['w'][idx]"),
    "row_read_outside_the_lock": (
        ("    def layout(self):",
         "    def bad(self, idx):\n        return self.state['w'][idx]\n\n"
         "    def layout(self):"),
        "read of Srv.state rows outside the publish lock"),
    "stamp_read_outside_the_lock": (
        ("    def layout(self):",
         "    def bad(self):\n        return self._version\n\n    def layout(self):"),
        "read of Srv._version outside the publish lock"),
    "helper_called_outside_the_lock": (
        ("    def layout(self):",
         "    def bad(self, idx):\n        return self._rows(idx)\n\n    def layout(self):"),
        "read of Srv.state rows outside the publish lock"),
    "restore_without_the_apply_lock": (
        ("        with self._lock, self._pub_lock:", "        with self._pub_lock:"),
        "restore of Srv.state must hold Srv._lock and Srv._pub_lock"),
}


@pytest.mark.parametrize("name", sorted(INPLACE_VIOLATIONS))
def test_inplace_publisher_rule_fires(name):
    (old, new), message = INPLACE_VIOLATIONS[name]
    assert _INPLACE.count(old) == 1
    fs = _rcu(_INPLACE.replace(old, new))
    assert fs and any(message in f.message for f in fs), [f.render() for f in fs]


def test_version_arithmetic_is_the_setters_alone():
    """idtype exempts the setter's ``+= 1`` on the version; the same
    arithmetic anywhere else is a finding."""
    chk = {"idtype": P.CHECKERS["idtype"]}
    assert P.analyze_sources({"s.py": _INPLACE}, checkers=chk) == []
    bad = _INPLACE.replace(
        "    def layout(self):",
        "    def skip(self):\n        with self._pub_lock:\n"
        "            nxt = self._version + 2\n        return nxt\n\n    def layout(self):")
    fs = P.analyze_sources({"s.py": bad}, checkers=chk)
    assert len(fs) == 1 and "EQUALITY-ONLY" in fs[0].message


# ---------------------------------------------------------------------------
# the module entry: the JAX main's options and exit codes
# ---------------------------------------------------------------------------

_VIOLATION = (
    "import threading\nimport time\n"
    "_lk = threading.Lock()\n"
    "def m():\n"
    "    with _lk:\n"
    "        time.sleep(1)\n"
)


def _git_pkg(tmp_path: Path) -> Path:
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "old.py").write_text(_VIOLATION)

    def git(*args):
        subprocess.run(
            ["git", "-C", str(tmp_path), "-c", "user.email=t@t", "-c", "user.name=t",
             *args], check=True, capture_output=True,
        )

    git("init", "-q")
    git("add", "-A")
    git("commit", "-qm", "seed")
    return pkg


def _mains(argv, capsys):
    """(rc, stdout) of the JAX main and of the port's, on the same argv."""
    out = []
    for main in (j_main.main, p_main.main):
        rc = main(list(argv))
        out.append((rc, capsys.readouterr().out))
    return out


def test_main_matches_the_jax_main(tmp_path, capsys):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "a.py").write_text(_VIOLATION)
    base = tmp_path / "base.json"
    # absolute gate, JSON findings with their severity
    (j_rc, j_out), (p_rc, p_out) = _mains(["--root", str(pkg), "--json"], capsys)
    assert p_rc == j_rc == 1 and json.loads(p_out) == json.loads(j_out)
    assert json.loads(p_out)[0]["severity"] == "error"
    # recording a baseline exits 0; the frozen findings then pass
    assert p_main.main(["--root", str(pkg), "--baseline", str(base),
                        "--update-baseline"]) == 0
    capsys.readouterr()
    (j_rc, _), (p_rc, _) = _mains(["--root", str(pkg), "--baseline", str(base)], capsys)
    assert p_rc == j_rc == 0
    # a new finding gates again
    (pkg / "b.py").write_text(_VIOLATION.replace("_lk", "_lk2"))
    (j_rc, j_out), (p_rc, p_out) = _mains(
        ["--root", str(pkg), "--baseline", str(base), "--json"], capsys)
    assert p_rc == j_rc == 1 and json.loads(p_out) == json.loads(j_out)
    assert [d["file"] for d in json.loads(p_out)] == ["b.py"]
    # [tool.pslint] warn demotes a checker: warn-only runs exit 2
    (tmp_path / "pyproject.toml").write_text(
        '[tool.pslint]\nwarn = ["blocking-under-lock"]\n')
    (j_rc, _), (p_rc, p_out) = _mains(["--root", str(pkg)], capsys)
    assert p_rc == j_rc == 2 and "[warn]" in p_out
    # a clean tree exits 0
    clean = tmp_path / "clean"
    clean.mkdir()
    (clean / "a.py").write_text("x = 1\n")
    (j_rc, _), (p_rc, _) = _mains(["--root", str(clean)], capsys)
    assert p_rc == j_rc == 0


def test_changed_only_matches_the_jax_main(tmp_path, capsys):
    pkg = _git_pkg(tmp_path)
    (pkg / "new.py").write_text(_VIOLATION)
    (j_rc, j_out), (p_rc, p_out) = _mains(
        ["--root", str(pkg), "--changed-only", "HEAD", "--json"], capsys)
    assert p_rc == j_rc == 1 and json.loads(p_out) == json.loads(j_out)
    assert {d["file"] for d in json.loads(p_out)} == {"new.py"}
    (pkg / "new.py").write_text("x = 1\n")
    (j_rc, _), (p_rc, _) = _mains(["--root", str(pkg), "--changed-only", "HEAD"], capsys)
    assert p_rc == j_rc == 0
    with pytest.raises(SystemExit):
        p_main.main(["--root", str(pkg), "--baseline", "b.json",
                     "--update-baseline", "--changed-only", "HEAD"])


def test_main_help_documents_line_insensitive_baselines(capsys):
    with pytest.raises(SystemExit):
        p_main.main(["--help"])
    out = capsys.readouterr().out
    assert "LINE-INSENSITIVE" in out and "parameter_server_tpu_torch" in out
