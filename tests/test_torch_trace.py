"""Port parity for distributed tracing (``parameter_server_tpu_torch/utils/
trace.py``, a copy of the JAX package's).

Mirrors the JAX package's ``tests/test_trace_schema.py``: the disabled path
is an identity-pinned no-op, nesting, the ring, the export schema,
counters, head sampling and flows; then tail capture against the JAX
``TailCapture`` on one event sequence. Across packages: a traced push from
a JAX ``ServerHandle`` into a port ``ShardServer`` in another process (and
a port handle into a JAX server) carries one trace id through both
processes' exports, and a port cluster's merged trace holds the span names
of the JAX cluster's on the same drive."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from parameter_server_tpu.utils import trace as jtrace
from parameter_server_tpu_torch.utils import trace

REPO = Path(__file__).resolve().parent.parent
_VALID_PH = {"X", "i", "M", "s", "f", "C"}


def _validate_chrome_trace(path: Path) -> list[dict]:
    """Strict-JSON Chrome trace-event checks; returns the event list."""
    doc = json.loads(Path(path).read_text())
    assert isinstance(doc, dict) and "traceEvents" in doc
    events = doc["traceEvents"]
    assert isinstance(events, list) and events
    last_ts = None
    for ev in events:
        assert isinstance(ev["name"], str) and ev["name"]
        assert ev["ph"] in _VALID_PH, ev
        assert isinstance(ev["pid"], int) and isinstance(ev["tid"], int)
        if ev["ph"] == "M":
            continue
        assert ev["ts"] >= 0
        if last_ts is not None:  # export sorts: ts must be monotonic
            assert ev["ts"] >= last_ts
        last_ts = ev["ts"]
        if ev["ph"] == "X":
            assert ev["dur"] >= 0
        if ev["ph"] in ("s", "f"):
            assert isinstance(ev["id"], str) and ev["id"]
        if ev["ph"] == "f":
            assert ev["bp"] == "e"
        if ev["ph"] == "C":
            assert isinstance(ev["args"]["value"], (int, float))
    return events


def _spans(events: list[dict], name: str) -> list[dict]:
    return [e for e in events if e.get("ph") == "X" and e["name"] == name]


@pytest.fixture(autouse=True)
def _disarm_after():
    yield
    trace.configure(None)
    jtrace.configure(None)


# -- two processes, across packages -----------------------------------------


def _child(script: str, trace_dir: Path) -> tuple[subprocess.Popen, str]:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env[trace.TRACE_DIR_ENV] = str(trace_dir)
    child = subprocess.Popen([sys.executable, str(REPO / "tests" / script)],
                             stdout=subprocess.PIPE, text=True, env=env)
    line = child.stdout.readline()  # "ADDR host:port"
    assert line.startswith("ADDR "), line
    return child, line.split()[1]


def _push_trace(handle_mod, trace_mod, cfg, script: str, tmp_path: Path, **kw):
    """A traced push and pull from a ``handle_mod.ServerHandle`` in this
    process into the child ``script``'s server; returns the worker's and
    the server's export events."""
    trace_dir = tmp_path / "traces"
    trace_dir.mkdir()
    child, addr = _child(script, trace_dir)
    try:
        trace_mod.configure(str(trace_dir), process_name="worker-0")
        handle = handle_mod.ServerHandle(addr, 0, 0, cfg, range_size=4096, **kw)
        keys = np.arange(1, 65, dtype=np.int64)
        g = np.full(len(keys), 0.5, dtype=np.float32)
        handle.push(keys, g)
        np.testing.assert_allclose(handle.pull(keys), -0.1 * g, rtol=1e-6)
        handle.shutdown()
        handle.close()
        child.wait(timeout=60)
        worker_path = Path(trace_mod.tracer.flush())
    finally:
        trace_mod.configure(None)
        if child.poll() is None:
            child.kill()
            child.wait()
        child.stdout.close()
    assert child.returncode == 0
    server_files = list(trace_dir.glob("trace-server-0-*.json"))
    assert server_files, list(trace_dir.iterdir())
    worker_ev = _validate_chrome_trace(worker_path)
    server_ev = _validate_chrome_trace(server_files[0])
    merged = _validate_chrome_trace(Path(trace.merge_trace_dir(str(trace_dir))))
    return worker_ev, server_ev, merged


def _assert_one_push_trace(worker_ev, server_ev, merged):
    wpids = {e["pid"] for e in worker_ev if e["ph"] == "X"}
    spids = {e["pid"] for e in server_ev if e["ph"] == "X"}
    assert wpids and spids and wpids.isdisjoint(spids)
    # one logical push = one trace id across processes: ps.push (worker)
    # -> rpc.push (worker) -> rpc.serve.push (server) -> server.updater
    push_spans = _spans(worker_ev, "ps.push")
    assert push_spans, [e["name"] for e in worker_ev]
    tid = push_spans[0]["args"]["trace_id"]
    client_rpc = [e for e in _spans(worker_ev, "rpc.push") if e["args"]["trace_id"] == tid]
    assert client_rpc, "client rpc.push span missing from the trace"
    serve = [e for e in _spans(server_ev, "rpc.serve.push") if e["args"]["trace_id"] == tid]
    assert serve, "server dispatch span did not join the trace"
    updater = [e for e in _spans(server_ev, "server.updater")
               if e["args"]["trace_id"] == tid]
    assert updater, "updater span did not join the trace"
    assert serve[0]["args"]["parent_id"] == client_rpc[0]["args"]["span_id"]
    assert {e["pid"] for e in merged if e["ph"] == "X"} >= wpids | spids


class TestTwoProcessTrace:
    def test_port_push_trace_id_spans_both_processes(self, tmp_path):
        """A port handle into a port server in another process."""
        from parameter_server_tpu_torch.parallel import multislice as TM
        from parameter_server_tpu_torch.utils.config import PSConfig

        _assert_one_push_trace(*_push_trace(
            TM, trace, PSConfig(), "_torch_trace_child.py", tmp_path, device="cpu"))

    def test_jax_client_joins_a_port_server_trace(self, tmp_path):
        """A traced JAX ``ServerHandle`` pushing into a port server: the
        port server binds the JAX client's ``_trace`` header field."""
        from parameter_server_tpu.parallel import multislice as JM
        from parameter_server_tpu.utils.config import PSConfig

        _assert_one_push_trace(*_push_trace(
            JM, jtrace, PSConfig(), "_torch_trace_child.py", tmp_path))

    def test_port_client_joins_a_jax_server_trace(self, tmp_path):
        """A traced port handle pushing into a JAX server process."""
        from parameter_server_tpu_torch.parallel import multislice as TM
        from parameter_server_tpu_torch.utils.config import PSConfig

        _assert_one_push_trace(*_push_trace(
            TM, trace, PSConfig(), "_trace_child_server.py", tmp_path, device="cpu"))


class TestFlowEvents:
    """Every async push emits a flow start inside its issue span and a
    flow end at completion: the same id, so Perfetto draws the arrow."""

    def test_push_async_emits_matched_flow_pairs(self, tmp_path):
        from parameter_server_tpu_torch.kv.updaters import Sgd
        from parameter_server_tpu_torch.parallel.multislice import ServerHandle, ShardServer
        from parameter_server_tpu_torch.utils.config import PSConfig
        from parameter_server_tpu_torch.utils.keyrange import KeyRange

        trace.configure(str(tmp_path), process_name="flow-test")
        srv = ShardServer(Sgd(eta=0.1), KeyRange(0, 1024), device="cpu").start()
        handle = ServerHandle(srv.address, 0, 0, PSConfig(), range_size=1024, device="cpu")
        try:
            keys = np.arange(1, 33, dtype=np.int64)
            futs = [handle.push_async(keys, np.ones(32, np.float32)) for _ in range(5)]
            for f in futs:
                f.result(timeout=30)
            assert handle.pull_async(keys).result(timeout=30).shape[0] == 32
            handle.shutdown()
        finally:
            handle.close()
            srv.join(timeout=10)
        path = Path(trace.tracer.flush())
        events = _validate_chrome_trace(path)
        starts = [e for e in events if e["ph"] == "s"]
        ends = [e for e in events if e["ph"] == "f"]
        push_starts = [e for e in starts if e["name"] == "ps.push.inflight"]
        assert len(push_starts) == 5
        end_ids = {(e["name"], e["id"]) for e in ends}
        for s in starts:
            assert (s["name"], s["id"]) in end_ids, s
        assert len(end_ids) == len(starts)
        issue_spans = {e["args"]["span_id"]: e["args"]["trace_id"]
                       for e in _spans(events, "ps.push")}
        for s in push_starts:
            assert s["args"]["parent_id"] in issue_spans
            assert s["args"]["trace_id"] == issue_spans[s["args"]["parent_id"]]
        # the server side of the same process: dispatch, batched apply
        # and queue-depth / batch-size counter tracks
        names = {e["name"] for e in events}
        assert {"rpc.serve.push", "server.apply_batch", "server.updater",
                "server.apply_queue_depth", "server.apply_batch_size"} <= names

    def test_flow_api_disabled_is_free(self):
        t = trace.Tracer(None)
        fid = t.flow_start("nope", cat="x")
        assert fid is None
        t.flow_end("nope", cat="x", flow_id=fid)
        assert t.events() == []


class TestDisabledTracingIsFree:
    def test_noop_path_allocates_no_spans(self):
        t = trace.Tracer(None)
        s1 = t.span("hot.path", cat="step", keys=128)
        s2 = t.span("other")
        assert s1 is s2 is trace._NOOP
        with s1 as s:
            s.set(bytes=4096)
        assert t.events() == []
        assert t.wire_context() is None
        assert t.activate({"tid": "x", "sid": "y"}) is trace._NOOP
        t.instant("nope")
        assert t.events() == []
        assert t.flush() is None

    def test_noop_is_reference_stable_across_calls(self):
        t = trace.Tracer(None)
        assert len({id(t.span(f"s{i}")) for i in range(100)}) == 1
        # the module-level delegates of the disarmed global, too
        assert trace.span("x") is trace._NOOP and not trace.enabled()



def _profiled(tmp_path: Path, body) -> list[dict]:
    """Run ``body`` under ``torch.profiler`` (CPU activity) and return the
    exported trace's ``user_annotation`` events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        body()
    path = tmp_path / "prof.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"]


def _inside(inner: dict, outer: dict) -> bool:
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


class TestUnderTheProfiler:
    """While ``torch.profiler`` collects, spans reach its trace and spans
    and counters the ring, with no trace dir armed; outside it, the
    disabled path is the no-op singleton again."""

    def test_span_lands_in_the_profile_nested_as_opened(self, tmp_path):
        trace.configure(None)

        def body():
            with trace.span("linear.step", cat="step") as o:
                with trace.span("linear.h2d", cat="step") as i:
                    assert i is not trace._NOOP and i.parent_id == o.span_id
                with trace.span("linear.launch", cat="step"):
                    pass

        ann = _profiled(tmp_path, body)
        by = {e["name"]: e for e in ann}
        assert [e["name"] for e in ann].count("linear.step") == 1
        assert _inside(by["linear.h2d"], by["linear.step"])
        assert _inside(by["linear.launch"], by["linear.step"])
        assert by["linear.h2d"]["ts"] + by["linear.h2d"]["dur"] <= by["linear.launch"]["ts"]
        ring = trace.tracer.events()
        assert [e["name"] for e in ring] == ["linear.h2d", "linear.launch", "linear.step"]
        assert all(e["cat"] == "step" and e["ph"] == "X" for e in ring)
        assert trace.tracer.flush() is None  # no dir: nothing written

    def test_counter_lands_in_the_ring_with_no_trace_dir(self, tmp_path):
        trace.configure(None)

        def body():
            trace.counter("linear.slots", 524289, cat="step")
            trace.counter("linear.pad_slots", 475000)

        _profiled(tmp_path, body)
        cs = [(e["ph"], e["name"], e["args"]["value"]) for e in trace.tracer.events()]
        assert cs == [("C", "linear.slots", 524289.0), ("C", "linear.pad_slots", 475000.0)]
        assert not trace.enabled()

    def test_after_the_profiler_exits_the_noop_is_back(self, tmp_path):
        trace.configure(None)
        _profiled(tmp_path, lambda: None)
        assert trace.span("linear.step") is trace._NOOP
        with trace.span("linear.step"):
            trace.counter("linear.slots", 1)
        assert trace.tracer.events() == []

    def test_armed_dir_without_a_profiler_writes_what_the_jax_tracer_writes(
        self, tmp_path
    ):
        """The same drive into each package's armed tracer, no profiler:
        the port's export has the JAX copy's events, field for field
        (times, ids and pids aside), and opens no profiler range."""
        def drive(mod):
            with mod.span("outer", cat="a", n=3):
                with mod.span("inner") as sp:
                    sp.set(bytes=8)
                    mod.instant("rpc.retry", attempt=1)
                mod.counter("depth", 2)
            doc = json.loads(Path(mod.tracer.flush()).read_text())
            return [(e["name"], e["ph"], e.get("cat"), sorted(e.get("args", {})))
                    for e in doc["traceEvents"] if e["ph"] != "M"]

        jtrace.configure(str(tmp_path / "jax"), process_name="p")
        trace.configure(str(tmp_path / "port"), process_name="p")
        assert trace.span("x")._range is None
        got = drive(trace)
        assert got == drive(jtrace)
        assert [n for n, *_ in got] == ["outer", "inner", "rpc.retry", "depth"]

    def test_armed_dir_under_the_profiler_records_both(self, tmp_path):
        t = trace.configure(str(tmp_path / "d"), process_name="p")

        def body():
            with trace.span("ps.push", cat="rpc"):
                pass

        ann = _profiled(tmp_path, body)
        assert [e["name"] for e in ann] == ["ps.push"]
        assert [e["name"] for e in t.events()] == ["ps.push"]
        assert Path(t.flush()).is_file()


class TestTracerEnabled:
    @pytest.fixture
    def armed(self, tmp_path):
        yield trace.configure(str(tmp_path), process_name="t")

    def test_nesting_and_parent_ids(self, armed):
        with trace.span("outer", cat="a") as o:
            with trace.span("inner", cat="b") as i:
                assert i.trace_id == o.trace_id
                assert i.parent_id == o.span_id
        assert [e["name"] for e in armed.events()] == ["inner", "outer"]

    def test_wire_context_roundtrip_in_process(self, armed):
        with trace.span("client.side") as c:
            ctx = trace.wire_context()
            assert ctx == {"tid": c.trace_id, "sid": c.span_id}
        with trace.activate(ctx), trace.span("server.side") as s:
            assert s.trace_id == c.trace_id
            assert s.parent_id == c.span_id

    def test_ring_buffer_bounded(self, tmp_path):
        t = trace.Tracer(str(tmp_path), capacity=8)
        for i in range(50):
            with t.span(f"s{i}"):
                pass
        assert len(t.events()) == 8
        assert t.events()[-1]["name"] == "s49"

    def test_export_schema_and_error_annotation(self, armed):
        with pytest.raises(ValueError):
            with trace.span("boom"):
                raise ValueError("x")
        with trace.span("ok", answer=42):
            time.sleep(0.001)
        evs = _validate_chrome_trace(Path(armed.flush()))
        by_name = {e["name"]: e for e in evs if e["ph"] == "X"}
        assert "error" in by_name["boom"]["args"]
        assert by_name["ok"]["args"]["answer"] == 42
        assert by_name["ok"]["dur"] >= 900

    def test_instant_rides_current_trace(self, armed):
        with trace.span("call") as c:
            trace.instant("rpc.retry", attempt=1)
        inst = [e for e in armed.events() if e["ph"] == "i"]
        assert inst and inst[0]["args"]["trace_id"] == c.trace_id

    def test_counter_events_export_as_perfetto_counter_track(self, armed):
        for v in (1, 4, 2):
            trace.counter("server.apply_queue_depth", v)
        evs = _validate_chrome_trace(Path(armed.flush()))
        cs = [e for e in evs if e["ph"] == "C"]
        assert [e["args"]["value"] for e in cs] == [1.0, 4.0, 2.0]
        assert all(e["name"] == "server.apply_queue_depth" for e in cs)

    def test_counter_disabled_is_free(self):
        trace.configure(None)
        trace.counter("x", 1)
        assert trace.tracer.events() == []

    def test_step_context_carries_onto_pool_threads(self, armed):
        from concurrent.futures import ThreadPoolExecutor

        def pool_side(ctx=None):
            with trace.activate(ctx), trace.span("ps.pull"):
                return True

        with ThreadPoolExecutor(max_workers=2) as pool:
            with trace.span("step") as stp:
                ctx = trace.wire_context()
                assert pool.submit(pool_side).result()
                assert pool.submit(pool_side, ctx).result()
        pulls = _spans(armed.events(), "ps.pull")
        assert len(pulls) == 2
        tids = {e["args"]["trace_id"] for e in pulls}
        assert stp.trace_id in tids and len(tids) == 2
        joined = [e for e in pulls if e["args"]["trace_id"] == stp.trace_id]
        assert joined[0]["args"]["parent_id"] == stp.span_id


class TestHeadSampling:
    def test_sample_one_records_everything(self, tmp_path):
        t = trace.configure(str(tmp_path), process_name="s1", sample=1)
        for _ in range(20):
            with trace.span("root", cat="t"):
                pass
        assert len(t.events()) == 20

    def test_sample_n_drops_whole_traces(self, tmp_path):
        t = trace.configure(str(tmp_path), process_name="s4", sample=4)
        kept = 0
        for _ in range(200):
            with trace.span("root", cat="t"):
                with trace.span("child", cat="t"):
                    trace.instant("tick", cat="t")
            before, kept = kept, len(t.events())
            assert kept - before in (0, 3)  # whole traces, never fragments
        assert 0 < kept // 3 < 150
        roots = {e["args"]["trace_id"] for e in t.events()
                 if e.get("ph") == "X" and e["name"] == "root"}
        assert all(e["args"]["trace_id"] in roots for e in t.events())

    def test_decision_is_keyed_off_trace_id_in_both_packages(self, tmp_path):
        """The same trace id gets the same verdict in any process of
        either package: the port keeps exactly the ids the JAX tracer
        keeps, and a remote span under a dropped context stays dropped."""
        t = trace.configure(str(tmp_path), process_name="sk", sample=3)
        jt = jtrace.Tracer(str(tmp_path), sample=3)
        ids = [f"{i * 2654435761 % (1 << 64):016x}" for i in range(300)]
        assert [t._keep(i) for i in ids] == [jt._keep(i) for i in ids]
        kept_ctx = dropped_ctx = None
        while kept_ctx is None or dropped_ctx is None:
            with trace.span("probe", cat="t") as sp:
                ctx = trace.wire_context()
            if t._keep(sp.trace_id):
                kept_ctx = kept_ctx or ctx
            else:
                dropped_ctx = dropped_ctx or ctx
        n0 = len(t.events())
        with trace.activate(dropped_ctx), trace.span("server.side", cat="t"):
            pass
        assert len(t.events()) == n0
        with trace.activate(kept_ctx), trace.span("server.side", cat="t"):
            pass
        assert len(t.events()) == n0 + 1

    def test_dropped_trace_flow_api_returns_none(self, tmp_path):
        t = trace.configure(str(tmp_path), process_name="sf", sample=2)
        while True:
            sp = trace.span("root", cat="t")
            with sp:
                fid = trace.flow_start("f", cat="t")
                trace.flow_end("f", cat="t", flow_id=fid)
            if not t._keep(sp.trace_id):
                break
        assert all(e["name"] != "f" or t._keep(e["args"]["trace_id"]) for e in t.events())

    def test_env_var_arms_sampling(self, monkeypatch):
        monkeypatch.setenv(trace.TRACE_SAMPLE_ENV, "8")
        assert trace._env_sample() == 8
        monkeypatch.setenv(trace.TRACE_SAMPLE_ENV, "junk")
        assert trace._env_sample() == 1
        for raw, k in (("", trace.DEFAULT_TAIL_K), ("0", 0), ("7", 7)):
            monkeypatch.setenv(trace.TRACE_TAIL_ENV, raw)
            assert trace._env_tail_k() == jtrace._env_tail_k() == k

    def test_config_knob_and_constants_are_the_jax_ones(self):
        from parameter_server_tpu_torch.utils.config import TraceConfig

        assert TraceConfig().sample == 1
        for name in ("TRACE_DIR_ENV", "TRACE_SAMPLE_ENV", "TRACE_TAIL_ENV",
                     "DEFAULT_CAPACITY", "DEFAULT_TAIL_K", "DEFAULT_TAIL_LIMBO",
                     "TAIL_ANOMALY_EVENTS"):
            assert getattr(trace, name) == getattr(jtrace, name), name


# -- tail capture ------------------------------------------------------------


def _tail_drive(mod, tmp_path: Path):
    """One fixed event sequence through ``mod``'s Tracer with head
    sampling 1/4 and tail capture (slowest 2): returns the export ring's
    and the limbo's (name, trace id) pairs and the promote counters."""
    from parameter_server_tpu.utils.metrics import wire_counters as jwc
    from parameter_server_tpu_torch.utils.metrics import wire_counters as twc

    wc = jwc if mod is jtrace else twc
    p0, d0 = wc.get("trace_tail_promoted"), wc.get("trace_tail_dropped")
    t = mod.Tracer(str(tmp_path), sample=4, tail=mod.TailCapture(k=2))
    durs = [5.0, 1.0, 9.0, 2.0, 3.0, 8.0, 1.5, 4.0, 0.5, 7.0, 6.0, 2.5]
    for i, dur_ms in enumerate(durs):
        tid = f"{(4 * i + 1):08x}{i:08x}"  # head sampling reads the first 8 hex
        assert not t._keep(tid)
        child = {"name": "child", "cat": "t", "ph": "X", "ts": 1.0 + i, "dur": 10.0,
                 "pid": 1, "tid": 1, "args": {"trace_id": tid, "span_id": f"c{i}",
                                              "parent_id": f"r{i}"}}
        t._record(child)
        if i == 6:  # an anomaly-bearing trace promotes whatever its speed
            t._record({"name": "rpc.retry", "cat": "rpc", "ph": "i", "ts": 1.5 + i,
                       "s": "t", "pid": 1, "tid": 1,
                       "args": {"trace_id": tid, "parent_id": f"r{i}"}})
        t._record({"name": "push", "cat": "t", "ph": "X", "ts": 1.0 + i,
                   "dur": dur_ms * 1e3, "pid": 1, "tid": 1,
                   "args": {"trace_id": tid, "span_id": f"r{i}"}}, tail_seal=True)
    kept_tid = f"{8:08x}{0:08x}"  # 8 % 4 == 0: head-kept, recorded as ever
    assert t._keep(kept_tid)
    t._record({"name": "push", "cat": "t", "ph": "X", "ts": 99.0, "dur": 1.0, "pid": 1,
               "tid": 1, "args": {"trace_id": kept_tid, "span_id": "k"}})
    ring = [(e["name"], e["args"]["trace_id"]) for e in t.events()]
    limbo = [(e["name"], e["args"]["trace_id"]) for e in t.tail.limbo_events()]
    return ring, limbo, (wc.get("trace_tail_promoted") - p0,
                         wc.get("trace_tail_dropped") - d0)


def test_tail_capture_promotes_what_the_jax_tail_capture_promotes(tmp_path):
    """Slowest-K per root name and anomaly-bearing traces are promoted into
    the ring whole (children first, then the root); the rest land in the
    limbo sidecar ring: the same verdicts, events and counters as the JAX
    package's TailCapture on the same sequence."""
    got = _tail_drive(trace, tmp_path)
    want = _tail_drive(jtrace, tmp_path)
    assert got == want
    ring, limbo, (promoted, dropped) = got
    promoted_tids = {tid for _, tid in ring}
    assert f"{25:08x}{6:08x}" in promoted_tids  # the anomaly
    assert {f"{1:08x}{0:08x}", f"{5:08x}{1:08x}"} <= promoted_tids  # the first K
    assert promoted + dropped == 12 and limbo
    assert ("push", f"{8:08x}{0:08x}") in ring  # the head-kept trace


def test_tail_sidecar_is_rescued_at_merge(tmp_path):
    """An unpromoted trace's limbo events land in a ``tracetail-*.json``
    sidecar; ``merge_trace_dir`` rescues those whose trace id another
    process's main file kept, as JAX's merge does."""
    t = trace.configure(str(tmp_path), process_name="a", sample=1 << 30, tail=True,
                        tail_k=1)
    with trace.span("push"):  # first of its name: slowest-1, promoted
        pass
    with trace.span("push") as sp:  # not slower: limbo
        pass
    limbo_tid = sp.trace_id
    t.flush()
    assert list(tmp_path.glob("tracetail-a-*.json"))
    other = {"name": "rpc.push", "ph": "X", "ts": 1.0, "dur": 1.0, "pid": 7, "tid": 7,
             "args": {"trace_id": limbo_tid, "span_id": "z"}}
    trace.write_chrome_trace([other], str(tmp_path / "trace-b-7.json"))
    jpath = Path(jtrace.merge_trace_dir(str(tmp_path)))
    jmerged = json.loads(jpath.read_text())
    jpath.unlink()
    merged = json.loads(Path(trace.merge_trace_dir(str(tmp_path))).read_text())
    tids = [e["args"]["trace_id"] for e in merged["traceEvents"] if e["ph"] == "X"]
    assert tids.count(limbo_tid) == 2  # the rescued server half and its peer
    assert sorted(json.dumps(e, sort_keys=True) for e in merged["traceEvents"]) == sorted(
        json.dumps(e, sort_keys=True) for e in jmerged["traceEvents"])


# -- a cluster, against the JAX cluster ---------------------------------------


def _cluster_cfg(tmp_path: Path) -> Path:
    from parameter_server_tpu.data.synthetic import make_sparse_logistic, write_libsvm

    labels, keys, vals, _ = make_sparse_logistic(600, 400, nnz_per_example=6, seed=23)
    files = []
    for i in range(2):
        files.append(str(tmp_path / f"part-{i}.svm"))
        write_libsvm(files[-1], labels[i::2], keys[i::2], vals[i::2])
    cfg = {"app": "linear_method",
           "data": {"files": files, "num_keys": 1024, "format": "libsvm"},
           "solver": {"minibatch": 100, "epochs": 1, "max_delay": 1},
           "fault": {"heartbeat_interval_s": 0.2}}
    app = tmp_path / "app.json"
    app.write_text(json.dumps(cfg))
    return app


def _span_names(trace_dir: Path) -> set[str]:
    merged = json.loads(Path(trace.merge_trace_dir(str(trace_dir))).read_text())
    return {e["name"] for e in merged["traceEvents"] if e["ph"] in ("X", "i")}


def test_port_cluster_spans_carry_the_jax_cluster_names(tmp_path):
    """The same 1-server 1-worker cluster, traced, in each package: every
    node exports a file, and the port's merged trace holds the JAX
    cluster's span names (the wire, the server apply and the worker's step
    anatomy), so either package's tools read the other's captures."""
    from parameter_server_tpu.parallel import multislice as JM
    from parameter_server_tpu_torch.parallel import multislice as TM

    app = _cluster_cfg(tmp_path)
    out = TM.launch_local(str(app), 1, 1, device="cpu", trace_dir=str(tmp_path / "pt"),
                          timeout=120, log_dir=str(tmp_path / "plogs"))
    assert out["workloads"]["done"] == 2
    JM.launch_local(str(app), 1, 1, trace_dir=str(tmp_path / "jt"), timeout=180)
    for d in ("pt", "jt"):
        files = sorted(p.name.rsplit("-", 1)[0] for p in (tmp_path / d).glob("trace-*-*.json")
                       if p.name != "trace-merged.json")
        assert files == ["trace-scheduler-0", "trace-server-0", "trace-worker-0"], files
    port, jax = _span_names(tmp_path / "pt"), _span_names(tmp_path / "jt")
    core = {"rpc.push", "rpc.serve.push", "ps.push", "ps.pull", "rpc.pull",
            "rpc.serve.pull", "server.apply_batch", "server.updater", "step",
            "step.ssp_wait", "step.pull", "step.compute", "step.workload_fetch"}
    assert core <= jax, core - jax
    assert jax <= port, sorted(jax - port)
    assert port <= jax | {n for n in port if n.startswith(("rpc.", "rpc.serve."))}
