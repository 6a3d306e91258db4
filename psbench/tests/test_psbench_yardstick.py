"""The yardstick on the CPU: byte and FLOP counts against hand counts,
spreads, idle shares, the trace reader, the contract's shape
of ``BENCHMARK.json``, and discovery of a new configuration, mix and metric,
and of a second model's cell, by file name alone."""

from __future__ import annotations

import importlib.util
import json
import math
import re
import shutil
import statistics
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from psbench import roofline, stats  # noqa: E402
from psbench.device import H100  # noqa: E402
from psbench.devtrace import WINDOW, DeviceTrace  # noqa: E402
from psbench.run import run_cell  # noqa: E402
from psbench.spec import app_module, load_cell, read_per_layer  # noqa: E402
from psbench.tests.cellcheck import (  # noqa: E402
    app_of,
    cell_faults,
    check_agrees,
    check_control,
    check_fault,
)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_lr_step_counts_by_hand():
    # 2 examples, 6 nonzeros, 4 unique keys: z and n of each key read and
    # written (4 x 4 B), each nonzero's id, value and row id (12 B), each
    # label (4 B); 4 FLOPs a nonzero, 12 an example, 18 a key
    assert roofline.lr_step(2, 6, 4) == (4 * 16 + 6 * 12 + 2 * 4, 6 * 4 + 2 * 12 + 4 * 18)


def test_ftrl_delta_counts_by_hand():
    assert roofline.ftrl_delta(10) == (10 * 5 * 4, 10 * 18)


def test_least_seconds_takes_the_larger_bound():
    t, by = roofline.least_seconds(3.35e12, 1.0, H100)
    assert by == "bytes" and t == pytest.approx(1.0)
    t, by = roofline.least_seconds(1.0, 67e12 * 2, H100)
    assert by == "flops" and t == pytest.approx(2.0)


def test_spread_is_python_quartiles_over_median():
    v = [10.0, 11.0, 12.0, 13.0, 14.0, 30.0]
    q1, _, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / statistics.median(v))


def test_idle_share_from_synthetic_intervals():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (4.5, 6.0)]
    assert stats.busy(iv, 0.0, 5.0) == pytest.approx(3.5)
    assert stats.idle_share(iv, 0.0, 5.0) == pytest.approx(0.3)
    assert stats.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 4.5)]


def _trace_file(tmp_path: Path) -> Path:
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": 1000, "dur": 10000},
        {"ph": "X", "cat": "cpu_op", "name": "aten::unique", "ts": 4000, "dur": 3000},
        {"ph": "X", "cat": "kernel", "name": "ftrl_delta_kernel", "ts": 1000, "dur": 1000},
        {"ph": "X", "cat": "kernel", "name": "indexFuncLargeIndex", "ts": 1500, "dur": 2000},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 8000, "dur": 1000},
        {"ph": "X", "cat": "gpu_user_annotation", "name": WINDOW, "ts": 1000, "dur": 10000},
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    return p


def test_device_trace_reads_busy_kernels_and_gaps(tmp_path):
    tr = DeviceTrace.read(_trace_file(tmp_path))
    assert tr.window_s == pytest.approx(0.01)
    assert tr.busy_s() == pytest.approx(0.0035)
    assert tr.kernel_s("ftrl_delta_kernel") == (pytest.approx(0.001), 1)
    bd = tr.breakdown()
    assert bd["device_ops"][0][0] == "indexFuncLargeIndex"
    assert bd["idle_gaps"][0] == ["aten::unique", pytest.approx(0.0045)]
    assert bd["idle_gaps"][1][1] == pytest.approx(0.002)


def test_per_layer_readers_on_a_synthetic_run(tmp_path):
    tr = DeviceTrace.read(_trace_file(tmp_path))
    cell = load_cell("lr.cached_b8192")
    ctx = {"trace": tr, "steps": 2, "lr_steps": [(2, 6, 4), (2, 6, 4)]}
    got = read_per_layer(cell, ctx)
    assert got["step_device_ms"]["value"] == pytest.approx(3.5 / 2)
    assert got["device_idle"]["value"] == pytest.approx(65.0)
    least, _ = roofline.least_seconds(2 * 5 * 4 * 4, 2 * 4 * 18, H100)
    assert got["k2_roofline"]["value"] == pytest.approx(100 * least / 0.001)
    b, f = roofline.lr_step(2, 6, 4)
    least, _ = roofline.least_seconds(2 * b, 2 * f, H100)
    assert got["step_mfu"]["value"] == pytest.approx(100 * least / 0.01)


def keeps_the_contract(root: Path) -> None:
    """``<root>/BENCHMARK.json`` keeps the contract's shape, and every app
    that a configuration names brings ``run``, ``control``, its CPU size
    ``TINY`` and at least one fault in ``FAULTS``."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51 and isinstance(spec["run_seconds"], int)
    cells = 2 + 14 * 24
    assert cells * (spec["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for p in spec["paths"]:
        assert (root / p).is_dir() and not p.startswith("/") and ".." not in p
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (root / c["file"]).is_file() and c["file"].startswith("psbench/")
        cfg = json.loads((root / c["file"]).read_text())
        assert all(k in cfg for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in spec["workloads"]), c["name"]
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in spec["workloads"]:
        assert w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (root / "psbench" / "traffic" / f"{w['traffic']}.json").is_file()
        reports = [m for m in spec["per_layer"] if w["name"] in m["workloads"]]
        assert reports, w["name"]
        app = app_module(load_cell(w["name"], root))
        for name in ("run", "control", "TINY", "FAULTS"):
            assert hasattr(app, name), f"{app.__name__} defines no {name}"
        assert callable(app.run) and callable(app.control) and isinstance(app.TINY, dict)
        assert isinstance(app.FAULTS, dict) and app.FAULTS, f"{app.__name__}: FAULTS is empty"
        assert all(callable(plant) for plant in app.FAULTS.values()), app.__name__
    for m in spec["end_to_end"] + spec["per_layer"] + spec["workloads"] + spec["configs"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert (root / "psbench" / "metrics" / f"{m['name']}.py").is_file()
        for w in m["workloads"]:
            moved = next(x for x in spec["end_to_end"] if x["name"] == m["moves"])
            assert "workloads" not in moved or w in moved["workloads"]
    assert len((root / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_benchmark_json_keeps_the_contract():
    keeps_the_contract(ROOT)


def _copy(root: Path) -> None:
    shutil.copytree(ROOT / "psbench", root / "psbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")


@pytest.mark.parametrize("tail", ["del FAULTS", "FAULTS = {}"], ids=["missing", "empty"])
def test_an_app_without_faults_breaks_the_contract(tmp_path, tail):
    _copy(tmp_path)
    app = tmp_path / "psbench/apps/linear_1chip.py"
    app.write_text(app.read_text() + f"\n{tail}\n")
    with pytest.raises(AssertionError, match="FAULTS"):
        keeps_the_contract(tmp_path)


def test_a_new_config_mix_and_metric_need_only_files_and_entries(tmp_path):
    """Copy the benchmark, add a configuration, a mix, a per-layer metric
    and a cell by new files and entries alone, and run the cell."""
    _copy(tmp_path)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "psbench/configs/criteo1tb_lr_1chip.json").read_text())
    cfg.update(name="tiny_lr", num_keys=1 << 14, categorical_vocab=[1000] * 26)
    (tmp_path / "psbench/configs/tiny_lr.json").write_text(json.dumps(cfg))
    (tmp_path / "psbench/traffic/cached_b128.json").write_text(
        json.dumps({"batch_size": 128, "batches": 4}))
    (tmp_path / "psbench/metrics/steps_in_window.py").write_text(
        "def read(ctx):\n    return ctx.get('steps')\n")
    spec["configs"].append({"name": "tiny_lr", "source": "a test", "reduced": [],
                            "file": "psbench/configs/tiny_lr.json", "why": "a test"})
    spec["workloads"].append({"name": "lr.tiny", "config": "tiny_lr",
                              "traffic": "cached_b128", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "steps_in_window", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "step",
                              "moves": "examples_per_s", "workloads": ["lr.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    out = run_cell("lr.tiny", 3, 0.5, True, device="cpu", root=tmp_path)
    assert out["correct"], out["checks"]
    assert out["metrics"]["steps_in_window"]["value"] >= 1
    assert math.isfinite(out["metrics"]["steps_in_window"]["value"])
    out = run_cell("lr.tiny", 3, 0.5, False, device="cpu", root=tmp_path)
    assert set(out["metrics"]) == {"examples_per_s", "setup_s"}


SECOND = Path(__file__).resolve().parent / "second_app"
DENSE = "dense.b4096"


@pytest.fixture
def second_model_root(tmp_path, monkeypatch):
    """A copy of the benchmark with a cell of a second model, dense logistic
    regression (``second_app/``), added by new files and entries alone: an
    app, its reference, a configuration, a mix, a reader and a cell."""
    _copy(tmp_path)
    for part in ("apps", "reference", "configs", "traffic", "metrics"):
        shutil.copytree(SECOND / part, tmp_path / "psbench" / part, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for key, entries in json.loads((SECOND / "entries.json").read_text()).items():
        spec[key] += entries
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    # this process imported psbench from the repo: its reference package
    # takes the copy's new module, as a checkout's psbench would hold it
    name = "psbench.reference.dense_lr"
    s = importlib.util.spec_from_file_location(name, tmp_path / "psbench/reference/dense_lr.py")
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    monkeypatch.setitem(sys.modules, name, mod)
    return tmp_path


def test_a_second_model_is_held_to_its_own_checks(second_model_root, monkeypatch):
    """The shared cell checks on the copy: the second model's cell agrees
    with its own reference, its own fault and its control each make it not
    correct, and none of ``LinearMethod``'s faults is planted in it."""
    from parameter_server_tpu_torch.models import linear as L

    root = second_model_root
    keeps_the_contract(root)
    cases = cell_faults(root)
    assert [f for c, f in cases if c == DENSE] == list(app_of(DENSE, root).FAULTS)
    assert [f for c, f in cases if c == "lr.cached_b8192"] == list(
        app_of("lr.cached_b8192", root).FAULTS)
    assert not {f for c, f in cases if c == DENSE} & set(app_of("lr.cached_b8192", root).FAULTS)
    check_agrees(DENSE, root)
    check_control(DENSE, root)
    port = (L.train_step, L.logistic_loss)
    for c, fault in cases:
        if c == DENSE:
            with monkeypatch.context() as mp:
                check_fault(DENSE, fault, mp, root)
                assert (L.train_step, L.logistic_loss) == port
    out = run_cell(DENSE, 5, 0.3, True, device="cpu", root=root,
                   overrides=dict(app_of(DENSE, root).TINY))
    assert out["correct"] and set(out["metrics"]) == {"dense_steps"}
    assert out["metrics"]["dense_steps"]["value"] == out["attempted"] > 0
