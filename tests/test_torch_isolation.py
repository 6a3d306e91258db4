"""The port stands alone: it imports with JAX absent, loads no module of the
JAX package, and its entry points run on the card by default (and raise
where there is none). ``chip_smoke.py`` is held to the same rule."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = "parameter_server_tpu_torch"
#: pslint's modules, the lock-order witness, psmc (the model checker, its
#: specs and their conformance to the code), the schedule explorer and the
#: race witness, beside the monitors
ANALYSIS_MODULES = (
    "core.py", "callgraph.py", "dataflow.py", "flowrun.py", "lockgraph.py",
    "blocking.py", "settle.py", "contracts.py", "replycache.py", "tracehygiene.py",
    "rcu.py", "wireproto.py", "quantity.py", "flightreccontract.py", "witness.py",
    "model.py", "conformance.py", "explorer.py", "racewitness.py",
    "specs/__init__.py", "specs/exactly_once.py", "specs/rcu.py", "specs/sspclock.py",
    "specs/failover.py",
)


def _analysis_module(path: str) -> str:
    """``specs/rcu.py`` -> ``parameter_server_tpu_torch.analysis.specs.rcu``."""
    mod = path.removesuffix(".py").removesuffix("/__init__").replace("/", ".")
    return f"{PKG}.analysis.{mod}"

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import parameter_server_tpu_torch as pkg
names = [pkg.__name__] + [
    m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
]
for name in names:
    importlib.import_module(name)
leaked = sorted(
    m for m in sys.modules
    if m == "parameter_server_tpu" or m.startswith("parameter_server_tpu.")
)
jax_loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                    if sys.modules[m] is not None)
print(json.dumps({"imported": names, "leaked": leaked, "jax": jax_loaded}))
"""


def test_port_imports_without_jax_or_the_jax_package():
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120, check=True,
    )
    res = json.loads(out.stdout.strip().splitlines()[-1])
    expected = {
        f"{PKG}.{p.relative_to(ROOT / PKG).with_suffix('').as_posix().replace('/', '.')}"
        for p in (ROOT / PKG).rglob("*.py")
    }
    expected = {e.removesuffix(".__init__") for e in expected}
    assert expected <= set(res["imported"]) | {PKG}
    # the SPMD tier, named so that losing a module from the walk shows here
    assert {f"{PKG}.parallel.{m}" for m in (
        "mesh", "runtime", "traffic", "spmd", "trainer", "ssp")} <= set(res["imported"])
    # the wire tier and the backends, and the copies they need
    assert {f"{PKG}.parallel.{m}" for m in (
        "control", "multislice", "backend", "meshbackend")} <= set(res["imported"])
    assert f"{PKG}.utils.keyrange" in res["imported"]
    # the live operations plane, the audit plane and the forensics tools
    assert {f"{PKG}.utils.{m}" for m in (
        "clock", "timeseries", "profiler", "slo", "auditor", "postmortem")} <= set(
        res["imported"])
    assert {f"{PKG}.analysis.monitors", f"{PKG}.analysis.critpath"} <= set(res["imported"])
    # pslint, its module entry, the lock-order witness, psmc, the explorer
    # and the race witness
    assert {_analysis_module(m) for m in ANALYSIS_MODULES} | {
        f"{PKG}.analysis.__main__"} <= set(res["imported"])
    # chaos and the serving plane's client cache
    assert {f"{PKG}.parallel.chaos", f"{PKG}.filters.keycache"} <= set(res["imported"])
    # the control plane and the cluster's entry points, and their copies
    assert {f"{PKG}.utils.heartbeat", f"{PKG}.parallel.workload", f"{PKG}.cli"} <= set(
        res["imported"])
    # the batch solver, its block cache, and the sketch and graph apps
    assert {f"{PKG}.models.{m}" for m in ("darlin", "graph_partition", "sketch")} | {
        f"{PKG}.data.blockcache"} <= set(res["imported"])
    # the native parser's bindings and the tracing and black-box planes
    assert {f"{PKG}.data.native", f"{PKG}.utils.trace", f"{PKG}.utils.flightrec"} <= set(
        res["imported"])
    assert res["leaked"] == []
    assert res["jax"] == []


def test_cluster_entry_points_stand_alone():
    """The coordinator, its client, the node entry points and the CLI's
    ``node`` / ``launch`` live in the port, with JAX absent."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    probe = (
        'import sys, json; sys.modules["jax"] = None\n'
        "from parameter_server_tpu_torch.parallel.control import Coordinator, ControlClient\n"
        "from parameter_server_tpu_torch.parallel.multislice import (launch_local, run_node,\n"
        "    run_scheduler, run_server, run_worker)\n"
        "from parameter_server_tpu_torch.parallel.ssp import PushWindow\n"
        "from parameter_server_tpu_torch.utils.heartbeat import HeartbeatMonitor\n"
        "from parameter_server_tpu_torch import cli\n"
        "cmds = next(a.choices for a in cli._build_parser()._actions\n"
        "            if isinstance(a.choices, dict) and 'node' in a.choices)\n"
        "assert {'node', 'launch', 'check', 'verify', 'explore'} <= set(cmds)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "    ('parameter_server_tpu', 'jax') and sys.modules[m] is not None)))\n"
    )
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_chaos_and_serving_modules_stand_alone():
    """``parallel/chaos.py`` and ``filters/keycache.py`` are the port's own
    copies: with JAX absent they import, a plan decides and a cache
    serves, and no JAX-package module loads."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    probe = (
        'import sys, json; sys.modules["jax"] = None\n'
        "import numpy as np\n"
        "from parameter_server_tpu_torch.parallel.chaos import FaultPlan, PLAN_ENV\n"
        "from parameter_server_tpu_torch.filters.keycache import ClientKeyCache\n"
        "from parameter_server_tpu_torch.parallel.multislice import ServerHandle, ShardServer\n"
        "assert PLAN_ENV == 'PS_FAULT_PLAN'\n"
        "assert FaultPlan.parse('drop,every=1').decide('push').action == 'drop'\n"
        "kc = ClientKeyCache()\n"
        "kc.put((0, 's'), np.arange(3), np.ones((3, 1), np.float32), 7)\n"
        "assert kc.lookup((0, 's')).version == 7\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "    ('parameter_server_tpu', 'jax') and sys.modules[m] is not None)))\n"
    )
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


_SMOKE_PROBE = r"""
import ast, importlib, json, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.path.insert(0, ".")
imported = ["chip_smoke"]
importlib.import_module("chip_smoke")
tree = ast.parse(open("chip_smoke.py").read())
for node in ast.walk(tree):  # every import, those inside functions too
    if isinstance(node, ast.Import):
        for a in node.names:
            importlib.import_module(a.name)
            imported.append(a.name)
    elif isinstance(node, ast.ImportFrom):
        mod = importlib.import_module(node.module)
        imported.append(node.module)
        for a in node.names:
            if not hasattr(mod, a.name):  # a submodule, not a name in mod
                importlib.import_module(f"{node.module}.{a.name}")
            imported.append(f"{node.module}.{a.name}")
leaked = sorted(
    m for m in sys.modules
    if m == "parameter_server_tpu" or m.startswith("parameter_server_tpu.")
)
jax_loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                    if sys.modules[m] is not None)
print(json.dumps({"imported": imported, "leaked": leaked, "jax": jax_loaded}))
"""


def test_chip_smoke_imports_nothing_of_jax():
    """Every module ``chip_smoke.py`` imports, at the top and inside its
    functions, loads with JAX absent and loads no JAX-package module."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run(
        [sys.executable, "-c", _SMOKE_PROBE], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120, check=True,
    )
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "chip_smoke" in res["imported"]
    assert f"{PKG}.filters.fixed_point" in res["imported"]
    assert res["leaked"] == []
    assert res["jax"] == []


def test_spmd_tier_has_the_ssp_clock_without_jax():
    """``SSPClock`` sits in the port's ``parallel/ssp.py`` beside the
    dispatch window, a copy with no hook into the JAX package: its
    flight-recorder events go to the port's own recorder, its blocked
    time and realized lag to the port's own telemetry."""
    import parameter_server_tpu_torch.parallel.ssp as ssp

    src = Path(ssp.__file__).read_text()
    assert "class SSPClock" in src and "parameter_server_tpu." not in src
    assert "from parameter_server_tpu_torch.utils import flightrec" in src
    assert ("from parameter_server_tpu_torch.utils.metrics import observe_scalar, "
            "wire_counters") in src


def test_port_sources_never_import_the_jax_package():
    for path in [*(ROOT / PKG).rglob("*.py"), ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1]
                assert mod != "jax" and not mod.startswith("jax."), (path, line)
                assert mod.split(".")[0] != "parameter_server_tpu", (path, line)


def test_port_sources_name_no_jax_package_module():
    """Not even as a string: a ``sys.modules`` lookup of a JAX package
    module (the profiler hook of the telemetry snapshot, the race
    witness) would read the JAX package's state, never the port's."""
    import re

    pat = re.compile(r"""parameter_server_tpu(\.|["'])""")
    for path in [*(ROOT / PKG).rglob("*.py"), ROOT / "chip_smoke.py"]:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            assert not pat.search(line), (path, n, line)
    import parameter_server_tpu_torch.utils.metrics as metrics

    msrc = Path(metrics.__file__).read_text()
    assert "parameter_server_tpu_torch.utils.profiler" in msrc
    assert "parameter_server_tpu_torch.analysis.racewitness" in msrc
    # the analysis subpackage: the two monitors the runtime reads, pslint,
    # the lock-order witness, psmc, the explorer and the race witness —
    # the JAX package's analysis subpackage, module for module
    tree = sorted(p.relative_to(ROOT / PKG / "analysis").as_posix()
                  for p in (ROOT / PKG / "analysis").rglob("*.py"))
    assert tree == sorted([
        "__init__.py", "__main__.py", "critpath.py", "monitors.py", *ANALYSIS_MODULES])
    jax_tree = ROOT / "parameter_server_tpu" / "analysis"
    assert tree == sorted(p.relative_to(jax_tree).as_posix() for p in jax_tree.rglob("*.py"))


def test_entry_points_default_to_cuda():
    from parameter_server_tpu_torch.kv.store import KVStore
    from parameter_server_tpu_torch.kv.updaters import Ftrl
    from parameter_server_tpu_torch.models.linear import LinearMethod
    from parameter_server_tpu_torch.models.matrix_fac import MatrixFactorization
    from parameter_server_tpu_torch.models.wide_deep import WideDeep
    from parameter_server_tpu_torch.models.word2vec import Word2Vec
    from parameter_server_tpu_torch.utils.config import PSConfig

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    cfg = PSConfig()
    cfg.data.num_keys = 64
    with pytest.raises(RuntimeError, match="cuda"):
        LinearMethod(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        KVStore(Ftrl(), 64)
    with pytest.raises(RuntimeError, match="cuda"):
        MatrixFactorization(8, 8, rank=4)
    with pytest.raises(RuntimeError, match="cuda"):
        WideDeep(64, emb_dim=4)
    with pytest.raises(RuntimeError, match="cuda"):
        WideDeep.from_config(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        Word2Vec(64, dim=4)
    assert LinearMethod(cfg, device="cpu").device == torch.device("cpu")
    assert MatrixFactorization(8, 8, rank=4, device="cpu").device == torch.device("cpu")
    assert WideDeep(64, emb_dim=4, device="cpu").device == torch.device("cpu")
    assert Word2Vec(64, dim=4, device="cpu").device == torch.device("cpu")
    from parameter_server_tpu_torch.models.darlin import Darlin
    from parameter_server_tpu_torch.models.graph_partition import GraphPartition

    with pytest.raises(RuntimeError, match="cuda"):
        Darlin(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        GraphPartition(cfg)
    assert GraphPartition(cfg, device="cpu").state["presence"].device == torch.device("cpu")
