"""The port's pslint over whole trees.

Over the JAX package's tree the port's analyzer must see what the JAX
analyzer sees: the same findings, the same lock graph (edges and
construction sites), the same counter inventory and config usage, and the
same wire-protocol tables. The only findings allowed to differ are those
through the names the port adds to the blocking checker (the torch
primitives), listed in ``PORT_ONLY`` (none on the JAX tree today). Over
the port's own tree it must be clean, with a non-empty acyclic lock graph
and the shard server discovered as an in-place publisher; the module
entry exits 0 on it. Each tree is analysed once per module."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

import parameter_server_tpu.analysis as J
import parameter_server_tpu_torch.analysis as P
from parameter_server_tpu.analysis import wireproto as j_wire
from parameter_server_tpu_torch.analysis import wireproto as p_wire
from parameter_server_tpu_torch.analysis.blocking import BLOCKING_ATTRS, BLOCKING_MODULE_ATTRS
from parameter_server_tpu_torch.analysis.rcu import discover_inplace_publishers

ROOT = Path(__file__).resolve().parent.parent
JAX_TREE = ROOT / "parameter_server_tpu"
PORT_TREE = ROOT / "parameter_server_tpu_torch"

#: (checker, path, line) of findings the port's analyzer gives on the JAX
#: tree through the names it adds to the blocking checker
PORT_ONLY: list[tuple[str, str, int]] = []

#: the blocking names the port adds to the JAX checker's
_ADDED_NAMES = (
    {"item", "tolist", "cpu", "numpy", "nonzero", "synchronize", "cuda", "CDLL",
     "communicate", "to"} | set().union(*BLOCKING_MODULE_ATTRS.values())
)


def _tree(pkg, root: Path) -> dict:
    """Everything the parity compares, from one analysis of ``root``."""
    index = pkg.load_package(root, pkg._default_config(root))
    chk = {i: pkg.CHECKERS[i] for i in P.CHECKERS}
    findings = pkg.run_checkers(index, chk, index.config)
    lg = pkg.build_lock_graph(index)
    return {
        "index": index,
        "findings": [(f.checker, f.path, f.line, f.message) for f in findings],
        "edges": dict(lg.edges),
        "sites": dict(lg.sites),
        "cycles": lg.cycles(),
        "counters": pkg.counter_inventory(index),
        "config": pkg.config_key_usage(index),
    }


@pytest.fixture(scope="module")
def jax_by_jax():
    return _tree(J, JAX_TREE)


@pytest.fixture(scope="module")
def jax_by_port():
    return _tree(P, JAX_TREE)


@pytest.fixture(scope="module")
def port_by_port():
    return _tree(P, PORT_TREE)


def test_findings_on_the_jax_tree_equal_the_jax_analyzers(jax_by_jax, jax_by_port):
    jf, pf = set(jax_by_jax["findings"]), set(jax_by_port["findings"])
    assert jf - pf == set()
    extra = sorted(f[:3] for f in pf - jf)
    assert extra == PORT_ONLY
    for f in pf - jf:  # each one through a name the port added
        assert f[0] == "blocking-under-lock"
        assert any(f"{n}(" in f[3] for n in _ADDED_NAMES), f


def test_lock_graph_on_the_jax_tree_equals_the_jax_analyzers(jax_by_jax, jax_by_port):
    assert jax_by_port["edges"] == jax_by_jax["edges"]
    assert jax_by_port["sites"] == jax_by_jax["sites"]
    assert len(jax_by_port["sites"]) >= 10 and jax_by_port["cycles"] == []


def test_inventories_on_the_jax_tree_equal_the_jax_analyzers(jax_by_jax, jax_by_port):
    assert jax_by_port["counters"] == jax_by_jax["counters"]
    assert jax_by_port["config"] == jax_by_jax["config"]
    assert "window" in jax_by_port["config"]["wire"]


def _codec(index, wire):
    f = index.get("parallel/control.py")
    fns = {n.name: n for n in ast.walk(f.tree) if isinstance(n, ast.FunctionDef)}
    return (wire.encode_table(fns["_encode_bin_header"]),
            wire.decode_table(fns["_decode_bin_header"]),
            wire._mask_members(f.tree)[0])


def test_wireproto_tables_on_the_jax_tree_equal_the_jax_analyzers(jax_by_jax, jax_by_port):
    got = _codec(jax_by_port["index"], p_wire)
    assert got == _codec(jax_by_jax["index"], j_wire)
    enc, dec, mask = got
    assert enc["ver"] == dec["ver"] and mask == {
        "_BF2_VER", "_BF2_IF_NEWER", "_BF2_NOT_MODIFIED"}


def test_the_ports_codec_tables_equal_the_jax_packages(jax_by_jax, port_by_port):
    """The port's wire is the JAX wire, byte for byte: its derived slot
    tables are the JAX tree's."""
    assert _codec(port_by_port["index"], p_wire) == _codec(jax_by_jax["index"], j_wire)


def test_the_ports_tree_is_clean(port_by_port):
    assert port_by_port["findings"] == [], "\n".join(
        f"{p}:{ln}: [{c}] {m}" for c, p, ln, m in port_by_port["findings"])


def test_the_ports_lock_graph_is_nonvacuous_and_acyclic(port_by_port):
    edges = port_by_port["edges"]
    assert len(port_by_port["sites"]) >= 10 and port_by_port["cycles"] == []
    # the apply lock is taken before the publish lock, never the reverse
    assert ("ShardServer._lock", "ShardServer._pub_lock") in edges
    assert ("ShardServer._pub_lock", "ShardServer._lock") not in edges


def test_shard_server_is_an_inplace_publisher(port_by_port):
    (pub,) = [p for p in discover_inplace_publishers(port_by_port["index"])
              if p.cls == "ShardServer"]
    assert (pub.setter, pub.pub_lock) == ("_publish", "_pub_lock")
    assert pub.apply_locks == {"_lock"} and pub.stamps == {"_version", "_pts"}
    assert {"_publish", "_table_weights"} <= pub.caller_held


def test_the_blocking_names_keep_the_jax_ones():
    from parameter_server_tpu.analysis.blocking import BLOCKING_ATTRS as J_ATTRS

    assert J_ATTRS <= BLOCKING_ATTRS


def test_module_entry_exits_zero_on_the_port():
    r = subprocess.run(
        [sys.executable, "-m", "parameter_server_tpu_torch.analysis"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 finding(s)" in r.stdout and "17 checker(s)" in r.stdout
