"""The port stands alone: it imports with JAX absent, loads no module of the
JAX package, and its entry points run on the card by default (and raise
where there is none)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = "parameter_server_tpu_torch"

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
    assert res["leaked"] == []
    assert res["jax"] == []


def test_port_sources_never_import_the_jax_package():
    for path in (ROOT / PKG).rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1]
                assert mod != "jax" and not mod.startswith("jax."), (path, line)
                assert mod.split(".")[0] != "parameter_server_tpu", (path, line)


def test_entry_points_default_to_cuda():
    from parameter_server_tpu_torch.kv.store import KVStore
    from parameter_server_tpu_torch.kv.updaters import Ftrl
    from parameter_server_tpu_torch.models.linear import LinearMethod
    from parameter_server_tpu_torch.utils.config import PSConfig

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    cfg = PSConfig()
    cfg.data.num_keys = 64
    with pytest.raises(RuntimeError, match="cuda"):
        LinearMethod(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        KVStore(Ftrl(), 64)
    assert LinearMethod(cfg, device="cpu").device == torch.device("cpu")
