"""Port parity for the column-block cache (``data/blockcache.py``) and ``cli
convert``, on the CPU. Mirrors tests/test_blockcache.py, plus the cache
shared across packages: a cache written by either package's ``convert``
loads in the other (same ``.npy`` names, ``meta.json``, CACHE_VERSION and
fingerprint), and darlin trained from it gives the run that parses. The
arrays are copies, so they compare exactly; darlin's results from a cache
and from a parse compare exactly too (the same arrays, the same sums)."""

import json
import os

import numpy as np
import pytest

from parameter_server_tpu import cli as JC
from parameter_server_tpu.data import blockcache as JBC
from parameter_server_tpu_torch import cli as TC
from parameter_server_tpu_torch.data import reader as reader_mod
from parameter_server_tpu_torch.data.blockcache import (
    CACHE_VERSION,
    ColumnBlocks,
    cached_column_blocks,
    load_column_blocks,
    save_column_blocks,
    source_fingerprint,
)
from parameter_server_tpu_torch.data.synthetic import make_sparse_logistic, write_libsvm
from parameter_server_tpu_torch.models.darlin import Darlin
from parameter_server_tpu_torch.utils.config import PSConfig
from parameter_server_tpu_torch.utils.metrics import ProgressReporter

NUM_KEYS = 128


def _write_data(tmp_path, n=300, seed=0, name="train.svm"):
    labels, keys, vals, _ = make_sparse_logistic(n, NUM_KEYS - 2, nnz_per_example=8,
                                                 seed=seed)
    p = tmp_path / name
    write_libsvm(p, labels, keys, vals)
    return p


def _cfg(files, cache_dir=""):
    cfg = PSConfig()
    cfg.data.files = [str(f) for f in files]
    cfg.data.num_keys = NUM_KEYS
    cfg.data.cache_dir = str(cache_dir)
    cfg.solver.algo = "darlin"
    cfg.solver.feature_blocks = 4
    cfg.solver.block_iters = 10
    cfg.solver.minibatch = 64
    cfg.penalty.lambda_l1 = 0.5
    return cfg


def _blocks_equal(a, b):
    for f in ("feat_local", "rows", "values", "labels"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (a.num_keys, a.block_size, a.num_examples) == (b.num_keys, b.block_size,
                                                          b.num_examples)


def _quiet():
    return ProgressReporter(print_fn=lambda *_: None)


class TestSaveLoad:
    def test_roundtrip(self, tmp_path):
        p = _write_data(tmp_path)
        cb = cached_column_blocks(_cfg([p]))  # no cache dir: plain build
        save_column_blocks(tmp_path / "cache", cb, "fp0")
        loaded = load_column_blocks(tmp_path / "cache", "fp0")
        assert loaded is not None
        _blocks_equal(cb, loaded)
        assert isinstance(loaded.values, np.memmap)

    def test_missing_and_stale(self, tmp_path):
        assert load_column_blocks(tmp_path / "nope") is None
        p = _write_data(tmp_path)
        cb = cached_column_blocks(_cfg([p]))
        save_column_blocks(tmp_path / "c", cb, "fp0")
        assert load_column_blocks(tmp_path / "c", "other-fp") is None
        (tmp_path / "c" / "values.npy").unlink()
        assert load_column_blocks(tmp_path / "c", "fp0") is None

    def test_corrupt_sidecar_is_a_cache_miss(self, tmp_path):
        p = _write_data(tmp_path)
        cb = cached_column_blocks(_cfg([p]))
        save_column_blocks(tmp_path / "c", cb, "fp0")
        meta = tmp_path / "c" / "meta.json"
        meta.write_text(meta.read_text()[: len(meta.read_text()) // 2])
        assert load_column_blocks(tmp_path / "c", "fp0") is None
        meta.write_text('{"version": 1}')
        assert load_column_blocks(tmp_path / "c") is None

    def test_fingerprint_equals_jax_and_tracks_sources(self, tmp_path):
        p = _write_data(tmp_path)
        fp1 = source_fingerprint([str(p)], "libsvm", NUM_KEYS, 4, 512)
        assert fp1 == JBC.source_fingerprint([str(p)], "libsvm", NUM_KEYS, 4, 512)
        assert CACHE_VERSION == JBC.CACHE_VERSION
        assert fp1 != source_fingerprint([str(p)], "libsvm", NUM_KEYS, 8, 512)
        os.utime(p, ns=(1, 1))
        assert fp1 != source_fingerprint([str(p)], "libsvm", NUM_KEYS, 4, 512)
        with pytest.raises(FileNotFoundError):
            source_fingerprint(["/no/such/file"], "libsvm", NUM_KEYS, 4, 512)


class TestCachedColumnBlocks:
    def test_blocks_equal_jax(self, tmp_path):
        p = _write_data(tmp_path, n=500)
        from parameter_server_tpu.utils.config import PSConfig as JCfg

        jcfg = JCfg()
        for sec in ("data", "solver", "penalty"):
            for k, v in vars(getattr(_cfg([p]), sec)).items():
                setattr(getattr(jcfg, sec), k, v)
        _blocks_equal(cached_column_blocks(_cfg([p])), JBC.cached_column_blocks(jcfg))

    def test_second_call_skips_parsing(self, tmp_path, monkeypatch):
        p = _write_data(tmp_path)
        cfg = _cfg([p], cache_dir=tmp_path / "cache")
        first = cached_column_blocks(cfg)

        def boom(*a, **k):
            raise AssertionError("cache hit must not re-parse")

        monkeypatch.setattr(reader_mod.MinibatchReader, "__init__", boom)
        _blocks_equal(first, cached_column_blocks(cfg))

    def test_rewrite_invalidates(self, tmp_path):
        p = _write_data(tmp_path, seed=0)
        cfg = _cfg([p], cache_dir=tmp_path / "cache")
        first = cached_column_blocks(cfg)
        _write_data(tmp_path, seed=1)
        second = cached_column_blocks(cfg)
        assert not np.array_equal(np.asarray(first.labels), np.asarray(second.labels))

    def test_darlin_same_result_from_cache(self, tmp_path):
        p = _write_data(tmp_path)
        cfg = _cfg([p], cache_dir=tmp_path / "cache")
        r1 = Darlin(cfg, reporter=_quiet(), device="cpu").fit_blocks(
            cached_column_blocks(cfg), shuffle_blocks=False)
        r2 = Darlin(cfg, reporter=_quiet(), device="cpu").fit_blocks(
            cached_column_blocks(cfg), shuffle_blocks=False)
        assert r1["history"] == r2["history"] and r1["nnz_w"] == r2["nnz_w"]


# --- convert, across packages ---------------------------------------------------


def _app_file(tmp_path, files, cache_dir="") -> str:
    cfg = {"app": "linear_method",
           "data": {"files": [str(f) for f in files], "num_keys": NUM_KEYS,
                    "cache_dir": str(cache_dir)},
           "solver": {"algo": "darlin", "feature_blocks": 4, "block_iters": 8,
                      "minibatch": 64},
           "penalty": {"lambda_l1": 0.5}}
    p = tmp_path / f"cfg{len(list(tmp_path.glob('cfg*.json')))}.json"
    p.write_text(json.dumps(cfg))
    return str(p)


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_convert_cache_loads_in_the_other_package(tmp_path, capsys, writer):
    """One package's ``convert`` writes the cache; both packages' loaders
    read it (fingerprint hit) with the arrays of a parse."""
    files = [_write_data(tmp_path, n=200, seed=s, name=f"p{s}.svm") for s in (0, 1)]
    cache = tmp_path / "cache"
    app_file = _app_file(tmp_path, files, cache)
    main = JC.main if writer == "jax" else TC.main
    assert main(["convert", "--app_file", app_file]) == 0
    out = _last_json(capsys)
    assert out == {"cache_dir": str(cache), "num_examples": 400, "n_blocks": 4,
                   "block_size": NUM_KEYS // 4, "entries": out["entries"]}
    meta = json.loads((cache / "meta.json").read_text())
    assert meta["nnz"] == out["entries"] and meta["version"] == CACHE_VERSION
    fp = source_fingerprint(files, "libsvm", NUM_KEYS, 4, 512)  # the config default
    port_cb, jax_cb = load_column_blocks(cache, fp), JBC.load_column_blocks(cache, fp)
    assert port_cb is not None and jax_cb is not None
    parsed = cached_column_blocks(_cfg(files))
    _blocks_equal(port_cb, parsed)
    _blocks_equal(jax_cb, parsed)


def test_cli_train_from_cache_does_not_parse(tmp_path, capsys, monkeypatch):
    files = [_write_data(tmp_path, n=250, seed=3)]
    cache = tmp_path / "cache"
    assert TC.main(["convert", "--app_file", _app_file(tmp_path, files, cache)]) == 0
    capsys.readouterr()
    assert TC.main(["train", "--app_file", _app_file(tmp_path, files), "--device",
                    "cpu"]) == 0
    parsed = _last_json(capsys)

    def boom(*a, **k):
        raise AssertionError("a cache hit must not parse")

    monkeypatch.setattr(reader_mod.MinibatchReader, "__init__", boom)
    assert TC.main(["train", "--app_file", _app_file(tmp_path, files, cache), "--device",
                    "cpu"]) == 0
    assert _last_json(capsys) == parsed


def test_convert_cache_dir_flag_and_refusals(tmp_path, capsys):
    files = [_write_data(tmp_path, n=120)]
    app_file = _app_file(tmp_path, files)
    with pytest.raises(SystemExit, match="cache_dir"):
        TC.main(["convert", "--app_file", app_file])
    assert TC.main(["convert", "--app_file", app_file, "--cache_dir",
                    str(tmp_path / "c2")]) == 0
    out = _last_json(capsys)
    assert "warning" in out and out["num_examples"] == 120
    assert (tmp_path / "c2" / "meta.json").exists()
    cmds = next(a.choices for a in TC._build_parser()._actions
                if isinstance(a.choices, dict) and "convert" in a.choices)
    assert "convert" in cmds
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"data": {"cache_dir": str(tmp_path / "c3")}}))
    with pytest.raises(SystemExit, match="files"):
        TC.main(["convert", "--app_file", str(empty)])


def test_column_blocks_is_the_jax_dataclass_layout():
    assert [f for f in ColumnBlocks.__dataclass_fields__] == [
        f for f in JBC.ColumnBlocks.__dataclass_fields__]
