"""Port parity for the native (C++) parser: ``parameter_server_tpu_torch/
data/native.py`` over its copy of ``native/parser.cpp``.

Mirrors the JAX package's ``tests/test_native.py`` case for case, with
the JAX package's Python parsers (``parameter_server_tpu.data.libsvm``) as
the golden reference: they are always there, so these tests do not
depend on the JAX package's own native build. Then the copy's bytes, the
port's build location, and the reader, ``iter_flat_rows`` and
``hash_localize`` against the JAX package."""

import ctypes
import dataclasses
import gzip
import random
import threading

import numpy as np
import pytest

from parameter_server_tpu.data import batch as JB
from parameter_server_tpu.data import reader as JR
from parameter_server_tpu.data.libsvm import iter_adfea, iter_criteo, iter_libsvm
from parameter_server_tpu.data.synthetic import make_sparse_logistic, write_libsvm
from parameter_server_tpu.utils.hashing import hash_keys
from parameter_server_tpu_torch.data import batch as TB
from parameter_server_tpu_torch.data import native
from parameter_server_tpu_torch.data import reader as TR

REPO = native._PKG.parent


@pytest.fixture(scope="module", autouse=True)
def _built():
    """The port's library builds here (g++ is part of the test machine);
    a failed build is a failure with g++'s output, not a skip."""
    assert native.native_available(), native.build_log()


def rows_from_flat(flat):
    labels, splits, keys, vals, slots = flat
    if slots is None:  # slotless formats elide the all-zero array
        slots = np.zeros(len(keys), dtype=np.uint64)
    out = []
    for i in range(len(labels)):
        s, e = splits[i], splits[i + 1]
        out.append((labels[i], keys[s:e], vals[s:e], slots[s:e]))
    return out


def assert_rows_equal(native_rows, python_rows):
    assert len(native_rows) == len(python_rows)
    for (ln, kn, vn, sn), (lp, kp, vp, sp) in zip(native_rows, python_rows):
        assert ln == lp
        np.testing.assert_array_equal(kn, kp)
        np.testing.assert_allclose(vn, vp, rtol=1e-6)
        np.testing.assert_array_equal(sn, sp)


class TestLibsvmParity:
    def test_parity_synthetic(self, tmp_path):
        labels, keys, vals, _ = make_sparse_logistic(500, 1000, nnz_per_example=10)
        p = tmp_path / "d.svm"
        write_libsvm(p, labels, keys, vals)
        flat = native.parse_chunk("libsvm", p.read_bytes())
        assert_rows_equal(rows_from_flat(flat), list(iter_libsvm(p)))

    def test_label_variants_and_blank_lines(self, tmp_path):
        p = tmp_path / "d.svm"
        p.write_text("+1 3:0.5\n\n-1 1:1 2:2.5e-1\n0 7:1\n1 9\n")
        rows = rows_from_flat(native.parse_chunk("libsvm", p.read_bytes()))
        assert [r[0] for r in rows] == [1.0, 0.0, 0.0, 1.0]
        assert rows[1][2][1] == pytest.approx(0.25)
        assert rows[3][1][0] == 9 and rows[3][2][0] == 1.0  # bare key -> 1.0
        assert_rows_equal(rows, list(iter_libsvm(p)))

    def test_no_trailing_newline(self):
        assert rows_from_flat(native.parse_chunk("libsvm", b"1 2:3"))[0][2][0] == 3.0

    def test_empty_value_does_not_cross_lines(self):
        """'k:' at EOL reads as value 1.0, never consumes the next line."""
        labels, _, keys, vals, _ = native.parse_chunk("libsvm", b"1 5:\n-1 7:2\n")
        np.testing.assert_array_equal(labels, [1.0, 0.0])
        np.testing.assert_array_equal(vals, [1.0, 2.0])
        _, _, keys, vals, _ = native.parse_chunk("libsvm", b"1 5: 6:2\n")
        np.testing.assert_array_equal(keys, [5, 6])
        np.testing.assert_array_equal(vals, [1.0, 2.0])

    def test_parse_error_reports_line(self):
        with pytest.raises(ValueError, match="line 1"):
            native.parse_chunk("libsvm", b"1 2:3\n1 junk:1\n")


def _criteo_file(tmp_path, n=200, seed=0):
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n):
        ints = ["" if rng.random() < 0.3 else str(int(rng.integers(-5, 10_000)))
                for _ in range(13)]
        cats = ["" if rng.random() < 0.3 else format(int(rng.integers(0, 2**32)), "x")
                for _ in range(26)]
        lines.append("\t".join([str(rng.integers(0, 2))] + ints + cats))
    p = tmp_path / "c.tsv"
    p.write_text("\n".join(lines) + "\n")
    return p


class TestCriteoParity:
    def test_parity_random(self, tmp_path):
        p = _criteo_file(tmp_path)
        flat = native.parse_chunk("criteo", p.read_bytes())
        assert_rows_equal(rows_from_flat(flat), list(iter_criteo(p)))

    def test_short_lines_skipped(self):
        assert len(native.parse_chunk("criteo", b"1\tjunk\n")[0]) == 0

    def test_malformed_fields_skipped_by_both_paths(self, tmp_path):
        """Junk like '3x7' / '12g3' is skipped whole, never prefix-parsed."""
        row = "\t".join(["1"] + ["3x7"] + ["5"] * 12 + ["12g3"] + ["ff"] * 25)
        p = tmp_path / "cx.tsv"
        p.write_text(row + "\n")
        nat = native.parse_chunk("criteo", (row + "\n").encode())
        py = list(iter_criteo(p))
        assert len(nat[2]) == len(py[0][1]) == 37
        np.testing.assert_array_equal(nat[2], py[0][1])


class TestAdfeaParity:
    def test_parity_random(self, tmp_path):
        rng = np.random.default_rng(3)
        lines = []
        for i in range(300):
            toks = [str(10000 + i), str(int(rng.integers(0, 2)))]
            toks += [f"{int(rng.integers(0, 2**40))}:{int(rng.integers(0, 64))}"
                     for _ in range(int(rng.integers(1, 30)))]
            lines.append(" ".join(toks))
        p = tmp_path / "p.adfea"
        p.write_text("\n".join(lines) + "\n")
        flat = native.parse_chunk("adfea", p.read_bytes())
        assert_rows_equal(rows_from_flat(flat), list(iter_adfea(p)))

    def test_edge_cases_match_python(self, tmp_path):
        p = tmp_path / "p.adfea"
        # id-only line skipped; non-numeric id fine; "k:" -> slot 0; CRLF ok
        p.write_bytes(b"5\nhash_x 1 3:2\r\n9 0 7: 8:4\n")
        flat = native.parse_chunk("adfea", p.read_bytes())
        assert_rows_equal(rows_from_flat(flat), list(iter_adfea(p)))
        with pytest.raises(ValueError, match="line 0"):
            native.parse_chunk("adfea", b"1 1 3:y\n")  # junk group id
        with pytest.raises(ValueError, match="line 0"):
            native.parse_chunk("adfea", b"1 zz 3:2\n")  # junk label

    def test_crlf_matches_python_all_formats(self, tmp_path):
        svm = tmp_path / "w.svm"
        svm.write_bytes(b"1 3:0.5 7:2\r\n-1 1:1\r\n")
        flat = native.parse_chunk("libsvm", svm.read_bytes())
        assert_rows_equal(rows_from_flat(flat), list(iter_libsvm(svm)))
        row = "\t".join(["1"] + [str(i) for i in range(13)] + ["ff"] * 26)
        tsv = tmp_path / "w.tsv"
        tsv.write_bytes((row + "\r\n" + row + "\r\n").encode())
        flat = native.parse_chunk("criteo", tsv.read_bytes())
        assert_rows_equal(rows_from_flat(flat), list(iter_criteo(tsv)))

    def test_lone_cr_matches_python(self, tmp_path):
        """Classic-Mac '\\r' terminators: Python's universal newlines split
        there, so the native side does too."""
        svm = tmp_path / "m.svm"
        svm.write_bytes(b"1 3:1\r-1 4:1\r")
        flat = native.parse_chunk("libsvm", svm.read_bytes())
        assert_rows_equal(rows_from_flat(flat), list(iter_libsvm(svm)))
        row = "\t".join(["1"] + [str(i) for i in range(13)] + ["ff"] * 26)
        tsv = tmp_path / "m.tsv"
        tsv.write_bytes((row + "\r" + row + "\r").encode())
        flat = native.parse_chunk("criteo", tsv.read_bytes())
        assert_rows_equal(rows_from_flat(flat), list(iter_criteo(tsv)))

    def test_many_lone_cr_rows(self, tmp_path):
        """The row capacity counts '\\r' rows too."""
        svm = tmp_path / "many.svm"
        svm.write_bytes(b"".join(f"1 {k}:1\r".encode() for k in range(3, 40)))
        flat = native.parse_chunk("libsvm", svm.read_bytes())
        assert len(flat[0]) == 37
        assert_rows_equal(rows_from_flat(flat), list(iter_libsvm(svm)))


class TestChunkedStreaming:
    def test_small_chunks_match_whole_file(self, tmp_path):
        labels, keys, vals, _ = make_sparse_logistic(300, 500, nnz_per_example=8)
        p = tmp_path / "d.svm"
        write_libsvm(p, labels, keys, vals)
        chunked = []
        for flat in native.iter_chunks(p, "libsvm", chunk_bytes=256):
            chunked.extend(rows_from_flat(flat))
        assert_rows_equal(chunked, list(iter_libsvm(p)))

    def test_cr_only_file_streams_in_chunks(self, tmp_path):
        """Lone-CR files stream (chunks cut at '\\r'), and a CRLF pair split
        across a chunk boundary makes no phantom blank row."""
        p = tmp_path / "mac.svm"
        p.write_bytes(b"".join(f"1 {k}:1\r".encode() for k in range(3, 120)))
        want = list(iter_libsvm(p))
        for nbytes in (7, 8, 9, 64):  # odd sizes land cuts on/next to '\r'
            chunked, n_chunks = [], 0
            for flat in native.iter_chunks(p, "libsvm", chunk_bytes=nbytes):
                chunked.extend(rows_from_flat(flat))
                n_chunks += 1
            assert n_chunks > 1  # streamed, not one EOF blob
            assert_rows_equal(chunked, want)
        crlf = tmp_path / "win.svm"
        crlf.write_bytes(b"".join(f"1 {k}:1\r\n".encode() for k in range(3, 120)))
        want = list(iter_libsvm(crlf))
        for nbytes in (7, 8, 9):
            chunked = []
            for flat in native.iter_chunks(crlf, "libsvm", chunk_bytes=nbytes):
                chunked.extend(rows_from_flat(flat))
            assert_rows_equal(chunked, want)

    def test_single_line_longer_than_buffer_grows(self, tmp_path):
        """One ~5 KB row streamed in 256-byte chunks: the buffer grows and
        the tail longer than the parsed prefix is carried."""
        line = "1 " + " ".join(f"{k}:1.5" for k in range(3, 603)) + "\n"
        p = tmp_path / "long.svm"
        p.write_text("0 7:2\n" + line + "0 9:3\n")
        chunked = []
        for flat in native.iter_chunks(p, "libsvm", chunk_bytes=256):
            chunked.extend(rows_from_flat(flat))
        assert len(chunked) == 3
        assert_rows_equal(chunked, list(iter_libsvm(p)))

    def test_gzip(self, tmp_path):
        p = tmp_path / "d.svm.gz"
        with gzip.open(p, "wt") as f:
            f.write("1 5:1.5\n0 2:1\n")
        rows = []
        for flat in native.iter_chunks(p, "libsvm"):
            rows.extend(rows_from_flat(flat))
        assert len(rows) == 2 and rows[0][1][0] == 5
        assert_rows_equal(rows, list(iter_libsvm(p)))


BATCH_FIELDS = [f.name for f in dataclasses.fields(JB.CSRBatch)]


def _same_batch(a, b):
    for f in BATCH_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert x == y, f


class TestReaderNativeBackend:
    def test_native_reader_matches_python_reader(self, tmp_path):
        """The port's native reader gives the JAX Python reader's batches,
        field for field."""
        labels, keys, vals, _ = make_sparse_logistic(500, 800, nnz_per_example=9)
        p = tmp_path / "d.svm"
        write_libsvm(p, labels, keys, vals)
        kw = dict(num_keys=1 << 14, batch_size=64)
        b_nat = list(TR.MinibatchReader([p], "libsvm", TB.BatchBuilder(**kw), backend="native"))
        b_py = list(JR.MinibatchReader([p], "libsvm", JB.BatchBuilder(**kw), backend="python"))
        assert sum(b.num_examples for b in b_nat) == 500
        assert len(b_nat) == len(b_py)
        for a, b in zip(b_nat, b_py):
            _same_batch(a, b)

    def test_nnz_capacity_respected(self, tmp_path):
        labels, keys, vals, _ = make_sparse_logistic(200, 300, nnz_per_example=20)
        p = tmp_path / "d.svm"
        write_libsvm(p, labels, keys, vals)
        kw = dict(num_keys=1 << 14, batch_size=64, max_nnz_per_example=8)
        builder = TB.BatchBuilder(**kw)
        got = list(TR.MinibatchReader([p], "libsvm", builder, backend="native"))
        for b in got:
            assert b.num_entries <= builder.nnz_capacity
            assert b.num_examples <= 64
        want = list(JR.MinibatchReader([p], "libsvm", JB.BatchBuilder(**kw), backend="python"))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same_batch(a, b)

    def test_epochs(self, tmp_path):
        labels, keys, vals, _ = make_sparse_logistic(50, 100, nnz_per_example=5)
        p = tmp_path / "d.svm"
        write_libsvm(p, labels, keys, vals)
        builder = TB.BatchBuilder(num_keys=1 << 12, batch_size=16)
        n = sum(b.num_examples for b in
                TR.MinibatchReader([p], "libsvm", builder, backend="native", epochs=3))
        assert n == 150


class TestHashLocalize:
    """``ps_hash_localize`` reproduces np.unique(hash_keys(...),
    return_inverse=True) of the JAX package bit for bit."""

    def test_matches_numpy_hash_path(self):
        rng = np.random.default_rng(3)
        for num_keys in (2, 1 << 10, 1 << 20, (1 << 31) - 7):
            raw = rng.integers(0, 1 << 62, 20000, dtype=np.uint64)
            slots = rng.integers(0, 40, 20000, dtype=np.uint64)
            for sl in (None, slots):
                got = native.hash_localize(raw, sl, num_keys)
                assert got is not None
                ru, ri = np.unique(
                    hash_keys(raw, num_keys, slot_ids=sl if sl is not None else 0),
                    return_inverse=True,
                )
                np.testing.assert_array_equal(got[0], ru)
                np.testing.assert_array_equal(got[1], ri)

    def test_identity_mode_and_fallbacks(self):
        rng = np.random.default_rng(4)
        raw = rng.integers(0, 1000, 5000, dtype=np.uint64)
        got = native.hash_localize(raw, None, 4096, identity=True)
        ru, ri = np.unique(raw.astype(np.int64) + 1, return_inverse=True)
        np.testing.assert_array_equal(got[0], ru)
        np.testing.assert_array_equal(got[1], ri)
        # an out-of-range identity key and >2^32 spaces decline: the numpy
        # path owns those cases, with the exact error message
        assert native.hash_localize(np.array([5000], np.uint64), None, 4096,
                                    identity=True) is None
        assert native.hash_localize(raw, None, 1 << 33) is None

    def test_float_fast_path_bit_parity(self):
        """Adversarial float literals are bit-identical to Python float()."""
        vals = [
            "1", "0.5", "-3.25", "1e5", "2.5E-3", "123456789.123456789",
            "9007199254740993", "1e-300", "3.14159265358979", "0.1",
            "-.5", "5.", "1e22", "1e23", "-0.000244140625", "17.125e3",
            "+4.5", "0.30000000000000004", "2.2250738585072014e-308",
        ]
        lines = "\n".join(f"{v} 1:{v}" for v in vals) + "\n"
        _, _, _, parsed, _ = native.parse_chunk("libsvm", lines.encode())
        for i, v in enumerate(vals):
            ref = np.float32(float(v))
            assert parsed[i].tobytes() == ref.tobytes(), (v, parsed[i], ref)

    def test_num_keys_below_two_raises_not_crashes(self):
        """num_keys < 2 surfaces the numpy path's ValueError and never
        reaches the native kernel (whose modulus would be zero)."""
        b = TB.BatchBuilder(num_keys=1, batch_size=4)
        with pytest.raises(ValueError, match="num_keys must be >= 2"):
            b.build(np.ones(1, np.float32), [np.array([3], np.uint64)],
                    [np.ones(1, np.float32)])

    def test_hex_floats_fall_back_to_strtod(self):
        _, _, _, vals, _ = native.parse_chunk("libsvm", b"1 1:0x1A 2:0x1p-3 3:0.5\n")
        np.testing.assert_array_equal(vals[:3], np.array([26.0, 0.125, 0.5], np.float32))


class TestAdversarialFuzzParity:
    """Randomized bit-parity sweep for the AVX2 structural parser: bare
    keys, empty values, CRLF line ends, tab/multi-space separators,
    overlong digit runs, 19-digit mantissas, exponents — through
    parse_chunk and the streaming iter_chunks."""

    def _blob(self, n=1500, seed=7):
        rng = random.Random(seed)

        def num():
            c = rng.randrange(9)
            if c == 0:
                return str(rng.randint(0, 10 ** rng.randint(1, 25)))
            if c == 1:
                return f"{rng.uniform(-1e3, 1e3):.{rng.randint(0, 20)}f}"
            if c == 2:
                return f"{rng.uniform(-1e30, 1e30):.{rng.randint(0, 18)}e}"
            if c == 3:
                return "0" * rng.randint(1, 12) + str(rng.randint(0, 999999))
            if c == 4:
                return str(rng.randint(0, 9))
            if c == 5:
                return "12345678"
            if c == 6:
                return "1234567890123456789"
            if c == 7:
                return "9" * rng.randint(18, 26)
            return f"{rng.uniform(0, 2):.6g}"

        lines = []
        for _ in range(n):
            ents = []
            for _ in range(rng.randint(1, 12)):
                k = str(rng.randint(0, 10 ** rng.randint(1, 12)))
                style = rng.randrange(4)
                ents.append(k if style == 0 else k + ":" if style == 1 else f"{k}:{num()}")
            sep = rng.choice([" ", "  ", " \t "])
            lines.append(rng.choice(["1", "-1", "0", "0.5", "-0.0001", "+1"])
                         + sep + sep.join(ents) + rng.choice(["\n", "\n", "\r\n"]))
        return "".join(lines).encode(), n

    def test_bit_parity_with_python(self, tmp_path):
        blob, n = self._blob()
        labels, splits, keys, vals, _ = native.parse_chunk("libsvm", blob)
        p = tmp_path / "fuzz.svm"
        p.write_bytes(blob)
        rows_py = list(iter_libsvm(p))
        assert len(rows_py) == len(labels) == n
        for i, (yl, kk, vv, _s) in enumerate(rows_py):
            s, e = splits[i], splits[i + 1]
            assert labels[i] == yl
            assert np.array_equal(keys[s:e], kk)
            assert np.array_equal(vals[s:e], vv), i
        total = sum(len(fl[0]) for fl in native.iter_chunks(p, "libsvm", chunk_bytes=1 << 14))
        assert total == n

    def test_criteo_hex_swar_parity(self, tmp_path):
        """SWAR 8/16-char hex ids vs the Python parser bit for bit, with
        uppercase, junk-8, short/odd lengths and missing fields."""
        rng = random.Random(11)
        rows = []
        for i in range(600):
            ints = "\t".join(rng.choice([str(rng.randint(0, 10**9)), "", "-3", "jk3x"])
                             for _ in range(13))
            cats = [rng.choice(["", "deadbeef", "DEADBEEF", "zzzzzzzz",
                                f"{rng.getrandbits(32):08x}", f"{rng.getrandbits(64):016x}",
                                f"{rng.getrandbits(16):04x}", f"{rng.getrandbits(28):07x}"])
                    for _ in range(26)]
            rows.append(f"{i % 2}\t{ints}\t" + "\t".join(cats) + "\n")
        blob = "".join(rows).encode()
        labels, splits, keys, vals, slots = native.parse_chunk("criteo", blob)
        p = tmp_path / "c.txt"
        p.write_bytes(blob)
        py = list(iter_criteo(p))
        assert len(py) == len(labels) == 600
        for i, (yl, kk, vv, ss) in enumerate(py):
            s, e = splits[i], splits[i + 1]
            assert labels[i] == yl
            assert np.array_equal(keys[s:e], kk), i
            assert np.array_equal(vals[s:e], vv), i
            assert np.array_equal(slots[s:e], ss), i


class TestCount4:
    """ps_count4 sizes the outputs exactly: a wrong count would become a
    capacity error or an overallocation."""

    def test_counts_match_python(self):
        rng = random.Random(3)
        blob = bytes(rng.choice(b"abc:\n\r \t059") for _ in range(100_000))
        ba = bytearray(blob)
        out = (ctypes.c_int64 * 4)()
        native.load_native().ps_count4(
            (ctypes.c_char * len(ba)).from_buffer(ba), len(ba),
            0x0A, 0x0D, ord(":"), ord(" "), out,
        )
        assert list(out) == [blob.count(bytes([c])) for c in (0x0A, 0x0D, ord(":"), ord(" "))]

    def test_partial_length_and_tail(self):
        ba = bytearray(b":" * 37 + b"\n" * 5)  # 42 bytes: SIMD blocks + tail
        out = (ctypes.c_int64 * 4)()
        native.load_native().ps_count4(
            (ctypes.c_char * len(ba)).from_buffer(ba), 40,  # counts only [:40]
            ord(":"), 0x0A, 0x00, 0x00, out,
        )
        assert out[0] == 37 and out[1] == 3


# -- the port's copy and its build ------------------------------------------


def test_parser_source_is_the_jax_source_byte_for_byte():
    assert native.SOURCE.read_bytes() == (REPO / "native" / "parser.cpp").read_bytes()


def test_library_builds_into_the_port_build_dir_with_the_makefile_flags():
    """The library is the port's own ``_build/libpsdata-<hash>.so``, built
    with the JAX Makefile's flags, never the JAX package's
    ``native/libpsdata.so``; g++'s log sits beside it."""
    path = native.library_path()
    assert path.parent == REPO / "parameter_server_tpu_torch" / "_build"
    assert path.name.startswith("libpsdata-") and path.exists()
    assert path != REPO / "native" / "libpsdata.so"
    makefile = (REPO / "native" / "Makefile").read_text()
    assert " ".join(native.CXX_FLAGS) in makefile
    log = native.build_log()
    assert log.split()[0].endswith("g++") and " ".join(native.CXX_FLAGS) in log
    assert not list(path.parent.glob("libpsdata-*.tmp.so"))  # renamed into place


def test_concurrent_builds_leave_one_whole_library(tmp_path, monkeypatch):
    """Threads that build at once wait on the lock, and the library is
    renamed into place whole: every thread loads the same file."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    paths, errs = [], []

    def build():
        try:
            paths.append(native._build())
        except BaseException as e:  # surfaced below
            errs.append(e)

    ts = [threading.Thread(target=build) for _ in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs and len(set(paths)) == 1 and paths[0] is not None
    ctypes.CDLL(str(paths[0])).ps_count4  # a whole, loadable library
    assert sorted(p.name for p in (tmp_path / "_build").iterdir()) == sorted(
        [paths[0].name, paths[0].with_suffix(".log").name])


@pytest.mark.parametrize("fmt", ["libsvm", "criteo", "adfea"])
def test_iter_flat_rows_matches_jax_python_parsers(tmp_path, fmt, monkeypatch):
    """The port's ``iter_flat_rows`` (native: chunks) carries the rows the
    JAX package's Python path yields (one chunk a file)."""
    from parameter_server_tpu.data import native as JN

    monkeypatch.setattr(JN, "native_available", lambda: False)
    if fmt == "libsvm":
        labels, keys, vals, _ = make_sparse_logistic(300, 700, nnz_per_example=6, seed=2)
        paths = []
        for i in range(2):
            paths.append(tmp_path / f"{i}.svm")
            write_libsvm(paths[-1], labels[i::2], keys[i::2], vals[i::2])
    elif fmt == "criteo":
        paths = [_criteo_file(tmp_path, n=150, seed=5)]
    else:
        paths = [tmp_path / "a.adfea"]
        paths[0].write_text("".join(f"{i} {i % 2} {3 * i}:{i % 5} {7 * i + 1}:2\n"
                                    for i in range(120)))
    got = list(TR.iter_flat_rows(paths, fmt))
    want = list(JR.iter_flat_rows(paths, fmt))
    assert len(got) == len(want) == len(paths)
    for g, w in zip(got, want):
        assert (g[4] is None) == (w[4] is None) == (fmt == "libsvm")
        assert_rows_equal(rows_from_flat(g), rows_from_flat(w))
        assert g[2].dtype == w[2].dtype and g[1].dtype == w[1].dtype


@pytest.mark.parametrize("key_mode", ["hash", "identity"])
def test_flat_build_localizes_like_jax(key_mode):
    """``BatchBuilder.build_flat`` (the native localizer) equals the JAX
    package's builder with its numpy localizer."""
    from parameter_server_tpu.data import native as JN

    rng = np.random.default_rng(8)
    splits = np.arange(0, 257 * 5, 5, dtype=np.int64)[:65]
    keys = rng.integers(0, 3000, int(splits[-1]), dtype=np.uint64)
    vals = rng.random(int(splits[-1]), dtype=np.float32)
    slots = rng.integers(0, 9, int(splits[-1]), dtype=np.uint64)
    labels = (rng.random(64) < 0.5).astype(np.float32)
    kw = dict(num_keys=4096, batch_size=64, key_mode=key_mode)
    got = TB.BatchBuilder(**kw).build_flat(labels, splits, keys, vals, slots)
    orig = JN.hash_localize
    JN.hash_localize = lambda *a, **k: None  # the JAX numpy path
    try:
        want = JB.BatchBuilder(**kw).build_flat(labels, splits, keys, vals, slots)
    finally:
        JN.hash_localize = orig
    _same_batch(got, want)
