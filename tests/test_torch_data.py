"""The port's text data layer against the JAX package's, on the CPU.

Twins of ``tests/test_data.py`` (parsers native / Python parity, readers,
training from a file) and ``tests/test_fs.py`` (the ``psfs://`` file
service), and of the count-min cases of ``tests/test_keys.py``.  Then the
port's parsers against the JAX parsers on the same bytes through both
routes (native and Python): labels, CSR planes, dense fields and keys
byte-identical, dtypes equal; count-min estimates equal for one seed; and
``StreamReader`` / ``SlotReader`` batches equal to the JAX readers', locally
and over ``psfs://`` (a JAX server read by the port's client and the other
way round).
"""

import gzip
import os

import numpy as np
import pytest

from parameter_server_tpu import native as jnative
from parameter_server_tpu.data import fs as jfs
from parameter_server_tpu.data import reader as jreader
from parameter_server_tpu.data import text as jtext
from parameter_server_tpu.utils.countmin import CountMin as JaxCountMin
from parameter_server_tpu_torch import native
from parameter_server_tpu_torch.data import fs
from parameter_server_tpu_torch.data import reader as reader_lib
from parameter_server_tpu_torch.data import text as text_lib
from parameter_server_tpu_torch.data.reader import SlotReader, StreamReader
from parameter_server_tpu_torch.utils.countmin import CountMin
from parameter_server_tpu_torch.utils.keys import PAD_KEY, mix64

LIBSVM_SAMPLE = b"""# comment line
1 3:0.5 17:1.25 100000:2
0 5:1 6:-0.75
1 12345678901:3.5e-2  # trailing comment
0

-1 7:1e3
"""


def _py_parse(fn, *args, **kw):
    """Run a parse with the native path disabled (both packages' caches)."""
    native._cache.clear()
    jnative._cache.clear()
    os.environ["PS_NO_NATIVE"] = "1"
    try:
        return fn(*args, **kw)
    finally:
        del os.environ["PS_NO_NATIVE"]
        native._cache.clear()
        jnative._cache.clear()


def _has_native():
    return native.load("textparse") is not None


# ------------------------------------------------------- twins of test_data.py


def test_libsvm_fallback_basics():
    b = _py_parse(text_lib.parse_libsvm, LIBSVM_SAMPLE)
    assert b.rows == 5
    np.testing.assert_array_equal(b.labels, [1, 0, 1, 0, -1])
    np.testing.assert_array_equal(b.indptr, [0, 3, 5, 6, 6, 7])
    assert b.indices[0] == 3 and b.values[1] == pytest.approx(1.25)
    assert b.indices[5] == 12345678901
    assert b.values[5] == pytest.approx(3.5e-2)


def _random_libsvm(seed, rows=500):
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(rows):
        nnz = rng.integers(0, 40)
        feats = " ".join(f"{rng.integers(0, 1 << 48)}:{rng.normal():.6g}" for _ in range(nnz))
        lines.append(f"{rng.integers(0, 2)} {feats}")
    return ("\n".join(lines) + "\n").encode()


def test_libsvm_native_matches_python():
    if not _has_native():
        pytest.skip("no native toolchain")
    data = _random_libsvm(0)
    a = text_lib.parse_libsvm(data)
    b = _py_parse(text_lib.parse_libsvm, data)
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_allclose(a.values, b.values, rtol=1e-6)


CRITEO_SAMPLE = (
    b"1\t" + b"\t".join(b"%d" % i for i in range(13)) + b"\t"
    + b"\t".join(b"%02x" % i for i in range(26)) + b"\n"
    + b"0\t\t2\t\t4\t5\t6\t7\t8\t9\t10\t11\t12\t\tdeadbeef"
    + b"\t" * 25 + b"\n"
)


def test_criteo_native_matches_python_and_hashes():
    lp, dp, kp = _py_parse(text_lib.parse_criteo, CRITEO_SAMPLE)
    assert lp.shape == (2,) and dp.shape == (2, 13) and kp.shape == (2, 26)
    assert dp[1, 0] == 0.0 and dp[1, 1] == 2.0  # missing dense -> 0
    # slot salting: same raw value in different slots -> different keys
    assert kp[1, 1] != kp[1, 2]
    # hash parity with utils.keys.mix64
    assert kp[1, 0] == mix64(np.uint64(0xDEADBEEF) ^ np.uint64(1), 0)
    if _has_native():
        ln, dn, kn = text_lib.parse_criteo(CRITEO_SAMPLE)
        np.testing.assert_array_equal(ln, lp)
        np.testing.assert_array_equal(dn, dp)
        np.testing.assert_array_equal(kn, kp)


MALFORMED_SVM = (
    b"1 qid:3 5:1\n"          # qid token skipped, 5:1 kept
    b"0 -3:0.5 7:2\n"         # negative key skipped
    b"1 3:0.5x 9:1\n"         # junk-suffix value: token skipped
    b"0 5: 11:1\n"            # empty value: token skipped
    b"1 3.5:1 13:4\n"         # non-integer key skipped
    b"abc 15:1e2\n"           # junk label -> 0.0, exponent value kept
)


def test_malformed_tokens_skip_not_hang():
    """qid:/negative/junk-suffix tokens are skipped whole by BOTH parsers."""
    a = _py_parse(text_lib.parse_libsvm, MALFORMED_SVM)
    np.testing.assert_array_equal(a.labels, [1, 0, 1, 0, 1, 0])
    np.testing.assert_array_equal(a.indices, [5, 7, 9, 11, 13, 15])
    np.testing.assert_allclose(a.values, [1, 2, 1, 1, 4, 100])
    if _has_native():
        b = text_lib.parse_libsvm(MALFORMED_SVM)
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_allclose(a.values, b.values)


JUNK_TSV = (
    b"1\tnan\t2\t1a\t4\t5\t6\t7\t8\t9\t10\t11\t12\t99"
    + b"\t" + b"\t".join(b"%02x" % i for i in range(26)) + b"\n"
)


def test_criteo_dense_junk_no_desync():
    """Non-numeric dense fields zero that field only; columns stay aligned."""
    lp, dp, kp = _py_parse(text_lib.parse_criteo, JUNK_TSV)
    assert dp[0, 0] == 0.0  # 'nan' rejected (C numeric subset has no nan)
    assert dp[0, 1] == 2.0
    assert dp[0, 2] == 1.0  # '1a' -> numeric prefix 1, junk dropped
    assert dp[0, 12] == 99.0
    assert kp[0, 0] == text_lib.hash_cat(np.uint64(0), 0)  # col 14 == "00"
    if _has_native():
        ln, dn, kn = text_lib.parse_criteo(JUNK_TSV)
        np.testing.assert_array_equal(dn, dp)
        np.testing.assert_array_equal(kn, kp)


EDGE_SVM = b"# header comment\n1 3:0.5\n   # indented comment\n0 5:1\n"
EDGE_TSV = (
    b"1\t" + b"\t".join(b"%d" % i for i in range(13)) + b"\t"
    + b"\t".join(b"%02x" % i for i in range(26)) + b"\n"
    + b"\r\n"  # blank CRLF line: not a row
    + b"0\t" + b"\t" * 13 + b"12345678901234567"  # 17 hex digits: wraps
    + b"\t12z9"  # junk suffix: hex prefix 0x12
    + b"\t" * 24 + b"\n"
)


def test_parser_parity_edge_cases():
    """Comment lines, blank CRLF lines, junk/overflow hex — both paths agree."""
    a = _py_parse(text_lib.parse_libsvm, EDGE_SVM)
    assert a.rows == 2
    if _has_native():
        b = text_lib.parse_libsvm(EDGE_SVM)
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.indptr, b.indptr)
    lp, dp, kp = _py_parse(text_lib.parse_criteo, EDGE_TSV)
    assert lp.shape == (2,)
    assert kp[1, 0] == text_lib.hash_cat(np.uint64(0x2345678901234567), 0)  # top digit wrapped off
    assert kp[1, 1] == text_lib.hash_cat(np.uint64(0x12), 1)
    if _has_native():
        ln, dn, kn = text_lib.parse_criteo(EDGE_TSV)
        np.testing.assert_array_equal(ln, lp)
        np.testing.assert_array_equal(kn, kp)


def test_mix64_abi_parity():
    lib = text_lib._lib()  # sets ps_mix64 argtypes/restype (order-independent)
    if lib is None:
        pytest.skip("no native toolchain")
    xs = np.random.default_rng(1).integers(0, 1 << 63, size=32, dtype=np.uint64)
    for x in xs:
        assert lib.ps_mix64(int(x), 7) == int(mix64(x, 7))


def test_to_fixed_nnz_pads_and_truncates():
    b = _py_parse(text_lib.parse_libsvm, LIBSVM_SAMPLE)
    keys, vals, labels = b.to_fixed_nnz(2)
    assert keys.shape == (5, 2)
    assert keys[0, 0] == 3 and keys[0, 1] == 17  # truncated row
    assert keys[3, 0] == PAD_KEY and vals[3, 0] == 0.0  # empty row padded
    np.testing.assert_array_equal(labels, b.labels)


def test_write_parse_roundtrip(tmp_path):
    b = _py_parse(text_lib.parse_libsvm, LIBSVM_SAMPLE)
    p = tmp_path / "out.libsvm"
    text_lib.write_libsvm(str(p), b)
    b2 = text_lib.parse_libsvm(p.read_bytes())
    np.testing.assert_array_equal(b.indices, b2.indices)
    np.testing.assert_allclose(b.values, b2.values, rtol=1e-5)


def _write_synthetic_libsvm(path, rows, seed=0, nnz=8, key_space=1 << 16):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(rows):
            keys = rng.integers(0, key_space, size=nnz)
            label = rng.integers(0, 2)
            f.write(f"{label} " + " ".join(f"{k}:1" for k in keys) + "\n")


def test_slot_reader_caches(tmp_path):
    data = tmp_path / "train.libsvm"
    _write_synthetic_libsvm(str(data), 300)
    cache = tmp_path / "cache"
    r = reader_lib.SlotReader([str(data)], cache_dir=str(cache), chunk_bytes=4096)
    full = r.read_all()
    assert full.rows == 300
    assert list(cache.glob("slot_*.npz")), "cache not written"
    # second pass hits the cache and returns identical data
    full2 = r.read_all()
    np.testing.assert_array_equal(full.indices, full2.indices)
    np.testing.assert_array_equal(full.indptr, full2.indptr)
    # warm-cache fast path: overwrite the raw file with garbage while
    # preserving (size, mtime) — the manifest + chunk cache must serve the
    # ORIGINAL data without touching the raw bytes
    st = data.stat()
    data.write_bytes(b"#" * st.st_size)
    os.utime(data, ns=(st.st_atime_ns, st.st_mtime_ns))
    full3 = r.read_all()
    np.testing.assert_array_equal(full.indices, full3.indices)


def test_stream_reader_batches(tmp_path):
    data = tmp_path / "s.libsvm"
    _write_synthetic_libsvm(str(data), 250)
    sr = reader_lib.StreamReader([str(data)], batch_size=64, max_nnz=8, epochs=2,
                                 chunk_bytes=2048)
    batches = list(sr)
    # 500 rows over 2 epochs -> 7 full batches of 64
    assert len(batches) == (250 * 2) // 64
    for keys, vals, labels in batches:
        assert keys.shape == (64, 8) and labels.shape == (64,)
        assert keys.dtype == np.uint64


def _criteo_text(rows, seed):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(rows):
        dense = "\t".join(str(int(x)) for x in rng.integers(0, 100, 13))
        cats = "\t".join(f"{int(x):x}" for x in rng.integers(0, 1 << 32, 26))
        lines.append(f"{i % 2}\t{dense}\t{cats}")
    return "\n".join(lines) + "\n"


def test_stream_reader_criteo(tmp_path):
    p = tmp_path / "day0.tsv"
    p.write_text(_criteo_text(40, 3))
    batches = list(reader_lib.StreamReader([str(p)], batch_size=16, format="criteo", epochs=1))
    assert len(batches) == 2
    keys, dense, labels = batches[0]
    assert keys.shape == (16, 26) and dense.shape == (16, 13)


def test_e2e_train_from_libsvm_file(tmp_path):
    """Full slice: text file -> StreamReader -> LocalLRTrainer, loss drops."""
    from parameter_server_tpu_torch.config import OptimizerConfig, TableConfig
    from parameter_server_tpu_torch.learner.sgd import LocalLRTrainer

    path = tmp_path / "train.libsvm"
    rng = np.random.default_rng(7)
    with open(path, "w") as f:
        for _ in range(2000):
            keys = rng.integers(0, 512, size=6)
            label = int(np.sum(keys % 7 == 0) > 0)
            f.write(f"{label} " + " ".join(f"{k}:1" for k in keys) + "\n")
    cfg = TableConfig(name="w", rows=4096, dim=1,
                      optimizer=OptimizerConfig(kind="adagrad", learning_rate=0.2))
    tr = LocalLRTrainer(cfg, min_bucket=256, device="cpu")
    losses = []
    sr = reader_lib.StreamReader([str(path)], batch_size=256, max_nnz=6, epochs=4)
    for keys, _vals, labels in sr:
        losses.append(tr.step(keys, labels))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05


HASH_COMMENT_SVM = (
    b"1 3:1#x 5:2\n"      # 3:1#x malformed -> only 5:2 survives
    b"# full line comment\n"
    b"0 7:1 # trailing 9:9\n"  # comment token ends the line
    b"1 12#4:5 8:1\n"     # 12#4:5 malformed key -> only 8:1
)


def test_libsvm_hash_comment_parity():
    """'#' glued inside a token is a malformed token, not a line truncation."""
    b = _py_parse(text_lib.parse_libsvm, HASH_COMMENT_SVM)
    np.testing.assert_array_equal(b.labels, [1, 0, 1])
    np.testing.assert_array_equal(b.indices, [5, 7, 8])
    np.testing.assert_array_equal(b.indptr, [0, 1, 2, 3])
    if _has_native():
        a = text_lib.parse_libsvm(HASH_COMMENT_SVM)
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_allclose(a.values, b.values)


OVERFLOW_SVM = b"1 3:1e400 4:1e-400 5:2e2147483648 6:1.5\n"


def test_float_exponent_overflow_parity():
    """Huge exponents must saturate to inf/0, never raise or wrap (UB)."""
    b = _py_parse(text_lib.parse_libsvm, OVERFLOW_SVM)
    np.testing.assert_array_equal(b.indices, [3, 4, 5, 6])
    assert np.isinf(b.values[0]) and b.values[1] == 0.0
    assert np.isinf(b.values[2]) and b.values[3] == pytest.approx(1.5)
    if _has_native():
        a = text_lib.parse_libsvm(OVERFLOW_SVM)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.values, b.values)


# ------------------------------------------------------- twins of test_keys.py


def test_countmin_never_undercounts():
    cm = CountMin(width=1 << 12, depth=4)
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 500, size=5000, dtype=np.uint64)
    cm.add(keys)
    true_counts = np.bincount(keys.astype(np.int64), minlength=500)
    est = cm.query(np.arange(500, dtype=np.uint64))
    assert np.all(est >= true_counts)
    # with a wide sketch estimates should be close
    assert np.mean(est - true_counts) < 1.0


def test_countmin_filter():
    cm = CountMin(width=1 << 12, depth=4)
    cm.add(np.array([42] * 10 + [7], dtype=np.uint64))
    mask = cm.filter(np.array([42, 7, 99], dtype=np.uint64), threshold=5)
    assert mask.tolist() == [True, False, False]


def test_countmin_equals_the_jax_sketch():
    rng = np.random.default_rng(2)
    ours, theirs = CountMin(width=1 << 10, depth=3, seed=5), JaxCountMin(width=1 << 10, depth=3,
                                                                           seed=5)
    for _ in range(3):
        keys = rng.integers(0, 1 << 40, size=4000, dtype=np.uint64)
        ours.add(keys)
        theirs.add(keys)
    probe = rng.integers(0, 1 << 40, size=2000, dtype=np.uint64)
    np.testing.assert_array_equal(ours.query(probe), theirs.query(probe))
    np.testing.assert_array_equal(ours._table, theirs._table)


# ---------------------------------------------------- parity with the JAX parsers

PARITY_INPUTS = {
    "sample": LIBSVM_SAMPLE, "malformed": MALFORMED_SVM, "edge": EDGE_SVM,
    "hash_comment": HASH_COMMENT_SVM, "overflow": OVERFLOW_SVM, "random": None,
}


def _same_bytes(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("name", list(PARITY_INPUTS))
def test_libsvm_planes_byte_equal_to_jax(name, route):
    data = PARITY_INPUTS[name] if PARITY_INPUTS[name] is not None else _random_libsvm(4, 300)
    if route == "native":
        if not _has_native() or jtext._lib() is None:
            pytest.skip("no native toolchain")
        ours, theirs = text_lib.parse_libsvm(data, nthreads=3), jtext.parse_libsvm(data, nthreads=3)
    else:
        ours = _py_parse(text_lib.parse_libsvm, data)
        theirs = _py_parse(jtext.parse_libsvm, data)
    for field in ("labels", "indptr", "indices", "values"):
        _same_bytes(getattr(ours, field), getattr(theirs, field))
    for a, b in zip(ours.to_fixed_nnz(4), theirs.to_fixed_nnz(4)):
        _same_bytes(a, b)


@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("name", ["sample", "junk", "edge", "random"])
def test_criteo_planes_byte_equal_to_jax(name, route):
    data = {"sample": CRITEO_SAMPLE, "junk": JUNK_TSV, "edge": EDGE_TSV,
            "random": _criteo_text(200, 9).encode()}[name]
    if route == "native":
        if not _has_native() or jtext._lib() is None:
            pytest.skip("no native toolchain")
        ours, theirs = text_lib.parse_criteo(data, nthreads=3), jtext.parse_criteo(data, nthreads=3)
    else:
        ours = _py_parse(text_lib.parse_criteo, data)
        theirs = _py_parse(jtext.parse_criteo, data)
    for a, b in zip(ours, theirs):
        _same_bytes(a, b)
    _same_bytes(reader_lib.criteo_log_transform(ours[1]), jreader.criteo_log_transform(theirs[1]))


# ------------------------------------------------------- twins of test_fs.py


@pytest.fixture
def served_dir(tmp_path):
    root = tmp_path / "shards"
    root.mkdir()
    srv = fs.FileServer(str(root), host="127.0.0.1").start()
    try:
        yield root, srv
    finally:
        srv.stop()


def _libsvm_lines(rows, seed=0):
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(rows):
        label = int(rng.integers(0, 2))
        keys = sorted(rng.choice(1000, size=5, replace=False))
        lines.append(f"{label} " + " ".join(f"{k}:1" for k in keys) + "\n")
    return "".join(lines)


def test_stat_read_list_roundtrip(served_dir):
    root, srv = served_dir
    payload = b"hello shard bytes" * 1000
    (root / "a.bin").write_bytes(payload)
    (root / "sub").mkdir()
    (root / "sub" / "b.bin").write_bytes(b"nested")

    url = f"{srv.url}/a.bin"
    assert fs.stat(url).size == len(payload)
    with fs.open_stream(url) as f:
        assert f.read() == payload
    with fs.open_stream(url) as f:  # ranged read through seek
        f.seek(6)
        assert f.read(5) == payload[6:11]
    assert fs.list_files(f"{srv.url}/*.bin") == [f"{srv.url}/a.bin"]
    assert fs.list_files(f"{srv.url}/sub/*.bin") == [f"{srv.url}/sub/b.bin"]


def test_path_escape_refused(served_dir):
    _root, srv = served_dir
    with pytest.raises(OSError, match="escapes root|No such file"):
        fs.open_stream(f"{srv.url}/../secrets").read()


def test_gzip_transparent_local_and_remote(served_dir):
    root, srv = served_dir
    text = _libsvm_lines(50)
    with gzip.open(root / "part.txt.gz", "wt") as f:
        f.write(text)
    with fs.open_stream(str(root / "part.txt.gz")) as f:
        local = f.read()
    with fs.open_stream(f"{srv.url}/part.txt.gz") as f:
        remote = f.read()
    assert local == remote == text.encode()


def test_stream_reader_over_psfs_matches_local(served_dir):
    root, srv = served_dir
    (root / "train.txt").write_text(_libsvm_lines(200, seed=1))
    local_batches = list(StreamReader([str(root / "train.txt")], batch_size=64, epochs=1))
    remote_batches = list(StreamReader([f"{srv.url}/train.txt"], batch_size=64, epochs=1))
    assert len(local_batches) == len(remote_batches) == 3
    for lb, rb in zip(local_batches, remote_batches):
        for a, b in zip(lb, rb):
            np.testing.assert_array_equal(a, b)


def test_slot_reader_caches_remote_shards(served_dir, tmp_path):
    root, srv = served_dir
    (root / "block.txt").write_text(_libsvm_lines(120, seed=2))
    cache = tmp_path / "cache"
    url = f"{srv.url}/block.txt"
    first = SlotReader([url], cache_dir=str(cache)).read_all()
    assert first.rows == 120
    reads_after_first = srv.op_counts.get(2, 0)  # _OP_READ
    assert reads_after_first > 0
    # second pass: freshness STAT only, the bytes come from the local cache
    second = SlotReader([url], cache_dir=str(cache)).read_all()
    np.testing.assert_array_equal(first.labels, second.labels)
    np.testing.assert_array_equal(first.indices, second.indices)
    assert srv.op_counts.get(2, 0) == reads_after_first  # zero new READs


# ------------------------------------------------ readers against the JAX readers


def _batches_equal(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for ob, tb in zip(ours, theirs):
        for a, b in zip(ob, tb):
            _same_bytes(a, b)


@pytest.mark.parametrize("fmt", ["libsvm", "criteo"])
@pytest.mark.parametrize("where", ["local", "psfs_port_server", "psfs_jax_server"])
def test_stream_reader_equals_the_jax_reader(tmp_path, fmt, where):
    """Shuffled two-epoch streams over two shards (one gzipped), chunked
    small so batches straddle chunks: every batch byte-equal to the JAX
    reader's, whichever package serves the shards."""
    root = tmp_path / "shards"
    root.mkdir()
    texts = ([_libsvm_lines(150, seed=s) for s in (5, 6)] if fmt == "libsvm"
             else [_criteo_text(150, s) for s in (5, 6)])
    (root / "p0.txt").write_text(texts[0])
    with gzip.open(root / "p1.txt.gz", "wt") as f:
        f.write(texts[1])
    srv = None
    if where == "psfs_port_server":
        srv = fs.FileServer(str(root), host="127.0.0.1").start()
    elif where == "psfs_jax_server":
        srv = jfs.FileServer(str(root), host="127.0.0.1").start()
    try:
        base = srv.url if srv else str(root)
        files = [f"{base}/p0.txt", f"{base}/p1.txt.gz"]
        kw = dict(format=fmt, max_nnz=6, epochs=2, chunk_bytes=4096, shuffle_seed=3)
        ours = list(StreamReader(files, 48, **kw))
        theirs = list(jreader.StreamReader(files, 48, **kw))
    finally:
        if srv:
            srv.stop()
    _batches_equal(ours, theirs)


def test_slot_reader_equals_the_jax_reader(tmp_path):
    data = tmp_path / "train.libsvm"
    _write_synthetic_libsvm(str(data), 400, seed=8)
    ours = SlotReader([str(data)], chunk_bytes=4096).read_all()
    theirs = jreader.SlotReader([str(data)], chunk_bytes=4096).read_all()
    for field in ("labels", "indptr", "indices", "values"):
        _same_bytes(getattr(ours, field), getattr(theirs, field))
