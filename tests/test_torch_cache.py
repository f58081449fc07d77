"""The port's hot-row cache against the JAX package's, on the CPU.

``kv/cache.py`` is framework-free numpy copied into the port, so the two
caches must agree exactly: the same seeded random operation sequences
(``observe``, ``insert``, ``lookup``, ``lookup_many``, ``lookup_stale``,
``invalidate_all``, ``watermark``) at a small capacity, where keys collide on
lines, give identical answers, counters and audit trails.  Then the six
cache cases of the JAX package's serving tests, on the port's cache.

Tolerances: none — every answer, row and counter is compared exactly.
"""

import numpy as np
import pytest

from parameter_server_tpu.kv.cache import HotRowCache as JaxHotRowCache
from parameter_server_tpu_torch.kv.cache import HotRowCache

DIM = 4
SERVERS = ("S0", "S1", "S2")
TABLES = ("w", "v")
OPS = ("observe", "insert", "lookup", "lookup_many", "lookup_stale", "invalidate_all",
       "watermark")
#: draw weights of the operations: mostly inserts, probes and watermark moves
OP_P = np.array([0.2, 0.3, 0.15, 0.15, 0.1, 0.03, 0.07])


def _ops(seed, n=300, key_space=40):
    """A seeded operation script: ``(op, args)`` tuples both caches replay."""
    rng = np.random.default_rng(seed)
    script = []
    for _ in range(n):
        op = OPS[rng.choice(len(OPS), p=OP_P / OP_P.sum())]
        table = TABLES[rng.integers(len(TABLES))]
        server = SERVERS[rng.integers(len(SERVERS))]
        if op == "observe":
            script.append((op, (table, server, int(rng.integers(0, 12)))))
        elif op == "insert":
            k = int(rng.integers(1, 6))
            keys = rng.integers(0, key_space, size=k).astype(np.int64)
            rows = rng.normal(size=(k, DIM)).astype(np.float32)
            script.append((op, (table, keys, rows, int(rng.integers(0, 12)), server)))
        elif op in ("lookup", "lookup_stale"):
            script.append((op, (table, int(rng.integers(0, key_space)), server)))
        elif op == "lookup_many":
            k = int(rng.integers(1, 8))
            slots = rng.integers(0, key_space, size=k).astype(np.int64)
            owners = [SERVERS[i] for i in rng.integers(len(SERVERS), size=k)]
            script.append((op, (table, slots, owners)))
        elif op == "invalidate_all":
            script.append((op, ("explicit",)))
        else:
            script.append((op, (table, server)))
    return script


def _replay(cache, script):
    """Every answer of ``script`` on ``cache``, as plain Python values."""
    out = []
    for op, args in script:
        if op == "observe":
            cache.observe(*args)
            out.append(None)
        elif op == "insert":
            cache.insert(*args)
            out.append(len(cache))
        elif op == "lookup":
            table, key, server = args
            got = cache.lookup(table, key, server)
            out.append(None if got is None else got.tolist())
        elif op == "lookup_stale":
            table, key, _server = args
            got = cache.lookup_stale(table, key)
            out.append(None if got is None else (got[0].tolist(), got[1]))
        elif op == "lookup_many":
            table, slots, owners = args
            codes = np.asarray([cache.server_code(o) for o in owners], dtype=np.int32)
            hit, rows = cache.lookup_many(table, slots, codes)
            out.append((hit.tolist(), None if rows is None else rows.tolist()))
        elif op == "invalidate_all":
            out.append(cache.invalidate_all(reason=args[0]))
        else:
            out.append(cache.watermark(*args))
    return out


@pytest.mark.parametrize("capacity", [1, 8, 64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_operation_sequences_match_jax(seed, capacity):
    """Capacity 8 against 40 keys: most inserts collide on a line; 64 holds
    every key; 1 is a single line that 3 keys fight over."""
    script = _ops(seed + 100 * capacity, key_space=3 if capacity == 1 else 40)
    port = HotRowCache(capacity, node="W0", audit=True)
    ref = JaxHotRowCache(capacity, node="W0", audit=True)
    assert port.capacity_rows == ref.capacity_rows
    assert _replay(port, script) == _replay(ref, script)
    assert port.counters() == ref.counters()
    assert port.hit_rate() == ref.hit_rate()
    assert port.audit == ref.audit
    assert port.counters()["cache_hits"] > 0 and port.counters()["cache_invalidations"] > 0
    # the bounded-staleness invariant of every hit served
    assert all(sv >= wm for _t, _k, sv, wm in port.audit)


@pytest.mark.parametrize("capacity", [0, -3, 5, 1000])
def test_capacity_rounds_up_to_a_power_of_two_like_jax(capacity):
    port, ref = HotRowCache(capacity), JaxHotRowCache(capacity)
    assert port.capacity_rows == ref.capacity_rows
    port.insert("w", np.array([3]), np.ones((1, DIM), np.float32), 1, "S0")
    ref.insert("w", np.array([3]), np.ones((1, DIM), np.float32), 1, "S0")
    assert len(port) == len(ref)


# -------------------------------------- the JAX package's cache cases, ported


def test_cache_hit_then_watermark_invalidation():
    c = HotRowCache(64, audit=True)
    row = np.arange(DIM, dtype=np.float32)
    c.insert("w", np.array([7]), row[None, :], sver=3, server="S0")
    c.observe("w", "S0", 3)
    np.testing.assert_array_equal(c.lookup("w", 7, "S0"), row)
    assert c.hits == 1 and c.misses == 0
    # a fresher write anywhere on the shard advances the watermark past the
    # entry's stamp: the entry dies lazily at the next probe
    c.observe("w", "S0", 5)
    assert c.lookup("w", 7, "S0") is None
    assert c.invalidations == 1 and c.misses == 1
    assert c.audit == [("w", 7, 3, 3)]


def test_cache_watermark_is_monotone_and_insert_never_regresses():
    c = HotRowCache(64)
    c.observe("w", "S0", 9)
    c.observe("w", "S0", 4)  # reordered reply: no-op
    assert c.watermark("w", "S0") == 9
    fresh = np.full((1, DIM), 2.0, np.float32)
    stale = np.full((1, DIM), 1.0, np.float32)
    c.insert("w", np.array([3]), fresh, sver=10, server="S0")
    c.insert("w", np.array([3]), stale, sver=9, server="S0")  # late reply
    np.testing.assert_array_equal(c.lookup("w", 3, "S0"), fresh[0])


def test_cache_owner_mismatch_misses_before_any_epoch_adoption():
    """Entries remember their source server, so a row whose range moved
    misses at once, before the worker clears the cache on adoption."""
    c = HotRowCache(64)
    c.insert("w", np.array([5]), np.ones((1, DIM), np.float32), 1, "S1")
    assert c.lookup("w", 5, "S0") is None
    assert c.invalidations == 1


def test_cache_collision_eviction_bounds_memory():
    c = HotRowCache(4)  # 4 lines: keys 1 and 5 share line 1
    c.insert("w", np.array([1]), np.full((1, DIM), 1.0, np.float32), 1, "S0")
    c.insert("w", np.array([5]), np.full((1, DIM), 5.0, np.float32), 1, "S0")
    assert c.lookup("w", 1, "S0") is None
    np.testing.assert_array_equal(c.lookup("w", 5, "S0"), np.full(DIM, 5.0, np.float32))
    assert len(c) == 1


def test_lookup_many_matches_scalar_semantics():
    c = HotRowCache(64, audit=True)
    keys = np.array([1, 2, 3])
    rows = np.arange(3 * DIM, dtype=np.float32).reshape(3, DIM)
    c.insert("w", keys, rows, sver=2, server="S0")
    c.insert("w", np.array([3]), rows[2:], sver=2, server="S1")  # moved row
    code0 = c.server_code("S0")
    slots = np.array([1, 2, 3, 9], dtype=np.int64)
    hit, hit_rows = c.lookup_many("w", slots, np.full(4, code0, dtype=np.int32))
    assert hit.tolist() == [True, True, False, False]
    np.testing.assert_array_equal(hit_rows, rows[:2])
    assert c.invalidations == 1  # key 3 cached from S1, probed for S0
    assert c.hits == 2 and c.misses == 2
    assert [a[:2] for a in c.audit] == [("w", 1), ("w", 2)]
    assert all(sv >= wm for _, _, sv, wm in c.audit)


def test_lookup_stale_ignores_freshness_and_invalidate_all_keeps_wm():
    c = HotRowCache(64)
    c.insert("w", np.array([2]), np.ones((1, DIM), np.float32), 1, "S0")
    c.observe("w", "S0", 99)
    row, sver = c.lookup_stale("w", 2)
    np.testing.assert_array_equal(row, np.ones(DIM, np.float32))
    assert sver == 1
    assert c.invalidate_all(reason="test") == 1 and len(c) == 0
    assert c.watermark("w", "S0") == 99  # watermarks shadow server clocks
