"""The port's growing ``Localizer`` against the JAX package's, on the CPU.

``parameter_server_tpu_torch/utils/keys.py`` carries a copy of the JAX
``Localizer`` with both engines: the C++ keymap (a copy of
``native/src/keymap.cc``, built by g++ at first use into the port's build
directory) and the windowed numpy probe that stands in where no toolchain
is found.  These tests replay the JAX package's ``Localizer`` cases on the
port, feed the same key streams (duplicates, ``PAD_KEY``, past capacity,
table growth) through every engine of both packages, and hold
``localizer_meta`` / ``localizer_from_meta`` to the JAX ones.  Host code:
every slot compared exactly.
"""

import os
import shutil

import numpy as np
import pytest

from parameter_server_tpu.utils import keys as jax_keys
from parameter_server_tpu_torch import native
from parameter_server_tpu_torch.utils import keys
from parameter_server_tpu_torch.utils.keys import (
    PAD_KEY,
    HashLocalizer,
    IdentityLocalizer,
    Localizer,
    localizer_from_meta,
    localizer_meta,
)


def _engine(module, capacity, engine, monkeypatch):
    """A ``Localizer`` of ``module`` on the named engine."""
    if engine == "numpy":
        monkeypatch.setattr(module, "_native_keymap", lambda cap: None)
    loc = module.Localizer(capacity=capacity)
    monkeypatch.undo()
    if engine == "native" and loc._native is None:  # pragma: no cover
        pytest.skip("no native toolchain on this host")
    assert (loc._native is None) == (engine == "numpy")
    return loc


# ------------------------------------------------------- the JAX cases


@pytest.mark.parametrize("engine", ["native", "numpy"])
def test_localizer_stable_slots(engine, monkeypatch):
    loc = _engine(keys, 100, engine, monkeypatch)
    a = loc.assign(np.array([7, 3, 9], dtype=np.uint64))
    b = loc.assign(np.array([9, 7, 11], dtype=np.uint64))
    assert b[0] == a[2] and b[1] == a[0]  # same key -> same slot
    assert len(loc) == 4
    assert not loc.overflowed


@pytest.mark.parametrize("engine", ["native", "numpy"])
def test_localizer_pad_key_to_trash_row(engine, monkeypatch):
    loc = _engine(keys, 10, engine, monkeypatch)
    slots = loc.assign(np.array([1, PAD_KEY], dtype=np.uint64))
    assert slots[1] == 10  # trash row == capacity


@pytest.mark.parametrize("engine", ["native", "numpy"])
def test_localizer_overflow_hashes(engine, monkeypatch):
    loc = _engine(keys, 4, engine, monkeypatch)
    slots = loc.assign(np.arange(10, dtype=np.uint64))
    assert loc.overflowed
    assert np.all(slots < 4)
    # stable even after overflow
    again = loc.assign(np.arange(10, dtype=np.uint64))
    np.testing.assert_array_equal(slots, again)


@pytest.mark.parametrize("engine", ["native", "numpy"])
def test_localizer_bounded_after_overflow(engine, monkeypatch):
    loc = _engine(keys, 4, engine, monkeypatch)
    loc.assign(np.arange(1000, dtype=np.uint64))
    # the vocab stays bounded by capacity; overflow keys hash, not cached
    assert len(loc) == 4 and loc.overflowed


@pytest.mark.parametrize("capacity", [0, -1, 2**31 - 1])
def test_localizer_bad_capacity(capacity):
    with pytest.raises(ValueError):
        Localizer(capacity=capacity)


@pytest.mark.parametrize("engine", ["native", "numpy"])
def test_localizer_duplicate_new_keys_share_slot(engine, monkeypatch):
    loc = _engine(keys, 100, engine, monkeypatch)
    out = loc.assign(np.array([5, 5, 7], dtype=np.uint64))
    assert out.tolist() == [0, 0, 1]
    assert len(loc) == 2


def test_localizer_engines_agree(monkeypatch):
    """Native C++ keymap and the numpy fallback produce identical slot
    streams — sequential ids, overflow hashing, PAD, duplicates sharing a
    slot, and table growth/rehash (vocab crosses both engines' initial
    1<<16 table at load factor 1/2)."""
    native_loc = _engine(keys, 50_000, "native", monkeypatch)
    fallback = _engine(keys, 50_000, "numpy", monkeypatch)
    rng = np.random.default_rng(3)
    for i in range(20):
        n = int(rng.integers(1, 4000))
        batch = np.unique(rng.integers(0, 2**62, size=n).astype(np.uint64))
        if i % 3 == 0:
            batch = np.concatenate([batch, [PAD_KEY]])
        if i % 4 == 0 and batch.size > 2:  # duplicates share one slot
            batch = np.concatenate([batch, batch[:2]])
        np.testing.assert_array_equal(native_loc.assign(batch), fallback.assign(batch))
    assert len(native_loc) == len(fallback) > (1 << 16) // 2  # growth exercised
    assert native_loc.overflowed == fallback.overflowed


# ------------------------------------------------ port against the JAX package


def _stream(seed, capacity):
    """Batches of keys with duplicates, PAD_KEY, 2-D shapes and, near the
    end, more distinct keys than ``capacity``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(12):
        n = int(rng.integers(1, 3 * capacity // 10))
        batch = rng.integers(0, 2**63, size=n, dtype=np.uint64)
        if i % 2 == 0:
            batch = np.concatenate([batch, batch[: n // 3]])  # repeats
        if i % 3 == 1:
            batch = np.concatenate([[PAD_KEY], batch, [PAD_KEY]]).astype(np.uint64)
        if i == 5 and batch.size % 2 == 0:
            batch = batch.reshape(2, -1)
        out.append(batch)
    return out


@pytest.mark.parametrize("engine", ["native", "numpy"])
@pytest.mark.parametrize("capacity", [300, 40_000])
def test_port_and_jax_localizers_give_identical_slots(engine, capacity, monkeypatch):
    port = _engine(keys, capacity, engine, monkeypatch)
    ref = _engine(jax_keys, capacity, engine, monkeypatch)
    for batch in _stream(capacity, capacity):
        got, want = port.assign(batch), ref.assign(batch)
        assert got.dtype == want.dtype == np.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert len(port) == len(ref)
    assert port.overflowed == ref.overflowed
    if capacity == 300:
        assert port.overflowed


def test_port_native_engine_equals_jax_numpy_engine(monkeypatch):
    """Across packages and engines at once: the port's keymap against the
    JAX package's numpy probe."""
    port = _engine(keys, 5_000, "native", monkeypatch)
    ref = _engine(jax_keys, 5_000, "numpy", monkeypatch)
    for batch in _stream(11, 5_000):
        np.testing.assert_array_equal(port.assign(batch), ref.assign(batch))


def test_native_library_builds_into_the_port_build_directory():
    if shutil.which(native._CXX) is None:  # pragma: no cover
        pytest.skip(f"no {native._CXX} on this host")
    lib = native.load("keymap")
    assert lib is not None
    path = native.library_path("keymap")
    assert os.path.exists(path)
    parts = path.split(os.sep)
    assert parts[-3:-1] == ["build", "native"] and "parameter_server_tpu_torch" in parts
    assert native.load("keymap") is lib  # cached per process


def test_missing_toolchain_degrades_to_numpy(monkeypatch):
    monkeypatch.setattr(native, "_cache", {})
    monkeypatch.setattr(native, "_CXX", "no-such-compiler-x")
    monkeypatch.setattr(native, "library_path",
                        lambda name: os.path.join(native._LIB_DIR, "absent.so"))
    assert native.load("keymap") is None
    with pytest.raises(OSError):
        native.load("keymap", required=True)


# ------------------------------------------------------- meta round trips


@pytest.mark.parametrize("make", [
    lambda m: m.HashLocalizer(1 << 12),
    lambda m: m.HashLocalizer(1 << 10, seed=7, hash_bits=32),
    lambda m: m.IdentityLocalizer(500),
    lambda m: m.Localizer(300),
], ids=["hash64", "hash32", "identity", "growing"])
def test_localizer_meta_matches_jax(make):
    assert localizer_meta(make(keys)) == jax_keys.localizer_meta(make(jax_keys))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("make", [
    lambda m: m.HashLocalizer(1 << 12, seed=3),
    lambda m: m.HashLocalizer(1 << 10, seed=7, hash_bits=32),
    lambda m: m.IdentityLocalizer(500),
], ids=["hash64", "hash32", "identity"])
def test_localizer_from_meta_round_trips_between_packages(direction, make):
    src_mod, dst_mod = (jax_keys, keys) if direction == "jax_to_port" else (keys, jax_keys)
    src = make(src_mod)
    rebuilt = dst_mod.localizer_from_meta(src_mod.localizer_meta(src))
    assert type(rebuilt).__name__ == type(src).__name__
    assert dst_mod.localizer_meta(rebuilt) == src_mod.localizer_meta(src)
    batch = np.concatenate([np.arange(0, 500, 7, dtype=np.uint64), [PAD_KEY]])
    np.testing.assert_array_equal(rebuilt.assign(batch), src.assign(batch))


def test_growing_localizer_does_not_rebuild_from_meta():
    with pytest.raises(ValueError, match="arrival-order"):
        localizer_from_meta(localizer_meta(Localizer(10)))
    assert isinstance(localizer_from_meta({"kind": "HashLocalizer", "capacity": 9}),
                      HashLocalizer)
    assert isinstance(localizer_from_meta({"kind": "IdentityLocalizer", "capacity": 9}),
                      IdentityLocalizer)
