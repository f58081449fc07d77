"""The port's overlapped ingest pipeline (data/prefetch.py), on the CPU.

The seven cases of tests/test_prefetch.py against the port's pipeline: (a)
deterministic — consumers see exactly the block sequence a serial loop over
``make_block(0), make_block(1), ...`` produces, (b) leak-free — ``close()``
reclaims the producer thread even when it is blocked on a full queue, (c)
honest about stalls.  ``device_put=lambda x: x`` runs device-free; the
CPU staging (``device="cpu"``) wraps numpy arrays as tensors, uint32 keys as
their int32 view.
"""

import threading
import time

import numpy as np
import pytest

import torch

from parameter_server_tpu_torch.data.prefetch import PrefetchPipeline, host_tensor

IDENT = lambda x: x  # noqa: E731 — device-free H2D stand-in


def _threads():
    return threading.active_count()


@pytest.mark.parametrize("staging", ["identity", "cpu"])
def test_blocks_arrive_in_order_and_match_serial(staging):
    def make_block(i):
        rng = np.random.default_rng(i)
        return rng.normal(size=4).astype(np.float32), i

    kw = dict(device_put=IDENT) if staging == "identity" else dict(device="cpu")
    serial = [make_block(i) for i in range(16)]
    with PrefetchPipeline(make_block, depth=2, **kw) as pf:
        got = [pf.get() for _ in range(16)]
    for (ga, gi), (sa, si) in zip(got, serial):
        assert gi == si
        assert isinstance(ga, np.ndarray if staging == "identity" else torch.Tensor)
        np.testing.assert_array_equal(np.asarray(ga), sa)


def test_limit_terminates_and_iterator_protocol():
    with PrefetchPipeline(lambda i: i, depth=2, limit=5, device_put=IDENT) as pf:
        assert list(pf) == [0, 1, 2, 3, 4]
        with pytest.raises(StopIteration):  # later gets keep terminating
            pf.get()
    c = pf.counters()
    assert c["prefetch_produced"] == 5 and c["prefetch_consumed"] == 5


def test_close_reclaims_producer_blocked_on_full_queue():
    """An unbounded producer fills the depth-1 queue and blocks in put();
    close() must still stop it, join the thread, and drain the queue."""
    before = _threads()
    pf = PrefetchPipeline(lambda i: np.zeros(1024), depth=1, device="cpu")
    deadline = time.time() + 5
    while pf.counters()["prefetch_produced"] < 1 and time.time() < deadline:
        time.sleep(0.005)  # producer now parked on the full queue
    assert _threads() == before + 1
    pf.close()
    assert _threads() == before
    assert pf._q.empty()


def test_stall_counters_charge_slow_producer():
    def slow(i):
        time.sleep(0.03)
        return i

    with PrefetchPipeline(slow, depth=2, device_put=IDENT) as pf:
        for _ in range(4):
            pf.get()
        c = pf.counters()
    assert c["prefetch_stalls"] >= 1
    assert c["prefetch_stall_s"] > 0.0


def test_producer_error_propagates_to_consumer():
    def exploding(i):
        if i == 3:
            raise RuntimeError("bad shard")
        return i

    with PrefetchPipeline(exploding, depth=1, device_put=IDENT) as pf:
        assert [pf.get(), pf.get(), pf.get()] == [0, 1, 2]
        with pytest.raises(RuntimeError, match="bad shard"):
            pf.get()
        with pytest.raises(RuntimeError, match="bad shard"):  # sticky
            pf.get()


def test_depth_must_be_positive():
    with pytest.raises(ValueError, match="depth"):
        PrefetchPipeline(lambda i: i, depth=0, device_put=IDENT)


def test_device_put_runs_on_producer_thread():
    """The H2D stage belongs to the producer: none of it may run on the
    consumer's critical path."""
    consumer = threading.get_ident()
    seen = []

    def tagging_put(x):
        seen.append(threading.get_ident())
        return x

    with PrefetchPipeline(lambda i: i, depth=2, limit=3, device_put=tagging_put) as pf:
        assert list(pf) == [0, 1, 2]
    assert seen and all(t != consumer for t in seen)


def test_cpu_staging_maps_every_array_and_keeps_key_bits():
    keys = np.array([[0, 1, 2**31, 0xFFFFFFFF]], dtype=np.uint32)
    block = {"keys": keys, "rest": [np.ones(3, np.float32), ("tag", 7)]}
    with PrefetchPipeline(lambda i: block, depth=1, limit=1, device="cpu") as pf:
        (got,) = list(pf)
    assert got["keys"].dtype == torch.int32
    np.testing.assert_array_equal(got["keys"].numpy().view(np.uint32), keys)
    assert isinstance(got["rest"], list) and isinstance(got["rest"][0], torch.Tensor)
    assert got["rest"][1] == ("tag", 7)
    t = host_tensor(np.arange(6, dtype=np.int64).reshape(2, 3)[:, ::2])  # non-contiguous
    assert t.is_contiguous() and t.tolist() == [[0, 2], [3, 5]]
