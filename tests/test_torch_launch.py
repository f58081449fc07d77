"""The port's multi-process launch (``launch.py``) on the CPU.

Twins of ``tests/test_launch.py`` (4 cases), with ``device="cpu"``: a
barrier in one process, then real scheduler, server and worker processes
(fresh interpreters running ``python -m parameter_server_tpu_torch.launch``)
over ``TcpVan`` on localhost: training that lowers the loss and a
checkpoint that the JAX package reads back as its own; the lossy ``full``
filter stack against no filters (fewer payload bytes, the codec's
overhead recorded); the lossless default.  Every child's JSON reports the
device it ran on and its kernel launches (none on the CPU).

Tolerances: exact (host values and files).
"""

import json
import os
import threading

import numpy as np
import pytest

from parameter_server_tpu import checkpoint as jax_checkpoint
from parameter_server_tpu_torch import checkpoint, native
from parameter_server_tpu_torch.core.manager import launch_local_cluster
from parameter_server_tpu_torch.core.van import LoopbackVan
from parameter_server_tpu_torch.launch import launch

if native.load("tcpvan") is None:  # pragma: no cover
    pytest.skip("no native toolchain for tcpvan", allow_module_level=True)


def test_barrier_in_process():
    van = LoopbackVan()
    try:
        _sched, managers, _posts = launch_local_cluster(van, num_workers=2, num_servers=1)
        results = {}

        def enter(nid):
            results[nid] = managers[nid].barrier("b1", 3, timeout=20)

        threads = [threading.Thread(target=enter, args=(nid,)) for nid in ("H", "S0", "W0")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(results.values())
        assert managers["W1"].barrier("b2", 5, timeout=0.5) is False  # short of quorum
    finally:
        van.close()


def test_multiprocess_launch_trains_and_checkpoints(tmp_path):
    ckpt, outdir = str(tmp_path / "ckpt"), str(tmp_path / "out")
    os.makedirs(outdir)
    result = launch(num_workers=2, num_servers=2, steps=12, rows=4096, batch_size=128,
                    ckpt_root=ckpt, run_timeout=240.0, device="cpu", outdir=outdir)
    assert result["returncodes"] == [0] * 5, result
    assert result["workers_reported"] == ["W0", "W1"]
    assert result["steps_total"] == 24
    assert result["final_loss"] < result["first_loss"], result
    # worker 0's save_model committed a checkpoint both packages read
    step = checkpoint.latest_step(ckpt)
    assert step == 12 == jax_checkpoint.latest_step(ckpt)
    w = checkpoint.load_global_weights(ckpt, step, "w")
    assert w.shape == (4096, 1) and np.abs(w).sum() > 0
    np.testing.assert_array_equal(w, jax_checkpoint.load_global_weights(ckpt, step, "w"))
    # every server and worker child ran where it was told, launching nothing
    for node in ("S0", "S1", "W0", "W1"):
        with open(os.path.join(outdir, f"{node}.json")) as f:
            row = json.load(f)
        assert row["device"] == "cpu", row
        assert set(row["launches"]) == {"apply", "gather", "scatter_set", "scatter_add",
                                        "segment_sum"}
        assert not any(row["launches"].values()), row


def test_launch_with_wire_filters():
    """The full stack (key caching + int8 + zlib) on the socket cluster:
    training converges and fewer payload bytes leave the vans than in an
    identical unfiltered run."""
    common = dict(num_workers=2, num_servers=2, steps=12, rows=1 << 12, batch_size=128,
                  run_timeout=240.0, device="cpu")
    plain = launch(**common, filters="none")
    assert plain["returncodes"] == [0] * 5, plain
    filtered = launch(**common, filters="full")
    assert filtered["returncodes"] == [0] * 5, filtered
    assert filtered["steps_total"] == 24
    assert filtered["final_loss"] < filtered["first_loss"]
    assert plain["wire_sent"] > 0 and filtered["wire_sent"] > 0
    assert filtered["wire_sent"] < 0.7 * plain["wire_sent"], (
        filtered["wire_sent"], plain["wire_sent"])
    oh = filtered["filter_overhead"]
    assert oh is not None and oh["messages"] > 0, filtered
    assert oh["encode_us_per_msg"] < 5000, oh
    assert plain["filter_overhead"] is None  # no chain, no overhead entry


def test_launch_default_filters_on():
    """The launcher defaults to the LOSSLESS codec stack: an unconfigured
    launch reports filter overhead (a chain is present) and converges."""
    result = launch(num_workers=1, num_servers=1, steps=6, rows=1 << 10, batch_size=64,
                    run_timeout=240.0, device="cpu")
    assert result["returncodes"] == [0] * 3, result
    assert result["final_loss"] < result["first_loss"], result
    assert result["filter_overhead"] is not None, result
    assert result["filter_overhead"]["messages"] > 0
