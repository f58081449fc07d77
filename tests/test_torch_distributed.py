"""The port's multi-host SPMD job against the JAX package's, on the CPU.

Twin of ``tests/test_distributed.py``.  A JAX process with ``cpu_devices=4``
is a host of 4 gloo ranks here, so ``launch_spmd(num_procs=2,
cpu_devices=4, device="cpu")`` runs 8 ranks as 2 hosts on a ``(2, 4)`` mesh.
The JAX multi-process job cannot run on its CPU backend, so the JAX side of
the data check is its host code: ``_assign_shards`` and the seeded
``SyntheticCTR`` streams, whose first batch gives the per-host digests.

Tolerances: host code bit for bit; 2 hosts against 1 host of 8 ranks rtol
1e-4 / atol 1e-6 (the JAX test's); a resumed run against the uninterrupted
one exactly (the same reductions in the same order).
"""

import os

import numpy as np
import pytest

from parameter_server_tpu import launch_spmd as jlaunch_spmd
from parameter_server_tpu.data.synthetic import SyntheticCTR as JaxSyntheticCTR
from parameter_server_tpu.parallel import distributed as jdistributed
from parameter_server_tpu_torch.launch_spmd import _assign_shards, launch_spmd
from parameter_server_tpu_torch.parallel import distributed

STEPS = 6
ROWS = 1 << 12
GLOBAL_BATCH = 256
COMMON = dict(num_procs=2, cpu_devices=4, steps=STEPS, rows=ROWS,
              global_batch=GLOBAL_BATCH, nnz=8, mesh_data=2, seed=0,
              timeout=120.0, data_shards=4, device="cpu", group_timeout=60.0)


@pytest.fixture(scope="module")
def base():
    """The uninterrupted 2-host run, shared by the cases that compare to it."""
    result = launch_spmd(**COMMON)
    assert result["returncodes"] == [0, 0], result
    return result


def _jax_digest(proc, num_procs=2, n_shards=4):
    shards = jlaunch_spmd._assign_shards(num_procs, n_shards)[proc]
    keys = [JaxSyntheticCTR(key_space=4 * ROWS, nnz=8, batch_size=GLOBAL_BATCH // n_shards,
                            seed=7919 * (s + 1)).next_batch()[0] for s in shards]
    return int(np.concatenate(keys).astype(np.uint64).sum())


def test_launch_spmd_on_the_card_refuses_a_second_host():
    """Every host starts on this machine and its rank j takes cuda:j, so a
    second host on the card would share the cards: refused before any
    process starts (and before CUDA is asked for)."""
    with pytest.raises(ValueError, match="num_procs=2 would put several ranks on a card"):
        launch_spmd(num_procs=2, device="cuda")


def test_local_batch_slice_is_the_jax_function():
    for n in range(1, 9):
        for gb in (0, 7, 8, 64, 255, 256):
            for p in range(n):
                try:
                    want = jdistributed.local_batch_slice(p, n, gb)
                except ValueError as e:
                    with pytest.raises(ValueError, match=str(e)):
                        distributed.local_batch_slice(p, n, gb)
                    continue
                got = distributed.local_batch_slice(p, n, gb)
                assert (got.start, got.stop, got.step) == (want.start, want.stop, want.step)
    for n_procs, n_shards in ((1, 4), (2, 4), (4, 8), (2, 3)):
        try:
            want = jlaunch_spmd._assign_shards(n_procs, n_shards)
        except ValueError:
            with pytest.raises(ValueError):
                _assign_shards(n_procs, n_shards)
            continue
        assert _assign_shards(n_procs, n_shards) == want


def test_two_hosts_match_one_host_and_the_jax_data_shards(base):
    single = launch_spmd(**dict(COMMON, num_procs=1, cpu_devices=8))
    assert single["returncodes"] == [0], single
    single = single["losses"][0]
    assert single[-1] < single[0]  # it actually trains
    assert sorted(base["losses"]) == [0, 1]
    # every host reports the same (global, reduced) trajectory
    np.testing.assert_allclose(base["losses"][0], base["losses"][1], rtol=1e-6)
    # and it matches the single-host run over the same (2, 4) mesh, though
    # each host now generates only its own data shards
    np.testing.assert_allclose(base["losses"][0], single, rtol=1e-4, atol=1e-6)
    # per-host streams differ, and are the JAX job's streams byte for byte
    assert base["digests"][0] != base["digests"][1], base["digests"]
    assert base["digests"] == {0: _jax_digest(0), 1: _jax_digest(1)}


def test_rows_sharded_across_hosts():
    """mesh_data=1: the model (table-row) axis spans BOTH hosts, so table
    blocks live on different hosts and the row reductions cross them."""
    result = launch_spmd(**dict(COMMON, steps=4, mesh_data=1, data_shards=None))
    assert result["returncodes"] == [0, 0], result
    losses = result["losses"][0]
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_kill_and_rejoin_resumes_from_checkpoint(tmp_path, base):
    """Every host dies hard after step 3; a relaunch forms a new world,
    resumes from the step-2 checkpoint, and its trajectory equals the
    uninterrupted run's suffix exactly."""
    ckpt = str(tmp_path / "spmd_ckpt")
    broken = launch_spmd(**dict(COMMON, timeout=90.0), ckpt_root=ckpt, ckpt_every=2,
                         die_after_step=3, die_proc=-1)
    assert 17 in broken["returncodes"], broken  # the injected death
    assert os.path.exists(os.path.join(ckpt, "spmd_step000002.npz")), os.listdir(ckpt)
    with np.load(os.path.join(ckpt, "spmd_step000002.npz")) as z:
        assert sorted(z.files) == ["bias", "bias_state.sum_sq", "state.sum_sq", "value"]
        assert z["value"].shape == ((ROWS + 1 + 3) // 4 * 4, 1)  # total_rows at model 4
    resumed = launch_spmd(**COMMON, ckpt_root=ckpt, ckpt_every=2, resume=True)
    assert resumed["returncodes"] == [0, 0], resumed
    assert resumed["start_steps"][0] == 2, resumed["start_steps"]
    assert len(resumed["losses"][0]) == STEPS - 2
    assert resumed["losses"][0] == base["losses"][0][2:]


def test_a_dead_host_fails_its_peers_within_the_group_timeout():
    """One host exits after step 1; the other's ranks are left in a
    collective with no peer, which raises (no hang): the launcher reports
    both hosts' codes."""
    result = launch_spmd(**dict(COMMON, steps=4, timeout=60.0, group_timeout=5.0),
                         die_after_step=1, die_proc=1)
    assert result["returncodes"][1] == 17, result
    assert result["returncodes"][0] not in (0, None, -9), result
    assert result["rank_returncodes"][4:] == [17] * 4, result
