"""The port's mesh and SPMD LR against the JAX package's, on an 8-rank gloo world.

Twin of ``tests/test_parallel.py``.  The JAX side runs in this process on
``conftest.py``'s 8 virtual CPU devices; the port's runs on 8 spawned gloo
ranks (``torch_world.World``, one per file), one rank per device, with a
``DeviceMesh`` of each shape built over that one world.  Every rank feeds the
whole global batch, as one JAX process does, and takes its data block.

Tolerances: host code exactly; a multi-rank trajectory against one device
and against the JAX mesh trainer rtol 2e-4 (``test_parallel.py:34``'s bound:
the data-axis sum reorders floats); a one-rank mesh bit for bit against the
single-device dense step, since every collective is then skipped.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from parameter_server_tpu.config import OptimizerConfig as JaxOptimizerConfig
from parameter_server_tpu.config import TableConfig as JaxTableConfig
from parameter_server_tpu.parallel import mesh as jmesh_lib
from parameter_server_tpu.parallel.lr_spmd import SpmdLRTrainer as JaxSpmdLRTrainer
from parameter_server_tpu_torch.data.synthetic import SyntheticCTR
from parameter_server_tpu_torch.learner.sgd import LocalLRTrainer
from parameter_server_tpu_torch.parallel import mesh as mesh_lib
from parameter_server_tpu_torch.parallel.lr_spmd import SpmdLRTrainer
from parameter_server_tpu_torch.utils.keys import PAD_KEY

import torch_world

SHAPES = [(8, 1), (4, 2), (1, 8), (2, 4)]
ROWS = 1 << 14
MESH_TOL = dict(rtol=2e-4)


@pytest.fixture(scope="module")
def world():
    w = torch_world.World(8)
    yield w
    w.close()


def _batches(n=10, seed=3):
    data = SyntheticCTR(key_space=1 << 14, nnz=8, batch_size=256, seed=seed, informative=0.3)
    return [data.next_batch() for _ in range(n)]


def _jax_cfg(rows=ROWS, lr=0.2):
    return JaxTableConfig(name="w", rows=rows, dim=1,
                          optimizer=JaxOptimizerConfig(kind="adagrad", learning_rate=lr))


def test_make_mesh_shapes(world):
    (shape, data_i, model_i), *rest = world.run(torch_world.mesh_shape, None)
    assert shape == {"data": 8, "model": 1} and (data_i, model_i) == (0, 0)
    got = world.run(torch_world.mesh_shape, (4, 2))
    assert all(g[0] == {"data": 4, "model": 2} for g in got)
    # row-major: rank r sits at (r // 2, r % 2)
    assert [(g[1], g[2]) for g in got] == [(r // 2, r % 2) for r in range(8)]
    errs = world.run(torch_world.make_mesh_error, (3, 2))
    assert all("devices" in e for e in errs), errs


@pytest.mark.parametrize("shape", SHAPES)
def test_spmd_matches_single_device_and_the_jax_mesh(world, shape):
    """The sharded step reproduces the single-device trajectory, and the JAX
    SPMD trainer's on the same mesh shape."""
    batches = _batches()
    per_rank = world.run(torch_world.lr_losses, shape, ROWS, batches)
    spmd = per_rank[0]
    assert all(r == spmd for r in per_rank)  # the loss is global
    local = LocalLRTrainer(torch_world.lr_cfg(ROWS), mode="dense", device="cpu")
    local_losses = [local.step(k, y) for k, y in batches]
    np.testing.assert_allclose(spmd, local_losses, **MESH_TOL)
    jtr = JaxSpmdLRTrainer(_jax_cfg(), jmesh_lib.make_mesh(shape))
    jax_losses = [jtr.step(k, y) for k, y in batches]
    np.testing.assert_allclose(spmd, jax_losses, **MESH_TOL)
    assert spmd[-1] < spmd[0] - 0.05


def test_one_rank_mesh_is_bitwise_the_single_device_step():
    """On a (1, 1) mesh (a world of this process) no collective runs, and the
    step is ``dense_fused_step``'s arithmetic: losses and table bit for bit."""
    batches = _batches(6, seed=5)
    spmd = SpmdLRTrainer(torch_world.lr_cfg(ROWS), mesh_lib.make_mesh((1, 1), device="cpu"))
    local = LocalLRTrainer(torch_world.lr_cfg(ROWS), mode="dense", device="cpu")
    for k, y in batches:
        assert spmd.step(k, y) == local.step(k, y)
    assert spmd.total_rows == ROWS + 1
    assert torch.equal(spmd.state.value, local.table.value)
    assert torch.equal(spmd.state.state["sum_sq"], local.table.state["sum_sq"])
    assert torch.equal(spmd.state.bias, local.bias)


def test_spmd_table_is_actually_sharded(world):
    got = world.run(torch_world.lr_shard_rows, (2, 4), 1 << 12)
    total = got[0][1]
    # model axis 4: each rank holds total_rows / 4 rows
    assert all(local == total // 4 for local, _ in got), got


def test_spmd_rejects_penalties(world):
    errs = world.run(torch_world.lr_rejects_penalties, (8, 1))
    assert all(e and "l1=l2=0" in e for e in errs), errs


def test_spmd_pad_keys_do_not_poison(world):
    """PAD_KEY positions under a sharded (padded) table stay inert: trash and
    pad rows exactly zero, and the table equals the JAX mesh trainer's."""
    rows = 1 << 12
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1 << 12, size=(64, 8), dtype=np.uint64)
    keys[:, -2:] = PAD_KEY  # variable-nnz padding
    labels = (rng.random(64) < 0.3).astype(np.float32)
    total, table = world.run(torch_world.lr_full_table, (4, 2), rows, keys, labels, 3)[0]
    assert total > rows + 1  # padding rows exist
    assert np.all(table[rows:] == 0.0)  # trash + pad rows zero
    jtr = JaxSpmdLRTrainer(_jax_cfg(rows), jmesh_lib.make_mesh((4, 2)))
    for _ in range(3):
        jtr.step(keys, labels)
    np.testing.assert_allclose(table, np.asarray(jtr.state.value), rtol=2e-4, atol=1e-7)


def test_a_mesh_on_the_card_never_drops_to_gloo_or_the_cpu():
    """Asked for on ``"cuda"`` where no card is visible, the mesh layer
    raises: it never forms a gloo world or runs on the CPU instead."""
    from parameter_server_tpu_torch.launch_spmd import launch_spmd
    from parameter_server_tpu_torch.parallel import distributed

    assert not torch.cuda.is_available()
    # no world yet: NCCL cannot start; a gloo world already here: refused
    with pytest.raises((RuntimeError, ValueError), match="CUDA device|needs a nccl world"):
        mesh_lib.make_mesh((1, 1), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_spmd(num_procs=1, device="cuda")
    with pytest.raises(ValueError, match="device='cpu'"):
        launch_spmd(num_procs=1, cpu_devices=4, device="cuda")


def test_spmd_from_a_jax_state_matches_the_jax_mesh_trainer(world):
    """One numpy state (a gaussian table, a positive AdaGrad ``sum_sq``, the
    trash and pad rows at their fills) in both packages at (4, 2): each port
    rank takes its row block through ``convert.trainer_from_numpy``."""
    import jax
    import jax.numpy as jnp

    rows = 1 << 12
    jtr = JaxSpmdLRTrainer(_jax_cfg(rows), jmesh_lib.make_mesh((4, 2)))
    rng = np.random.default_rng(7)
    shape = jtr.state.value.shape
    value = rng.normal(scale=0.1, size=shape).astype(np.float32)
    sum_sq = rng.uniform(0.01, 1.0, size=shape).astype(np.float32)
    value[rows:], sum_sq[rows:] = 0.0, 0.0
    put = lambda a, like: jax.device_put(jnp.asarray(a), like.sharding)
    jtr.state = jtr.state._replace(value=put(value, jtr.state.value),
                                   state={"sum_sq": put(sum_sq, jtr.state.state["sum_sq"])})
    batches = _batches(4, seed=11)
    losses, table = world.run(torch_world.lr_from_state, (4, 2), rows, value, sum_sq,
                              batches)[0]
    np.testing.assert_allclose(losses, [jtr.step(k, y) for k, y in batches], **MESH_TOL)
    np.testing.assert_allclose(table, np.asarray(jtr.state.value), rtol=2e-4, atol=1e-6)


_CARD_MESH = """
import json, torch, torch.distributed as dist
from parameter_server_tpu_torch.parallel import mesh as mesh_lib
m = mesh_lib.make_mesh((1, 1), device="cuda")
print(json.dumps([dist.get_backend(), dist.get_world_size(), m.device.type, m.shape]))
dist.destroy_process_group()
"""


@pytest.mark.cuda
def test_a_card_mesh_is_a_world_of_one_nccl_rank():
    """On the card a (1, 1) mesh forms a world-1 NCCL group of its own (in a
    child process: this one may already hold a gloo world)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL has no CPU mode")
    root = pathlib.Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", _CARD_MESH], capture_output=True, text=True,
                         timeout=120, check=True, env=dict(os.environ, PYTHONPATH=str(root)))
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == ["nccl", 1, "cuda", {"data": 1, "model": 1}]
