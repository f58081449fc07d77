"""The port's DLRM and ResNet trainers on a (data, model) mesh, on an 8-rank
gloo world, against the JAX package's mesh trainers and their one-device runs.

Twins of ``tests/test_dlrm.py:21``, ``:36`` and ``:45`` and of
``tests/test_resnet_dense.py:59``.  The port's ranks run in
``torch_world.World`` (one world for the file); the JAX side runs in this
process on ``conftest.py``'s 8 virtual CPU devices.

- The mesh DLRM starts from the JAX mesh trainer's state (its gaussian
  table, a positive AdaGrad ``sum_sq``, its flax MLP), each rank taking its
  row block through ``convert.dlrm_from_numpy``; 5 steps are held to JAX at
  ``test_torch_dlrm.py``'s trajectory tolerance (rtol / atol 1e-4).
- A DLRM step's memory is O(batch): on the CPU the bytes of every storage
  its operators make (forward, collectives, backward, optimizer) are
  counted, and must stay far below the rank's table bytes.
- The ResNet on a 2-way data axis equals one device on the same global
  batch at rtol 2e-4: its BatchNorm takes the global batch's statistics.
"""

import functools
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_tpu.config import OptimizerConfig as JaxOptimizerConfig
from parameter_server_tpu.config import TableConfig as JaxTableConfig
from parameter_server_tpu.models.dlrm import SpmdDLRMTrainer as JaxSpmdDLRMTrainer
from parameter_server_tpu.parallel import mesh as jmesh_lib
from parameter_server_tpu_torch.data.synthetic import SyntheticDLRM
from parameter_server_tpu_torch.learner.dense import SpmdDenseTrainer
from parameter_server_tpu_torch.models.resnet import ResNet

import torch_world

TRAJ = dict(rtol=1e-4, atol=1e-4)
ROWS = 1 << 14


@pytest.fixture(scope="module")
def world():
    w = torch_world.World(8)
    yield w
    w.close()


def test_dlrm_trains_on_mesh(world):
    data = SyntheticDLRM(key_space=1 << 14, batch_size=256, seed=0)
    batches = [data.next_batch() for _ in range(30)]
    kw = dict(n_dense=data.n_dense, n_sparse=data.n_sparse, learning_rate=0.005,
              min_bucket=1024)
    per_rank = world.run(torch_world.dlrm_losses, (4, 2), ROWS, batches, kw)
    losses = per_rank[0]
    assert all(r == losses for r in per_rank)  # the loss is global
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.02, losses[::10]


def test_dlrm_embedding_table_sharded(world):
    got = world.run(torch_world.dlrm_shard_rows, (2, 4), 1 << 12)
    assert len(got) == 8
    total = got[0][1]
    assert total % 4 == 0 and total >= (1 << 12) + 1
    assert all(local == total // 4 for local, _ in got), got


def test_mesh_dlrm_matches_the_jax_mesh_trainer(world):
    data = SyntheticDLRM(key_space=ROWS, batch_size=256, seed=1)
    batches = [data.next_batch() for _ in range(5)]
    kw = dict(n_dense=data.n_dense, n_sparse=data.n_sparse, learning_rate=0.01,
              min_bucket=1024, seed=1)
    jcfg = JaxTableConfig(name="emb", rows=ROWS, dim=16, init_scale=0.01,
                          optimizer=JaxOptimizerConfig(kind="adagrad", learning_rate=0.05))
    jtr = JaxSpmdDLRMTrainer(jcfg, jmesh_lib.make_mesh((2, 4)), **kw)
    value = np.asarray(jtr.emb_value)
    sum_sq = np.random.default_rng(101).uniform(0.01, 1.0, size=value.shape).astype(np.float32)
    sum_sq[ROWS:] = 0.0
    jtr.emb_state = {"sum_sq": jax.device_put(jnp.asarray(sum_sq),
                                              jtr.emb_state["sum_sq"].sharding)}
    mlp = jax.tree.map(np.asarray, jtr.mlp_params)
    losses, got_v, got_s, params = world.run(
        torch_world.dlrm_from_state, (2, 4), ROWS, value, {"sum_sq": sum_sq}, mlp,
        batches, kw)[0]
    want = [jtr.step(*b) for b in batches]
    np.testing.assert_allclose(losses, want, **TRAJ)
    np.testing.assert_allclose(got_v, np.asarray(jtr.emb_value), **TRAJ)
    np.testing.assert_allclose(got_s["sum_sq"], np.asarray(jtr.emb_state["sum_sq"]), **TRAJ)
    flat = dict(jax.tree_util.tree_flatten_with_path(jtr.mlp_params)[0])
    jparams = {".".join(k.key for k in path): np.asarray(v) for path, v in flat.items()}
    assert set(jparams) == set(params)
    for name, want_p in jparams.items():
        np.testing.assert_allclose(params[name], want_p, err_msg=name, **TRAJ)
    assert np.all(got_v[ROWS:] == 0.0)  # trash and pad rows


def test_dlrm_16m_rows_step_memory_is_the_batch(world):
    """A 2^24-row table on a (2, 4) mesh: every rank's step allocates
    O(batch) bytes, never O(table) — a dense apply would touch the rank's
    whole 32 MiB value block (+ state) every step."""
    data = SyntheticDLRM(key_space=1 << 30, batch_size=128, seed=1)
    batch = data.next_batch()
    got = world.run(torch_world.dlrm_step_bytes, (2, 4), 1 << 24, 2, batch, 5, 1024)
    for step_bytes, table_bytes, losses in got:
        assert table_bytes == ((1 << 24) + 4) // 4 * 2 * 4 * 2  # rows x dim x f32 x 2 planes
        assert step_bytes < table_bytes / 16, (step_bytes, table_bytes)
        assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def _tiny_batch(rng, n=16):
    images = rng.normal(size=(n, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    return images, labels


def test_spmd_dense_trainer_learns_on_an_8_way_data_mesh(world):
    images, labels = _tiny_batch(np.random.default_rng(0))
    per_rank = world.run(torch_world.resnet_losses, (8, 1), images, labels, 30, 0.3)
    losses = per_rank[0]
    assert all(r == losses for r in per_rank)
    assert losses[-1] < losses[0] - 0.5, losses[::10]


def test_two_data_ranks_equal_one_device_on_the_global_batch(world):
    """BatchNorm over a data-sharded batch takes the global batch's
    statistics (as under GSPMD), so 2 data ranks of 8 examples train the
    same model as one device on all 16."""
    images, labels = _tiny_batch(np.random.default_rng(1))
    mesh_losses = world.run(torch_world.resnet_losses, (2, 4), images, labels, 5, 0.1)[0]
    model = ResNet([1, 1], num_classes=10, width=8, bottleneck=False, small_inputs=True)
    one = SpmdDenseTrainer(model, functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9),
                           device="cpu")
    one_losses = [one.step(images, labels) for _ in range(5)]
    np.testing.assert_allclose(mesh_losses, one_losses, rtol=2e-4)


_CARD_DLRM = """
import json, numpy as np, torch, torch.distributed as dist
from parameter_server_tpu_torch.config import OptimizerConfig, TableConfig
from parameter_server_tpu_torch.data.synthetic import SyntheticDLRM
from parameter_server_tpu_torch.models.dlrm import SpmdDLRMTrainer
from parameter_server_tpu_torch.ops import scatter
from parameter_server_tpu_torch.parallel import mesh as mesh_lib
from parameter_server_tpu_torch.utils.keys import localize_to_slots
rows = 1 << 20
cfg = TableConfig(name="emb", rows=rows, dim=16, init_scale=0.01,
                  optimizer=OptimizerConfig(kind="adagrad", learning_rate=0.05))
tr = SpmdDLRMTrainer(cfg, mesh_lib.make_mesh((1, 1), device="cuda"), min_bucket=1024)
data = SyntheticDLRM(key_space=rows, batch_size=256, seed=0)
scatter.reset_launch_counts()
for _ in range(3):
    tr.step(*data.next_batch())
launches = scatter.launch_counts()
table = tr.emb_value.nbytes + tr.emb_state["sum_sq"].nbytes
torch.cuda.synchronize()
base = torch.cuda.memory_allocated()
torch.cuda.reset_peak_memory_stats()
keys, dense, labels = data.next_batch()
tr.step(keys, dense, labels)
torch.cuda.synchronize()
peak = torch.cuda.max_memory_allocated() - base
slots = localize_to_slots(keys, tr.localizer, min_bucket=1024)[0]
ids = torch.from_numpy(slots.astype(np.int32)).cuda()
planes = [tr.emb_value, tr.emb_state["sum_sq"]]
got = scatter.cuda_gather_planes(planes, ids)
err = max(float((a - scatter.gather_rows_torch(p, ids)).abs().max()) for a, p in zip(got, planes))
print(json.dumps([launches, peak, table, err]))
dist.destroy_process_group()
"""


@pytest.mark.cuda
def test_card_mesh_dlrm_launches_its_kernels_on_owned_rows():
    """On the card, a (1, 1) mesh DLRM step is one ``ps_gather`` and one
    ``ps_scatter_set`` launch, the gather agrees with its plain version on
    the owned ids, and a step's peak memory is O(batch) (a child process
    forms the NCCL world)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    root = pathlib.Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", _CARD_DLRM], capture_output=True, text=True,
                         timeout=300, check=True, env=dict(os.environ, PYTHONPATH=str(root)))
    launches, peak, table, err = json.loads(out.stdout.strip().splitlines()[-1])
    assert launches == {"apply": 0, "gather": 3, "scatter_set": 3, "scatter_add": 0,
                        "segment_sum": 0}
    assert err == 0.0 and peak < table / 8, (peak, table)
