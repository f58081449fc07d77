"""The port's DLRM (BASELINE config #3) against the JAX package's, on the CPU.

Both trainers start from one numpy state: the JAX trainer's gaussian table,
AdaGrad ``sum_sq`` drawn positive (no row at its first touch, where the sign
of a near-zero gradient would decide the update) with the trash row at its
fill, and the JAX trainer's flax MLP params, carried into the port with
``convert.dlrm_from_numpy``.  The JAX side runs on a one-device mesh.
Tolerances: host data bit for bit; one step's loss, table planes and MLP
params within 1e-5; a 5-step trajectory within 1e-4 (errors compound).
"""

import ast
import io
import json
import pathlib
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_tpu.config import OptimizerConfig as JaxOptimizerConfig
from parameter_server_tpu.config import TableConfig as JaxTableConfig
from parameter_server_tpu.data.synthetic import SyntheticDLRM as JaxSyntheticDLRM
from parameter_server_tpu.data.synthetic import SyntheticImages as JaxSyntheticImages
from parameter_server_tpu.models.dlrm import DLRM as JaxDLRM
from parameter_server_tpu.models.dlrm import SpmdDLRMTrainer as JaxSpmdDLRMTrainer
from parameter_server_tpu.parallel import mesh as mesh_lib
from parameter_server_tpu_torch.config import OptimizerConfig, TableConfig
from parameter_server_tpu_torch.convert import dlrm_from_numpy
from parameter_server_tpu_torch.data.synthetic import SyntheticDLRM, SyntheticImages
from parameter_server_tpu_torch.kv.optim import make_optimizer
from parameter_server_tpu_torch.models.dlrm import (
    DLRM,
    SpmdDLRMTrainer,
    expand_rows,
    init_sharded_table,
)
from parameter_server_tpu_torch.parallel import dlrm_scale

ROOT = pathlib.Path(__file__).resolve().parent.parent
STEP = dict(rtol=1e-5, atol=1e-5)
TRAJ = dict(rtol=1e-4, atol=1e-4)
ROWS, DIM, BATCH = 1 << 14, 16, 256


def _cfgs(rows=ROWS, dim=DIM):
    opt = dict(kind="adagrad", learning_rate=0.05)
    return (JaxTableConfig(name="emb", rows=rows, dim=dim, init_scale=0.01,
                           optimizer=JaxOptimizerConfig(**opt)),
            TableConfig(name="emb", rows=rows, dim=dim, init_scale=0.01,
                        optimizer=OptimizerConfig(**opt)))


def _one_device_mesh():
    return mesh_lib.make_mesh((1, 1), devices=jax.devices()[:1])


def _pair(data, seed=0, learning_rate=0.01):
    """A JAX and a port trainer holding one state (see the module docstring)."""
    jcfg, cfg = _cfgs()
    kw = dict(n_dense=data.n_dense, n_sparse=data.n_sparse,
              learning_rate=learning_rate, min_bucket=1024, seed=seed)
    jtr = JaxSpmdDLRMTrainer(jcfg, _one_device_mesh(), **kw)
    value = np.asarray(jtr.emb_value)
    sum_sq = np.random.default_rng(seed + 100).uniform(0.01, 1.0, size=value.shape)
    sum_sq = sum_sq.astype(np.float32)
    sum_sq[ROWS:] = 0.0
    jtr.emb_state = {"sum_sq": jax.device_put(jnp.asarray(sum_sq),
                                              jtr.emb_state["sum_sq"].sharding)}
    tr = SpmdDLRMTrainer(cfg, device="cpu", **kw)
    dlrm_from_numpy(tr, value, {"sum_sq": sum_sq},
                    jax.tree.map(np.asarray, jtr.mlp_params))
    return jtr, tr


def _assert_state_close(jtr, tr, tol):
    np.testing.assert_allclose(tr.emb_value.numpy(), np.asarray(jtr.emb_value), **tol)
    np.testing.assert_allclose(tr.emb_state["sum_sq"].numpy(),
                               np.asarray(jtr.emb_state["sum_sq"]), **tol)
    flat = dict(jax.tree_util.tree_flatten_with_path(jtr.mlp_params)[0])
    jparams = {".".join(k.key for k in path): np.asarray(v) for path, v in flat.items()}
    params = dict(tr.model.named_parameters())
    assert set(jparams) == set(params)
    for name, want in jparams.items():
        np.testing.assert_allclose(params[name].detach().numpy(), want, err_msg=name, **tol)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_dlrm_batches_match_jax_bit_for_bit(seed):
    ours = SyntheticDLRM(key_space=1 << 28, batch_size=128, seed=seed)
    ref = JaxSyntheticDLRM(key_space=1 << 28, batch_size=128, seed=seed)
    for _ in range(3):
        for a, b in zip(ours.next_batch(), ref.next_batch()):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("classes,hw", [(10, 16), (1000, 8)])
def test_synthetic_images_match_jax_bit_for_bit(classes, hw):
    ours = SyntheticImages(num_classes=classes, hw=hw, batch_size=8, seed=5)
    ref = JaxSyntheticImages(num_classes=classes, hw=hw, batch_size=8, seed=5)
    for _ in range(2):
        for a, b in zip(ours.next_batch(), ref.next_batch()):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_dlrm_forward_matches_flax():
    """27 features: 351 interaction pairs in ``jnp.triu_indices`` order, a
    top MLP of 16 + 351 inputs; logits from one set of params agree."""
    model = JaxDLRM(bottom_mlp=(64, 32), top_mlp=(64, 32), emb_dim=DIM)
    rng = np.random.default_rng(1)
    dense = rng.normal(size=(32, 13)).astype(np.float32)
    emb = rng.normal(scale=0.1, size=(32, 26, DIM)).astype(np.float32)
    params = model.init(jax.random.PRNGKey(4), dense, emb)["params"]
    want = np.asarray(model.apply({"params": params}, dense, emb))
    ours = DLRM(13, 26, (64, 32), (64, 32), DIM)
    assert ours.MLP_1.Dense_0.kernel.shape == (16 + 351, 64)
    iu, ju = np.triu_indices(27, k=1)
    assert np.array_equal(ours.pairs.numpy(), iu * 27 + ju)
    from parameter_server_tpu_torch.convert import _copy_tree

    _copy_tree(dict(ours.named_parameters()), jax.tree.map(np.asarray, params), "dlrm")
    got = ours(torch.from_numpy(dense), torch.from_numpy(emb)).detach().numpy()
    np.testing.assert_allclose(got, want, **STEP)


def test_flax_init_statistics():
    """``lecun_normal``: truncated at 2 sigma, variance 1 / fan_in; zero bias."""
    model = DLRM(13, 26, (512,), (64,), DIM, generator=torch.Generator().manual_seed(0))
    k = model.MLP_1.Dense_0.kernel.detach().numpy()
    fan_in = k.shape[0]
    assert abs(k.var() * fan_in - 1.0) < 0.05
    assert np.abs(k).max() <= 2.0 / 0.87962566103423978 / np.sqrt(fan_in) + 1e-7
    assert float(model.MLP_1.Dense_0.bias.detach().abs().max()) == 0.0


def test_expand_rows_backward_is_the_position_order_segment_sum():
    rng = np.random.default_rng(2)
    rows = torch.tensor(rng.normal(size=(7, 4)), dtype=torch.float32, requires_grad=True)
    inverse = torch.tensor(rng.integers(0, 5, size=40))  # rows 5, 6 unused (pads)
    up = torch.tensor(rng.normal(size=(40, 4)), dtype=torch.float32)
    out = expand_rows(rows, inverse)
    assert torch.equal(out, rows.detach()[inverse])
    out.backward(up)
    want = torch.zeros(7, 4)
    for p in range(40):  # serial, in position order
        want[inverse[p]] += up[p]
    assert torch.equal(rows.grad, want)


def test_one_step_matches_jax():
    data = SyntheticDLRM(key_space=ROWS, batch_size=BATCH, seed=0)
    jtr, tr = _pair(data)
    keys, dense, labels = data.next_batch()
    want = jtr.step(keys, dense, labels)
    got = tr.step(keys, dense, labels)
    np.testing.assert_allclose(got, want, **STEP)
    _assert_state_close(jtr, tr, STEP)
    assert float(tr.emb_value[ROWS].abs().max()) == 0.0
    assert float(tr.emb_state["sum_sq"][ROWS].abs().max()) == 0.0


def test_five_step_trajectory_matches_jax():
    data = SyntheticDLRM(key_space=ROWS, batch_size=BATCH, seed=1)
    jtr, tr = _pair(data, seed=1)
    want, got = [], []
    for _ in range(5):
        keys, dense, labels = data.next_batch()
        want.append(jtr.step(keys, dense, labels))
        got.append(tr.step(keys, dense, labels))
    np.testing.assert_allclose(got, want, **TRAJ)
    _assert_state_close(jtr, tr, TRAJ)


def test_dlrm_trains():
    """The port's twin of ``tests/test_dlrm.py::test_dlrm_trains_on_mesh``."""
    data = SyntheticDLRM(key_space=1 << 14, batch_size=256, seed=0)
    trainer = SpmdDLRMTrainer(_cfgs()[1], device="cpu", n_dense=data.n_dense,
                              n_sparse=data.n_sparse, learning_rate=0.005,
                              min_bucket=1024)
    losses = [trainer.step(*data.next_batch()) for _ in range(30)]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.02, losses[::10]
    assert trainer.step_count == 30


def test_no_table_plane_requires_grad_and_step_memory_is_the_batch():
    data = SyntheticDLRM(key_space=1 << 20, batch_size=64, seed=2)
    trainer = SpmdDLRMTrainer(_cfgs()[1], device="cpu", min_bucket=1024)
    keys, dense, labels = data.next_batch()
    rep = [trainer.step(keys, dense, labels) for _ in range(5)]
    assert np.isfinite(rep).all() and rep[-1] < rep[0], rep
    planes = [trainer.emb_value, *trainer.emb_state.values()]
    assert not any(p.requires_grad or p.grad is not None for p in planes)
    assert all(p.grad is not None for p in trainer.model.parameters())


def test_init_sharded_table_zeros_matches_layout():
    """The port's twin of ``tests/test_dlrm.py::
    test_init_sharded_table_zeros_matches_layout`` on one device."""
    _, cfg = _cfgs(rows=1 << 10, dim=8)
    opt = make_optimizer(cfg.optimizer)
    total = cfg.rows + 1
    vz, sz = init_sharded_table(cfg, opt, total, kind="zeros", device="cpu")
    vn, sn = init_sharded_table(cfg, opt, total, torch.Generator().manual_seed(1),
                                kind="normal", device="cpu")
    assert vz.shape == vn.shape == (total, 8) and vz.device == vn.device
    assert float(vz.abs().max()) == 0.0
    assert float(vn[: cfg.rows].abs().max()) > 0.0
    assert float(vn[cfg.rows:].abs().max()) == 0.0  # trash row
    assert abs(float(vn[: cfg.rows].std()) - 0.01) < 0.001
    for k in sz:
        assert torch.equal(sz[k], sn[k])
    with pytest.raises(ValueError):
        init_sharded_table(cfg, opt, total, kind="uniform", device="cpu")


def _jax_out_keys():
    tree = ast.parse((ROOT / "parameter_server_tpu/parallel/dlrm_scale.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "out"
                and isinstance(node.value, ast.Dict)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no out = {...} in the JAX dlrm_scale")


def test_dlrm_scale_prints_the_jax_key_set():
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = dlrm_scale.main(["--rows-log2", "12", "--batch", "256", "--steps", "2",
                              "--min-bucket", "1024", "--device", "cpu"])
    assert rc == 0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert set(out) == _jax_out_keys()
    assert out["backend"] == "cpu" and out["mesh"] == {"data": 1, "model": 1}
    # two planes of (2^12 + 1) x 16 float32, read from the tensors
    assert out["table_gib"] == round(2 * ((1 << 12) + 1) * 16 * 4 / 2**30, 2)
    assert len(out["losses"]) == len(out["step_ms"]) == 2
    assert out["gathered_slots_per_step"] >= out["unique_rows_per_step"] > 0
    with pytest.raises(SystemExit):
        dlrm_scale.main(["--mesh", "1,8", "--device", "cpu"])


def test_dlrm_from_numpy_checks_shapes():
    data = SyntheticDLRM(key_space=ROWS, batch_size=8, seed=0)
    _, tr = _pair(data)
    with pytest.raises(ValueError):
        dlrm_from_numpy(tr, np.zeros((ROWS, DIM), np.float32),
                        {"sum_sq": np.zeros((ROWS, DIM), np.float32)}, {})


# ----------------------------------------------------------------------- MFU


def _closed_form_dense_flops(batch, n_dense, n_sparse, dim, bottom=(64, 32), top=(64, 32)):
    """2·M·N·K of every matmul of the dense part's forward and backward."""
    b_w = (n_dense,) + bottom + (dim,)
    f = n_sparse + 1
    t_w = (dim + f * (f - 1) // 2,) + top + (1,)
    mm = lambda ws: [2 * batch * a * b for a, b in zip(ws[:-1], ws[1:])]  # noqa: E731
    bottom_mm, top_mm = mm(b_w), mm(t_w)
    inter = 2 * batch * f * f * dim
    fwd = sum(bottom_mm) + sum(top_mm) + inter
    # backward: every weight gradient; input gradients for all but the first
    # bottom layer (the dense features need none); both operands of the bmm
    return fwd + sum(bottom_mm) + sum(top_mm) + sum(bottom_mm[1:]) + sum(top_mm) + 2 * inter


def test_mfu_counts_the_dense_part_exactly_and_executes_nothing(monkeypatch):
    """The step's MFU numerator is the exact 2·M·N·K sum of the dense part,
    counted at the first step and again when the slot bucket changes; the
    count runs nothing on the live state, so the losses and the table are
    bitwise those of a trainer that never counts.  The ratio to the JAX
    trainer's XLA count (which also counts the gathers, the optimizer and
    every elementwise op) is reported, and held only to a broad band."""
    data = SyntheticDLRM(key_space=ROWS, batch_size=BATCH, seed=3)
    batches = [data.next_batch() for _ in range(3)]
    jtr, tr = _pair(data, seed=3)
    _jtr2, quiet = _pair(data, seed=3)
    from parameter_server_tpu_torch.utils import metrics as metrics_lib

    counts = []
    real = metrics_lib.counted_flops_by_kind
    monkeypatch.setattr(metrics_lib, "counted_flops_by_kind",
                        lambda *a, **k: counts.append(1) or real(*a, **k))
    got = [tr.step(*b) for b in batches]
    monkeypatch.setattr(metrics_lib, "counted_flops_by_kind",
                        lambda *a, **k: {"conv": 0.0, "matmul": 0.0})
    want = [quiet.step(*b) for b in batches]
    assert got == want  # bitwise
    assert torch.equal(tr.emb_value, quiet.emb_value)
    assert torch.equal(tr.emb_state["sum_sq"], quiet.emb_state["sum_sq"])
    for a, b in zip(tr.model.parameters(), quiet.model.parameters()):
        assert torch.equal(a, b)
    assert 1 <= len(counts) <= 3
    per_example = _closed_form_dense_flops(BATCH, data.n_dense, data.n_sparse, DIM) / BATCH
    assert tr.dashboard.flops_per_example == per_example
    assert tr.dashboard.precision == "fp32" and tr.dashboard.peak_flops > 0
    jtr.step(*batches[0])
    jax_per_example = jtr.dashboard.flops_per_example
    ratio = per_example / jax_per_example
    print(f"DLRM flops/example: port {per_example:.0f}, JAX lowered {jax_per_example:.0f}, "
          f"ratio {ratio:.4f}")
    assert 0.25 < ratio < 4.0
