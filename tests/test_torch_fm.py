"""The port's factorization machine against the JAX package's, on the CPU.

Twins of ``tests/test_fm.py``: the logits against numpy (rtol 1e-5), the
per-position gradient against autograd (rtol 2e-4 / atol 1e-6), XOR
learned by the fused trainer and over the Van (then scored offline from a
checkpoint), and the LR offline evaluation.  Then the fused step against
``parameter_server_tpu.models.fm.fused_train_step`` from one numpy table
(value, nonzero optimizer state, the trash row at its fill) under each
optimizer, 4 steps on batches with repeated and PAD keys: losses and every
row of every plane within 1e-5; and the whole trainer against the JAX
trainer from the JAX trainer's table: losses within 1e-5, AUC equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parameter_server_tpu.config import OptimizerConfig as JaxOptimizerConfig
from parameter_server_tpu.config import TableConfig as JaxTableConfig
from parameter_server_tpu.kv.optim import make_optimizer as jax_make_optimizer
from parameter_server_tpu.learner.fm import LocalFMTrainer as JaxLocalFMTrainer
from parameter_server_tpu.models import fm as jfm
from parameter_server_tpu_torch import checkpoint, evaluation
from parameter_server_tpu_torch.config import OptimizerConfig, TableConfig
from parameter_server_tpu_torch.convert import trainer_from_numpy
from parameter_server_tpu_torch.core.postoffice import Postoffice
from parameter_server_tpu_torch.core.van import LoopbackVan
from parameter_server_tpu_torch.kv.optim import make_optimizer
from parameter_server_tpu_torch.kv.server import KVServer
from parameter_server_tpu_torch.kv.table import KVTable
from parameter_server_tpu_torch.kv.worker import KVWorker
from parameter_server_tpu_torch.learner.fm import LocalFMTrainer
from parameter_server_tpu_torch.models import fm
from parameter_server_tpu_torch.models.linear import logloss
from parameter_server_tpu_torch.utils.keys import PAD_KEY, HashLocalizer, localize_to_slots

CPU = "cpu"
OPTS = {
    "sgd": dict(kind="sgd", learning_rate=0.5, l1=0.01, l2=0.01),
    "adagrad": dict(kind="adagrad", learning_rate=0.1, l1=0.001, l2=0.01),
    "adam": dict(kind="adam", learning_rate=0.05, l1=0.01),
    "ftrl": dict(kind="ftrl", ftrl_alpha=0.5, l1=0.01, l2=0.1),
}


def _xor_batch(rng, batch=256, noise=0.0):
    a = rng.integers(0, 2, size=batch)
    b = rng.integers(0, 2, size=batch)
    keys = np.stack([10 + a, 20 + b], axis=1).astype(np.uint64)
    labels = (a == b).astype(np.float32)
    if noise:
        flip = rng.random(batch) < noise
        labels = np.where(flip, 1 - labels, labels)
    return keys, labels


def test_fm_logits_matches_numpy():
    rng = np.random.default_rng(0)
    rows_pos = rng.normal(size=(4, 3, 5)).astype(np.float32)  # k=4
    got = fm.fm_logits(torch.from_numpy(rows_pos), 0.3).numpy()
    w = rows_pos[..., 0].sum(axis=-1)
    v = rows_pos[..., 1:]
    s = v.sum(axis=1)
    pair = 0.5 * (s**2 - (v**2).sum(axis=1)).sum(axis=-1)
    np.testing.assert_allclose(got, w + pair + 0.3, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jfm.fm_logits(jnp.asarray(rows_pos), 0.3)),
                               rtol=1e-5)


def test_fm_grad_rows_matches_autodiff():
    rng = np.random.default_rng(1)
    rows_pos = torch.from_numpy(rng.normal(size=(8, 4, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 2, size=8).astype(np.float32))
    g, g_bias, loss = fm.fm_grad_rows(rows_pos, labels)
    rp = rows_pos.clone().requires_grad_(True)
    want_loss = logloss(fm.fm_logits(rp, 0.0), labels)
    (want,) = torch.autograd.grad(want_loss, rp)
    np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=2e-4, atol=1e-6)
    assert float(loss) == pytest.approx(float(want_loss.detach()), rel=1e-5)
    jg, jgb, jloss = jfm.fm_grad_rows(jnp.asarray(rows_pos.numpy()), jnp.asarray(labels.numpy()))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-7)
    assert float(g_bias) == pytest.approx(float(jgb), rel=1e-5, abs=1e-7)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)


def test_local_fm_learns_xor():
    cfg = TableConfig(
        name="fm", rows=64, dim=1 + 4, init_scale=0.1,
        optimizer=OptimizerConfig(kind="adagrad", learning_rate=0.2),
    )
    tr = LocalFMTrainer(cfg, min_bucket=8, seed=1, device=CPU)
    rng = np.random.default_rng(2)
    losses = [tr.step(*_xor_batch(rng)) for _ in range(150)]
    assert np.mean(losses[-10:]) < 0.25, np.mean(losses[-10:])  # linear floor ~0.69
    auc = tr.eval_auc(lambda: _xor_batch(rng), 4)
    assert auc > 0.95, auc


def test_fm_van_path_trains(tmp_path):
    """Classic PS loop: pull [1+k] rows -> fm_grad_rows -> push; then save
    the model and score it offline via evaluate_checkpoint."""
    van = LoopbackVan()
    try:
        cfgs = {
            "fm": TableConfig(
                name="fm", rows=64, dim=1 + 4, init_scale=0.1,
                optimizer=OptimizerConfig(kind="adagrad", learning_rate=0.2),
            )
        }
        _servers = [KVServer(Postoffice(f"S{i}", van), cfgs, i, 2, device=CPU)
                    for i in range(2)]
        worker = KVWorker(Postoffice("W0", van), cfgs, 2, min_bucket=8, device=CPU)
        rng = np.random.default_rng(3)
        losses = []
        for _ in range(150):
            keys, labels = _xor_batch(rng, batch=256)
            rows_pos = worker.pull_sync("fm", keys, timeout=20)
            g, _gb, loss = fm.fm_grad_rows(torch.from_numpy(rows_pos),
                                           torch.from_numpy(labels))
            ts = worker.push("fm", keys, g.numpy())
            assert worker.wait(ts, timeout=20)
            losses.append(float(loss))
        assert np.mean(losses[-10:]) < 0.3, np.mean(losses[-10:])

        worker.save_model(str(tmp_path), step=1)
        batches = [_xor_batch(rng) for _ in range(4)]
        report = evaluation.evaluate_checkpoint(
            str(tmp_path), "fm", batches, model="fm", localizer=worker.localizers["fm"],
        )
        assert report["auc"] > 0.95, report
        assert report["step"] == 1
        # the manifest's localizer alone scores the same
        again = evaluation.evaluate_checkpoint(str(tmp_path), "fm", batches, model="fm")
        assert again == report
    finally:
        van.close()


def test_evaluate_checkpoint_lr(tmp_path):
    """LR offline eval: known weights -> known ranking."""
    cfg = TableConfig(name="w", rows=32, dim=1, optimizer=OptimizerConfig(kind="sgd"))
    table = KVTable(cfg, rows=32, device=CPU)
    loc = HashLocalizer(32)
    pos_key = np.array([[7]], dtype=np.uint64)
    neg_key = np.array([[13]], dtype=np.uint64)
    buf = np.zeros((33, 1), np.float32)
    buf[loc.assign(pos_key)[0, 0]] = 3.0
    buf[loc.assign(neg_key)[0, 0]] = -3.0
    table.set_value(buf)
    checkpoint.save_shard(str(tmp_path), 5, "w", table, 0, 1, 0)
    checkpoint.finalize(str(tmp_path), 5, 1, {"w": 32})

    batches = [(np.array([[7], [13]], dtype=np.uint64), np.array([1.0, 0.0], np.float32))]
    report = evaluation.evaluate_checkpoint(str(tmp_path), "w", batches, model="lr",
                                            localizer=loc)
    assert report["auc"] == 1.0
    assert report["examples"] == 2
    with pytest.raises(ValueError, match="unknown model"):
        evaluation.evaluate_checkpoint(str(tmp_path), "w", batches, model="nn")


def _fm_batches(rng, n, batch=64, nnz=5, key_space=200):
    out = []
    for _ in range(n):
        keys = rng.integers(0, key_space, size=(batch, nnz)).astype(np.uint64)
        keys[rng.random(keys.shape) < 0.05] = PAD_KEY  # tail-filtered positions
        labels = (rng.random(batch) < 0.5).astype(np.float32)
        out.append((keys, labels))
    return out


@pytest.mark.parametrize("kind", list(OPTS))
def test_fused_step_matches_jax(kind):
    """4 fused steps from one numpy table: losses and every plane (trash row
    included) within 1e-5; the trash row stays at zero and its fills."""
    rows, dim = 128, 1 + 4
    rng = np.random.default_rng(5)
    jopt = jax_make_optimizer(JaxOptimizerConfig(**OPTS[kind]))
    opt = make_optimizer(OptimizerConfig(**OPTS[kind]))
    value = rng.normal(0, 0.1, size=(rows + 1, dim)).astype(np.float32)
    value[-1] = 0
    fills = opt.state_shapes()
    state = {k: np.abs(rng.normal(size=(rows + 1, dim))).astype(np.float32) for k in fills}
    if "t" in state:
        state["t"] = np.floor(state["t"] * 3)
    for k, f in fills.items():
        state[k][-1] = f
    bias = np.full((1, 1), 0.1, np.float32)
    bias_state = {k: np.full((1, 1), f, np.float32) for k, f in fills.items()}

    jv, js = jnp.asarray(value), {k: jnp.asarray(v) for k, v in state.items()}
    jb, jbs = jnp.asarray(bias), {k: jnp.asarray(v) for k, v in bias_state.items()}
    tv, ts = torch.tensor(value), {k: torch.tensor(v) for k, v in state.items()}
    tb, tbs = torch.tensor(bias), {k: torch.tensor(v) for k, v in bias_state.items()}
    loc = HashLocalizer(rows)
    for keys, labels in _fm_batches(rng, 4):
        slots, inverse, _n = localize_to_slots(keys, loc, min_bucket=16)
        jv, js, jb, jbs, jloss = jfm.fused_train_step(
            jv, js, jb, jbs, jnp.asarray(slots), jnp.asarray(inverse),
            jnp.asarray(labels), jopt, slots.shape[0])
        tloss = fm.fused_train_step(
            tv, ts, tb, tbs, torch.from_numpy(slots), torch.from_numpy(inverse),
            torch.from_numpy(labels), opt, slots.shape[0])
        assert float(tloss) == pytest.approx(float(jloss), rel=1e-5, abs=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    for k in state:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-5)
    assert not tv[-1].any()
    for k, f in fills.items():
        assert bool((ts[k][-1] == f).all())


def test_trainer_matches_jax_trainer():
    """The whole trainer from the JAX trainer's table: 4 steps' losses within
    1e-5, the tables within 1e-5, and the same AUC on held-out batches."""
    jcfg = JaxTableConfig(name="fm", rows=256, dim=1 + 8, init_scale=0.1,
                          optimizer=JaxOptimizerConfig(kind="adagrad", learning_rate=0.1))
    cfg = TableConfig(name="fm", rows=256, dim=1 + 8, init_scale=0.1,
                      optimizer=OptimizerConfig(kind="adagrad", learning_rate=0.1))
    jtr = JaxLocalFMTrainer(jcfg, min_bucket=32, seed=3)
    tr = LocalFMTrainer(cfg, min_bucket=32, seed=3, device=CPU)
    trainer_from_numpy(tr, np.asarray(jtr.table.value),
                       {k: np.asarray(v) for k, v in jtr.table.state.items()},
                       np.asarray(jtr.bias), {k: np.asarray(v) for k, v in jtr.bias_state.items()})
    rng = np.random.default_rng(8)
    for keys, labels in _fm_batches(rng, 4, batch=128, nnz=6, key_space=1000):
        assert tr.step(keys, labels) == pytest.approx(jtr.step(keys, labels), rel=1e-5,
                                                      abs=1e-5)
    np.testing.assert_allclose(tr.table.value.numpy(), np.asarray(jtr.table.value),
                               rtol=1e-5, atol=1e-5)
    held = _fm_batches(np.random.default_rng(9), 3, batch=128, nnz=6, key_space=1000)
    it_a, it_b = iter(held), iter(held)
    assert tr.eval_auc(lambda: next(it_a), 3) == pytest.approx(
        jtr.eval_auc(lambda: next(it_b), 3), abs=1e-6)


def test_trainer_checks_and_card_default():
    import inspect

    with pytest.raises(ValueError, match="1 \\+ k"):
        LocalFMTrainer(TableConfig(name="fm", rows=8, dim=1), device=CPU)
    param = inspect.signature(LocalFMTrainer.__init__).parameters["device"]
    assert param.default == "cuda" and param.kind is inspect.Parameter.KEYWORD_ONLY
