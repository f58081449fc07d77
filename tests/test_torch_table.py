"""Parity of the port's KVTable (parameter_server_tpu_torch/kv/table.py) with
``parameter_server_tpu.kv.table.KVTable`` on the CPU: N pushes (unique ids +
trash pads carrying zero gradients) and pulls per optimizer, fused and
three-pass, both tables started from one numpy state.  float32 allclose at
rtol = atol = 1e-5 after each pull; the trash row must be exactly reset."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from parameter_server_tpu.config import OptimizerConfig as JaxOptimizerConfig
from parameter_server_tpu.config import TableConfig as JaxTableConfig
from parameter_server_tpu.kv.table import KVTable as JaxKVTable
from parameter_server_tpu_torch.config import OptimizerConfig, TableConfig
from parameter_server_tpu_torch.kv.table import KVTable
from parameter_server_tpu_torch.ops import scatter

TOL = dict(rtol=1e-5, atol=1e-5)
ROWS = 48
OPTS = {
    "sgd": dict(kind="sgd", learning_rate=0.1, l2=0.01),
    "adagrad": dict(kind="adagrad", learning_rate=0.1, l1=0.001),
    "adam": dict(kind="adam", learning_rate=0.05),
    "ftrl": dict(kind="ftrl", l1=0.1),
}
# (dim, JAX scatter_impl): dim 1 runs XLA there; the Pallas kernels in
# interpret mode are checked at dim 128 on the main path's rule
PATHS = [(1, "auto", k) for k in OPTS] + [(128, "auto", k) for k in OPTS]
PATHS += [(128, "pallas", "adagrad")]


def _pair(kind, dim, impl, fused, seed=0):
    rng = np.random.default_rng(seed)
    jt = JaxKVTable(JaxTableConfig(
        name="t", rows=ROWS, dim=dim, optimizer=JaxOptimizerConfig(**OPTS[kind]),
        scatter_impl=impl, fused_apply=fused,
    ))
    pt = KVTable(
        TableConfig(name="t", rows=ROWS, dim=dim, optimizer=OptimizerConfig(**OPTS[kind]),
                    fused_apply=fused),
        device="cpu",
    )
    value = rng.normal(size=(ROWS, dim)).astype(np.float32)
    state = {
        k: np.abs(rng.normal(size=(ROWS, dim))).astype(np.float32)
        for k in pt.optimizer.state_shapes()
    }
    if "t" in state:
        state["t"] = np.floor(state["t"] * 3)
    jt.install_rows(value, state)
    pt.install_rows(value, state)
    return jt, pt


def _assert_tables_close(jt, pt):
    np.testing.assert_allclose(pt.value.numpy(), np.asarray(jt.value), **TOL)
    for k in pt.state:
        np.testing.assert_allclose(pt.state[k].numpy(), np.asarray(jt.state[k]),
                                   err_msg=k, **TOL)
    fills = pt.optimizer.state_shapes()
    assert np.all(pt.value.numpy()[ROWS] == 0.0)
    for k, fill in fills.items():
        assert np.all(pt.state[k].numpy()[ROWS] == fill)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "three_pass"])
@pytest.mark.parametrize("dim,impl,kind", PATHS)
def test_push_pull_matches_jax(dim, impl, kind, fused):
    jt, pt = _pair(kind, dim, impl, fused)
    rng = np.random.default_rng(1)
    for step in range(3):
        # 8 ids: one Pallas block (interpret mode is slow)
        ids = np.concatenate(
            [np.sort(rng.choice(ROWS, size=5, replace=False)), np.full(3, ROWS)]
        ).astype(np.int32)
        grads = rng.normal(size=(8, dim)).astype(np.float32)
        grads[5:] = 0.0
        jt.push(jnp.asarray(ids), jnp.asarray(grads))
        pt.push(torch.from_numpy(ids), torch.from_numpy(grads))
        np.testing.assert_allclose(
            pt.pull(torch.from_numpy(ids)).numpy(),
            np.asarray(jt.pull(jnp.asarray(ids))),
            err_msg=f"pull after push {step}", **TOL,
        )
        _assert_tables_close(jt, pt)
    np.testing.assert_allclose(pt.weights().numpy(), np.asarray(jt.weights()), **TOL)


@pytest.mark.parametrize("dim", [1, 4, 128])
def test_ftrl_pull_gathers_z_and_n_in_one_call(dim, monkeypatch):
    """FTRL serves weights derived from ``z`` and its ``n`` plane: the port's
    pull gathers both in one call and matches the JAX ``KVTable.pull``."""
    jt, pt = _pair("ftrl", dim, "auto", True, seed=3)
    calls = []
    gather = scatter.gather_rows_planes

    def counting(tables, ids):
        calls.append(len(tables))
        return gather(tables, ids)

    monkeypatch.setattr(scatter, "gather_rows_planes", counting)
    rng = np.random.default_rng(4)
    ids = np.concatenate(
        [np.sort(rng.choice(ROWS, size=11, replace=False)), np.full(5, ROWS)]
    ).astype(np.int32)
    got = pt.pull(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, np.asarray(jt.pull(jnp.asarray(ids))), **TOL)
    assert calls == [2]
    assert np.any(got[:11] != 0.0) and np.all(got[11:] == 0.0)


@pytest.mark.parametrize("kind", sorted(OPTS))
def test_three_pass_push_writes_every_plane_in_one_call(kind, monkeypatch):
    """A three-pass push writes the value and every state plane back with one
    ``scatter_update_rows_planes`` call (one launch on the card) and matches
    the JAX table."""
    jt, pt = _pair(kind, 4, "auto", False, seed=7)
    calls = []
    write_back = scatter.scatter_update_rows_planes

    def counting(tables, ids, rows):
        calls.append(len(tables))
        return write_back(tables, ids, rows)

    monkeypatch.setattr(scatter, "scatter_update_rows_planes", counting)
    rng = np.random.default_rng(8)
    for _ in range(2):
        ids = np.concatenate(
            [np.sort(rng.choice(ROWS, size=5, replace=False)), np.full(3, ROWS)]
        ).astype(np.int32)
        grads = rng.normal(size=(8, 4)).astype(np.float32)
        grads[5:] = 0.0
        jt.push(jnp.asarray(ids), jnp.asarray(grads))
        pt.push(torch.from_numpy(ids), torch.from_numpy(grads))
    assert calls == [1 + len(pt.state)] * 2
    _assert_tables_close(jt, pt)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "three_pass"])
@pytest.mark.parametrize("kind", sorted(OPTS))
def test_installed_trash_row_is_at_its_fill_after_a_push(kind, fused):
    """A shard installed with a nonzero trash row (``resize``, which
    ``KVServer.import_shard`` calls) holds the row at its fill, which the
    fused push never rewrites: after a push every row of every plane matches
    the JAX table, which resets the row after each push."""
    jt, pt = _pair(kind, 4, "auto", fused, seed=5)
    value = np.asarray(jt.value).copy()
    state = {k: np.asarray(v).copy() for k, v in jt.state.items()}
    for plane in (value, *state.values()):
        plane[ROWS] = 3.5
    jt.resize(value, state)
    pt.resize(value, state)
    rng = np.random.default_rng(6)
    ids = np.concatenate(
        [np.sort(rng.choice(ROWS, size=5, replace=False)), np.full(3, ROWS)]
    ).astype(np.int32)
    grads = rng.normal(size=(8, 4)).astype(np.float32)
    grads[5:] = 0.0
    jt.push(jnp.asarray(ids), jnp.asarray(grads))
    pt.push(torch.from_numpy(ids), torch.from_numpy(grads))
    _assert_tables_close(jt, pt)


def test_set_value_puts_the_trash_row_at_zero():
    _, pt = _pair("adagrad", 4, "auto", True)
    value = np.full((ROWS + 1, 4), 2.0, np.float32)
    pt.set_value(value)
    assert torch.all(pt.value[ROWS] == 0.0)
    assert torch.all(pt.value[:ROWS] == 2.0)


def test_combine_matches_jax():
    jt, pt = _pair("sgd", 4, "auto", True)
    rng = np.random.default_rng(2)
    values = rng.normal(size=(30, 4)).astype(np.float32)
    inverse = rng.integers(0, 9, size=30).astype(np.int32)
    np.testing.assert_allclose(
        pt.combine(torch.from_numpy(inverse), torch.from_numpy(values), 12).numpy(),
        np.asarray(jt.combine(jnp.asarray(inverse), jnp.asarray(values), 12)),
        **TOL,
    )


def test_random_init_is_seeded_and_keeps_the_trash_row_zero():
    cfg = TableConfig(name="e", rows=32, dim=8, init_scale=0.1)
    a = KVTable(cfg, seed=3, device="cpu")
    b = KVTable(cfg, seed=3, device="cpu")
    c = KVTable(cfg, seed=4, device="cpu")
    assert torch.equal(a.value, b.value)
    assert not torch.equal(a.value, c.value)
    assert torch.all(a.value[32] == 0)
    assert 0.05 < float(a.value[:32].std()) < 0.2


def test_only_auto_float32_tables():
    with pytest.raises(ValueError, match="scatter_impl"):
        KVTable(TableConfig(name="t", rows=4, scatter_impl="pallas"), device="cpu")
    with pytest.raises(ValueError, match="float32"):
        KVTable(TableConfig(name="t", rows=4, dtype="bfloat16"), device="cpu")
