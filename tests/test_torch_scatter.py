"""Parity of the port's row ops (parameter_server_tpu_torch/ops/scatter.py)
with the JAX package's, on the CPU.

Inputs come from numpy seeds and go through both packages.  At dim 1 the JAX
side runs its XLA path (the Pallas kernels refuse dim 1); at dim 128 it also
runs the Pallas kernels in interpret mode.  Tolerances: row moves are exact
(they copy bytes); sums and the optimizer step use float32 allclose with
rtol = atol = 1e-5.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from parameter_server_tpu.config import OptimizerConfig as JaxOptimizerConfig
from parameter_server_tpu.kv.optim import make_optimizer as jax_make_optimizer
from parameter_server_tpu.ops import scatter as jax_scatter
from parameter_server_tpu_torch.config import OptimizerConfig
from parameter_server_tpu_torch.kv.optim import make_optimizer
from parameter_server_tpu_torch.ops import _build
from parameter_server_tpu_torch.ops import scatter

TOL = dict(rtol=1e-5, atol=1e-5)
ROWS = 64  # real rows; row ROWS is the trash row
N_REAL, N_PAD = 5, 3  # one 8-id Pallas block: interpret mode is slow


def _case(dim, seed=0):
    """Table [ROWS + 1, dim], 5 unique real ids + 3 trash pads, row values
    whose pad rows are zero (the pad contract)."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(ROWS + 1, dim)).astype(np.float32)
    table[ROWS] = 0.0
    ids = np.concatenate(
        [rng.choice(ROWS, size=N_REAL, replace=False), np.full(N_PAD, ROWS)]
    ).astype(np.int32)
    rows = rng.normal(size=(N_REAL + N_PAD, dim)).astype(np.float32)
    rows[N_REAL:] = 0.0
    return table, ids, rows


def _jax_impls(dim):
    """(name, gather, scatter_set, scatter_add) of the JAX side at ``dim``."""
    impls = [("xla", jax_scatter.gather_rows_xla, jax_scatter.scatter_update_rows_xla,
              jax_scatter.scatter_add_rows_xla)]
    if dim == 128:
        impls.append((
            "pallas",
            lambda t, i: jax_scatter._pallas_gather(t, i, interpret=True),
            lambda t, i, r: jax_scatter._pallas_scatter_set(t, i, r, interpret=True),
            lambda t, i, r: jax_scatter._pallas_scatter_add(t, i, r, interpret=True),
        ))
    return impls


@pytest.mark.parametrize("dim", [1, 128])
def test_gather_matches_jax(dim):
    table, ids, _ = _case(dim)
    got = scatter.gather_rows(torch.from_numpy(table), torch.from_numpy(ids))
    for name, gather, _s, _a in _jax_impls(dim):
        want = np.asarray(gather(jnp.asarray(table), jnp.asarray(ids)))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


@pytest.mark.parametrize("dim", [1, 128])
def test_scatter_set_matches_jax(dim):
    table, ids, rows = _case(dim, seed=1)
    got = scatter.scatter_update_rows(
        torch.from_numpy(table.copy()), torch.from_numpy(ids), torch.from_numpy(rows)
    )
    for name, _g, scatter_set, _a in _jax_impls(dim):
        want = np.asarray(scatter_set(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(rows)))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


@pytest.mark.parametrize("dim", [1, 128])
def test_scatter_add_matches_jax(dim):
    table, ids, rows = _case(dim, seed=2)
    got = scatter.scatter_add_rows(
        torch.from_numpy(table.copy()), torch.from_numpy(ids), torch.from_numpy(rows)
    )
    for name, _g, _s, scatter_add in _jax_impls(dim):
        want = np.asarray(scatter_add(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(rows)))
        np.testing.assert_allclose(got.numpy(), want, err_msg=name, **TOL)


@pytest.mark.parametrize("dim", [1, 128])
def test_segment_combine_matches_jax(dim):
    rng = np.random.default_rng(3)
    values = rng.normal(size=(200, dim)).astype(np.float32)
    inverse = rng.integers(0, 50, size=200).astype(np.int32)  # slots 50..63 empty
    got = scatter.segment_combine(torch.from_numpy(values), torch.from_numpy(inverse), 64)
    want = np.asarray(
        jax_scatter.segment_combine(jnp.asarray(values), jnp.asarray(inverse), 64)
    )
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.all(got.numpy()[50:] == 0.0)


@pytest.mark.parametrize("unique_ids", [False, True])
@pytest.mark.parametrize("dim", [1, 128])
def test_combine_and_scatter_add_matches_jax(dim, unique_ids):
    rng = np.random.default_rng(4)
    table = rng.normal(size=(ROWS + 1, dim)).astype(np.float32)
    table[ROWS] = 0.0
    num_rows = 16
    if unique_ids:
        ids = np.concatenate([rng.choice(ROWS, 10, replace=False), np.full(6, ROWS)])
        inverse = rng.integers(0, 10, size=40)
    else:  # hashed keys colliding on a slot: ids repeat across unique keys
        ids = np.concatenate([rng.choice(8, 10), np.full(6, ROWS)])
        inverse = rng.integers(0, 10, size=40)
    ids, inverse = ids.astype(np.int32), inverse.astype(np.int32)
    values = rng.normal(size=(40, dim)).astype(np.float32)
    got = scatter.combine_and_scatter_add(
        torch.from_numpy(table.copy()), torch.from_numpy(ids),
        torch.from_numpy(inverse), torch.from_numpy(values), num_rows,
        unique_ids=unique_ids,
    )
    want = jax_scatter.combine_and_scatter_add(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(inverse),
        jnp.asarray(values), num_rows,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


_OPT_CFGS = {
    "sgd": dict(kind="sgd", learning_rate=0.1, l2=0.01),
    "adagrad": dict(kind="adagrad", learning_rate=0.1, l1=0.01),
    "adam": dict(kind="adam", learning_rate=0.05),
    "ftrl": dict(kind="ftrl", l1=0.01, l2=0.1),
}


@pytest.mark.parametrize("dim", [1, 128])
@pytest.mark.parametrize("kind", sorted(_OPT_CFGS))
def test_apply_rows_matches_jax(kind, dim):
    """Fused push apply over value + state planes; the trash row is excluded
    (both sides re-zero it in the table layer)."""
    table, ids, grads = _case(dim, seed=5)
    opt = make_optimizer(OptimizerConfig(**_OPT_CFGS[kind]))
    jopt = jax_make_optimizer(JaxOptimizerConfig(**_OPT_CFGS[kind]))
    rng = np.random.default_rng(6)
    state = {
        k: np.abs(rng.normal(size=table.shape)).astype(np.float32)
        for k in opt.state_shapes()
    }
    if "t" in state:
        state["t"] = np.floor(state["t"] * 3)
    v, s = scatter.apply_rows(
        torch.from_numpy(table.copy()),
        {k: torch.from_numpy(x.copy()) for k, x in state.items()},
        torch.from_numpy(ids), torch.from_numpy(grads), opt,
    )
    jax_paths = [("xla", lambda *a: jax_scatter.apply_rows(*a))]
    if dim == 128 and kind == "adagrad":  # the main path's rule; interpret
        # mode costs seconds per rule, and the XLA path checks every rule
        jax_paths.append(
            ("pallas", lambda *a: jax_scatter._pallas_apply(*a, interpret=True))
        )
    for name, fn in jax_paths:
        jv, js = fn(
            jnp.asarray(table), {k: jnp.asarray(x) for k, x in state.items()},
            jnp.asarray(ids), jnp.asarray(grads), jopt.apply,
        )
        np.testing.assert_allclose(v.numpy()[:ROWS], np.asarray(jv)[:ROWS],
                                   err_msg=name, **TOL)
        for k in state:
            np.testing.assert_allclose(s[k].numpy()[:ROWS], np.asarray(js[k])[:ROWS],
                                       err_msg=f"{name}:{k}", **TOL)


def test_cpu_tensors_never_touch_the_kernel_library(monkeypatch):
    """On the CPU every dispatcher takes the plain version: loading (or
    building) the CUDA library would raise here."""

    def refuse():
        raise AssertionError("kernel library loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load_library", refuse)
    scatter.reset_launch_counts()
    table, ids, rows = _case(4)
    t, i, r = (torch.from_numpy(x.copy()) for x in (table, ids, rows))
    scatter.gather_rows(t, i)
    scatter.scatter_update_rows(t, i, r)
    scatter.scatter_add_rows(t, i, r)
    opt = make_optimizer(OptimizerConfig(kind="adam"))
    state = {k: torch.zeros_like(t) for k in opt.state_shapes()}
    scatter.apply_rows(t, state, i, r, opt)
    scatter.combine_and_scatter_add(t, i, torch.arange(8, dtype=torch.int32), r, 8)
    assert scatter.launch_counts() == {
        "apply": 0, "gather": 0, "scatter_set": 0, "scatter_add": 0
    }


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    table, ids, rows = _case(4)
    t, i, r = (torch.from_numpy(x) for x in (table, ids, rows))
    with pytest.raises(ValueError, match="CUDA tensor"):
        scatter.cuda_gather(t, i)
    with pytest.raises(ValueError, match="CUDA tensor"):
        scatter.cuda_scatter_set(t, i, r)
    with pytest.raises(ValueError, match="unsupported device"):
        scatter.gather_rows(t.to("meta"), i.to("meta"))


@pytest.mark.cuda
def test_cuda_tensors_always_launch_the_kernels():
    """On the card every dispatcher launches its kernel and agrees with the
    plain version (run on the H100: ``python -m pytest -m cuda tests/``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    table, ids, rows = _case(128)
    t, i, r = (torch.from_numpy(x.copy()).cuda() for x in (table, ids, rows))
    scatter.reset_launch_counts()
    np.testing.assert_array_equal(
        scatter.gather_rows(t, i).cpu().numpy(), table[ids]
    )
    scatter.scatter_update_rows(t, i, r)
    scatter.scatter_add_rows(t, i, r)
    opt = make_optimizer(OptimizerConfig(kind="adagrad"))
    state = {k: torch.zeros_like(t) for k in opt.state_shapes()}
    scatter.apply_rows(t, state, i, r, opt)
    torch.cuda.synchronize()
    assert all(v == 1 for v in scatter.launch_counts().values())
