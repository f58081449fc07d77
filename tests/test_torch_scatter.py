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


@pytest.mark.parametrize("dim", [1, 3, 4, 128])
@pytest.mark.parametrize("planes", [1, 2, 3, 4])
def test_gather_rows_planes_matches_jax(planes, dim):
    """One call gathers every plane at the shared ids, trash pads included:
    each output equals the JAX package's per-plane ``gather_rows`` exactly
    (dims 3 and 4 are the card's scalar and smallest float4 layouts)."""
    rng = np.random.default_rng(10 * planes + dim)
    tables = rng.normal(size=(planes, ROWS + 1, dim)).astype(np.float32)
    tables[:, ROWS] = 0.0
    _, ids, _ = _case(dim, seed=planes)
    got = scatter.gather_rows_planes(
        [torch.from_numpy(t) for t in tables], torch.from_numpy(ids)
    )
    assert len(got) == planes
    for p, (table, out) in enumerate(zip(tables, got)):
        want = np.asarray(jax_scatter.gather_rows(jnp.asarray(table), jnp.asarray(ids)))
        np.testing.assert_array_equal(out.numpy(), want, err_msg=f"plane {p}")


def test_gather_rows_planes_takes_one_to_four_planes():
    table, ids, _ = _case(4)
    t, i = torch.from_numpy(table), torch.from_numpy(ids)
    for planes in ([], [t] * 5):
        with pytest.raises(ValueError, match="1 to 4 planes"):
            scatter.gather_rows_planes(planes, i)
        with pytest.raises(ValueError, match="1 to 4 planes"):
            scatter.cuda_gather_planes(planes, i)


@pytest.mark.parametrize("dim", [1, 128])
def test_scatter_set_matches_jax(dim):
    table, ids, rows = _case(dim, seed=1)
    got = scatter.scatter_update_rows(
        torch.from_numpy(table.copy()), torch.from_numpy(ids), torch.from_numpy(rows)
    )
    for name, _g, scatter_set, _a in _jax_impls(dim):
        want = np.asarray(scatter_set(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(rows)))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


@pytest.mark.parametrize("dim", [1, 3, 4, 128])
@pytest.mark.parametrize("planes", [1, 2, 3, 4])
def test_scatter_update_rows_planes_matches_jax(planes, dim):
    """One call writes every plane at the shared ids, trash pads (identical
    zero rows) included: each table equals the JAX package's per-plane
    ``scatter_update_rows`` exactly."""
    rng = np.random.default_rng(20 * planes + dim)
    tables = rng.normal(size=(planes, ROWS + 1, dim)).astype(np.float32)
    tables[:, ROWS] = 0.0
    _, ids, _ = _case(dim, seed=planes)
    rows = rng.normal(size=(planes, ids.size, dim)).astype(np.float32)
    rows[:, N_REAL:] = 0.0
    got = scatter.scatter_update_rows_planes(
        [torch.from_numpy(t.copy()) for t in tables], torch.from_numpy(ids),
        [torch.from_numpy(r) for r in rows],
    )
    assert len(got) == planes
    for p, (table, r, out) in enumerate(zip(tables, rows, got)):
        want = np.asarray(jax_scatter.scatter_update_rows(
            jnp.asarray(table), jnp.asarray(ids), jnp.asarray(r)))
        np.testing.assert_array_equal(out.numpy(), want, err_msg=f"plane {p}")


def test_scatter_update_rows_planes_takes_one_to_four_planes_and_a_row_set_each():
    table, ids, rows = _case(4)
    t, i, r = torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(rows)
    for planes in ([], [t] * 5):
        with pytest.raises(ValueError, match="1 to 4 planes"):
            scatter.scatter_update_rows_planes(planes, i, [r] * len(planes))
        with pytest.raises(ValueError, match="1 to 4 planes"):
            scatter.cuda_scatter_set_planes(planes, i, [r] * len(planes))
    with pytest.raises(ValueError, match="2 tables, 1 row sets"):
        scatter.scatter_update_rows_planes([t, t.clone()], i, [r])


@pytest.mark.parametrize("route", ["cpu", "card_merge"])
@pytest.mark.parametrize("dim", [1, 128])
def test_scatter_add_rows_with_repeated_ids_matches_jax(dim, route):
    """Repeated ids sum, as under the JAX package's default ``scatter_add_rows``
    (``table.at[ids].add(rows)``).  ``cpu``: the port's dispatcher on CPU
    tensors.  ``card_merge``: what the dispatcher does on the card, with the
    plain add in place of the kernel: merge the repeats, then add unique
    rows."""
    rng = np.random.default_rng(30 + dim)
    table = rng.normal(size=(ROWS + 1, dim)).astype(np.float32)
    ids = rng.integers(0, 12, size=40).astype(np.int32)  # ~3 repeats per id
    rows = rng.normal(size=(40, dim)).astype(np.float32)
    t, i, r = torch.from_numpy(table.copy()), torch.from_numpy(ids), torch.from_numpy(rows)
    if route == "cpu":
        got = scatter.scatter_add_rows(t, i, r)
    else:
        merged_ids, merged = scatter._merge_repeats(i, r)
        assert merged_ids.dtype == torch.int32
        assert torch.equal(merged_ids, torch.unique(i))
        got = scatter.scatter_add_rows_torch(t, merged_ids, merged)
    want = jax_scatter.scatter_add_rows(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(rows))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


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
    """Fused push apply over value + state planes.  The trash row is excluded
    from the comparison (the JAX table re-zeros it after the apply); the
    port's plain version must leave it exactly as it was, as its kernel does."""
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
    np.testing.assert_array_equal(v.numpy()[ROWS], table[ROWS])
    for k in state:
        np.testing.assert_array_equal(s[k].numpy()[ROWS], state[k][ROWS], err_msg=k)
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
    scatter.scatter_update_rows_planes([t, t.clone()], i, [r, r])
    scatter.scatter_add_rows(t, i, r)
    scatter.scatter_add_rows(t, torch.zeros_like(i), r)  # repeated ids
    opt = make_optimizer(OptimizerConfig(kind="adam"))
    state = {k: torch.zeros_like(t) for k in opt.state_shapes()}
    scatter.apply_rows(t, state, i, r, opt)
    scatter.combine_and_scatter_add(t, i, torch.arange(8, dtype=torch.int32), r, 8)
    assert scatter.launch_counts() == {
        "apply": 0, "gather": 0, "scatter_set": 0, "scatter_add": 0, "segment_sum": 0
    }


@pytest.mark.parametrize("planes", [1, 2, 4])
def test_gather_rows_planes_on_the_cpu_never_loads_the_kernel_library(monkeypatch, planes):
    """The plural dispatcher takes the plain per-plane loop for CPU tensors:
    loading (or building) the CUDA library would raise here."""

    def refuse():
        raise AssertionError("kernel library loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load_library", refuse)
    scatter.reset_launch_counts()
    table, ids, _ = _case(4)
    tables = [torch.from_numpy(table + p) for p in range(planes)]
    got = scatter.gather_rows_planes(tables, torch.from_numpy(ids))
    for t, out in zip(tables, got):
        assert torch.equal(out, t[torch.from_numpy(ids).long()])
    assert scatter.launch_counts()["gather"] == 0


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
    plain version, ``scatter_add_rows`` sums repeated ids as the plain
    version does, and ``cuda_apply`` leaves the trash row of every plane as
    it was (run on the H100: ``python -m pytest -m cuda tests/``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    table, ids, rows = _case(128)
    t, i, r = (torch.from_numpy(x.copy()).cuda() for x in (table, ids, rows))
    scatter.reset_launch_counts()
    np.testing.assert_array_equal(
        scatter.gather_rows(t, i).cpu().numpy(), table[ids]
    )
    got = scatter.gather_rows_planes([t, t + 1], i)
    np.testing.assert_array_equal(got[1].cpu().numpy(), table[ids] + 1)
    scatter.scatter_update_rows(t, i, r)
    s2 = t + 2
    scatter.scatter_update_rows_planes([t, s2], i, [r, r + 1])
    np.testing.assert_array_equal(s2[i.long()].cpu().numpy(), rows + 1)
    with pytest.raises(ValueError, match="overlap"):
        scatter.cuda_scatter_set_planes([t, t], i, [r, r])
    scatter.scatter_add_rows(t, i, r)
    # repeated ids: merged, then one launch; equal to the plain sum
    rep_ids = torch.from_numpy(np.random.default_rng(8).integers(0, 12, size=8)
                               .astype(np.int32)).cuda()
    before = t.clone()
    scatter.scatter_add_rows(t, rep_ids, r)
    want = scatter.scatter_add_rows_torch(before, rep_ids, r)
    torch.testing.assert_close(t, want, rtol=1e-5, atol=1e-5)
    opt = make_optimizer(OptimizerConfig(kind="adagrad"))
    state = {k: torch.zeros_like(t) for k in opt.state_shapes()}
    scatter.apply_rows(t, state, i, r, opt)
    torch.cuda.synchronize()
    assert scatter.launch_counts() == {
        "apply": 1, "gather": 2, "scatter_set": 2, "scatter_add": 2, "segment_sum": 0
    }
    # pads point at the trash row; a marker there must survive every rule
    for dim in (1, 128):
        table, ids, grads = _case(dim, seed=7)
        for kind in sorted(_OPT_CFGS):
            opt = make_optimizer(OptimizerConfig(**_OPT_CFGS[kind]))
            value = torch.from_numpy(table.copy()).cuda()
            state = {k: torch.full_like(value, fill) for k, fill in opt.state_shapes().items()}
            planes = [value, *state.values()]
            for p in planes:
                p[ROWS] = 7.0
            scatter.cuda_apply(value, state, torch.from_numpy(ids).cuda(),
                               torch.from_numpy(grads).cuda(), opt)
            torch.cuda.synchronize()
            for p in planes:
                assert bool((p[ROWS] == 7.0).all()), f"{kind} dim {dim} wrote the trash row"



def test_segment_sum_on_the_cpu_never_loads_the_kernel_library(monkeypatch):
    def refuse():
        raise AssertionError("kernel library loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load_library", refuse)
    scatter.reset_launch_counts()
    slots = (np.arange(33 * 7) // 33).reshape(1, -1)  # rows of 33 positions
    order, uid, _ids = (g[0] for g in scatter.group_slots(torch.from_numpy(slots), 1 << 20))
    residual = torch.ones(33)
    got = scatter.segment_sum_sorted(residual, order, uid, 7)
    assert got[:8, 0].tolist() == [33.0] * 7 + [0.0]
    assert scatter.launch_counts()["segment_sum"] == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        scatter.cuda_segment_sum(residual, order, uid, 7)
