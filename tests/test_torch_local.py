"""The port's single-device LR trainer against the JAX package's, on the CPU:
the device hash, the dense step, K-step blocks, rows mode under both apply
paths, evaluation, the constructor's checks, and the prefetch-fed stream.

Both sides start from one random numpy state (nonzero optimizer state, the
trash row at its fill), carried into the port with
``convert.trainer_from_numpy``.  Tolerances: host code and the hash exactly;
one dense step's loss rtol 1e-5 and its tables atol 1e-6 / rtol 1e-5 (the
same float ops in the same order, up to the reductions' association);
K-step blocks rtol 1e-4 (errors compound over steps).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from parameter_server_tpu.config import OptimizerConfig as JaxOptimizerConfig
from parameter_server_tpu.config import TableConfig as JaxTableConfig
from parameter_server_tpu.kv.optim import make_optimizer as jax_make_optimizer
from parameter_server_tpu.kv.optim import require_dense_apply as jax_require_dense_apply
from parameter_server_tpu.learner.sgd import LocalLRTrainer as JaxLocalLRTrainer
from parameter_server_tpu.models import linear as jlinear
from parameter_server_tpu.utils import keys as jkeys
from parameter_server_tpu_torch.config import OptimizerConfig, TableConfig
from parameter_server_tpu_torch.convert import trainer_from_numpy
from parameter_server_tpu_torch.data.prefetch import PrefetchPipeline
from parameter_server_tpu_torch.data.synthetic import SyntheticCTR
from parameter_server_tpu_torch.kv.optim import make_optimizer, require_dense_apply
from parameter_server_tpu_torch.learner.sgd import LocalLRTrainer
from parameter_server_tpu_torch.models import linear
from parameter_server_tpu_torch.ops import scatter
from parameter_server_tpu_torch.utils.keys import (
    PAD_KEY,
    HashLocalizer,
    ensure_uint32_keys,
    mix32,
)

STEP_LOSS = dict(rtol=1e-5)
STEP_TABLE = dict(rtol=1e-5, atol=1e-6)
BLOCK_LOSS = dict(rtol=1e-4)
BLOCK_TABLE = dict(rtol=1e-4, atol=1e-6)
EDGE_KEYS = np.array([0, 1, 2**31, 2**32 - 2, 0xFFFFFFFF], dtype=np.uint32)

DENSE_OPTS = {
    "sgd": dict(kind="sgd", learning_rate=0.5),
    "adagrad": dict(kind="adagrad", learning_rate=0.1),
    "ftrl": dict(kind="ftrl", ftrl_alpha=0.5),
}
ROWS_OPTS = {
    "sgd": dict(kind="sgd", learning_rate=0.5, l1=0.01, l2=0.01),
    "adagrad": dict(kind="adagrad", learning_rate=0.1, l1=0.001, l2=0.01),
    "adam": dict(kind="adam", learning_rate=0.05, l1=0.01),
    "ftrl": dict(kind="ftrl", ftrl_alpha=0.5, l1=0.01, l2=0.1),
}


def _cfgs(rows, opt, **kw):
    return (JaxTableConfig(name="w", rows=rows, dim=1,
                           optimizer=JaxOptimizerConfig(**opt), **kw),
            TableConfig(name="w", rows=rows, dim=1, optimizer=OptimizerConfig(**opt), **kw))


def _random_state(rng, rows, kind):
    """A trained-looking table: weights, positive optimizer state (Adam's t
    a small whole count), the trash row at its fill (0 for every rule)."""
    names = sorted(make_optimizer(OptimizerConfig(kind=kind)).state_shapes())

    def plane(n, name):
        x = rng.normal(scale=0.3, size=(n, 1))
        if name in ("sum_sq", "n", "v"):
            x = np.abs(x) + 0.01
        elif name == "t":
            x = np.floor(np.abs(x) * 10) + 1
        return x.astype(np.float32)

    value = plane(rows + 1, "value")
    state = {k: plane(rows + 1, k) for k in names}
    value[rows] = 0
    for k in names:
        state[k][rows] = 0
    bias = plane(1, "value")
    bias_state = {k: plane(1, k) for k in names}
    return value, state, bias, bias_state


def _pair(jcfg, pcfg, state, **kw):
    """A JAX trainer and a port trainer (CPU) that both hold ``state``."""
    jt = JaxLocalLRTrainer(jcfg, **kw)
    pt = LocalLRTrainer(pcfg, device="cpu", **kw)
    value, st, bias, bst = state
    jt.table.value = jnp.asarray(value)
    jt.table.state = {k: jnp.asarray(v) for k, v in st.items()}
    jt.bias = jnp.asarray(bias)
    jt.bias_state = {k: jnp.asarray(v) for k, v in bst.items()}
    trainer_from_numpy(pt, value, st, bias, bst)
    return jt, pt


def _assert_trainers_close(jt, pt, tol):
    np.testing.assert_allclose(pt.table.value.numpy(), np.asarray(jt.table.value), **tol)
    for k in jt.table.state:
        np.testing.assert_allclose(pt.table.state[k].numpy(),
                                   np.asarray(jt.table.state[k]), **tol)
    np.testing.assert_allclose(pt.bias.numpy(), np.asarray(jt.bias), **tol)
    for k in jt.bias_state:
        np.testing.assert_allclose(pt.bias_state[k].numpy(),
                                   np.asarray(jt.bias_state[k]), **tol)


def _keys(rng, shape, pad_every=0):
    """uint64 keys < 2**32 - 1 (zipf-skewed, so slots repeat), PAD_KEY at
    every ``pad_every``-th position."""
    keys = (rng.zipf(1.3, size=shape).astype(np.uint64) * np.uint64(2654435761)) % np.uint64(
        2**32 - 1)
    if pad_every:
        keys.reshape(-1)[::pad_every] = PAD_KEY
    return keys


# ---------------------------------------------------------------------------
# the device hash
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_mix32_torch_matches_numpy_and_jax_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    keys = np.concatenate([EDGE_KEYS, rng.integers(0, 2**32, size=5000, dtype=np.uint64)
                           .astype(np.uint32)])
    want = mix32(keys, np.uint32(seed))
    np.testing.assert_array_equal(want, jkeys.mix32(keys, np.uint32(seed)))
    np.testing.assert_array_equal(np.asarray(jlinear.mix32_jax(jnp.asarray(keys), seed)), want)
    for t in (torch.from_numpy(keys.view(np.int32)), torch.from_numpy(keys),
              torch.from_numpy(keys.astype(np.int64))):
        got = linear.mix32_torch(t, seed)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
        assert int(got.min()) >= 0 and int(got.max()) < 2**32


@pytest.mark.parametrize("seed", [0, 7])
def test_device_slots_match_hash_localizer_pad_included(seed):
    rng = np.random.default_rng(10 + seed)
    keys = rng.integers(0, 2**32 - 1, size=(50, 100), dtype=np.uint64)
    keys[0, :5] = EDGE_KEYS[:4].tolist() + [int(PAD_KEY)]
    keys[3, 7] = PAD_KEY
    for rows in (1000, 4096, (1 << 22)):
        want = HashLocalizer(rows, seed=seed, hash_bits=32).assign(keys)
        np.testing.assert_array_equal(
            want, jkeys.HashLocalizer(rows, seed=seed, hash_bits=32).assign(keys))
        k32 = jkeys.ensure_uint32_keys(keys)
        got = linear.device_slots(torch.from_numpy(k32.view(np.int32)), rows, seed)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.shape == keys.shape and int(got[0, 4]) == rows and int(got[3, 7]) == rows


# ---------------------------------------------------------------------------
# dense mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(DENSE_OPTS))
def test_dense_fused_step_matches_jax(kind):
    rows, batch, nnz = 500, 64, 12
    rng = np.random.default_rng(1)
    value, state, bias, bias_state = _random_state(rng, rows, kind)
    slots = HashLocalizer(rows).assign(_keys(rng, (batch, nnz), pad_every=7))
    labels = rng.integers(0, 2, size=batch).astype(np.float32)
    assert (slots == rows).any() and len(np.unique(slots)) < slots.size
    jopt = jax_make_optimizer(JaxOptimizerConfig(**DENSE_OPTS[kind]))
    popt = make_optimizer(OptimizerConfig(**DENSE_OPTS[kind]))
    jv, js, jb, jbs, jloss = jlinear.dense_fused_train_step(
        jnp.asarray(value), {k: jnp.asarray(v) for k, v in state.items()},
        jnp.asarray(bias), {k: jnp.asarray(v) for k, v in bias_state.items()},
        jnp.asarray(slots), jnp.asarray(labels), jopt, rows)
    pv, pb = torch.tensor(value), torch.tensor(bias)
    ps = {k: torch.tensor(v) for k, v in state.items()}
    pbs = {k: torch.tensor(v) for k, v in bias_state.items()}
    ploss = linear.dense_fused_step(pv, ps, pb, pbs, torch.from_numpy(slots),
                                    torch.from_numpy(labels), popt, rows)
    np.testing.assert_allclose(float(ploss), float(jloss), **STEP_LOSS)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), **STEP_TABLE)
    for k in state:
        np.testing.assert_allclose(ps[k].numpy(), np.asarray(js[k]), **STEP_TABLE)
        np.testing.assert_allclose(pbs[k].numpy(), np.asarray(jbs[k]), **STEP_TABLE)
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), **STEP_TABLE)
    assert float(pv[rows]) == 0.0 and not (pv.numpy() == value).all()


def test_segment_combine_is_position_ordered_and_counts_every_row():
    """The dense step's full-size gradient: every row of the table, each
    row's positions summed in position order."""
    rng = np.random.default_rng(2)
    slots = rng.integers(0, 40, size=1000)
    vals = rng.normal(size=(1000, 1)).astype(np.float32)
    got = scatter.segment_combine(torch.from_numpy(vals), torch.from_numpy(slots), 50)
    assert got.shape == (50, 1)
    for r in range(50):  # sequential float32 sums in position order: exact
        acc = np.float32(0)
        for v in vals[slots == r, 0]:
            acc = np.float32(acc + v)
        assert got[r, 0].item() == acc


def _hot_slots(rng, rows, batch, nnz):
    """Slots ``[batch, nnz]`` in ``[0, rows]``: one hot row at 30% of the
    positions, PAD (the trash row ``rows``) at every 7th, the rest spread
    over half the table, so many rows stay untouched."""
    slots = rng.integers(0, rows // 2, size=(batch, nnz))
    flat = slots.reshape(-1)
    flat[rng.random(flat.size) < 0.3] = rows // 3
    flat[::7] = rows
    return slots


def _full_table_dense_step(value, state, bias, bias_state, slots, labels, opt, rows):
    """The dense step as a full-table rule: the per-row gradient of every
    row by ``segment_combine``, the trash row's zeroed, the rule over the
    whole table, copied back."""
    flat = slots.reshape(-1).long()
    w_pos = opt.pull_weights(torch.index_select(value, 0, flat),
                             {k: torch.index_select(p, 0, flat) for k, p in state.items()})
    w_pos = w_pos[:, 0].reshape(labels.shape[0], -1)
    loss, residual = linear._loss_and_residual(w_pos, bias, bias_state, labels, opt)
    g_pos = residual[:, None].expand(w_pos.shape).reshape(-1, 1)
    grad = scatter.segment_combine(g_pos, flat, value.shape[0])
    grad[rows].zero_()
    new_v, new_s = opt.apply(value, state, grad)
    value.copy_(new_v)
    for k in state:
        state[k].copy_(new_s[k])
    linear._apply_bias(bias, bias_state, residual, opt)
    return loss


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("kind", sorted(DENSE_OPTS))
def test_dense_step_over_touched_rows_is_the_full_table_rule_bit_for_bit(kind):
    """The step that sums and applies at the touched rows alone gives every
    row the bits of the full-table rule, under a hot row and PAD keys; the
    rows outside the batch and the trash row keep their bytes."""
    rows, batch, nnz = 600, 96, 13
    rng = np.random.default_rng(11)
    value, state, bias, bias_state = _random_state(rng, rows, kind)
    slots = torch.from_numpy(_hot_slots(rng, rows, batch, nnz))
    assert float((slots == rows // 3).float().mean()) >= 0.25 and (slots == rows).any()
    labels = torch.from_numpy(rng.integers(0, 2, size=batch).astype(np.float32))
    opt = make_optimizer(OptimizerConfig(**DENSE_OPTS[kind]))
    planes = [(torch.tensor(value), {k: torch.tensor(v) for k, v in state.items()},
               torch.tensor(bias), {k: torch.tensor(v) for k, v in bias_state.items()})
              for _ in range(2)]
    (nv, ns, nb, nbs), (ov, os_, ob, obs) = planes
    new_loss = linear.dense_fused_step(nv, ns, nb, nbs, slots, labels, opt, rows)
    old_loss = _full_table_dense_step(ov, os_, ob, obs, slots, labels, opt, rows)
    assert torch.equal(_bits(new_loss), _bits(old_loss))
    for a, b in [(nv, ov), (nb, ob), *((ns[k], os_[k]) for k in ns),
                 *((nbs[k], obs[k]) for k in nbs)]:
        assert torch.equal(_bits(a), _bits(b))
    untouched = torch.ones(rows + 1, dtype=torch.bool)
    untouched[slots.reshape(-1)] = False
    untouched[rows] = True  # the trash row keeps its fill
    assert int(untouched.sum()) > rows // 2
    for got, before in [(nv, value), *((ns[k], state[k]) for k in ns)]:
        assert torch.equal(_bits(got[untouched]), _bits(torch.from_numpy(before)[untouched]))
    assert not torch.equal(nv, torch.from_numpy(value))


def test_group_slots_gives_the_unique_rows_at_a_static_length():
    """``group_slots``, row by row: the positions sorted by slot (stably),
    each entry's unique index pointing at its slot in ``ids``, ``ids`` the
    unique slots ascending and then the trash row, every output the input's
    shape, and nothing read back from the tensors on the way."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.add(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))

    rows = 500
    rng = np.random.default_rng(12)
    slots = torch.from_numpy(np.stack([_hot_slots(rng, rows, 64, 9).reshape(-1)
                                       for _ in range(3)]))
    with Ops() as ops:
        order, uid, ids = scatter.group_slots(slots, rows)
    assert not {s for s in ops.seen
                if any(w in s for w in ("local_scalar", "unique", "bincount", "nonzero"))}
    assert order.shape == uid.shape == ids.shape == slots.shape
    assert (order.dtype, uid.dtype, ids.dtype) == (torch.int64, torch.int64, torch.int32)
    for k in range(slots.shape[0]):
        flat = slots[k]
        want_ids, want_inv = np.unique(flat.numpy(), return_inverse=True)
        np.testing.assert_array_equal(order[k].numpy(), np.argsort(flat.numpy(), kind="stable"))
        np.testing.assert_array_equal(uid[k].numpy(), want_inv[order[k].numpy()])
        assert torch.equal(ids[k][uid[k]], flat[order[k]].to(torch.int32))  # entry -> its slot
        u = want_ids.size
        np.testing.assert_array_equal(ids[k][:u].numpy(), want_ids)
        assert (ids[k][u:] == rows).all() and u < flat.numel()


def test_segment_sum_sorted_sums_each_row_in_position_order():
    """The plain segment sum: each unique row's positions summed in position
    order from its example's residual, zeros past the last row."""
    rows, batch, nnz = 300, 40, 7
    rng = np.random.default_rng(13)
    slots = torch.from_numpy(_hot_slots(rng, rows, batch, nnz))
    residual = torch.from_numpy(rng.normal(size=batch).astype(np.float32))
    order, uid, ids = (g[0] for g in scatter.group_slots(slots.reshape(1, -1), rows))
    got = scatter.segment_sum_sorted(residual, order, uid, nnz)
    assert got.shape == (batch * nnz, 1)
    flat, u = slots.reshape(-1).numpy(), int(uid[-1]) + 1
    for j in range(u):
        acc = np.float32(0)
        for p in np.flatnonzero(flat == int(ids[j])):
            acc = np.float32(acc + residual[p // nnz].numpy())
        assert got[j, 0].item() == acc
    assert (got[u:] == 0).all()


@pytest.mark.parametrize("kind", sorted(DENSE_OPTS))
def test_step_block_matches_jax(kind):
    rows, K, batch, nnz = 700, 4, 48, 10
    rng = np.random.default_rng(3)
    jcfg, pcfg = _cfgs(rows, DENSE_OPTS[kind])
    jt, pt = _pair(jcfg, pcfg, _random_state(rng, rows, kind), mode="dense",
                   device_hash=True)
    keys = _keys(rng, (K, batch, nnz), pad_every=11)
    labels = rng.integers(0, 2, size=(K, batch)).astype(np.float32)
    jl = np.asarray(jt.step_block(keys, labels))
    pl = pt.step_block(keys, labels)
    assert pl.shape == (K,) and pt.step_count == jt.step_count == K
    np.testing.assert_allclose(pl.numpy(), jl, **BLOCK_LOSS)
    _assert_trainers_close(jt, pt, BLOCK_TABLE)
    assert float(pt.table.value[rows]) == 0.0


def test_step_block_equals_sequential_steps_with_pads():
    """Inside the port: one K-step block (device hash) gives the same bits as
    K host-hashed ``step`` calls; PAD keys leave the trash row exactly 0."""
    rows, K, batch, nnz = 512, 3, 32, 6
    rng = np.random.default_rng(4)
    keys = _keys(rng, (K, batch, nnz))
    keys[:, :, -2:] = PAD_KEY  # variable-nnz padding
    labels = rng.integers(0, 2, size=(K, batch)).astype(np.float32)
    _, pcfg = _cfgs(rows, DENSE_OPTS["adagrad"])
    block = LocalLRTrainer(pcfg, mode="dense", device_hash=True, device="cpu")
    seq = LocalLRTrainer(pcfg, mode="dense", device_hash=True, device="cpu")
    losses = block.step_block(keys, labels).numpy()
    np.testing.assert_array_equal(losses, [seq.step(keys[k], labels[k]) for k in range(K)])
    for a, b in [(block.table.value, seq.table.value), (block.bias, seq.bias),
                 (block.table.state["sum_sq"], seq.table.state["sum_sq"])]:
        assert torch.equal(a, b)
    assert float(block.table.value[rows]) == 0.0 and float(block.table.state["sum_sq"][rows]) == 0.0
    assert (block.table.value[:rows] != 0).any()


def test_step_async_returns_a_tensor_and_step_count():
    _, pcfg = _cfgs(256, DENSE_OPTS["sgd"])
    pt = LocalLRTrainer(pcfg, mode="dense", device="cpu")
    rng = np.random.default_rng(5)
    loss = pt.step_async(_keys(rng, (16, 4)), np.ones(16, np.float32))
    assert isinstance(loss, torch.Tensor) and loss.shape == () and pt.step_count == 1
    rows = LocalLRTrainer(pcfg, device="cpu")
    with pytest.raises(ValueError, match="step_async requires mode='dense'"):
        rows.step_async(_keys(rng, (16, 4)), np.ones(16, np.float32))


def test_dense_mode_host_hash_matches_jax():
    """``mode="dense"`` without the device hash: 64-bit host slots."""
    rows = 300
    rng = np.random.default_rng(6)
    jcfg, pcfg = _cfgs(rows, DENSE_OPTS["adagrad"])
    jt, pt = _pair(jcfg, pcfg, _random_state(rng, rows, "adagrad"), mode="dense")
    for _ in range(3):
        keys = _keys(rng, (40, 8), pad_every=9)
        labels = rng.integers(0, 2, size=40).astype(np.float32)
        np.testing.assert_allclose(pt.step(keys, labels), jt.step(keys, labels), **STEP_LOSS)
    _assert_trainers_close(jt, pt, BLOCK_TABLE)


# ---------------------------------------------------------------------------
# rows mode and evaluation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused_apply", [True, False], ids=["fused", "three_pass"])
@pytest.mark.parametrize("kind", sorted(ROWS_OPTS))
def test_rows_step_matches_jax(kind, fused_apply):
    rows = 600
    rng = np.random.default_rng(7)
    jcfg, pcfg = _cfgs(rows, ROWS_OPTS[kind], fused_apply=fused_apply)
    jt, pt = _pair(jcfg, pcfg, _random_state(rng, rows, kind), min_bucket=64)
    for _ in range(3):
        keys = _keys(rng, (40, 8))
        labels = rng.integers(0, 2, size=40).astype(np.float32)
        np.testing.assert_allclose(pt.step(keys, labels), jt.step(keys, labels), **STEP_LOSS)
    _assert_trainers_close(jt, pt, BLOCK_TABLE)
    fills = pt.optimizer.state_shapes()
    assert float(pt.table.value[rows]) == 0.0
    for k, plane in pt.table.state.items():
        assert float(plane[rows]) == fills[k]


@pytest.mark.parametrize("fused_apply", [True, False], ids=["fused", "three_pass"])
def test_rows_step_is_one_gather_and_one_apply_call(fused_apply, monkeypatch):
    """A rows step reads the value and state rows in one gather call (one
    launch on the card) and writes them back in one apply or one
    scatter-set call."""
    calls = {"gather": 0, "apply": 0, "scatter_set": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(scatter, "gather_rows_planes",
                        counting("gather", scatter.gather_rows_planes))
    monkeypatch.setattr(scatter, "apply_rows", counting("apply", scatter.apply_rows))
    monkeypatch.setattr(scatter, "scatter_update_rows_planes",
                        counting("scatter_set", scatter.scatter_update_rows_planes))
    _, pcfg = _cfgs(256, ROWS_OPTS["adam"], fused_apply=fused_apply)
    pt = LocalLRTrainer(pcfg, min_bucket=32, device="cpu")
    rng = np.random.default_rng(8)
    for _ in range(2):
        pt.step(_keys(rng, (16, 5)), np.ones(16, np.float32))
    assert calls == {"gather": 2, "apply": 2 if fused_apply else 0,
                     "scatter_set": 0 if fused_apply else 2}


@pytest.mark.parametrize("mode", ["rows", "dense"])
def test_eval_auc_matches_jax(mode):
    rows = 1 << 12
    rng = np.random.default_rng(9)
    opt = ROWS_OPTS["ftrl"] if mode == "rows" else DENSE_OPTS["ftrl"]
    jcfg, pcfg = _cfgs(rows, opt)
    jt, pt = _pair(jcfg, pcfg, _random_state(rng, rows, "ftrl"), min_bucket=1024, mode=mode)
    data = dict(key_space=1 << 14, nnz=8, batch_size=128, seed=3, informative=0.3)
    jdata, pdata = SyntheticCTR(**data), SyntheticCTR(**data)
    for _ in range(2):
        (jk, jy), (pk, py) = jdata.next_batch(), pdata.next_batch()
        jt.step(jk, jy)
        pt.step(pk, py)
    ja, pa = jt.eval_auc(jdata.next_batch, 3), pt.eval_auc(pdata.next_batch, 3)
    assert 0.0 < pa < 1.0
    np.testing.assert_allclose(pa, ja, atol=1e-6)


# ---------------------------------------------------------------------------
# checks and errors
# ---------------------------------------------------------------------------


CTOR_CASES = {
    "dim": (dict(dim=2), {}),
    "unknown_mode": ({}, dict(mode="bogus")),
    "dense_adam": (dict(optimizer=dict(kind="adam")), dict(mode="dense")),
    "dense_l1": (dict(optimizer=dict(kind="adagrad", l1=0.1)), dict(mode="dense")),
    "dense_l2": (dict(optimizer=dict(kind="sgd", l2=0.1)), dict(mode="dense")),
    "device_hash_rows": ({}, dict(device_hash=True)),
}


@pytest.mark.parametrize("case", sorted(CTOR_CASES))
def test_constructor_errors_match_jax(case):
    table_kw, kw = CTOR_CASES[case]
    opt = table_kw.get("optimizer", {})
    dim = table_kw.get("dim", 1)
    jcfg = JaxTableConfig(name="w", rows=64, dim=dim, optimizer=JaxOptimizerConfig(**opt))
    pcfg = TableConfig(name="w", rows=64, dim=dim, optimizer=OptimizerConfig(**opt))
    with pytest.raises(ValueError) as jerr:
        JaxLocalLRTrainer(jcfg, **kw)
    with pytest.raises(ValueError) as perr:
        LocalLRTrainer(pcfg, device="cpu", **kw)
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("kind", ["sgd", "adagrad", "adam", "ftrl"])
def test_require_dense_apply_and_g0_stable_match_jax(kind):
    assert (make_optimizer(OptimizerConfig(kind=kind)).g0_stable
            == jax_make_optimizer(JaxOptimizerConfig(kind=kind)).g0_stable
            == (kind != "adam"))
    for extra in ({}, dict(l1=0.5), dict(l2=0.5)):
        results = []
        for req, cfg in ((jax_require_dense_apply, JaxOptimizerConfig(kind=kind, **extra)),
                         (require_dense_apply, OptimizerConfig(kind=kind, **extra))):
            try:
                req(cfg)
                results.append(None)
            except ValueError as e:
                results.append(str(e))
        assert results[0] == results[1]


def test_step_block_rejects_out_of_range_keys_and_needs_device_hash():
    _, pcfg = _cfgs(64, DENSE_OPTS["sgd"])
    pt = LocalLRTrainer(pcfg, mode="dense", device_hash=True, device="cpu")
    keys = np.zeros((1, 4, 3), np.uint64)
    keys[0, 2, 1] = 2**32 - 1  # the PAD image, but not PAD_KEY: refused
    with pytest.raises(ValueError, match="device-hash keys must be < 2\\*\\*32 - 1"):
        pt.step_block(keys, np.zeros((1, 4), np.float32))
    assert pt.step_count == 0
    plain = LocalLRTrainer(pcfg, mode="dense", device="cpu")
    for call in (plain.step_block, plain.step_block_device):
        with pytest.raises(ValueError, match="requires device_hash=True"):
            call(keys[:, :, :0], np.zeros((1, 4), np.float32))


def test_trainer_from_numpy_checks_shapes():
    _, pcfg = _cfgs(32, DENSE_OPTS["adagrad"])
    pt = LocalLRTrainer(pcfg, mode="dense", device="cpu")
    value, state, bias, bias_state = _random_state(np.random.default_rng(0), 32, "adagrad")
    with pytest.raises(ValueError, match="value shape"):
        trainer_from_numpy(pt, value[:-1], state, bias, bias_state)
    with pytest.raises(ValueError, match="bias planes"):
        trainer_from_numpy(pt, value, state, np.zeros((2, 1), np.float32), bias_state)
    value[-1] = 5.0  # a trash row off its fill is put back at it
    trainer_from_numpy(pt, value, state, bias, bias_state)
    assert float(pt.table.value[-1]) == 0.0 and pt.table.value.device.type == "cpu"
    np.testing.assert_array_equal(pt.table.state["sum_sq"][:-1].numpy(), state["sum_sq"][:-1])


# ---------------------------------------------------------------------------
# convergence and the prefetch-fed stream
# ---------------------------------------------------------------------------


def test_local_trainer_converges():
    """Mirror of tests/test_lr_e2e.py::test_local_trainer_converges."""
    data = SyntheticCTR(key_space=1 << 14, nnz=8, batch_size=512, seed=1, informative=0.3)
    _, pcfg = _cfgs(1 << 14, dict(kind="adagrad", learning_rate=0.2))
    trainer = LocalLRTrainer(pcfg, min_bucket=512, device="cpu")
    losses = [trainer.step(*data.next_batch()) for _ in range(60)]
    head, tail = np.mean(losses[:10]), np.mean(losses[-10:])
    assert tail < head - 0.05, (head, tail)
    assert trainer.eval_auc(data.next_batch, 5) > 0.70


def test_step_block_learns_and_train_records():
    _, pcfg = _cfgs(1 << 14, dict(kind="adagrad", learning_rate=0.1))
    tr = LocalLRTrainer(pcfg, mode="dense", device_hash=True, device="cpu")
    data = SyntheticCTR(key_space=1 << 18, nnz=8, batch_size=256, seed=5, informative=0.2)
    losses = []
    for _ in range(12):
        batches = [data.next_batch() for _ in range(8)]
        losses.extend(tr.step_block(np.stack([b[0] for b in batches]),
                                    np.stack([b[1] for b in batches])).tolist())
    assert np.mean(losses[-8:]) < np.mean(losses[:8]) - 0.01
    tr.train(data.next_batch, 3)
    assert tr.step_count == 99 and tr.dashboard._examples == 3 * 256


def test_train_stream_over_prefetch_equals_step_block():
    rows, K, batch, nnz, n_blocks = 1024, 4, 64, 8, 3
    data = SyntheticCTR(key_space=1 << 16, nnz=nnz, batch_size=batch, seed=2, informative=0.2)
    blocks = []
    for _ in range(n_blocks):
        bs = [data.next_batch() for _ in range(K)]
        blocks.append((np.stack([b[0] for b in bs]), np.stack([b[1] for b in bs])))
    _, pcfg = _cfgs(rows, DENSE_OPTS["adagrad"])
    direct = LocalLRTrainer(pcfg, mode="dense", device_hash=True, device="cpu")
    want = [direct.step_block(k, y) for k, y in blocks]
    streamed = LocalLRTrainer(pcfg, mode="dense", device_hash=True, device="cpu")

    def make_block(i):
        k, y = blocks[i % n_blocks]
        return ensure_uint32_keys(k), y

    with PrefetchPipeline(make_block, depth=2, limit=n_blocks, device="cpu") as pf:
        got = streamed.train_stream(pf)
        assert pf.counters()["prefetch_consumed"] == n_blocks
    assert len(got) == n_blocks and streamed.step_count == n_blocks * K
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(streamed.table.value, direct.table.value)
    assert torch.equal(streamed.table.state["sum_sq"], direct.table.state["sum_sq"])
    with PrefetchPipeline(make_block, depth=1, device="cpu") as pf:
        assert len(streamed.train_stream(pf, num_blocks=2)) == 2
