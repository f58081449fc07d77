"""The port's pipeline parallelism against the JAX package's, on an 8-rank
gloo world.

Twin of ``tests/test_pp.py``, case for case, plus the cross-package parity
(the port's loss and AdamW trajectory from a JAX ``PipelinedLMTrainer``'s
parameters, ``convert.pipelined_from_numpy``), the virtual pipeline against
the ranked one, and the schedules' send / receive plans checked for
deadlock under rendezvous semantics.

A torch mesh covers its world, so a pipeline of ``S`` stages runs on a
``(rep, pp)`` mesh of ``8 / S`` replicas (an axis the trainer leaves alone:
each replica computes the whole step); DP x PP is ``(data 2, pp 4)`` and
PP x TP ``(rep 2, pp 2, model 2)``.  The sequential oracle is the port's
dense ``Transformer`` loaded with the gathered stage weights, one
microbatch at a time.  Memory is the package's live-bytes tracker
(``feasibility.peak_live_bytes``) on each rank, where JAX reads XLA's
memory analysis.  The bubble case asserts the schedule's own count of
stage-ticks (``_schedule_ticks``), since wall time on ranks that
share the host's cores under ``-n 6`` is not a steady measure.
"""

import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from parameter_server_tpu.models import transformer as jtfm
from parameter_server_tpu.parallel.pp import PipelinedLMTrainer as JaxPipelinedLMTrainer
from parameter_server_tpu_torch.convert import pipelined_from_numpy, transformer_from_numpy
from parameter_server_tpu_torch.models import transformer as tfm
from parameter_server_tpu_torch.models.layers import flat_items
from parameter_server_tpu_torch.parallel import pp
from parameter_server_tpu_torch.parallel.pp import PipelinedLMTrainer, VirtualPipeline

import torch_world

N = 8


@pytest.fixture(scope="module")
def world():
    w = torch_world.World(N)
    yield w
    w.close()


def _axes(S):
    return (N // S, S), ("rep", "pp")


def _tokens(vocab, rng, batch=8, seq=16):
    base = rng.integers(0, vocab, size=(batch, 1))
    return ((base + np.arange(seq)[None, :]) % vocab).astype(np.int32)


def _dense_from(cfg_kw, params):
    """The port's dense Transformer holding a pipeline's parameters: stage
    ``s``'s ``Block_{j}`` is ``layer_{s * per + j}``."""
    stages = params["stages"]
    per = len(stages)
    tree = {f"layer_{s * per + j}": _slice(stages[f"Block_{j}"], s)
            for j in range(per) for s in range(_leading(stages))}
    tree.update(final_norm=params["norm"], embedding=params["embed"],
                lm_head={"kernel": params["head"]})
    model = tfm.Transformer(tfm.tiny_config(**cfg_kw), device="cpu")
    transformer_from_numpy(model, tree)
    return model


def _leading(tree):
    for v in tree.values():
        return _leading(v) if isinstance(v, dict) else v.shape[0]


def _slice(tree, s):
    return {k: _slice(v, s) if isinstance(v, dict) else v[s] for k, v in tree.items()}


def _sequential_loss(model, tokens, n_micro):
    micro = torch.from_numpy(tokens.astype(np.int64)).reshape(n_micro, -1, tokens.shape[1])
    losses = [tfm.causal_lm_loss(model(mb), mb) for mb in micro]
    return torch.stack(losses).mean()


@pytest.mark.parametrize("n_stages,n_layers", [(2, 2), (4, 4)])
def test_pipeline_matches_sequential(world, n_stages, n_layers):
    cfg_kw = dict(causal=True, n_layers=n_layers)
    tokens = _tokens(256, np.random.default_rng(0))
    shape, axes = _axes(n_stages)
    res = world.run(torch_world.pp_run, shape, axes, cfg_kw, dict(n_micro=4, seed=1), None,
                    [tokens], [])
    got, _steps, params = res[0]
    assert all(r[0] == got for r in res)  # the loss is global
    with torch.no_grad():
        want = float(_sequential_loss(_dense_from(cfg_kw, params), tokens, 4))
    np.testing.assert_allclose(got[0], want, rtol=2e-5, atol=2e-5)


def test_pipeline_trains(world):
    cfg_kw = dict(causal=True, n_layers=4)
    rng = np.random.default_rng(2)
    res = world.run(torch_world.pp_run, *_axes(4), cfg_kw,
                    dict(n_micro=4, learning_rate=3e-3), None, [],
                    [_tokens(256, rng) for _ in range(12)])
    losses = res[0][1]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) - 0.1, losses


def test_pipeline_stage_weights_are_sharded(world):
    """One stage a rank: a rank holds 1 of 4 stages' blocks, and the stack
    gathered over pp has the stage axis in front."""
    tokens = _tokens(256, np.random.default_rng(3))
    res = world.run(torch_world.pp_layout, *_axes(4), dict(causal=True, n_layers=4),
                    dict(n_micro=4), tokens)
    for local, _moments, stacked, specs in res:
        for name, shape in stacked.items():
            assert shape[0] == 4 and tuple(shape[1:]) == local[name], (name, shape)
            assert specs[name][0] == "pp"
        assert all(k.startswith("Block_0.") for k in local)  # n_layers / S blocks


def test_pipeline_rejects_bad_shapes(world):
    mesh = lambda S: types.SimpleNamespace(axis_names=("pp",), shape={"pp": S})  # noqa: E731
    with pytest.raises(ValueError, match="n_layers"):
        PipelinedLMTrainer(tfm.tiny_config(causal=True, n_layers=2), mesh(4), n_micro=4)
    # learned positional embeddings are stage-0-only state: unsupported
    with pytest.raises(ValueError, match="rotary"):
        PipelinedLMTrainer(tfm.tiny_config(causal=False, n_layers=2), mesh(2), n_micro=2)
    with pytest.raises(ValueError, match="n_micro"):
        PipelinedLMTrainer(tfm.tiny_config(causal=True, n_layers=2), mesh(2), n_micro=3)
    with pytest.raises(ValueError, match="schedule"):
        PipelinedLMTrainer(tfm.tiny_config(causal=True, n_layers=2), mesh(2), n_micro=2,
                           schedule="interleaved")
    with pytest.raises(ValueError, match="pp"):
        PipelinedLMTrainer(tfm.tiny_config(causal=True),
                           types.SimpleNamespace(axis_names=("data",), shape={"data": 2}))
    errors = world.run(torch_world.pp_errors, *_axes(2), dict(causal=True, n_layers=2),
                       dict(n_micro=4), np.zeros((9, 16), np.int32))
    assert all("n_micro" in e for e in errors), errors
    # a microbatch's rows split over data: 4 rows in 4 microbatches of 1 row
    errors = world.run(torch_world.pp_errors, (2, 4), ("data", "pp"),
                       dict(causal=True, n_layers=4), dict(n_micro=4), np.zeros((4, 16), np.int32))
    assert all("microbatch 1 % data 2" in e for e in errors), errors


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipeline_gradients_match_sequential(world, schedule):
    """The pipeline's gradients are those of the sequential stack: forward
    parity alone would not catch a misrouted gradient."""
    cfg_kw = dict(causal=True, n_layers=2)
    tokens = _tokens(256, np.random.default_rng(4), batch=4, seq=8)
    res = world.run(torch_world.pp_grads, *_axes(2), cfg_kw,
                    dict(n_micro=2, seed=3, schedule=schedule), tokens)
    loss, grads, params = res[0]
    model = _dense_from(cfg_kw, params)
    want_loss = _sequential_loss(model, tokens, 2)
    want_loss.backward()
    np.testing.assert_allclose(loss, float(want_loss.detach()), rtol=2e-5)
    named = dict(model.named_parameters())
    pairs = [(grads["embed"], named["embedding"].grad), (grads["head"],
             named["lm_head.kernel"].grad), (grads["norm"]["scale"],
             named["final_norm.scale"].grad)]
    per = len(grads["stages"])
    for name, g in flat_items(grads["stages"]):
        block, rest = name.split(".", 1)
        for s in range(g.shape[0]):
            layer = s * per + int(block.split("_")[1])
            pairs.append((g[s], named[f"layer_{layer}.{rest}"].grad))
    for got, want in pairs:
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-4, atol=1e-5)


def test_pipeline_opt_state_stays_pp_sharded(world):
    """AdamW's moments of the stage stack live with their stage: a rank's
    moments are its own stage's shapes, 1 of 4 stages."""
    tokens = _tokens(256, np.random.default_rng(5))
    res = world.run(torch_world.pp_layout, *_axes(4), dict(causal=True, n_layers=4),
                    dict(n_micro=4), tokens)
    for local, moments, stacked, _specs in res:
        assert moments == local
        assert sum(np.prod(s) for s in local.values()) * 4 == sum(
            np.prod(s) for s in stacked.values())


def test_pipeline_per_device_memory_is_bounded_by_m_over_s_model(world):
    """A rank's peak of live bytes for the loss stays within 3x the JAX
    test's analytic budget at its shapes (S 4, M 16, microbatch 4 x 256,
    d 256): the stage input / output buffers, the saved tick inputs, the
    head's logits and a working set.  A GPipe step (forward and backward,
    remat) is held to the same bound."""
    cfg_kw = dict(causal=True, n_layers=4, d_model=256, max_seq=256, vocab_size=512)
    S, M, mb, seq = 4, 16, 4, 256
    res = world.run(torch_world.pp_peaks, *_axes(S), cfg_kw,
                    [({}, M, "loss"), ({}, M, "step")], (mb, seq))
    act = mb * seq * 256 * 4
    logits_mb = mb * seq * 512 * 4
    budget = (2 * (M // S) * act + (M + S - 1) * 2 * act + (M // S) * logits_mb * 2
              + 16 * act)
    for loss_peak, step_peak in res:
        assert 0 < loss_peak <= 3 * budget, (loss_peak, budget)
        assert 0 < step_peak <= 3 * budget, (step_peak, budget)


def _schedule_ticks(schedule: str, n_stages: int, n_micro: int) -> dict:
    """Unit-time model of a schedule: every op takes one tick, a stage runs
    its ops in order, an op waits for the op of the neighbour that feeds it.
    Returns the makespan in ticks, the busy stage-ticks, and their ratio to
    the ideal (``makespan x S / busy``): GPipe's forward gives ``(M + S - 1)
    / M``."""
    orders = [pp.stage_ops(schedule, n_stages, n_micro, s) for s in range(n_stages)]
    done: dict = {}
    clock = [0] * n_stages
    pos = [0] * n_stages
    while any(pos[s] < len(orders[s]) for s in range(n_stages)):
        moved = False
        for s in range(n_stages):
            if pos[s] == len(orders[s]):
                continue
            kind, m = orders[s][pos[s]]
            dep = None
            if kind == "F" and s > 0:
                dep = ("F", s - 1, m)
            elif kind == "B" and s < n_stages - 1:
                dep = ("B", s + 1, m)
            elif kind == "B":
                dep = ("F", s, m)
            if dep is not None and dep not in done:
                continue
            start = max(clock[s], done.get(dep, 0))
            clock[s] = done[(kind, s, m)] = start + 1
            pos[s] += 1
            moved = True
        if not moved:
            raise RuntimeError(f"{schedule} schedule cannot progress")
    makespan = max(clock)
    busy = sum(len(o) for o in orders)
    return {"makespan": makespan, "busy": busy,
            "ratio_to_ideal": makespan * n_stages / busy}


def test_pipeline_bubble_amortizes_with_microbatches():
    """GPipe's bubble: S stages over M microbatches take M + S - 1 ticks for
    M ticks of work, (M + S - 1) / M of the ideal: 1.75 at M 4, 1.1875 at M
    16 for S 4.  Counted on the schedule's op lists, which both the ranked
    and the virtual pipeline run."""
    S = 4
    rows = {M: _schedule_ticks("forward", S, M) for M in (4, 16)}
    for M, r in rows.items():
        assert r["makespan"] == M + S - 1
        assert r["ratio_to_ideal"] == pytest.approx((M + S - 1) / M)
    assert rows[16]["ratio_to_ideal"] < rows[4]["ratio_to_ideal"]
    # the training schedules: 2 (M + S - 1) ticks for 2M of work each
    for sched in ("gpipe", "1f1b"):
        assert _schedule_ticks(sched, S, 16)["makespan"] == 2 * (16 + S - 1)


def test_pipeline_composes_with_dp(world):
    """DP x PP on one (data, pp) mesh: the pure pipeline's loss, batch rows
    over data, loss and gradients averaged there; and it trains."""
    cfg_kw = dict(causal=True, n_layers=4)
    rng = np.random.default_rng(7)
    tokens = _tokens(256, rng)
    dp = world.run(torch_world.pp_run, (2, 4), ("data", "pp"), cfg_kw,
                   dict(n_micro=4, seed=5), None, [tokens],
                   [_tokens(256, rng) for _ in range(8)])[0]
    pure = world.run(torch_world.pp_run, *_axes(4), cfg_kw, dict(n_micro=4, seed=5), None,
                     [tokens], [])[0]
    np.testing.assert_allclose(dp[0], pure[0], rtol=2e-5, atol=2e-5)
    losses = dp[1]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-2:]) < np.mean(losses[:2])


_F1B = dict(causal=True, tie_embeddings=False, n_layers=4, n_kv_heads=4)


def test_1f1b_matches_gpipe_trajectory(world):
    """schedule="1f1b" (recompute-from-input backward) takes GPipe's
    trajectory: the same math in another order."""
    rng = np.random.default_rng(0)
    toks = [_tokens(256, rng) for _ in range(3)]
    lg = world.run(torch_world.pp_run, *_axes(4), _F1B, dict(n_micro=8, seed=0), None,
                   [], toks)[0][1]
    l1 = world.run(torch_world.pp_run, *_axes(4), _F1B,
                   dict(n_micro=8, seed=0, schedule="1f1b"), None, [], toks)[0][1]
    np.testing.assert_allclose(lg, l1, rtol=2e-5, atol=1e-6)


def test_1f1b_composes_with_dp(world):
    """DP x PP with the 1F1B backward: every gradient, the embedding's too,
    is the gradient of the data-averaged loss, so the trajectory equals
    GPipe's on the same (data, pp) mesh and stream."""
    rng = np.random.default_rng(0)
    toks = [_tokens(256, rng, batch=16) for _ in range(3)]
    shape, axes = (2, 4), ("data", "pp")
    lg = world.run(torch_world.pp_run, shape, axes, _F1B, dict(n_micro=8, seed=0), None,
                   [], toks)[0][1]
    l1 = world.run(torch_world.pp_run, shape, axes, _F1B,
                   dict(n_micro=8, seed=0, schedule="1f1b"), None, [], toks)[0][1]
    np.testing.assert_allclose(lg, l1, rtol=2e-5, atol=1e-6)


def test_1f1b_memory_is_microbatch_independent(world):
    """1F1B's point: a rank's peak stays about flat as M grows (at most S
    stashed inputs) while GPipe's grows O(M), on the largest rank's peak of
    a step (the second, after AdamW's state exists)."""
    cfg_kw = dict(_F1B, d_model=128, d_ff=256, max_seq=128)
    runs = [({"schedule": s}, M, "step") for s in ("gpipe", "1f1b") for M in (8, 32)]
    res = world.run(torch_world.pp_peaks, *_axes(4), cfg_kw, runs, (2, 128))
    g8, g32, f8, f32 = (max(r[i] for r in res) for i in range(4))
    g_ratio, f_ratio = g32 / g8, f32 / f8
    assert g_ratio > 1.7, g_ratio
    assert f_ratio < 1.45, f_ratio
    assert f_ratio < g_ratio - 0.4, (f_ratio, g_ratio)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pp_composes_with_tp(world, schedule):
    """PP x TP: each stage's blocks placed over model by the TP rules (a q
    kernel split over both axes), the pp-only pipeline's loss."""
    cfg_kw = dict(causal=True, tie_embeddings=False, n_layers=4, n_kv_heads=2)
    toks = np.random.default_rng(0).integers(0, 256, size=(4, 16)).astype(np.int32)
    kw = dict(n_micro=4, seed=0, schedule=schedule)
    tp_res = world.run(torch_world.pp_run, (2, 2, 2), ("rep", "pp", "model"), cfg_kw,
                       dict(kw, tp=True), None, [], [toks])
    pp_res = world.run(torch_world.pp_run, *_axes(2), cfg_kw, kw, None, [], [toks])
    np.testing.assert_allclose(tp_res[0][1], pp_res[0][1], rtol=2e-5)
    layout = world.run(torch_world.pp_layout, (2, 2, 2), ("rep", "pp", "model"), cfg_kw,
                       dict(kw, tp=True), toks)
    local, moments, stacked, specs = layout[0]
    q = "Block_0.attn.q.kernel"
    assert "pp" in specs[q] and "model" in specs[q], specs[q]
    assert local[q][1] * 2 == stacked[q][2] and moments[q] == local[q]


# -- across the packages --------------------------------------------------------------


def _jax_trainer(cfg_kw, S, **kw):
    mesh = Mesh(np.asarray(jax.devices()[:S]), ("pp",))
    return JaxPipelinedLMTrainer(jtfm.tiny_config(**cfg_kw), mesh, **kw)


def _jax_params(tr):
    return {"stages": jax.tree.map(np.asarray, tr.stage_params),
            "embed": np.asarray(tr.embed), "head": np.asarray(tr.head),
            "norm": jax.tree.map(np.asarray, tr.norm)}


def test_loss_matches_jax(world):
    """The port's loss from a JAX trainer's parameters equals JAX's loss at
    1e-5 (4 stages, 4 microbatches), on a pipeline of 4 gloo ranks."""
    cfg_kw = dict(causal=True, n_layers=4)
    tokens = _tokens(256, np.random.default_rng(1))
    jt = _jax_trainer(cfg_kw, 4, n_micro=4, seed=2)
    want = jt.loss(tokens)
    res = world.run(torch_world.pp_run, *_axes(4), cfg_kw, dict(n_micro=4),
                    _jax_params(jt), [tokens], [])
    np.testing.assert_allclose(res[0][0][0], want, rtol=1e-5)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_trajectory_matches_jax(world, schedule):
    """Three AdamW steps from the JAX trainer's parameters: the port's
    losses on 4 gloo ranks follow JAX's at 1e-4."""
    rng = np.random.default_rng(3)
    toks = [_tokens(256, rng) for _ in range(3)]
    jt = _jax_trainer(_F1B, 4, n_micro=4, seed=4, schedule=schedule)
    params = _jax_params(jt)
    want = [jt.step(t) for t in toks]
    res = world.run(torch_world.pp_run, *_axes(4), _F1B,
                    dict(n_micro=4, schedule=schedule), params, [], toks)
    assert all(r[1] == res[0][1] for r in res)
    np.testing.assert_allclose(res[0][1], want, rtol=1e-4)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_virtual_pipeline_equals_ranked(world, schedule):
    """The virtual pipeline (4 stages in one process, a mailbox for the
    hops) runs the ranked pipeline's code: its loss and 3-step trajectory
    equal the 4-rank gloo pipeline's within 1e-6 relative."""
    cfg_kw = dict(_F1B)
    rng = np.random.default_rng(6)
    toks = [_tokens(256, rng) for _ in range(3)]
    res = world.run(torch_world.pp_run, *_axes(4), cfg_kw,
                    dict(n_micro=4, seed=7, schedule=schedule), None, [toks[0]], toks)
    ranked_loss, ranked, params = res[0]
    vp = VirtualPipeline(tfm.tiny_config(**cfg_kw), 4, n_micro=4, schedule=schedule,
                         device="cpu")
    pipelined_from_numpy(vp, params)
    np.testing.assert_allclose(vp.loss(toks[0]), ranked_loss[0], rtol=1e-6)
    np.testing.assert_allclose([vp.step(t) for t in toks], ranked, rtol=1e-6)


def _deadlocks(orders):
    """Simulate the ranks' batches of point-to-point ops under rendezvous
    semantics (an op completes only once its peer has posted the matching
    one; a rank posts its next batch when the last one completed): True when
    some rank waits forever."""
    S = len(orders)
    batches = []
    for s, ops in enumerate(orders):
        out, pending = [], []
        for recv, send in pp.p2p_plan(ops, S, s):
            out.append(pending + ([("recv",) + recv] if recv else []))
            pending = [("send",) + send] if send else []
        out.append(pending)
        batches.append([b for b in out if b])
    pos, done = [0] * S, set()
    while any(pos[s] < len(batches[s]) for s in range(S)):
        moved = False
        for s in range(S):
            if pos[s] == len(batches[s]):
                continue
            for op in batches[s][pos[s]]:
                kind, peer, what, m = op
                twin = ("recv" if kind == "send" else "send", s, what, m)
                if ((s, op) not in done and pos[peer] < len(batches[peer])
                        and twin in batches[peer][pos[peer]]):
                    done.update({(s, op), (peer, twin)})
                    moved = True
            if all((s, op) in done for op in batches[s][pos[s]]):
                pos[s] += 1
                moved = True
        if not moved:
            return True
    return False


def test_schedules_match_send_and_receive_order():
    """Every boundary's sends and receives pair up in order, in one batch
    each side: no schedule deadlocks at any S and M (a gloo world would hang
    until its timeout)."""
    for S in range(1, 7):
        for M in (S, 2 * S, 4 * S + S):
            for sched in ("forward", "gpipe", "1f1b"):
                orders = [pp.stage_ops(sched, S, M, s) for s in range(S)]
                assert not _deadlocks(orders), (sched, S, M)
