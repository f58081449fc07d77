"""A spawned gloo world for the port's mesh tests, and the functions its ranks run.

A torch mesh needs one process per rank, where the JAX tests fake 8 devices
inside the pytest process.  :class:`World` spawns ``n`` ranks once (the
``spawn`` start method: the pytest process has JAX initialised, which must
not be forked), joins them in one gloo world with a timeout on every group,
and then runs one function per call on every rank, returning each rank's
result.  A test file holds one world in a module-scoped fixture.

Nothing here may hang the suite: every result wait has a deadline, a rank
whose function raised reports its traceback, and a world that failed or
timed out is killed and spawned again for the next call (a gloo world does
not survive a stuck collective).  The rank functions live in this module,
which imports no JAX, so a rank's interpreter stays light.
"""

from __future__ import annotations

import functools
import multiprocessing as mp
import os
import socket
import time
import traceback

import numpy as np

#: every collective of a rank raises after this many seconds
GROUP_TIMEOUT_S = 60.0


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rank_main(rank: int, n: int, port: int, conn) -> None:
    import torch

    from parameter_server_tpu_torch.parallel import distributed

    torch.set_num_threads(1)  # the ranks share the host's cores
    try:
        distributed.initialize(f"127.0.0.1:{port}", 1, 0, cpu_devices=n,
                               local_rank=rank, timeout=GROUP_TIMEOUT_S)
        conn.send(("ok", None))
    except BaseException:
        conn.send(("err", traceback.format_exc()))
        return
    while True:
        msg = conn.recv()
        if msg is None:
            break
        fn, args = msg
        try:
            conn.send(("ok", fn(*args)))
        except BaseException:
            conn.send(("err", f"rank {rank}: {traceback.format_exc()}"))


class World:
    """``n`` gloo ranks on this host, started on first use."""

    def __init__(self, n: int = 8, deadline_s: float = 120.0) -> None:
        self.n = n
        self.deadline_s = deadline_s
        self._procs: list = []
        self._conns: list = []

    def _start(self) -> None:
        ctx = mp.get_context("spawn")
        port = _free_port()
        for r in range(self.n):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_rank_main, args=(r, self.n, port, child), daemon=True)
            p.start()
            child.close()
            self._procs.append(p)
            self._conns.append(parent)
        self._collect(self.deadline_s)

    def _collect(self, deadline_s: float) -> list:
        end = time.monotonic() + deadline_s
        out = [None] * self.n
        pending = set(range(self.n))
        while pending:
            left = end - time.monotonic()
            if left <= 0:
                self.close()
                raise TimeoutError(f"ranks {sorted(pending)} gave no result in {deadline_s} s")
            for r in list(pending):
                conn = self._conns[r]
                if conn.poll(min(left, 0.05)):
                    try:
                        status, value = conn.recv()
                    except EOFError:
                        status, value = "err", f"rank {r} died"
                    if status != "ok":
                        self.close()
                        raise RuntimeError(value)
                    out[r] = value
                    pending.discard(r)
        return out

    def run(self, fn, *args, deadline_s: float | None = None) -> list:
        """``fn(*args)`` on every rank; every rank's result, in rank order."""
        if not self._procs:
            self._start()
        for conn in self._conns:
            conn.send((fn, args))
        return self._collect(deadline_s or self.deadline_s)

    def close(self) -> None:
        for conn in self._conns:
            try:
                conn.send(None)
            except (BrokenPipeError, OSError):
                pass
        for p in self._procs:
            p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        for conn in self._conns:
            conn.close()
        self._procs, self._conns = [], []


# ---------------------------------------------------------------------------
# Rank functions (run on every rank of the world)
# ---------------------------------------------------------------------------


def m_lib():
    from parameter_server_tpu_torch.parallel import mesh as mesh_lib

    return mesh_lib


@functools.lru_cache(maxsize=None)
def mesh(shape, axes=("data", "model")):
    """One mesh per shape and axes for the life of the rank (its groups are
    reused)."""
    from parameter_server_tpu_torch.parallel import mesh as mesh_lib

    return mesh_lib.make_mesh(shape, axes, device="cpu")


def mesh_shape(shape):
    m = mesh(shape)
    return m.shape, m.index("data"), m.index("model")


def make_mesh_error(shape):
    from parameter_server_tpu_torch.parallel import mesh as mesh_lib

    try:
        mesh_lib.make_mesh(shape, device="cpu")
    except ValueError as e:
        return str(e)
    return ""


def lr_cfg(rows, lr=0.2, **opt):
    from parameter_server_tpu_torch.config import OptimizerConfig, TableConfig

    return TableConfig(name="w", rows=rows, dim=1,
                       optimizer=OptimizerConfig(kind="adagrad", learning_rate=lr, **opt))


def lr_losses(shape, rows, batches):
    """Losses of an ``SpmdLRTrainer`` on ``batches`` (each rank feeds the
    whole global batch, as one JAX process does)."""
    from parameter_server_tpu_torch.parallel.lr_spmd import SpmdLRTrainer

    tr = SpmdLRTrainer(lr_cfg(rows), mesh(shape))
    return [tr.step(k, y) for k, y in batches]


def lr_shard_rows(shape, rows):
    from parameter_server_tpu_torch.parallel.lr_spmd import SpmdLRTrainer

    tr = SpmdLRTrainer(lr_cfg(rows), mesh(shape))
    return tr.state.value.shape[0], tr.total_rows


def lr_rejects_penalties(shape):
    from parameter_server_tpu_torch.parallel.lr_spmd import SpmdLRTrainer

    try:
        SpmdLRTrainer(lr_cfg(64, l1=0.1), mesh(shape))
    except ValueError as e:
        return str(e)
    return None


def lr_full_table(shape, rows, keys, labels, steps):
    """The whole value table (gathered over ``model``) after ``steps`` steps
    on one batch."""
    from parameter_server_tpu_torch.parallel.lr_spmd import SpmdLRTrainer

    tr = SpmdLRTrainer(lr_cfg(rows), mesh(shape))
    for _ in range(steps):
        tr.step(keys, labels)
    return tr.total_rows, tr.full_state()["value"]


def dlrm_cfg(rows, dim=16):
    from parameter_server_tpu_torch.config import OptimizerConfig, TableConfig

    return TableConfig(name="emb", rows=rows, dim=dim, init_scale=0.01,
                       optimizer=OptimizerConfig(kind="adagrad", learning_rate=0.05))


def dlrm_trainer(shape, rows, dim=16, **kw):
    from parameter_server_tpu_torch.models.dlrm import SpmdDLRMTrainer

    return SpmdDLRMTrainer(dlrm_cfg(rows, dim), mesh(shape), **kw)


def dlrm_losses(shape, rows, batches, kw):
    tr = dlrm_trainer(shape, rows, **kw)
    return [tr.step(*b) for b in batches]


def dlrm_shard_rows(shape, rows):
    tr = dlrm_trainer(shape, rows)
    return tr.emb_value.shape[0], tr.total_rows


def dlrm_from_state(shape, rows, value, state, mlp_params, batches, kw):
    """Losses, the gathered table planes and the MLP params after ``batches``
    from one numpy state (``convert.dlrm_from_numpy``)."""
    from parameter_server_tpu_torch.convert import dlrm_from_numpy

    tr = dlrm_trainer(shape, rows, **kw)
    dlrm_from_numpy(tr, value, state, mlp_params)
    losses = [tr.step(*b) for b in batches]
    m = mesh(shape)
    value = m_lib().gather_over_model(m, tr.emb_value)
    state = {k: m_lib().gather_over_model(m, v) for k, v in tr.emb_state.items()}
    params = {k: p.detach().numpy().copy() for k, p in tr.model.named_parameters()}
    return losses, value, state, params


def _allocated_bytes(fn):
    """``fn()``'s result and the bytes of every new storage its operators
    made (the step's allocations, forward and backward)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Count(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ins = {t.untyped_storage().data_ptr() for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)}
            out = func(*args, **(kwargs or {}))
            seen = set()
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    st = t.untyped_storage()
                    if st.data_ptr() not in ins and st.data_ptr() not in seen:
                        seen.add(st.data_ptr())
                        Count.total += st.nbytes()
            return out

    with Count():
        out = fn()
    return out, Count.total


def dlrm_step_bytes(shape, rows, dim, batch, steps, min_bucket):
    """Per-step allocated bytes of a mesh DLRM step, the rank's table bytes,
    and the losses of ``steps`` steps on one batch."""
    tr = dlrm_trainer(shape, rows, dim, min_bucket=min_bucket, table_init="zeros",
                      n_dense=batch[1].shape[1], n_sparse=batch[0].shape[1])
    table = tr.emb_value.nbytes + sum(v.nbytes for v in tr.emb_state.values())
    losses, step_bytes = [], []
    for _ in range(steps):
        loss, n = _allocated_bytes(lambda: tr.step(*batch))
        losses.append(loss)
        step_bytes.append(n)
    return max(step_bytes), table, losses


def resnet_losses(shape, images, labels, steps, lr):
    """Losses of a tiny ResNet (the JAX test's) trained data-parallel over
    the mesh's ``data`` axis by SGD with momentum."""
    import functools

    import torch

    from parameter_server_tpu_torch.learner.dense import SpmdDenseTrainer
    from parameter_server_tpu_torch.models.resnet import ResNet

    model = ResNet([1, 1], num_classes=10, width=8, bottleneck=False, small_inputs=True)
    tr = SpmdDenseTrainer(model, functools.partial(torch.optim.SGD, lr=lr, momentum=0.9),
                          mesh(shape))
    return [tr.step(images, labels) for _ in range(steps)]


def lm_losses(shape, cfg_kw, batches, kw):
    """Causal-LM losses of an ``SpmdLMTrainer`` on the mesh."""
    from parameter_server_tpu_torch.learner.lm import SpmdLMTrainer
    from parameter_server_tpu_torch.models import transformer as tfm

    tr = SpmdLMTrainer(tfm.tiny_config(**cfg_kw), mesh(shape), device="cpu", **kw)
    placements = {n: tuple(str(p) for p in t.placements) for n, t in tr.params.items()}
    local = {n: tuple(t.to_local().shape) for n, t in tr.params.items()}
    return [tr.step_causal(b) for b in batches], placements, local


def body_losses(shape, cfg_kw, params, emb, tokens, fsdp, steps):
    """A ``TransformerBody`` from flax ``params``, placed by the TP (or fsdp)
    rules and computed as their Megatron split, trained by AdamW(1e-2) on
    one replicated batch: its losses."""
    import torch
    from torch.func import functional_call

    from parameter_server_tpu_torch.convert import transformer_from_numpy
    from parameter_server_tpu_torch.learner.lm import adamw
    from parameter_server_tpu_torch.models import transformer as tfm
    from parameter_server_tpu_torch.parallel import tp

    m = mesh(shape)
    body = tfm.TransformerBody(tp.split_config(tfm.tiny_config(**cfg_kw), m), device="cpu")
    transformer_from_numpy(body, params)
    placed = tp.place_params(body, m, tp.transformer_param_shardings(body, m, fsdp=fsdp))
    opt = adamw(placed.values(), 1e-2)
    e, t = torch.from_numpy(emb), torch.from_numpy(tokens).long()
    out = []
    for _ in range(steps):
        # every rank holds the whole batch: the gradients are identical over
        # data; each rank computes its model shards' part
        local = tp.materialize(placed, m, partial_over=())
        loss = tfm.causal_lm_loss(functional_call(body, local, (e,)), t, body.cfg)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        out.append(float(loss))
    return out


def _held_bytes(root) -> int:
    """Bytes of every tensor reachable from ``root`` (the package's
    ``feasibility.held_bytes``)."""
    from parameter_server_tpu_torch.parallel.feasibility import held_bytes

    return held_bytes(root)


def lm_held_bytes(shape, cfg_kw, batch, fsdp):
    """Bytes of every tensor an ``SpmdLMTrainer`` holds on this rank after a
    step (parameters, AdamW's moments, anything else it keeps)."""
    from parameter_server_tpu_torch.learner.lm import SpmdLMTrainer
    from parameter_server_tpu_torch.models import transformer as tfm

    tr = SpmdLMTrainer(tfm.tiny_config(**cfg_kw), mesh(shape), device="cpu", fsdp=fsdp)
    tr.step_causal(batch)
    return _held_bytes(tr)


def lm_mlm_losses(shape, batches, seed):
    """Masked-LM losses of an ``SpmdLMTrainer`` (tiny BERT) on the mesh."""
    from parameter_server_tpu_torch.learner.lm import SpmdLMTrainer
    from parameter_server_tpu_torch.models import transformer as tfm

    tr = SpmdLMTrainer(tfm.tiny_config(causal=False), mesh(shape), learning_rate=5e-3,
                       seed=seed, device="cpu")
    return [tr.step_mlm(*b) for b in batches]


def lr_from_state(shape, rows, value, sum_sq, steps_batches):
    """Losses and the gathered table of an ``SpmdLRTrainer`` started from
    whole numpy planes (``convert.trainer_from_numpy``: each rank keeps its
    row block)."""
    from parameter_server_tpu_torch.convert import trainer_from_numpy
    from parameter_server_tpu_torch.parallel.lr_spmd import SpmdLRTrainer

    tr = SpmdLRTrainer(lr_cfg(rows), mesh(shape))
    zero = np.zeros((1, 1), np.float32)
    trainer_from_numpy(tr, value, {"sum_sq": sum_sq}, zero, {"sum_sq": zero})
    losses = [tr.step(k, y) for k, y in steps_batches]
    return losses, tr.full_state()["value"]


# -- sequence parallelism ------------------------------------------------------


def sp_attention(n, kind, causal, q, k, v, w):
    """This rank's output block of ring (or Ulysses) attention over an
    ``("sp",)`` mesh of ``n`` ranks (the whole ``q`` / ``k`` / ``v`` given to
    every rank), and, for the ring, the gradients of ``sum(out * w)`` with
    respect to the whole tensors (non-zero on this rank's share)."""
    import torch

    from parameter_server_tpu_torch.ops import ring_attention as ra
    from parameter_server_tpu_torch.ops import ulysses

    m = mesh((n,), ("sp",))
    make = ra.make_ring_attention if kind == "ring" else ulysses.make_ulysses_attention
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = make(m, sp_axis="sp", causal=causal)(*ts)
    if w is None:
        return out.detach().numpy(), None
    (out * ra.local_block(torch.from_numpy(w), m, "sp")).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _saved_bytes(fn):
    """``fn()``'s result and the bytes of the distinct storages autograd
    saved for the backward while it ran."""
    import torch

    seen = {}

    def pack(t):
        st = t.untyped_storage()
        seen[(t.device, st.data_ptr())] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, sum(seen.values())


def sp_ring_memory(n, shape, causal):
    """Per-rank bytes of ring attention at ``shape`` ``[B, S, H, D]`` over
    ``n`` ranks: what autograd saves for the backward (one call), the peak
    of the forward's temporaries (``torch.profiler`` memory events), and the
    peak of the backward's temporaries."""
    import torch

    from parameter_server_tpu_torch.ops import ring_attention as ra

    m = mesh((n,), ("sp",))
    B, S, H, D = shape
    g = torch.Generator().manual_seed(m.index("sp"))
    q, k, v = (torch.randn(B, S // n, H, D, generator=g).requires_grad_(True)
               for _ in range(3))
    out, saved = _saved_bytes(lambda: ra.ring_attention_spmd(q, k, v, mesh=m, sp_axis="sp",
                                                             causal=causal))
    fwd_peak = _peak_bytes(lambda: ra.ring_attention_spmd(q.detach(), k.detach(), v.detach(),
                                                          mesh=m, sp_axis="sp", causal=causal))
    bwd_peak = _peak_bytes(lambda: (out ** 2).sum().backward())
    return saved, fwd_peak, bwd_peak


def _peak_bytes(fn) -> int:
    """The peak of the bytes that storages made by ``fn``'s operators held
    alive at once (the package's tracker, ``feasibility.peak_live_bytes``)."""
    from parameter_server_tpu_torch.parallel.feasibility import peak_live_bytes

    return peak_live_bytes(fn)[1]


def sp_lm_losses(shape, axes, cfg_kw, batches, kw):
    """Losses of an ``SpLMTrainer`` on a mesh of ``shape`` over ``axes``."""
    from parameter_server_tpu_torch.models import transformer as tfm
    from parameter_server_tpu_torch.parallel.sp_lm import SpLMTrainer

    tr = SpLMTrainer(tfm.tiny_config(**cfg_kw), mesh(tuple(shape), tuple(axes)), **kw)
    return [tr.step(b) for b in batches]


def sp_lm_from_params(shape, axes, cfg_kw, params, batches, kw):
    """Losses of an ``SpLMTrainer`` started from a flax params tree."""
    from parameter_server_tpu_torch.convert import transformer_from_numpy
    from parameter_server_tpu_torch.models import transformer as tfm
    from parameter_server_tpu_torch.parallel.sp_lm import SpLMTrainer

    tr = SpLMTrainer(tfm.tiny_config(**cfg_kw), mesh(tuple(shape), tuple(axes)), **kw)
    transformer_from_numpy(tr.model, params)
    return [tr.step(b) for b in batches]


def sp_lm_errors(n, cfg_kw, steps):
    """The messages of an ``SpLMTrainer``'s refusals: each ``(cfg_kw,
    tokens shape)`` of ``steps`` is built on an ``("sp",)`` mesh of ``n`` and
    stepped once."""
    import numpy as np_

    from parameter_server_tpu_torch.models import transformer as tfm
    from parameter_server_tpu_torch.parallel.sp_lm import SpLMTrainer

    out = []
    for kw, tok_shape in steps:
        try:
            tr = SpLMTrainer(tfm.tiny_config(**{**cfg_kw, **kw}), mesh((n,), ("sp",)),
                             device="cpu")
            tr.step(np_.zeros(tok_shape, np_.int32))
            out.append("")
        except ValueError as e:
            out.append(str(e))
    return out


def sp_lm_step_bytes(n, cfg_kw, batch):
    """Per-rank bytes an ``SpLMTrainer`` step allocates, forward and
    backward (every new storage its operators make)."""
    from parameter_server_tpu_torch.models import transformer as tfm
    from parameter_server_tpu_torch.parallel.sp_lm import SpLMTrainer

    tr = SpLMTrainer(tfm.tiny_config(**cfg_kw), mesh((n,), ("sp",)), device="cpu")
    tok, tgt, msk = tr._place(batch)

    def fwd_bwd():
        loss_sum, count = tr._local(tok, tgt, msk)
        (loss_sum / count).backward()

    _, saved = _saved_bytes(fwd_bwd)
    tr.optimizer.zero_grad(set_to_none=True)
    return saved, _peak_bytes(fwd_bwd)


def sptp_run(shape, cfg_kw, params, batches, kw):
    """Losses of an ``SpTpLMTrainer`` on an ``(sp, model)`` mesh (from a
    flax params tree when given), and the local shapes of its parameters
    and AdamW moments after the steps, by dotted name."""
    from parameter_server_tpu_torch.models import transformer as tfm
    from parameter_server_tpu_torch.parallel.sp_fsdp import SpTpLMTrainer

    tr = SpTpLMTrainer(tfm.tiny_config(**cfg_kw), mesh(tuple(shape), ("sp", "model")), **kw)
    if params is not None:
        from parameter_server_tpu_torch.convert import placed_from_numpy

        placed_from_numpy(tr, params)
    losses = [tr.step(b) for b in batches]
    local = {n: tuple(p.to_local().shape) for n, p in tr.params.items()}
    moments = {n: tuple(tr.optimizer.state[s]["exp_avg"].to_local().shape)
               for n, s in tr._slices.items()}
    placements = {n: tuple(str(p) for p in s.placements) for n, s in tr._slices.items()}
    return losses, local, moments, placements


def sptp_errors(shape, cfg_kw, tok_shape):
    import numpy as np_

    from parameter_server_tpu_torch.models import transformer as tfm
    from parameter_server_tpu_torch.parallel.sp_fsdp import SpTpLMTrainer

    tr = SpTpLMTrainer(tfm.tiny_config(**cfg_kw), mesh(tuple(shape), ("sp", "model")),
                       device="cpu")
    try:
        tr.step(np_.zeros(tok_shape, np_.int32))
    except ValueError as e:
        return str(e)
    return ""


def sp_chunked_loss(n, hidden, head, tokens, chunk):
    """``sp_chunked_causal_loss`` over an ``("sp",)`` mesh of ``n`` on the
    shifted targets of ``tokens``: the value, and its gradient with respect
    to this rank's ``hidden`` block."""
    import torch

    from parameter_server_tpu_torch.parallel.sp_fsdp import sp_chunked_causal_loss
    from parameter_server_tpu_torch.parallel.sp_lm import shift_targets
    from parameter_server_tpu_torch.models import transformer as tfm

    m = mesh((n,), ("sp",))
    cfg = tfm.tiny_config()
    tok, tgt, msk = shift_targets(tokens, n, cfg)
    s = tok.shape[1] // n
    i = m.index("sp")
    h = torch.from_numpy(np.ascontiguousarray(hidden[:, i * s:(i + 1) * s])).requires_grad_(True)
    loss = sp_chunked_causal_loss(h, torch.from_numpy(head),
                                  torch.from_numpy(tgt[:, i * s:(i + 1) * s]),
                                  torch.from_numpy(msk[:, i * s:(i + 1) * s]),
                                  mesh=m, chunk=chunk)
    loss.backward()
    return float(loss), h.grad.numpy()


# -- config #5's body on a mesh ---------------------------------------------------


def hybrid_mesh_run(shape, cfg_kw, batches, emb_optimizer, kw):
    """``HybridLMTrainer`` on a ``(data, model)`` mesh of ``shape``.  Each
    data line's Van rank (model index 0) holds a worker over its own
    LoopbackVan cluster of 2 servers (the same seeded tables everywhere);
    the other ranks hold none.  Returns (losses, the ``Mesh.all_reduce``
    calls of each step by axis, the servers' push requests or None, whether
    this rank talked to the Van)."""
    import collections

    from parameter_server_tpu_torch.core.postoffice import Postoffice
    from parameter_server_tpu_torch.core.van import LoopbackVan
    from parameter_server_tpu_torch.kv.server import KVServer
    from parameter_server_tpu_torch.kv.worker import KVWorker
    from parameter_server_tpu_torch.learner import hybrid
    from parameter_server_tpu_torch.models import transformer as tfm

    m = mesh(shape)
    cfg = tfm.tiny_config(**cfg_kw)
    van, servers, worker = None, [], None
    if m.index("model") == 0:
        van = LoopbackVan()
        tables = {"emb": hybrid.embedding_table_cfg(cfg, optimizer=emb_optimizer)}
        servers = [KVServer(Postoffice(f"S{s}", van), tables, s, 2, device="cpu")
                   for s in range(2)]
        worker = KVWorker(Postoffice("W0", van), tables, 2,
                          localizers=hybrid.embedding_localizers(cfg), device="cpu")
    calls = collections.Counter()
    reduce = m.all_reduce

    def counting(t, axis):
        calls[axis] += 1
        return reduce(t, axis)

    m.all_reduce = counting
    try:
        tr = hybrid.HybridLMTrainer(cfg, worker, mesh=m, device="cpu", **kw)
        losses, per_step = [], []
        for b in batches:
            calls.clear()
            losses.append(tr.step(b))
            per_step.append(dict(calls))
        tr.drain()
    finally:
        del m.all_reduce
        if van is not None:
            van.close()
            for s in servers:
                if s.ledger is not None:
                    s.ledger.close()
    pushes = sum(s.pushes for s in servers) if servers else None
    return losses, per_step, pushes, tr.van_rank


def hybrid_mesh_ckpt(shape, cfg_kw, batches, root, split):
    """A mesh ``HybridLMTrainer`` (rank 0 the only Van rank, over its own
    LoopbackVan cluster) saves after ``split`` steps and goes on; a fresh
    cluster and trainer (another seed) restore that checkpoint and take the
    same remaining steps.  Returns (the first run's tail losses, the
    restored run's)."""
    from parameter_server_tpu_torch.core.postoffice import Postoffice
    from parameter_server_tpu_torch.core.van import LoopbackVan
    from parameter_server_tpu_torch.kv.server import KVServer
    from parameter_server_tpu_torch.kv.worker import KVWorker
    from parameter_server_tpu_torch.learner import hybrid
    from parameter_server_tpu_torch.models import transformer as tfm

    m = mesh(shape)
    cfg = tfm.tiny_config(**cfg_kw)
    tables = {"emb": hybrid.embedding_table_cfg(cfg)}

    def run(seed, restore):
        van, servers, worker = None, [], None
        if m.index("model") == 0:
            van = LoopbackVan()
            servers = [KVServer(Postoffice(f"S{s}", van), tables, s, 2, device="cpu")
                       for s in range(2)]
            worker = KVWorker(Postoffice("W0", van), tables, 2,
                              localizers=hybrid.embedding_localizers(cfg), device="cpu")
        try:
            tr = hybrid.HybridLMTrainer(cfg, worker, mesh=m, learning_rate=1e-2, seed=seed,
                                        device="cpu")
            if restore:
                tr.restore(root, step=split)
            else:
                for b in batches[:split]:
                    tr.step(b)
                tr.save(root, step=split)
            tail = [tr.step(b) for b in batches[split:]]
            tr.drain()
            return tail
        finally:
            if van is not None:
                van.close()
                for s in servers:
                    if s.ledger is not None:
                        s.ledger.close()

    return run(1, False), run(99, True)


# -- pipeline parallelism -----------------------------------------------------------


def pp_trainer(shape, axes, cfg_kw, kw, params=None):
    """A ``PipelinedLMTrainer`` on a mesh of ``shape`` over ``axes`` (from a
    JAX ``PipelinedLMTrainer``'s parameters when given)."""
    from parameter_server_tpu_torch.convert import pipelined_from_numpy
    from parameter_server_tpu_torch.models import transformer as tfm
    from parameter_server_tpu_torch.parallel.pp import PipelinedLMTrainer

    tr = PipelinedLMTrainer(tfm.tiny_config(**cfg_kw), mesh(tuple(shape), tuple(axes)),
                            device="cpu", **kw)
    if params is not None:
        pipelined_from_numpy(tr, params)
    return tr


def pp_params(tr):
    """The trainer's parameters as the JAX trainer's numpy tree."""
    from parameter_server_tpu_torch.models.layers import params_tree

    stages = {}
    for name, arr in tr.gather_stage_params().items():
        *path, leaf = name.split(".")
        node = stages
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return {"stages": stages, "embed": tr.embed.detach().numpy().copy(),
            "head": tr.head.detach().numpy().copy(),
            "norm": {k: v.detach().numpy().copy() for k, v in params_tree(tr.norm).items()}}


def pp_run(shape, axes, cfg_kw, kw, params, loss_batches, step_batches):
    """Losses of ``loss_batches`` before any step, then the losses of steps on
    ``step_batches``, and the parameters at the start."""
    tr = pp_trainer(shape, axes, cfg_kw, kw, params)
    start = pp_params(tr)
    losses = [tr.loss(b) for b in loss_batches]
    return losses, [tr.step(b) for b in step_batches], start


def pp_grads(shape, axes, cfg_kw, kw, tokens):
    """The loss and every gradient of one pass (no update), gathered as the
    parameters are, and the parameters."""
    import torch

    tr = pp_trainer(shape, axes, cfg_kw, kw)
    loss = float(tr.pp.loss_and_grads(tr._micro(tokens)))
    params = pp_params(tr)
    with torch.no_grad():
        for name, p in tr.stage_params.items():
            p.copy_(p.grad)
        tr.embed.copy_(tr.embed.grad)
        tr.head.copy_(tr.head.grad)
        for p in tr.norm.parameters():
            p.copy_(p.grad)
    return loss, pp_params(tr), params


def pp_layout(shape, axes, cfg_kw, kw, tokens):
    """After one step: this rank's stage parameter shapes, their AdamW
    moments' shapes, the stack's total size and the stage count."""
    from parameter_server_tpu_torch.parallel.pp import stage_sharding

    tr = pp_trainer(shape, axes, cfg_kw, kw)
    tr.step(tokens)
    local = {n: tuple(p.to_local().shape) if hasattr(p, "to_local") else tuple(p.shape)
             for n, p in tr.stage_params.items()}
    opt = tr.optimizer.state
    moments = {}
    for n, p in tr.stage_params.items():
        m = opt[p]["exp_avg"]
        moments[n] = tuple(m.to_local().shape) if hasattr(m, "to_local") else tuple(m.shape)
    stacked = tr.gather_stage_params()
    specs = {n: s.spec for n, s in stage_sharding(tr.mesh, stacked, tp=tr.pp.tp).items()}
    return local, moments, {n: a.shape for n, a in stacked.items()}, specs


def pp_peaks(shape, axes, cfg_kw, runs, batch_of):
    """This rank's peak of live bytes for each ``(kw, n_micro, what)`` of
    ``runs``: ``what`` "loss" (the forward alone) or "step" (the second
    step, after AdamW's state exists)."""
    from parameter_server_tpu_torch.parallel.feasibility import peak_live_bytes

    out = []
    for kw, n_micro, what in runs:
        tr = pp_trainer(shape, axes, cfg_kw, dict(kw, n_micro=n_micro))
        tokens = np.zeros((n_micro * batch_of[0], batch_of[1]), np.int32)
        if what == "loss":
            out.append(peak_live_bytes(lambda: tr.loss(tokens))[1])
        else:
            tr.step(tokens)
            out.append(peak_live_bytes(lambda: tr.step(tokens))[1])
    return out


def pp_errors(shape, axes, cfg_kw, kw, tokens):
    tr = pp_trainer(shape, axes, cfg_kw, kw)
    try:
        tr.step(tokens)
    except ValueError as e:
        return str(e)
    return ""


# -- memory feasibility (run in a process of its own: a fake world) ---------------


def feasibility_cases(budget):
    """The feasibility twins' results at test sizes, in one process: the body
    step under each ``fsdp`` knob, DLRM on a ``(1, 8)`` fake world, pp-vs-dp
    and pp-x-tp, and a tiny body step's fake trace beside the same step on
    real CPU tensors (the same tracker)."""
    from parameter_server_tpu_torch.models import transformer as tfm
    from parameter_server_tpu_torch.parallel import feasibility as feas
    from parameter_server_tpu_torch.parallel import mesh as mesh_lib

    cfg = tfm.tiny_config(causal=True, tie_embeddings=False, d_model=64, n_layers=2,
                          n_heads=4, n_kv_heads=4, remat=True)
    out = {"body": {f: feas.body_train_step_memory(cfg, (2, 4), 8, 32, loss_chunk=8, fsdp=f,
                                                   budget_bytes=budget)
                    for f in ("none", "state", "full")}}
    out["dlrm"] = feas.dlrm_feasibility(rows_log2=18, dim=16, mesh_shape=(1, 8), batch=256,
                                        slots_log2=10, budget_bytes=budget)
    small = dict(vocab=512, d_model=64, d_ff=128, n_heads=4, n_kv_heads=2)
    out["pp_vs_dp"] = feas.pp_vs_dp_feasibility(n_stages=4, n_micro=4, seq=32, n_layers=4,
                                                budget_bytes=budget, **small)
    out["pp_tp"] = feas.pp_tp_feasibility(n_stages=2, tp=2, n_micro=2, seq=32, n_layers=4,
                                          budget_bytes=budget, **small)
    fake = feas.body_train_step_memory(cfg, (1, 1), 2, 32, budget_bytes=budget)
    m = mesh_lib.make_mesh((1, 1), device="cpu")  # a real world of one, after the fake
    step, inputs, state, _n = feas.make_body_step(cfg, m, 2, 32)
    out["calibration"] = {"fake": fake, "real": feas.traced_step(state, step, *inputs)}
    return out


# -- the Megatron split over ``model`` (tests/test_torch_tp_compute.py) ----------------


def split_mesh(shape):
    """A ``(data, model)`` mesh of ``shape`` over the 8-rank world: a smaller
    one is repeated over a leading ``rep`` axis (``(1, 4)`` is ``(rep 2,
    data 1, model 4)``), whose ranks compute the same thing."""
    shape = tuple(shape)
    rep = 8 // int(np.prod(shape))
    if rep == 1:
        return mesh(shape)
    return mesh((rep,) + shape, ("rep", "data", "model"))


def _load_flat(module, flat):
    """Copy ``{dotted flax path: array}`` into ``module``'s parameters."""
    import torch

    with torch.no_grad():
        for n, p in module.named_parameters():
            p.copy_(torch.from_numpy(np.asarray(flat[n])))


def tp_block(shape, cfg_kw, flat, x, positions, mask, cot):
    """One ``Block`` from ``flat`` placed by the TP rules on a ``(data,
    model)`` mesh and computed as its split, on this rank's ``data`` rows of
    ``x``: (data index, those rows of ``sum(out * cot)``'s forward and of
    the input's gradient, every parameter's gradient summed and whole)."""
    import torch
    from torch.func import functional_call

    from parameter_server_tpu_torch.models import transformer as tfm
    from parameter_server_tpu_torch.parallel import distributed, tp

    m = split_mesh(shape)
    block = tfm.Block(tp.split_config(tfm.tiny_config(**cfg_kw), m), device="cpu")
    _load_flat(block, flat)
    placed = tp.place_params(block, m)
    rows = distributed.local_batch_slice(m.index("data"), m.shape["data"], x.shape[0])
    xs = torch.from_numpy(x[rows]).requires_grad_(True)
    attn = None if mask is None else torch.from_numpy(mask[rows])
    out = functional_call(block, tp.materialize(placed, m),
                          (xs, torch.from_numpy(positions[rows]), attn))
    (out * torch.from_numpy(cot[rows])).sum().backward()
    grads = {n: p.grad.full_tensor().numpy() for n, p in placed.items()}
    return m.index("data"), out.detach().numpy(), xs.grad.numpy(), grads


def tp_vocab(shape, kind, vocab, hidden, weight, tokens, mask, chunk):
    """The vocab-parallel embedding (``kind`` "embed": ``weight`` the
    ``[vocab, d]`` table, ``hidden`` the cotangent of the lookup) or loss
    ("causal", "chunked", "mlm": ``weight`` the ``[d, vocab]`` head) on a
    vocabulary split over ``model``: (the lookup or the loss, the gradient
    of ``hidden`` (None for "embed"), ``weight``'s gradient whole)."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from parameter_server_tpu_torch.models import transformer as tfm
    from parameter_server_tpu_torch.parallel import mesh as mesh_lib
    from parameter_server_tpu_torch.parallel import tp

    m = split_mesh(shape)
    cfg = tfm.TransformerConfig(vocab_size=vocab, n_layers=1, n_heads=1,
                                d_model=hidden.shape[-1], d_ff=4, spmd_mesh=m)
    dim = 0 if kind == "embed" else 1
    spec = [None, None]
    spec[dim] = "model"
    placed = torch.nn.Parameter(distribute_tensor(
        torch.from_numpy(weight), m.device_mesh, mesh_lib.Sharding(m, spec).placements))
    local = tp.materialize({"w": placed}, m, partial_over=())["w"]
    tok = torch.from_numpy(tokens).long()
    if kind == "embed":
        out = tp.vocab_parallel_embed(local, tok, m, vocab)
        (out * torch.from_numpy(hidden)).sum().backward()
        return out.detach().numpy(), None, placed.grad.full_tensor().numpy()
    h = torch.from_numpy(hidden).requires_grad_(True)
    if kind == "chunked":
        loss = tfm.chunked_causal_lm_loss(h, local, tok, chunk, cfg)
    else:
        logits = torch.einsum("bsd,dv->bsv", tp.copy_to_model(h, m), local)
        loss = (tfm.causal_lm_loss(logits, tok, cfg) if kind == "causal"
                else tfm.mlm_loss(logits, tok, torch.from_numpy(mask), cfg))
    loss.backward()
    return float(loss), h.grad.numpy(), placed.grad.full_tensor().numpy()


def tp_model(shape, cfg_kw, params, inputs, targets, mask):
    """An ``SpmdLMTrainer`` from the flax ``params`` on a ``(data, model)``
    mesh: its global loss on the batch (the step's own ``_mesh_loss`` on the
    rank's rows) and every parameter's gradient summed and whole."""
    import torch

    from parameter_server_tpu_torch.convert import placed_from_numpy
    from parameter_server_tpu_torch.learner.lm import SpmdLMTrainer
    from parameter_server_tpu_torch.models import transformer as tfm

    m = split_mesh(shape)
    tr = SpmdLMTrainer(tfm.tiny_config(**cfg_kw), m, device="cpu")
    placed_from_numpy(tr, params)
    mk = None if mask is None else torch.from_numpy(mask)
    inp, tgt, mk = tr._local_rows(torch.from_numpy(inputs).long(),
                                  torch.from_numpy(targets).long(), mk)
    loss = tr._mesh_loss(inp, tgt, mk)
    loss.backward()
    total = m.all_reduce(loss.detach().clone(), "data")
    return float(total), {n: p.grad.full_tensor().numpy() for n, p in tr.params.items()}


def _shapes_made(fn):
    """The shape of every plain tensor ``fn()``'s operators made (a
    DTensor's operator reaches the mode with its global shape first, then
    once more on the rank's local tensors: only those hold memory)."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    shapes = set()

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            shapes.update(tuple(t.shape) for t in tree_leaves(out)
                          if isinstance(t, torch.Tensor) and not isinstance(t, DTensor))
            return out

    with Record():
        fn()
    return shapes


def _tp_trace(kind, cfg, shape, batch, seq):
    """One traced step of ``kind`` as rank 0 of a fake world of ``shape``:
    the bytes of the parameters (the stage's for "pp") and their
    gradients; the part of them replicated over ``model``; the whole shapes
    of the ``model``-split parameters that an operator of the step made."""
    import torch
    from torch.distributed.tensor import Shard

    from parameter_server_tpu_torch.parallel import feasibility as feas
    from parameter_server_tpu_torch.parallel import mesh as mesh_lib

    axes = {"sptp": ("sp", "model"), "pp": ("pp", "model")}.get(kind, ("data", "model"))
    tokens = np.zeros((batch, seq), np.int64)
    with feas.fake_world(int(np.prod(shape))):
        m = mesh_lib.make_mesh(shape, axes, device="cpu")
        with feas.fake_tensors():
            tok = torch.from_numpy(tokens)
            if kind == "lm":
                from parameter_server_tpu_torch.learner.lm import SpmdLMTrainer

                tr = SpmdLMTrainer(cfg, m, device="cpu")
                params, step = tr.params, lambda: tr._update(tok, tok, None)
            elif kind == "hybrid":
                from parameter_server_tpu_torch.learner.hybrid import HybridLMTrainer

                tr = HybridLMTrainer(cfg, object(), mesh=m, device="cpu")
                emb = torch.zeros((batch, seq, cfg.d_model))
                params, step = tr.params, lambda: tr._body_step(emb, tok)
            elif kind == "body_step":
                body_step, inputs, state, _n = feas.make_body_step(cfg, m, batch, seq)
                params, step = state["params"], lambda: body_step(*inputs)
            elif kind == "sptp":
                from parameter_server_tpu_torch.parallel.sp_fsdp import SpTpLMTrainer

                tr = SpTpLMTrainer(cfg, m, loss_chunk=4, device="cpu")
                params, step = tr.params, lambda: tr._update(tokens)
            else:
                from parameter_server_tpu_torch.parallel.pp import PipelinedLMTrainer

                tr = PipelinedLMTrainer(cfg, m, n_micro=2, tp=True, device="cpu")
                micro = tr._micro(tokens)
                params, step = tr.stage_params, lambda: tr.pp.step(micro)
            made = _shapes_made(step)
            split = {n for n, p in params.items()
                     if any(isinstance(pl, Shard) and a == "model" for a, pl in
                            zip(p.device_mesh.mesh_dim_names, p.placements))}
            held = feas.held_bytes([list(params.values()),
                                    [p.grad for p in params.values()]])
            replicated = feas.held_bytes([[params[n], params[n].grad]
                                          for n in params if n not in split])
            whole = sorted({tuple(params[n].shape) for n in split} & made)
    return {"bytes": held, "replicated": replicated, "whole_shapes_made": whole,
            "n_split": len(split)}


def tp_trace_cases():
    """:func:`_tp_trace` of every trainer that computes the split, on a
    ``(1, 1)`` and a ``(1, 4)`` fake world, in one process (no world of its
    own)."""
    from parameter_server_tpu_torch.models import transformer as tfm

    # 8 query and 4 KV heads: whole KV groups a rank at model 4; B * S (24)
    # is no dimension of a parameter
    cfg = tfm.tiny_config(causal=True, tie_embeddings=False, n_heads=8, n_kv_heads=4,
                          d_model=64, d_ff=128, n_layers=2)
    out = {kind: {f"{s[0]},{s[1]}": _tp_trace(kind, cfg, s, 2, 12) for s in ((1, 1), (1, 4))}
           for kind in ("lm", "hybrid", "body_step", "sptp", "pp")}
    out["dtensor_op"] = _dtensor_op_bytes()
    return out


def _dtensor_op_bytes():
    """The tracker's bytes for one DTensor operator (``zeros_like`` of a
    ``[1024, 64]`` float32 split over ``model`` 4, rank 0 of a fake world)
    and that rank's shard's bytes."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from parameter_server_tpu_torch.parallel import feasibility as feas
    from parameter_server_tpu_torch.parallel import mesh as mesh_lib

    with feas.fake_world(4):
        m = mesh_lib.make_mesh((1, 4), device="cpu")
        with feas.fake_tensors():
            d = distribute_tensor(torch.ones(1024, 64), m.device_mesh, [Replicate(), Shard(0)])
            _, peak = feas.peak_live_bytes(lambda: torch.zeros_like(d))
            shard = d.to_local().numel() * d.element_size()
    return {"peak": peak, "shard": shard}
