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
def mesh(shape):
    """One mesh per shape for the life of the rank (its groups are reused)."""
    from parameter_server_tpu_torch.parallel import mesh as mesh_lib

    return mesh_lib.make_mesh(shape, device="cpu")


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
    rules, trained by AdamW(1e-2) on one replicated batch: its losses."""
    import torch
    from torch.func import functional_call

    from parameter_server_tpu_torch.convert import transformer_from_numpy
    from parameter_server_tpu_torch.learner.lm import adamw
    from parameter_server_tpu_torch.models import transformer as tfm
    from parameter_server_tpu_torch.parallel import tp

    m = mesh(shape)
    body = tfm.TransformerBody(tfm.tiny_config(**cfg_kw), device="cpu")
    transformer_from_numpy(body, params)
    placed = tp.place_params(body, m, tp.transformer_param_shardings(body, m, fsdp=fsdp))
    opt = adamw(placed.values(), 1e-2)
    e, t = torch.from_numpy(emb), torch.from_numpy(tokens).long()
    out = []
    for _ in range(steps):
        # every rank holds the whole batch: the gradients are identical
        full = tp.materialize(placed, m, partial_over=())
        loss = tfm.causal_lm_loss(functional_call(body, full, (e,)), t)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        out.append(float(loss))
    return out


def _held_bytes(root) -> int:
    """Bytes of every tensor reachable from ``root`` through dicts, lists,
    modules (parameters and buffers), optimizers (their state) and DTensors
    (this rank's local shard), each storage once; ``meta`` tensors hold
    none."""
    import torch
    from torch.distributed.tensor import DTensor

    seen, storages = {}, {}  # seen keeps what it met alive, so no id is reused
    todo = [root]
    while todo:
        x = todo.pop()
        if id(x) in seen:
            continue
        seen[id(x)] = x
        if isinstance(x, DTensor):
            todo.append(x.to_local())
        elif isinstance(x, torch.Tensor):
            if x.device.type != "meta":
                st = x.untyped_storage()
                storages[(x.device, st.data_ptr())] = st.nbytes()
        elif isinstance(x, torch.nn.Module):
            todo += list(x.parameters()) + list(x.buffers())
        elif isinstance(x, torch.optim.Optimizer):
            todo += list(x.state.values())
        elif isinstance(x, dict):
            todo += list(x.values())
        elif isinstance(x, (list, tuple)):
            todo += list(x)
        elif hasattr(x, "__dict__") and not isinstance(x, type):
            todo += [v for k, v in vars(x).items() if k != "mesh"]
    return sum(storages.values())


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
