"""Memory feasibility: does a configuration fit the card, per rank?

Torch counterpart of ``parameter_server_tpu/parallel/feasibility.py``.  The
JAX module AOT-compiles the real train step over a simulated mesh from
``ShapeDtypeStruct``s and reads XLA's ``memory_analysis()``.  Torch has no
such compile, so the port runs the rank's *real* step code — the same
trainers and step functions it trains with — with nothing materialised:

- as rank 0 of a world of ``n`` on torch's ``fake`` process-group backend
  (``FakeStore``; its collectives accept any tensor and move nothing), so a
  mesh of any shape forms in one process;
- inside ``FakeTensorMode``: every parameter, moment, activation and
  gradient is a fake tensor with a shape and no storage, on the CPU device
  (the kernel wrappers then take their plain versions, as on any CPU
  tensor);
- under :func:`peak_live_bytes`, which counts the bytes of the storages the
  step's operators make, alive at once, at their peak.

A result's ``peak_bytes`` is the rank's resident state (parameters and
optimizer state, :func:`held_bytes`) plus that peak of what the step makes
beyond it; ``"method": "fake_trace"``.  Where the shape fits one card,
:func:`body_train_step_memory` also measures a real step there
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``;
``"method": "measured"``).  The verdict ``fits_card`` compares the peak with
the card's memory (``torch.cuda.get_device_properties(0).total_memory``) or
with an explicit ``budget_bytes``.

What the fake trace does not see: the caching allocator's rounding and
fragmentation, cuBLAS workspaces and the CUDA context; where a kernel
wrapper would run on the card, the plain version's temporaries instead of
the kernel's (the gather's plain version makes the same output buffer; the
fused apply's plain version makes per-step temporaries the kernel does not).
Parameter initialisation draws a plain normal in place of the truncated one
(a truncated draw reads data), which changes no shape.

The fake world cannot share a process with another world, so :func:`main`
(``python -m parameter_server_tpu_torch.parallel.feasibility --preset ...``)
is the out-of-process entry, as in JAX.  The JAX ``compile_body_step`` (the
rank's step and its inputs, never materialised) is :func:`make_body_step`
here, and ``peak_bytes_from_analysis`` is :func:`peak_live_bytes`.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from typing import Callable, Optional, Sequence, Tuple

import torch


# -- the tracker --------------------------------------------------------------------


def peak_live_bytes(fn: Callable, *, resident: int = 0,
                    record: Optional[dict] = None) -> Tuple[object, int]:
    """``fn()``'s result and the peak of the bytes held at once by the
    storages ``fn``'s operators made (each counted from the op that made it
    until it is freed; an op's output on one of its inputs' storages, as in
    place or a view, is not new), plus ``resident``.  Storages are keyed by
    identity through a weak reference, never by address: fake storages have
    none, and a freed address is reused.  ``meta`` tensors hold nothing.
    ``record``: a dict that gets ``real_bytes_max``, the largest storage made
    that is not a fake tensor's.  A DTensor operator reaches the tracker as
    one operator on DTensors (its work on the rank's tensors runs beneath
    the mode): a DTensor counts as its local tensor, whose storage is what
    the rank holds (the wrapper's reports the global size)."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.multiprocessing.reductions import StorageWeakRef
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    live: dict = {}
    state = {"now": 0, "peak": 0}

    def key(t):
        return StorageWeakRef(t.untyped_storage())

    def tensors(tree):
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                t = getattr(t, "_local_tensor", t)  # a DTensor: the rank's tensor
                if t.device.type != "meta":
                    yield t

    class Track(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ins = {key(t).cdata for t in tensors((args, kwargs))}
            out = func(*args, **(kwargs or {}))
            for t in tensors(out):
                ref = key(t)
                # an input's storage (an in-place op, a view) is not new; a
                # weak ref pins the identity while the entry lives
                if ref.cdata not in live and ref.cdata not in ins:
                    n = t.untyped_storage().nbytes()
                    live[ref.cdata] = (ref, n)
                    state["now"] += n
                    if record is not None and not isinstance(t, FakeTensor):
                        record["real_bytes_max"] = max(record.get("real_bytes_max", 0), n)
            for gone in [k for k, (ref, _n) in live.items() if ref.expired()]:
                state["now"] -= live.pop(gone)[1]
            state["peak"] = max(state["peak"], state["now"])
            return out

    with Track():
        out = fn()
    return out, resident + state["peak"]


def held_bytes(root) -> int:
    """Bytes of every storage reachable from ``root`` through dicts, lists,
    modules (parameters and buffers), optimizers (their state), DTensors
    (this rank's shard) and objects' attributes, each storage once; ``meta``
    tensors hold none."""
    from torch.multiprocessing.reductions import StorageWeakRef

    seen, storages = {}, {}  # seen keeps what it met alive, so no id is reused
    todo = [root]
    while todo:
        x = todo.pop()
        if id(x) in seen:
            continue
        seen[id(x)] = x
        if hasattr(x, "to_local") and isinstance(x, torch.Tensor):
            todo.append(x.to_local())
        elif isinstance(x, torch.Tensor):
            if x.device.type != "meta":
                ref = StorageWeakRef(x.untyped_storage())
                storages[ref.cdata] = (ref, x.untyped_storage().nbytes())
        elif isinstance(x, torch.nn.Module):
            todo += list(x.parameters()) + list(x.buffers())
        elif isinstance(x, torch.optim.Optimizer):
            todo += list(x.state.values())
        elif isinstance(x, dict):
            todo += list(x.values())
        elif isinstance(x, (list, tuple)):
            todo += list(x)
        elif hasattr(x, "__dict__") and not isinstance(x, type):
            todo += [v for k, v in vars(x).items() if k not in ("mesh", "model_mesh")]
    return sum(n for _ref, n in storages.values())


# -- the fake world -----------------------------------------------------------------


def _plain_normal(tensor, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=None):
    return tensor.normal_(mean, std, generator=generator)


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """This process as rank ``rank`` of a ``fake`` world of ``world_size``
    for the block (make the mesh inside it, then enter
    :func:`fake_tensors`).  A process that has a world cannot hold one."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a fake world needs a process without a world: run "
                           "python -m parameter_server_tpu_torch.parallel.feasibility")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_tensors():
    """``FakeTensorMode`` (yielded) for the block: every tensor made is a
    fake one."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    trunc = torch.nn.init.trunc_normal_
    torch.nn.init.trunc_normal_ = _plain_normal
    try:
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            yield mode
    finally:
        torch.nn.init.trunc_normal_ = trunc


def card_memory() -> Optional[int]:
    """The card's memory in bytes, or None without a card."""
    if not torch.cuda.is_available():
        return None
    return int(torch.cuda.get_device_properties(0).total_memory)


def _budget(budget_bytes: Optional[int]) -> int:
    budget = card_memory() if budget_bytes is None else int(budget_bytes)
    if budget is None:
        raise ValueError("no card to judge against: give budget_bytes")
    return budget


def _verdict(out: dict, budget_bytes: Optional[int]) -> dict:
    out["budget_bytes"] = _budget(budget_bytes)
    out["fits_card"] = bool(out["peak_bytes"] <= out["budget_bytes"])
    return out


def traced_step(state, step: Callable, *args, record: Optional[dict] = None) -> dict:
    """Run ``step(*args)`` once under the tracker: ``resident_bytes`` (what
    ``state`` holds before), ``step_bytes`` (the peak of what the step makes
    beyond it: gradients, optimizer state made on the first step,
    activations), ``peak_bytes`` (their sum), ``state_bytes`` (what
    ``state`` holds after: parameters and optimizer state, the JAX
    ``argument_bytes``)."""
    resident = held_bytes(state)
    _, peak = peak_live_bytes(lambda: step(*args), resident=resident, record=record)
    return {"resident_bytes": resident, "step_bytes": peak - resident, "peak_bytes": peak,
            "state_bytes": held_bytes(state), "method": "fake_trace"}


# -- the body step (config #5's dense half) --------------------------------------------


class _BodyObjective(torch.nn.Module):
    """``HybridLMTrainer._loss`` over a body's structure, as a module that
    ``functional_call`` runs on the rank's shards."""

    def __init__(self, body, loss_chunk: int) -> None:
        super().__init__()
        self.body, self.loss_chunk = body, loss_chunk

    def forward(self, emb, tok):
        from parameter_server_tpu_torch.models import transformer as tfm

        cfg = self.body.cfg
        if self.loss_chunk > 0:
            return tfm.chunked_causal_lm_loss(self.body.trunk(emb), self.body.lm_head.kernel,
                                              tok, self.loss_chunk, cfg)
        return tfm.causal_lm_loss(self.body(emb), tok, cfg)


def make_body_step(cfg, mesh, batch: int, seq: int, *, learning_rate: float = 1e-3,
                   loss_chunk: int = 0, fsdp: str = "none", seed: int = 0):
    """One hybrid-body train step on this rank (the JAX ``compile_body_step``):
    loss and gradients with respect to the parameters and the input
    embeddings, AdamW, the batch split over ``data``, the parameters placed
    by ``parallel/tp.py``'s rules over ``model`` and computed with as its
    Megatron splits on the rank's shards, as ``HybridLMTrainer`` on a mesh
    does.  ``fsdp``: ``"none"``; ``"full"``
    (parameters and moments split over ``data`` too); ``"state"`` (the
    moments alone, as ``SpTpLMTrainer`` splits them over ``sp``).

    Returns ``(step, (emb, tokens), state, n_body_params)``: ``step(emb,
    tokens)`` gives the loss (on the device) and the embeddings' gradient;
    ``state`` holds the parameters and the optimizer."""
    from torch.func import functional_call

    from parameter_server_tpu_torch.learner.lm import adamw
    from parameter_server_tpu_torch.models import transformer as tfm
    from parameter_server_tpu_torch.parallel import mesh as mesh_lib
    from parameter_server_tpu_torch.parallel import tp

    if fsdp not in ("none", "full", "state"):
        raise ValueError(f"fsdp must be none|full|state, got {fsdp!r}")
    dev = mesh.device
    n_data = mesh.shape[mesh_lib.DATA_AXIS]
    if batch % n_data:
        raise ValueError(f"batch {batch} % data {n_data} != 0")
    body = tfm.TransformerBody(tp.split_config(cfg, mesh), device=dev,
                               generator=tfm.make_generator(dev, seed))
    n_params = sum(int(p.numel()) for p in body.parameters())
    shardings = tp.transformer_param_shardings(body, mesh, fsdp=fsdp == "full")
    params = tp.place_params(body, mesh, shardings)
    tfm.release_to_meta(body)
    if fsdp == "state":
        state_sh = tp.transformer_param_shardings(params, mesh, fsdp=True)
        slices = {n: torch.nn.Parameter(p.detach().redistribute(
            mesh.device_mesh, state_sh[n].placements)) for n, p in params.items()}
    else:
        slices = params
    optimizer = adamw(slices.values(), learning_rate)
    objective = _BodyObjective(body, loss_chunk)
    rows = batch // n_data
    emb = torch.zeros((rows, seq, cfg.d_model), dtype=torch.float32, device=dev)
    tokens = torch.zeros((rows, seq), dtype=torch.long, device=dev)

    def step(emb, tokens):
        emb = emb.detach().requires_grad_(True)
        # each rank's share of the global mean, on its model shards; the
        # gradients sum over data
        local = {f"body.{n}": t for n, t in tp.materialize(params, mesh).items()}
        loss = functional_call(objective, local, (emb, tokens)) / n_data
        optimizer.zero_grad(set_to_none=True)
        for p in params.values():
            p.grad = None
        loss.backward()
        if fsdp == "state":
            for n, p in params.items():
                slices[n].grad = p.grad.redistribute(mesh.device_mesh,
                                                     state_sh[n].placements)
            optimizer.step()
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(slices[n].redistribute(mesh.device_mesh, shardings[n].placements))
        else:
            optimizer.step()
        return loss.detach(), emb.grad

    state = {"params": params, "slices": slices, "optimizer": optimizer}
    return step, (emb, tokens), state, n_params


def body_train_step_memory(cfg, mesh: Sequence[int], batch: int, seq: int, *,
                           learning_rate: float = 1e-3, loss_chunk: int = 0,
                           fsdp: str = "none", method: str = "fake_trace",
                           budget_bytes: Optional[int] = None) -> dict:
    """One rank's memory for the hybrid body step (:func:`make_body_step`) on
    a ``(data, model)`` mesh of shape ``mesh``.  ``method="fake_trace"``:
    rank 0 of a fake world; ``"measured"``: a real step on the card,
    ``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats`` —
    a world of one for ``(1, 1)``, else rank 0 of a fake world on real
    card tensors (its collectives move nothing, so the values are
    meaningless, but every tensor a rank of that mesh makes is made)."""
    import numpy as np

    from parameter_server_tpu_torch.parallel import mesh as mesh_lib

    shape = tuple(int(x) for x in mesh)
    out = {"mesh": dict(zip((mesh_lib.DATA_AXIS, mesh_lib.MODEL_AXIS), shape)),
           "batch": batch, "seq": seq, "n_layers": cfg.n_layers, "remat": bool(cfg.remat),
           "scan_blocks": bool(cfg.scan_blocks), "loss_chunk": loss_chunk, "fsdp": fsdp}
    if method == "fake_trace":
        with fake_world(int(np.prod(shape))):
            m = mesh_lib.make_mesh(shape, device="cpu")
            with fake_tensors():
                step, inputs, state, n = make_body_step(cfg, m, batch, seq,
                                                        learning_rate=learning_rate,
                                                        loss_chunk=loss_chunk, fsdp=fsdp)
                out.update(traced_step(state, step, *inputs))
    elif method == "measured":
        out.update(_measured_body(cfg, shape, batch, seq, learning_rate, loss_chunk, fsdp))
        n = out.pop("n_body_params")
    else:
        raise ValueError(f"method must be fake_trace|measured, got {method!r}")
    out["n_body_params"] = n
    return _verdict(out, budget_bytes)


def _measured_body(cfg, shape, batch, seq, learning_rate, loss_chunk, fsdp) -> dict:
    import numpy as np

    from parameter_server_tpu_torch.parallel import mesh as mesh_lib

    if not torch.cuda.is_available():
        raise ValueError("method='measured' runs on the card: no CUDA device is visible")
    if shape == (1, 1):
        return _measured_rank(cfg, mesh_lib.make_mesh((1, 1), device="cuda"), batch, seq,
                              learning_rate, loss_chunk, fsdp)
    with fake_world(int(np.prod(shape))):
        m = mesh_lib.make_mesh(shape, device="cuda")
        return _measured_rank(cfg, m, batch, seq, learning_rate, loss_chunk, fsdp)


def _measured_rank(cfg, m, batch, seq, learning_rate, loss_chunk, fsdp) -> dict:
    step, inputs, state, n = make_body_step(cfg, m, batch, seq, learning_rate=learning_rate,
                                            loss_chunk=loss_chunk, fsdp=fsdp)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(*inputs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return {"resident_bytes": resident, "step_bytes": peak - resident, "peak_bytes": peak,
            "state_bytes": torch.cuda.memory_allocated() - sum(
                t.numel() * t.element_size() for t in inputs),
            "method": "measured", "n_body_params": n}


def _llama_cfg(remat: bool, scan_blocks: bool, dtype: Optional[str], n_layers: int):
    import dataclasses

    from parameter_server_tpu_torch.models import transformer as tfm

    kw = dict(remat=remat, scan_blocks=scan_blocks)
    if dtype:
        kw["dtype"] = getattr(torch, dtype)
    return dataclasses.replace(tfm.llama3_8b(**kw), n_layers=n_layers)


def llama3_8b_feasibility(*, mesh_shape: Sequence[int] = (2, 8), batch: int = 8,
                          seq: int = 2048, remat: bool = True, loss_chunk: int = 512,
                          fsdp: str = "state", scan_blocks: bool = True,
                          dtype: Optional[str] = None, n_layers: int = 32,
                          method: str = "fake_trace",
                          budget_bytes: Optional[int] = None) -> dict:
    """Config #5's 8B body on a ``(data, model)`` mesh, with the fitting
    recipe's knobs (scan over blocks with remat, the chunked fused-head
    loss, moments split over ``data``)."""
    cfg = _llama_cfg(remat, scan_blocks, dtype, n_layers)
    return body_train_step_memory(cfg, tuple(mesh_shape), batch, seq, loss_chunk=loss_chunk,
                                  fsdp=fsdp, method=method, budget_bytes=budget_bytes)


def dlrm_feasibility(*, rows_log2: int = 30, dim: int = 16,
                     mesh_shape: Sequence[int] = (1, 16), batch: int = 8192,
                     n_sparse: int = 26, n_dense: int = 13, slots_log2: int = 18,
                     optimizer: str = "adagrad", learning_rate: float = 0.01,
                     seed: int = 0, budget_bytes: Optional[int] = None) -> dict:
    """Config #3's billion-row DLRM, one rank: the real ``SpmdDLRMTrainer``
    (its table and optimizer planes row-split over ``model``) made and
    stepped on fake tensors, on a batch of real keys (drawn from
    ``2^slots_log2`` of the rows) localized on the host into that many
    bucketed slots.  No plane is ever allocated:
    ``real_bytes_max`` is the largest real (not fake) storage any operator
    made."""
    import numpy as np

    from parameter_server_tpu_torch.config import OptimizerConfig, TableConfig
    from parameter_server_tpu_torch.models.dlrm import SpmdDLRMTrainer
    from parameter_server_tpu_torch.parallel import mesh as mesh_lib
    from parameter_server_tpu_torch.utils.keys import localize_to_slots

    shape = tuple(int(x) for x in mesh_shape)
    rows = 1 << rows_log2
    cfg = TableConfig(name="emb", rows=rows, dim=dim,
                      optimizer=OptimizerConfig(kind=optimizer, learning_rate=learning_rate))
    rng = np.random.default_rng(seed)
    # keys from 2^slots_log2 of the rows: the localized slots fit that bucket
    pool = rng.integers(0, rows, size=1 << slots_log2, dtype=np.int64)
    keys = pool[rng.integers(0, pool.shape[0], size=(batch, n_sparse))].astype(np.uint64)
    dense = rng.normal(size=(batch, n_dense)).astype(np.float32)
    labels = (rng.random(batch) < 0.5).astype(np.float32)
    record: dict = {}
    with fake_world(int(np.prod(shape))):
        m = mesh_lib.make_mesh(shape, device="cpu")
        with fake_tensors() as mode:
            tr, _ = peak_live_bytes(lambda: SpmdDLRMTrainer(
                cfg, m, device="cpu", n_dense=n_dense, n_sparse=n_sparse,
                learning_rate=learning_rate, min_bucket=1 << slots_log2, seed=seed,
                table_init="zeros"), record=record)
            slots, inverse, n_unique = localize_to_slots(keys, tr.localizer,
                                                         min_bucket=1 << slots_log2)
            out = traced_step(tr, tr.step_localized, slots, inverse, dense, labels,
                              record=record)
            n_model = m.shape[mesh_lib.MODEL_AXIS]
            planes = 1 + len(tr.emb_state)
            out.update(table_fake=bool(mode.is_our_fake(tr.emb_value)),
                       table_bytes_per_device=planes * tr.total_rows * dim * 4 // n_model)
    out.update(rows_log2=rows_log2, dim=dim, mesh=dict(zip(("data", "model"), shape)),
               batch=batch, n_sparse=n_sparse, slots_log2=slots_log2,
               slots=int(slots.shape[0]), unique_slots=int(n_unique), optimizer=optimizer,
               real_bytes_max=int(record.get("real_bytes_max", 0)))
    return _verdict(out, budget_bytes)


def sp_8b_feasibility(*, mesh_shape: Sequence[int] = (2, 8), batch: int = 1,
                      seq: int = 16384, remat: bool = True, loss_chunk: int = 512,
                      fsdp: str = "state", scan_blocks: bool = True,
                      dtype: Optional[str] = None, n_layers: int = 32,
                      budget_bytes: Optional[int] = None) -> dict:
    """The long-context 8B: ``SpTpLMTrainer``'s real step (the ring over
    ``sp``, the TP placements over ``model``, moments over ``sp``, the
    chunked loss) on an ``(sp, model)`` fake world."""
    import numpy as np

    from parameter_server_tpu_torch.parallel import mesh as mesh_lib
    from parameter_server_tpu_torch.parallel.sp_fsdp import MODEL_AXIS, SP_AXIS, SpTpLMTrainer

    if fsdp not in ("none", "state"):
        raise ValueError(f"fsdp must be none|state, got {fsdp!r}")
    cfg = _llama_cfg(remat, scan_blocks, dtype, n_layers)
    shape = tuple(int(x) for x in mesh_shape)
    tokens = np.zeros((batch, seq), np.int64)
    with fake_world(int(np.prod(shape))):
        m = mesh_lib.make_mesh(shape, (SP_AXIS, MODEL_AXIS), device="cpu")
        with fake_tensors():
            tr = SpTpLMTrainer(cfg, m, fsdp=fsdp, loss_chunk=loss_chunk, device="cpu")
            out = traced_step(tr, tr._update, tokens)
            n_params = sum(int(np.prod(p.shape)) for p in tr.params.values())
    out.update(n_body_params=n_params, mesh={SP_AXIS: shape[0], MODEL_AXIS: shape[1]},
               batch=batch, seq=seq, n_layers=n_layers, remat=remat,
               scan_blocks=scan_blocks, loss_chunk=loss_chunk, fsdp=fsdp, attn="ring_spmd")
    return _verdict(out, budget_bytes)


def _pp_rank_trace(cfg, shape, axes, rank, n_micro, micro_batch, seq, tp):
    """One pipeline rank's traced step on a fake world: (trace, the rank's
    stage bytes)."""
    import numpy as np

    from parameter_server_tpu_torch.parallel import mesh as mesh_lib
    from parameter_server_tpu_torch.parallel.pp import PipelinedLMTrainer

    with fake_world(int(np.prod(shape)), rank):
        m = mesh_lib.make_mesh(shape, axes, device="cpu")
        with fake_tensors():
            tr = PipelinedLMTrainer(cfg, m, n_micro=n_micro, tp=tp, device="cpu")
            micro = tr._micro(np.zeros((n_micro * micro_batch, seq), np.int64))
            out = traced_step(tr, tr.pp.step, micro)
            out["stage"] = m.index("pp")
            out["stack_bytes"] = held_bytes(tr.stage_params)
            n_stack = (sum(int(np.prod(p.shape)) for p in tr.stage_params.values())
                       * m.shape["pp"])
    return out, n_stack


def _pp_peak(cfg, shape, axes, n_micro, micro_batch, seq, tp):
    """Stage 0 (the most stashed inputs) and the last stage (the head and
    the loss): the larger peak is the configuration's."""
    import numpy as np

    n = int(np.prod(shape))
    first, n_stack = _pp_rank_trace(cfg, shape, axes, 0, n_micro, micro_batch, seq, tp)
    last, _ = _pp_rank_trace(cfg, shape, axes, n - 1, n_micro, micro_batch, seq, tp)
    worst = max((first, last), key=lambda r: r["peak_bytes"])
    out = {k: worst[k] for k in ("resident_bytes", "step_bytes", "peak_bytes",
                                 "state_bytes", "method", "stack_bytes")}
    out["stages_traced"] = {str(r["stage"]): r["peak_bytes"] for r in (first, last)}
    return out, n_stack


def pp_vs_dp_feasibility(*, n_stages: int = 4, n_micro: int = 8, micro_batch: int = 1,
                         seq: int = 1024, vocab: int = 32_768, n_layers: int = 24,
                         d_model: int = 2304, d_ff: int = 8064, n_heads: int = 18,
                         n_kv_heads: int = 6, budget_bytes: Optional[int] = None) -> dict:
    """Where PP beats DP: a ~1.8B fp32 model whose full AdamW state one rank
    of pure DP must hold (``SpmdLMTrainer`` on one device, scan + remat +
    the chunked loss), against the same model pipelined over ``n_stages``
    (``PipelinedLMTrainer``, 1/S of the stack a rank), the same tokens a
    step.  Both are fake traces of the real steps."""
    import numpy as np

    from parameter_server_tpu_torch.learner.lm import SpmdLMTrainer
    from parameter_server_tpu_torch.models import transformer as tfm
    from parameter_server_tpu_torch.parallel.pp import PP_AXIS

    cfg = tfm.TransformerConfig(vocab_size=vocab, n_layers=n_layers, n_heads=n_heads,
                                n_kv_heads=n_kv_heads, d_model=d_model, d_ff=d_ff,
                                max_seq=seq, remat=True, scan_blocks=True)
    batch = n_micro * micro_batch
    tokens = np.zeros((batch, seq), np.int64)
    with fake_tensors():
        dp = SpmdLMTrainer(cfg, None, loss_chunk=512, device="cpu")
        tok = torch.from_numpy(tokens)
        dp_out = traced_step(dp, dp._update, tok, tok, None)
        n_params = sum(int(p.numel()) for p in dp.model.parameters())
    pp_out, _ = _pp_peak(cfg, (n_stages,), (PP_AXIS,), n_micro, micro_batch, seq, False)
    budget = _budget(budget_bytes)
    dp_out.update(devices=1)
    pp_out.update(devices=n_stages, n_micro=n_micro, schedule="gpipe")
    for side in (dp_out, pp_out):
        side["fits_card"] = bool(side["peak_bytes"] <= budget)
    return {"n_params": n_params, "seq": seq, "global_batch": batch, "dp": dp_out,
            "pp": pp_out, "budget_bytes": budget, "method": "fake_trace",
            "pp_beats_dp": pp_out["fits_card"] and not dp_out["fits_card"]}


def pp_tp_feasibility(*, n_stages: int = 8, tp: int = 8, n_micro: int = 8,
                      micro_batch: int = 1, seq: int = 2048, vocab: int = 32_000,
                      n_layers: int = 48, d_model: int = 7168, d_ff: int = 19_456,
                      n_heads: int = 56, n_kv_heads: int = 8,
                      budget_bytes: Optional[int] = None) -> dict:
    """Depth x width: a ~26B fp32-AdamW LM over ``(pp, model)``, each stage's
    blocks placed over ``model`` (``PipelinedLMTrainer(tp=True)``, 1/(S x TP)
    of the stack a rank), each rank computing its stage's Megatron split
    (``parallel/tp.py``)."""
    from parameter_server_tpu_torch.models import transformer as tfm
    from parameter_server_tpu_torch.parallel.pp import PP_AXIS

    cfg = tfm.TransformerConfig(vocab_size=vocab, n_layers=n_layers, n_heads=n_heads,
                                n_kv_heads=n_kv_heads, d_model=d_model, d_ff=d_ff,
                                max_seq=seq)
    out, n_stack = _pp_peak(cfg, (n_stages, tp), (PP_AXIS, "model"), n_micro, micro_batch,
                            seq, True)
    out.update(n_params=n_stack + vocab * d_model * 2 + d_model,
               mesh={"pp": n_stages, "model": tp}, devices=n_stages * tp, n_micro=n_micro,
               micro_batch=micro_batch, seq=seq, schedule="gpipe")
    return _verdict(out, budget_bytes)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", default="llama3-8b",
                   choices=["llama3-8b", "llama3-8b-sp", "dlrm-1b", "pp-vs-dp", "pp-tp-26b"])
    p.add_argument("--mesh", default=None,
                   help="data,model mesh shape (product = ranks); default 2,8 "
                   "(llama3-8b) / 1,16 (dlrm-1b)")
    p.add_argument("--batch", type=int, default=None,
                   help="default 8 (llama3-8b) / 8192 (dlrm-1b)")
    # dlrm-1b knobs
    p.add_argument("--rows-log2", type=int, default=30)
    p.add_argument("--dim", type=int, default=16)
    p.add_argument("--slots-log2", type=int, default=18,
                   help="bucketed unique-slot count the step runs at")
    p.add_argument("--optimizer", default="adagrad")
    p.add_argument("--seq", type=int, default=None,
                   help="default 2048 (llama presets) / 1024 (pp-vs-dp)")
    p.add_argument("--layers", type=int, default=32, help="llama presets' depth")
    p.add_argument("--remat", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--loss-chunk", type=int, default=512,
                   help="0 = full logits; >0 = fused-head chunked loss")
    p.add_argument("--fsdp", default="state", choices=["none", "full", "state"],
                   help="data-axis split of the train state: none, full (params + "
                   "moments), state (moments only)")
    p.add_argument("--scan-blocks", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--dtype", default=None, help="e.g. bfloat16")
    p.add_argument("--method", default="fake_trace", choices=["fake_trace", "measured"],
                   help="llama3-8b: measured runs a real step on the card (rank 0 of a "
                   "fake world of --mesh on real card tensors; a world of one at 1,1)")
    p.add_argument("--budget-gb", type=float, default=None,
                   help="the memory to judge against (default: the card's)")
    args = p.parse_args(argv)
    budget = None if args.budget_gb is None else int(args.budget_gb * 1e9)
    if args.preset in ("pp-tp-26b", "pp-vs-dp"):
        # these presets take only --seq: echoing other knobs
        # back would label numbers with a configuration never traced
        ignored = {"--mesh": args.mesh, "--batch": args.batch, "--dtype": args.dtype}
        bad = [k for k, v in ignored.items() if v is not None]
        if bad:
            p.error(f"--preset {args.preset} supports only --seq; got {bad} (edit the "
                    "feasibility function's keywords for other shapes)")
    if args.method == "measured" and args.preset != "llama3-8b":
        p.error("--method measured runs the llama3-8b body step only")
    from parameter_server_tpu_torch.ops import scatter

    scatter.reset_launch_counts()
    mesh = lambda default: tuple(int(x) for x in (args.mesh or default).split(","))  # noqa: E731
    if args.preset == "pp-tp-26b":
        result = pp_tp_feasibility(seq=args.seq or 2048, budget_bytes=budget)
    elif args.preset == "pp-vs-dp":
        result = pp_vs_dp_feasibility(seq=args.seq or 1024, budget_bytes=budget)
    elif args.preset == "llama3-8b-sp":
        result = sp_8b_feasibility(
            mesh_shape=mesh("2,8"), batch=args.batch or 1, seq=args.seq or 2048,
            remat=args.remat, loss_chunk=args.loss_chunk, fsdp=args.fsdp,
            scan_blocks=args.scan_blocks, dtype=args.dtype, n_layers=args.layers,
            budget_bytes=budget)
    elif args.preset == "dlrm-1b":
        result = dlrm_feasibility(
            rows_log2=args.rows_log2, dim=args.dim, mesh_shape=mesh("1,16"),
            batch=args.batch or 8192, slots_log2=args.slots_log2,
            optimizer=args.optimizer, budget_bytes=budget)
    else:
        result = llama3_8b_feasibility(
            mesh_shape=mesh("2,8"), batch=args.batch or 8, seq=args.seq or 2048,
            remat=args.remat, loss_chunk=args.loss_chunk, fsdp=args.fsdp,
            scan_blocks=args.scan_blocks, dtype=args.dtype, n_layers=args.layers,
            method=args.method, budget_bytes=budget)
    result["preset"] = args.preset
    # the scatter kernels this process launched (the fake trace takes their
    # plain versions; a measured step launches on the card)
    result["launches"] = scatter.launch_counts()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
