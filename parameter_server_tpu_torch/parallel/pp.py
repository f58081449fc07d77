"""Pipeline parallelism: the transformer's block stack split into stages.

Torch counterpart of ``parameter_server_tpu/parallel/pp.py``.  The layer
stack splits into ``S`` contiguous stages of ``n_layers / S`` blocks; a stage
is a rank of the mesh's ``pp`` axis (a torch mesh is one process a rank).
Microbatch activations go forward to the next stage and their gradients come
back with ``torch.distributed.batch_isend_irecv`` on the ``pp`` group, the
way ``ops/ring_attention.py`` rotates K/V.

Two schedules compute the same loss and gradients, the mean over the
microbatches of ``causal_lm_loss``:

- ``"gpipe"`` (:func:`pipeline_apply`): every microbatch forward, then every
  microbatch backward in reverse, the backward by autograd.  Each stage call
  is under ``torch.utils.checkpoint`` (the JAX ``jax.checkpoint`` per tick),
  so a microbatch keeps its stage input and output and recomputes the rest:
  a stage's memory grows O(M).
- ``"1f1b"`` (:func:`pipeline_1f1b`): warm-up, steady one-forward-one-
  backward, cool-down.  The forward runs without a graph and stashes the
  stage input; the backward recomputes the stage from it (the JAX manual
  backward), so a stage holds at most ``S - s`` inputs whatever ``M`` is.
  The last stage runs each microbatch's forward and backward back to back,
  so it stashes nothing and does not recompute.

The JAX module's psum injection and owner shipping exist because
``shard_map`` is SPMD; here each stage runs its own op list, so stage 0
embeds its microbatch itself and the last stage keeps the loss.  A stage's
op list and what each op sends and receives are plain data
(:func:`stage_ops`, :func:`p2p_plan`): an op receives what it needs in one
batch with what the previous op sends, and the send / receive order matches
on both sides of every boundary (a gloo world would hang otherwise).

One op on one stage is a function of tensors (:class:`StageWork`), apart
from the hop: :class:`VirtualPipeline` runs ``S`` stages in one process over
a mailbox with the same code, which is how ``S > 1`` runs on one card.

Parameters.  A rank holds its stage's blocks (``Block_{j}``, the flax
``Stage`` module's names), the embedding, the head and the final norm.  The
last three are replicated on every stage, as in JAX: their gradients are
summed over ``pp`` (only stage 0 and the last stage have non-zero ones), so
every rank takes the same AdamW update.  ``optax.adamw``'s rule runs as
``learner/lm.py::adamw``.

Meshes.  ``("pp",)``; ``("data", "pp")`` splits each microbatch's rows over
``data`` and averages the loss and the gradients there; ``("pp", "model")``
with ``tp=True`` places each stage's blocks over ``model`` by
``parallel/tp.py``'s rules (DTensors) and computes them as Megatron splits:
each rank runs its stage on its own heads and slice of ``d_ff``
(``models/transformer.py``), and the gradients land on its shards.  The
embedding, the head and the final norm stay replicated, as in JAX.  An axis
of another name holds replicas that compute the whole step each.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from parameter_server_tpu_torch.learner.lm import adamw
from parameter_server_tpu_torch.models import transformer as tfm
from parameter_server_tpu_torch.parallel import mesh as mesh_lib
from parameter_server_tpu_torch.parallel import tp as tp_lib
from parameter_server_tpu_torch.utils import metrics as metrics_lib

PP_AXIS = "pp"
SCHEDULES = ("gpipe", "1f1b")

Op = Tuple[str, int]  # ("F" | "B", microbatch)


# -- the schedules as data ----------------------------------------------------------


def stage_ops(schedule: str, n_stages: int, n_micro: int, stage: int) -> List[Op]:
    """Stage ``stage``'s ops in order: ``("F", m)`` a forward of microbatch
    ``m``, ``("B", m)`` its backward; ``schedule="forward"`` is the loss
    alone (forwards only)."""
    fwd = [("F", m) for m in range(n_micro)]
    if schedule == "forward":
        return fwd
    if schedule == "gpipe":
        return fwd + [("B", m) for m in reversed(range(n_micro))]
    if schedule != "1f1b":
        raise ValueError(f"schedule must be gpipe|1f1b, got {schedule!r}")
    warm = min(n_stages - stage - 1, n_micro)
    ops = fwd[:warm]
    for i in range(n_micro - warm):
        ops += [("F", warm + i), ("B", i)]
    return ops + [("B", m) for m in range(n_micro - warm, n_micro)]


def p2p_plan(ops: Sequence[Op], n_stages: int, stage: int):
    """For each op: (the peer and kind it receives from before it runs, the
    peer and kind it sends to after), ``None`` where it has none.  Kinds:
    ``"act"`` forward, ``"grad"`` backward."""
    last = n_stages - 1
    plan = []
    for kind, m in ops:
        if kind == "F":
            recv = (stage - 1, "act", m) if stage > 0 else None
            # the last stage's forward ends in the loss; "forward" sends on too
            send = (stage + 1, "act", m) if stage < last else None
        else:
            recv = (stage + 1, "grad", m) if stage < last else None
            send = (stage - 1, "grad", m) if stage > 0 else None
        plan.append((recv, send))
    return plan


# -- one stage's work ------------------------------------------------------------------


class Stage(torch.nn.Module):
    """``per_stage`` blocks under the flax ``Stage`` module's names
    (``Block_0`` ...), positions ``0..seq-1`` (rotary only)."""

    def __init__(self, cfg: tfm.TransformerConfig, per_stage: int, *, device="cuda",
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        # the schedules rematerialise a whole stage (pp.py:75): a block's own
        # checkpoint would recompute it twice, and the flax Stage has none
        cfg = dataclasses.replace(cfg, remat=False)
        self.cfg, self.per_stage = cfg, per_stage
        for j in range(per_stage):
            self.add_module(f"Block_{j}", tfm.Block(cfg, device=device, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        positions = torch.arange(x.shape[1], device=x.device)[None, :].expand(x.shape[0], -1)
        for j in range(self.per_stage):
            x = getattr(self, f"Block_{j}")(x, positions)
        return x


def stage_apply(stage: Stage, params: Optional[Dict[str, torch.Tensor]], x):
    """The stage on ``x`` with ``params`` (dotted name -> tensor) in place of
    its own, or its own with ``params=None``."""
    if params is None:
        return stage(x)
    from torch.func import functional_call

    return functional_call(stage, params, (x,))


def tail_loss(cfg: tfm.TransformerConfig, norm: torch.nn.Module, head: torch.Tensor,
              y: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """One microbatch's final norm, head and causal loss (``pp.py:613-619``)."""
    logits = torch.einsum("bsd,dv->bsv", norm(y), head.to(cfg.dtype)).to(torch.float32)
    return tfm.causal_lm_loss(logits, tokens)


class StageWork:
    """One stage's ops for one step, each a function of tensors: the
    forward and backward of a microbatch, the stash between them, the loss
    (last stage) and the gradients (accumulated into the tensors' ``.grad``).

    ``inject(m)``: microbatch ``m``'s stage-0 input (the embedding lookup,
    tracked by autograd when training); ``tail(y, m)``: the last stage's loss
    of ``y``; ``scale``: what each microbatch's loss is multiplied by (``1 /
    (M x data replicas)``: the gradients are those of the mean)."""

    def __init__(self, stage: Stage, params, *, first: bool, last: bool, mode: str,
                 inject: Callable, tail: Callable, scale: float) -> None:
        if mode not in SCHEDULES + ("forward",):
            raise ValueError(f"mode must be gpipe|1f1b|forward, got {mode!r}")
        self.stage, self.params = stage, params
        self.first, self.last, self.mode = first, last, mode
        self.inject, self.tail, self.scale = inject, tail, scale
        self.keep: dict = {}
        self.loss_sum = 0.0
        #: most microbatches held at once (stash or saved graph)
        self.max_held = 0

    def _apply(self, x):
        return stage_apply(self.stage, self.params, x)

    def _hold(self, m, value) -> None:
        self.keep[m] = value
        self.max_held = max(self.max_held, len(self.keep))

    def _add_loss(self, loss: torch.Tensor) -> None:
        self.loss_sum = self.loss_sum + loss.detach()

    def forward(self, m: int, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """Op ``("F", m)``: ``x`` is what the previous stage sent (None on
        stage 0); returns what goes to the next stage (None on the last)."""
        if self.mode == "forward":
            with torch.no_grad():
                y = self._apply(self.inject(m) if self.first else x)
                if self.last:
                    self._add_loss(self.tail(y, m) * self.scale)
                    return None
                return y
        if self.mode == "1f1b":
            if self.last:  # forward and backward run back to back in B(m)
                self._hold(m, x)
                return None
            with torch.no_grad():
                y = self._apply(self.inject(m) if self.first else x)
            self._hold(m, x)  # stage 0 re-embeds from the tokens instead
            return y
        # gpipe: autograd keeps the stage input and output; checkpoint
        # recomputes the inside in the backward
        xin = self.inject(m) if self.first else x.requires_grad_(True)
        y = checkpoint(self._apply, xin, use_reentrant=False)
        if not self.last:
            self._hold(m, (xin, y, None))
            return y.detach()
        yd = y.detach().requires_grad_(True)
        loss = self.tail(yd, m) * self.scale
        loss.backward()
        self._add_loss(loss)
        self._hold(m, (xin, y, yd.grad))
        return None

    def backward(self, m: int, dy: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """Op ``("B", m)``: ``dy`` is the next stage's gradient (None on the
        last); returns the gradient for the previous stage (None on stage
        0, whose gradient went into the embedding)."""
        if self.mode == "gpipe":
            xin, y, dy_last = self.keep.pop(m)
            torch.autograd.backward(y, dy_last if self.last else dy)
            return None if self.first else xin.grad
        x = self.keep.pop(m)
        with torch.enable_grad():
            xin = self.inject(m) if self.first else x.detach().requires_grad_(True)
            y = self._apply(xin)
            if self.last:
                loss = self.tail(y, m) * self.scale
                loss.backward()
                self._add_loss(loss)
            else:
                torch.autograd.backward(y, dy)
        return None if self.first else xin.grad


# -- the two transports ------------------------------------------------------------------


def _exchange(sends, recvs, group, shape, dtype, device) -> List[torch.Tensor]:
    """One batch of point-to-point ops on ``group``: every ``(group rank,
    tensor)`` of ``sends`` out, one buffer from every group rank of
    ``recvs`` in."""
    ops, bufs = [], []
    for peer, t in sends:
        ops.append(dist.P2POp(dist.isend, t.contiguous(), dist.get_global_rank(group, peer),
                              group))
    for peer in recvs:
        buf = torch.empty(shape, dtype=dtype, device=device)
        bufs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, peer), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return bufs


def run_ranked(work: StageWork, ops: Sequence[Op], *, n_stages: int, stage: int, group,
               act_shape, dtype, device) -> None:
    """Run this rank's ``ops`` with the hops over the ``pp`` ``group``: before
    each op one batch holds the previous op's send and this op's receive."""
    plan = p2p_plan(ops, n_stages, stage)
    pending: list = []
    for (kind, m), (recv, send) in zip(ops, plan):
        got = _exchange(pending, [recv[0]] if recv else [], group, act_shape, dtype, device)
        inp = got[0] if got else None
        out = work.forward(m, inp) if kind == "F" else work.backward(m, inp)
        pending = [(send[0], out)] if send is not None else []
    _exchange(pending, [], group, act_shape, dtype, device)


def run_virtual(works: Sequence[StageWork], orders: Sequence[Sequence[Op]]) -> None:
    """Run ``S`` stages in this process: a mailbox stands in for the hops.
    Sweeps the stages in order, each running its next op once its input is
    there, so stages hold what they would hold in a pipeline of ranks."""
    n = len(works)
    plans = [p2p_plan(orders[s], n, s) for s in range(n)]
    pos = [0] * n
    box: dict = {}
    while any(pos[s] < len(orders[s]) for s in range(n)):
        moved = False
        for s in range(n):
            if pos[s] == len(orders[s]):
                continue
            (kind, m), (recv, send) = orders[s][pos[s]], plans[s][pos[s]]
            key = (s, recv[1], m) if recv else None
            if key is not None and key not in box:
                continue
            inp = box.pop(key) if key is not None else None
            out = works[s].forward(m, inp) if kind == "F" else works[s].backward(m, inp)
            if send is not None:
                box[(send[0], send[1], m)] = out
            pos[s] += 1
            moved = True
        if not moved:
            raise RuntimeError("virtual pipeline cannot progress: the op lists disagree")


# -- the reference's functional names ------------------------------------------------------


def _ranked(mode, stage, params, inject, tail, n_micro, mesh, act_shape, dtype,
            scale) -> StageWork:
    n, idx = mesh.shape[PP_AXIS], mesh.index(PP_AXIS)
    work = StageWork(stage, params, first=idx == 0, last=idx == n - 1, mode=mode,
                     inject=inject, tail=tail, scale=scale)
    run_ranked(work, stage_ops(mode, n, n_micro, idx), n_stages=n, stage=idx,
               group=mesh.group(PP_AXIS) if n > 1 else None, act_shape=act_shape,
               dtype=dtype, device=mesh.device)
    return work


def pipeline_apply(stage: Stage, params, inject: Callable, tail: Callable, n_micro: int, *,
                   mesh, act_shape, dtype=torch.float32, scale: float = 1.0,
                   train: bool = True) -> StageWork:
    """GPipe over the mesh's ``pp`` line: this rank's ``stage`` (with
    ``params`` in place of its own, or its own with None), ``inject(m)``
    stage 0's input of microbatch ``m``, ``tail(y, m)`` the last stage's
    loss.  ``train=False`` runs the forwards alone.  Returns the rank's
    :class:`StageWork` (``loss_sum`` on the last stage; gradients in the
    tensors' ``.grad``)."""
    return _ranked("gpipe" if train else "forward", stage, params, inject, tail, n_micro,
                   mesh, act_shape, dtype, scale)


def pipeline_1f1b(stage: Stage, params, inject: Callable, tail: Callable, n_micro: int, *,
                  mesh, act_shape, dtype=torch.float32, scale: float = 1.0) -> StageWork:
    """1F1B over the mesh's ``pp`` line, the backward recomputed from each
    stashed stage input; as :func:`pipeline_apply` otherwise."""
    return _ranked("1f1b", stage, params, inject, tail, n_micro, mesh, act_shape, dtype,
                   scale)


def stack_stage_params(per_stage: Sequence[Dict[str, object]]) -> Dict[str, object]:
    """Stack per-stage ``{dotted name: array}`` dicts on a new leading stage
    axis (numpy arrays or tensors)."""
    out = {}
    for name in per_stage[0]:
        leaves = [p[name] for p in per_stage]
        if isinstance(leaves[0], torch.Tensor):
            out[name] = torch.stack([t.detach() for t in leaves])
        else:
            out[name] = np.stack([np.asarray(a) for a in leaves])
    return out


def stage_sharding(mesh, tree: Dict[str, object], *,
                   tp: bool = False) -> Dict[str, mesh_lib.Sharding]:
    """Shardings of stage-stacked parameters (``{dotted name: array}`` with a
    leading ``[S]`` axis): that axis over ``pp``; ``tp=True`` places the tail
    dims by ``parallel/tp.py``'s rules over ``model`` (each rank holds 1/(S x
    TP) of the stack)."""
    from parameter_server_tpu_torch.parallel.tp import _spec_for, _TailView

    out = {}
    for name, leaf in tree.items():
        ndim = len(leaf.shape)
        tail = _spec_for(tuple(name.split(".")), _TailView(leaf)) if tp else ()
        tail = tuple(tail) + (None,) * (ndim - 1 - len(tail))
        out[name] = mesh_lib.Sharding(mesh, (PP_AXIS,) + tail)
    return out


# -- the step ----------------------------------------------------------------------------


def _stage_generator(device, seed: int, stage: int) -> torch.Generator:
    """Stage ``stage``'s blocks draw from ``seed`` and ``stage`` alone: the
    same weights on every data line and replica, in a pipeline of ranks or
    a virtual one."""
    return tfm.make_generator(device, seed * 1_000_003 + 1 + stage)


def _init_tail(cfg: tfm.TransformerConfig, device, seed: int):
    """The embedding and the head ``normal(0.02)`` (from ``seed`` alone, so
    every rank holds the same copy) and the final norm."""
    shared = tfm.make_generator(device, seed)
    embed = torch.nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model, device=device))
    head = torch.nn.Parameter(torch.empty(cfg.d_model, cfg.vocab_size, device=device))
    with torch.no_grad():
        embed.normal_(0.0, 0.02, generator=shared)
        head.normal_(0.0, 0.02, generator=shared)
    return embed, head, tfm.Norm(cfg, device=device)


def _check_micro(n_micro: int, n_stages: int) -> None:
    if n_micro % n_stages:
        raise ValueError(f"n_micro {n_micro} % pp stages {n_stages} != 0")


def _check(cfg: tfm.TransformerConfig, n_stages: int, *, schedule: str,
           n_micro: Optional[int] = None) -> None:
    """Every guard on the configuration, before anything is made."""
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be gpipe|1f1b, got {schedule!r}")
    if cfg.n_layers % n_stages:
        raise ValueError(f"n_layers {cfg.n_layers} % pp stages {n_stages} != 0")
    if cfg.positional != "rotary":
        # learned positions are a stage-0-only parameter (and a Stage never
        # adds them): a learned-pos config would train with no position signal
        raise ValueError("make_pp_step requires cfg.positional == 'rotary'; "
                         f"got {cfg.positional!r}")
    if n_micro is not None:
        _check_micro(n_micro, n_stages)


class PPStep:
    """The pipelined train step of :func:`make_pp_step`: the stage's module
    and parameters, the replicated embedding / head / norm, AdamW, and
    :meth:`step` / :meth:`loss` over ``[M, mb, seq]`` microbatched tokens."""

    def __init__(self, cfg, mesh, *, learning_rate: float, schedule: str, tp: bool) -> None:
        self.cfg, self.mesh, self.schedule, self.tp = cfg, mesh, schedule, tp
        self.learning_rate = learning_rate
        self.device = mesh.device
        self.n_stages = mesh.shape[PP_AXIS]
        self.stage_index = mesh.index(PP_AXIS)
        self.per_stage = cfg.n_layers // self.n_stages
        self.data_axis = mesh_lib.DATA_AXIS if mesh_lib.DATA_AXIS in mesh.axis_names else None
        self.n_data = mesh.shape[self.data_axis] if self.data_axis else 1

    # -- state ------------------------------------------------------------------
    def init(self, seed: int) -> None:
        """This rank's stage (:func:`_stage_generator`), the replicated
        tail (:func:`_init_tail`), the TP placement and AdamW."""
        cfg, dev = self.cfg, self.device
        if self.tp:
            from torch._subclasses.fake_tensor import unset_fake_temporarily
            from torch.distributed.device_mesh import DeviceMesh

            # this rank's model line as a mesh of its own (from its group, not
            # a slice, which torch caches by the rank grid alone); the mesh
            # reads its ranks: real even in a fake trace
            with unset_fake_temporarily():
                line = DeviceMesh.from_group(self.mesh.group(mesh_lib.MODEL_AXIS), dev.type,
                                             mesh_dim_names=(mesh_lib.MODEL_AXIS,))
            self.model_mesh = mesh_lib.Mesh(line, dev)
        # the blocks' config: the model line is the split they compute
        self.stage = Stage(tp_lib.split_config(cfg, self.model_mesh if self.tp else None),
                           self.per_stage, device=dev,
                           generator=_stage_generator(dev, seed, self.stage_index))
        self.embed, self.head, self.norm = _init_tail(cfg, dev, seed)
        if self.tp:
            self.stage_shardings = tp_lib.transformer_param_shardings(self.stage,
                                                                      self.model_mesh)
            #: dotted name -> DTensor over this rank's ``model`` line
            self.stage_params = tp_lib.place_params(self.stage, self.model_mesh,
                                                    self.stage_shardings)
            tfm.release_to_meta(self.stage)
        else:
            self.stage_params = dict(self.stage.named_parameters())
        self.replicated = [self.embed, self.head, *self.norm.parameters()]
        self.optimizer = adamw(list(self.stage_params.values()) + self.replicated,
                               self.learning_rate)

    def _full_stage(self):
        """The stage's parameters to compute with: its own, or (TP) each
        DTensor as ``tp.materialize`` hands it over (the rank's ``model``
        shard), as a leaf that collects the step's gradient over every
        microbatch."""
        if not self.tp:
            return None
        with torch.no_grad():
            local = tp_lib.materialize(self.stage_params, self.model_mesh)
        return {n: t.detach().requires_grad_(True) for n, t in local.items()}

    def _rows(self, tokens_micro: torch.Tensor) -> torch.Tensor:
        if self.n_data == 1:
            return tokens_micro
        from parameter_server_tpu_torch.parallel import distributed

        return tokens_micro[:, distributed.local_batch_slice(
            self.mesh.index(self.data_axis), self.n_data, tokens_micro.shape[1])]

    def check_micro(self, tokens_micro) -> None:
        """The shape guards, before any collective."""
        n_micro, mb = tokens_micro.shape[:2]
        _check_micro(n_micro, self.n_stages)
        if mb % self.n_data:
            raise ValueError(f"microbatch {mb} % data {self.n_data} != 0")

    def _pass(self, mode: str, tokens_micro: torch.Tensor, full):
        tok = self._rows(tokens_micro)
        M, mb, seq = tok.shape
        cfg = self.cfg
        kw = dict(mesh=self.mesh, act_shape=(mb, seq, cfg.d_model), dtype=cfg.dtype,
                  scale=1.0 / (M * self.n_data))
        args = (self.stage, full if self.tp else None,
                lambda m: self.embed[tok[m]].to(cfg.dtype),
                lambda y, m: tail_loss(cfg, self.norm, self.head, y, tok[m]), M)
        if mode == "1f1b":
            return pipeline_1f1b(*args, **kw)
        return pipeline_apply(*args, train=mode == "gpipe", **kw)

    def _global_loss(self, work) -> torch.Tensor:
        loss = torch.as_tensor(work.loss_sum, dtype=torch.float32, device=self.device).clone()
        self.mesh.all_reduce(loss, PP_AXIS)  # only the last stage's is non-zero
        if self.data_axis:
            self.mesh.all_reduce(loss, self.data_axis)
        return loss

    # -- the step ----------------------------------------------------------------
    def step(self, tokens_micro: torch.Tensor) -> torch.Tensor:
        """One AdamW step on ``[M, mb, seq]`` tokens; returns the loss (the
        same on every rank)."""
        loss = self.loss_and_grads(tokens_micro)
        self.optimizer.step()
        return loss

    def loss_and_grads(self, tokens_micro: torch.Tensor) -> torch.Tensor:
        """The loss, and in every parameter's ``.grad`` its gradient, summed
        as AdamW takes it (over ``data``; the replicated ones over ``pp``)."""
        self.check_micro(tokens_micro)
        self.optimizer.zero_grad(set_to_none=True)
        full = self._full_stage()
        work = self._pass(self.schedule, tokens_micro, full)
        if self.tp:
            # each leaf's gradient onto its shard (a gathered k / v's
            # reduce-scattered: every rank's queries' share)
            for n, p in self.stage_params.items():
                p.grad = tp_lib.place_grad(p, full[n].grad, self.model_mesh)
        params = list(self.stage_params.values()) + self.replicated
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.data_axis:
            for p in params:
                g = p.grad.to_local() if hasattr(p.grad, "to_local") else p.grad
                self.mesh.all_reduce(g, self.data_axis)
        for p in self.replicated:  # used on stage 0 (embed) or the last stage
            self.mesh.all_reduce(p.grad, PP_AXIS)
        return self._global_loss(work)

    @torch.no_grad()
    def loss(self, tokens_micro: torch.Tensor) -> torch.Tensor:
        self.check_micro(tokens_micro)
        return self._global_loss(self._pass("forward", tokens_micro, self._full_stage()))


def make_pp_step(cfg: tfm.TransformerConfig, mesh, *, learning_rate: float = 1e-3,
                 schedule: str = "gpipe", tp: bool = False,
                 n_micro: Optional[int] = None) -> PPStep:
    """The pipelined train step, before any parameter exists: guards, then a
    :class:`PPStep` whose :meth:`PPStep.init` makes this rank's state.
    ``tp=True`` needs a ``model`` axis and places the stage over it;
    ``n_micro``, where given, must split over the stages.  Every guard
    raises ``ValueError`` before a collective runs."""
    if PP_AXIS not in mesh.axis_names:
        raise ValueError(f"mesh must carry a {PP_AXIS!r} axis, got {mesh.axis_names}")
    _check(cfg, mesh.shape[PP_AXIS], schedule=schedule, n_micro=n_micro)
    if tp and mesh_lib.MODEL_AXIS not in mesh.axis_names:
        raise ValueError(f"tp=True needs a {mesh_lib.MODEL_AXIS!r} mesh axis, "
                         f"got {mesh.axis_names}")
    return PPStep(cfg, mesh, learning_rate=learning_rate, schedule=schedule, tp=tp)


def _microbatches(tokens: np.ndarray, n_micro: int, device) -> torch.Tensor:
    """``[B, seq]`` tokens as ``[n_micro, B / n_micro, seq]`` on ``device``."""
    tokens = np.asarray(tokens)
    if tokens.shape[0] % n_micro:
        raise ValueError(f"batch {tokens.shape[0]} % n_micro {n_micro} != 0")
    micro = tokens.reshape(n_micro, tokens.shape[0] // n_micro, tokens.shape[1])
    return torch.from_numpy(micro.astype(np.int64)).to(device)


def _n_matmul_params(cfg: tfm.TransformerConfig, stage_numel: int, n_stages: int) -> int:
    """6ND's N (``pp.py:651-656``): the whole stage stack, the head and the
    final norm; the embedding gather is not matmul work."""
    norm = cfg.d_model * (1 if cfg.norm == "rms" else 2)
    return stage_numel * n_stages + cfg.d_model * cfg.vocab_size + norm


class PipelinedLMTrainer:
    """Causal-LM trainer with the block stack pipelined over ``pp``.

    One step: this rank's rows of each microbatch, the schedule over the
    ``pp`` line (stage 0 embeds, the last stage takes the final norm, the
    head and the loss), the gradients summed over ``data`` (and the
    replicated embedding / head / norm over ``pp``), AdamW.  The loss is the
    mean over the microbatches (and the data replicas) of ``causal_lm_loss``.
    MFU counts 6ND over the stage stack, the head and the norm; the bubble
    is not credited."""

    def __init__(
        self,
        cfg: tfm.TransformerConfig,
        mesh=None,
        *,
        n_micro: int = 4,
        learning_rate: float = 1e-3,
        seed: int = 0,
        schedule: str = "gpipe",
        dashboard: Optional[metrics_lib.Dashboard] = None,
        tp: bool = False,
        device: str | torch.device = "cuda",
    ) -> None:
        """``mesh``: a mesh with a ``pp`` axis; by default every rank of the
        world on ``pp`` (a process with no world forms one on ``device``)."""
        tfm.refuse_deepseek(cfg, "PipelinedLMTrainer")
        if mesh is None:
            mesh = mesh_lib.make_mesh(None, (PP_AXIS,), device=device)
        self.pp = make_pp_step(cfg, mesh, learning_rate=learning_rate, schedule=schedule,
                               tp=tp, n_micro=n_micro)
        n_stages = mesh.shape[PP_AXIS]
        self.cfg, self.mesh, self.device = cfg, mesh, mesh.device
        self.n_micro, self.n_stages, self.schedule = n_micro, n_stages, schedule
        self.pp.init(seed)
        self.dashboard = metrics_lib.trainer_dashboard(
            dashboard, mesh.size, metrics_lib.float32_math_mode("matmul"), self.device)
        stage_numel = sum(int(np.prod(p.shape)) for p in self.pp.stage_params.values())
        self.n_matmul_params = _n_matmul_params(cfg, stage_numel, n_stages)
        self.step_count = 0

    # -- the reference's attributes ------------------------------------------------
    @property
    def stage_params(self) -> Dict[str, torch.Tensor]:
        """This rank's stage (``Block_{j}.…``; DTensors under ``tp``)."""
        return self.pp.stage_params

    @property
    def embed(self) -> torch.Tensor:
        return self.pp.embed

    @property
    def head(self) -> torch.Tensor:
        return self.pp.head

    @property
    def norm(self) -> torch.nn.Module:
        return self.pp.norm

    @property
    def optimizer(self) -> torch.optim.Optimizer:
        return self.pp.optimizer

    def gather_stage_params(self) -> Dict[str, np.ndarray]:
        """Every stage's parameters stacked ``[S, ...]`` (a collective over
        ``pp``), in full, on the host."""
        out = {}
        for name, p in self.pp.stage_params.items():
            t = (p.full_tensor() if hasattr(p, "full_tensor") else p).detach().contiguous()
            if self.n_stages > 1:
                parts = [torch.empty_like(t) for _ in range(self.n_stages)]
                dist.all_gather(parts, t, group=self.mesh.group(PP_AXIS))
            else:
                parts = [t]
            out[name] = torch.stack(parts).cpu().numpy()
        return out

    def _micro(self, tokens: np.ndarray) -> torch.Tensor:
        return _microbatches(tokens, self.n_micro, self.device)

    def step(self, tokens: np.ndarray) -> float:
        """tokens [B, S] -> loss; B must split into n_micro microbatches."""
        micro = self._micro(tokens)
        loss_f = float(self.pp.step(micro))
        self.step_count += 1
        self.dashboard.flops_per_example = 6.0 * self.n_matmul_params * tokens.shape[1]
        self.dashboard.record(self.step_count, loss_f, examples=int(tokens.shape[0]))
        return loss_f

    def loss(self, tokens: np.ndarray) -> float:
        return float(self.pp.loss(self._micro(tokens)))


class VirtualPipeline:
    """``S`` stages on one device in one process: the trainer's per-op code
    (:class:`StageWork`) with a mailbox for the hops (:func:`run_virtual`).
    One copy of the embedding, head and norm; AdamW over everything."""

    def __init__(self, cfg: tfm.TransformerConfig, n_stages: int, *, n_micro: int = 4,
                 learning_rate: float = 1e-3, seed: int = 0, schedule: str = "gpipe",
                 dashboard: Optional[metrics_lib.Dashboard] = None,
                 device: str | torch.device = "cuda") -> None:
        _check(cfg, n_stages, schedule=schedule, n_micro=n_micro)
        dev = torch.device(device)
        self.cfg, self.device, self.schedule = cfg, dev, schedule
        self.n_stages, self.n_micro = n_stages, n_micro
        per = cfg.n_layers // n_stages
        self.stages = [Stage(cfg, per, device=dev, generator=_stage_generator(dev, seed, s))
                       for s in range(n_stages)]
        self.embed, self.head, self.norm = _init_tail(cfg, dev, seed)
        params = [p for st in self.stages for p in st.parameters()]
        self.optimizer = adamw(params + [self.embed, self.head, *self.norm.parameters()],
                               learning_rate)
        self.dashboard = metrics_lib.trainer_dashboard(
            dashboard, 1, metrics_lib.float32_math_mode("matmul"), dev)
        self.n_matmul_params = _n_matmul_params(
            cfg, sum(int(p.numel()) for p in self.stages[0].parameters()), n_stages)
        self.step_count = 0
        #: per stage, the most microbatches it held at once in the last pass
        self.max_held: List[int] = []

    def _pass(self, mode: str, tokens: np.ndarray):
        tok = _microbatches(tokens, self.n_micro, self.device)
        cfg, S, M = self.cfg, self.n_stages, self.n_micro
        works = [StageWork(self.stages[s], None, first=s == 0, last=s == S - 1, mode=mode,
                           inject=lambda m: self.embed[tok[m]].to(cfg.dtype),
                           tail=lambda y, m: tail_loss(cfg, self.norm, self.head, y, tok[m]),
                           scale=1.0 / M)
                 for s in range(S)]
        run_virtual(works, [stage_ops(mode, S, M, s) for s in range(S)])
        self.max_held = [w.max_held for w in works]
        return works[-1].loss_sum

    def loss_and_grads(self, tokens: np.ndarray) -> float:
        """The schedule's pass: the loss, and every gradient in ``.grad``."""
        self.optimizer.zero_grad(set_to_none=True)
        return float(self._pass(self.schedule, tokens))

    def step(self, tokens: np.ndarray) -> float:
        loss_f = self.loss_and_grads(tokens)
        self.optimizer.step()
        self.step_count += 1
        self.dashboard.flops_per_example = 6.0 * self.n_matmul_params * np.shape(tokens)[1]
        self.dashboard.record(self.step_count, loss_f, examples=int(np.shape(tokens)[0]))
        return loss_f

    @torch.no_grad()
    def loss(self, tokens: np.ndarray) -> float:
        return float(self._pass("forward", tokens))
