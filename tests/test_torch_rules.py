"""Package rules of the PyTorch port, checked on the source.

- ``parameter_server_tpu_torch/`` and ``chip_smoke.py`` import neither
  ``jax`` nor anything of the JAX package ``parameter_server_tpu``; the scan
  covers the serving plane (``kv/cache.py``, ``serve/``), the replica
  chain (``kv/replica.py``), the membership and elasticity plane
  (``core/manager.py``, ``core/fleet.py``, ``learner/*.py``) and the
  observability plane (``core/telemetry.py``, ``utils/slo.py``,
  ``scenario/``), the transformer workloads (``models/transformer.py``,
  ``learner/lm.py``, ``learner/hybrid.py``) and the factorization machine,
  DARLIN, the text data layer and the app / CLI entry points
  (``models/fm.py``, ``learner/bcd.py``, ``data/text.py``, ``app.py``,
  ``cli.py``, ...) by name.
- The server's push-ack path — ``_ack_push`` and the grouped apply
  (``_apply_push_group``, ``_push_group_rounds``, ``_push_group_combined``),
  with every method of the server they call — never reads device state
  back: no ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``, ``.to()``,
  ``synchronize()`` or numpy conversion.  The upload helpers they call fill
  pinned host buffers and copy them up without waiting on the device.  The
  replica forwarding it reaches (``_forward_push``) is wire I/O on the
  planes as received: a sync chain waits there for the standby's ack,
  never for the device.
- The consistency gate — the ``__cstep__`` branch of
  ``_validate_data_request`` and ``_wait_reply``, with every server method
  they call — and the group booking and step commit in ``_ack_push`` read
  nothing back from the card either: they are host dict and int work.
- The apply ledger's submit side (``ApplyLedger.begin`` / ``submit`` /
  ``overloaded``, ``_Inflight.mark_host`` / ``mark_h2d``) never waits on or
  polls a completion handle: no ``synchronize()``, ``query()`` or the calls
  above.
- The durability plane's freeze and rebuild paths — ``_export_rows``,
  ``_rebuild_table``, ``_commit_migration``, ``_install_migration`` and
  ``snap_commit`` (``_commit_snapshot``), with every server method they
  reach — never read a whole table plane to the host: no ``.cpu()``,
  ``.numpy()``, ``.tolist()``, ``.to()``, ``np.asarray`` / ``np.array`` or
  readback of ``tbl.value`` / ``tbl.state[...]`` (the JAX server's versions
  of these methods do, and the scan flags them).
- Every ``flightrec.record("<kind>", ...)`` in the port names a literal kind
  of the ``EVENTS`` registry, and the ledger's ``apply.*`` kinds are there.
- ``LocalLRTrainer.step_block_device`` and the dense steps of
  ``models/linear.py`` never wait on the device: no ``.item()``, ``.cpu()``,
  ``.tolist()``, ``.numpy()``, ``float(...)``, ``torch.unique``,
  ``torch.bincount`` or ``synchronize()``.
- The port's Van wrappers (``core/van.py``, ``netmon.py``, ``coalesce.py``,
  ``frame.py``, ``chaos.py``, ``resender.py``) keep the JAX package's wrapper
  contract (``tools/check_wrappers.py``): an overridden ``flush`` /
  ``close`` delegates to the inner van, ``counters()`` never merges the
  inner van's, and the frame path (codec, resender, coalescer) imports no
  pickle; ``ml_dtypes`` is as forbidden as ``jax``.
- Every entry point's ``device`` defaults to ``"cuda"``, the launcher's
  child roles' ``--device`` too, and ``app.create``'s.
- The shm ring's and the socket van's per-frame fast paths are copy-free
  (``check_wrappers.check_copy_free``).
- Every ``trace.*`` record in the hot-path functions of
  ``check_wrappers.TRACE_GATED_FUNCS`` (the worker's ``_trace_submitted``
  and ``_on_response``, the server's ``_trace_dispatch`` / reply sites, the
  ledger's ``_retire``, the socket van, the coalescer and the resender)
  sits behind the sampling gate, and none of those functions is missing
  or records no ``trace.*`` kind (``check_wrappers.check_trace_gated``).
- ``chip_smoke.py`` fails, and prints no result, where there is no card or
  no package beside it.
"""

import ast
import inspect
import json
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

from parameter_server_tpu_torch.app import create
from parameter_server_tpu_torch.config import LedgerConfig
from parameter_server_tpu_torch.dryrun import dryrun_multichip
from parameter_server_tpu_torch.core.postoffice import Postoffice
from parameter_server_tpu_torch.core.van import LoopbackVan
from parameter_server_tpu_torch.data.prefetch import PrefetchPipeline
from parameter_server_tpu_torch.kv.server import KVServer
from parameter_server_tpu_torch.kv.table import KVTable
from parameter_server_tpu_torch.kv.worker import KVWorker
from parameter_server_tpu_torch.kv.dense import DenseKVServer, DenseKVWorker
from parameter_server_tpu_torch.kv.replica import make_replicated_servers, restart_same_id
from parameter_server_tpu_torch.learner.bcd import DarlinServer, DarlinWorker
from parameter_server_tpu_torch.learner.dense import (
    AsyncDenseLearner,
    ChunkedAsyncDenseLearner,
    SpmdDenseTrainer,
)
from parameter_server_tpu_torch.learner.hybrid import HybridLMTrainer
from parameter_server_tpu_torch.learner.lm import SpmdLMTrainer
from parameter_server_tpu_torch.learner.elastic import ElasticTrainer, restart_server, scale_up
from parameter_server_tpu_torch.learner.fm import LocalFMTrainer
from parameter_server_tpu_torch.learner.sgd import AsyncLRLearner, LocalLRTrainer
from parameter_server_tpu_torch.launch import launch
from parameter_server_tpu_torch.launch_hybrid import launch_hybrid
from parameter_server_tpu_torch.launch_spmd import launch_spmd, run_job
from parameter_server_tpu_torch.models.dlrm import SpmdDLRMTrainer
from parameter_server_tpu_torch.models.transformer import (
    Transformer,
    TransformerBody,
    TransformerTrunk,
)
from parameter_server_tpu_torch.parallel import dlrm_scale
from parameter_server_tpu_torch.parallel.distributed import initialize
from parameter_server_tpu_torch.parallel.mesh import make_mesh
from parameter_server_tpu_torch.parallel.pp import PipelinedLMTrainer, VirtualPipeline
from parameter_server_tpu_torch.parallel.sp_fsdp import SpTpLMTrainer
from parameter_server_tpu_torch.parallel.sp_lm import SpLMTrainer

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "parameter_server_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    # ml_dtypes ships with jax: the card host has neither
    return top in ("jax", "jaxlib", "parameter_server_tpu", "ml_dtypes")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_the_jax_package(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


#: the serving plane's and the replica chain's modules, which the scan must
#: hold by name (a rename must not drop them from it silently)
SERVING_AND_REPLICA = ("kv/cache.py", "kv/replica.py", "kv/server.py", "kv/worker.py",
                       "config.py", "serve/__init__.py", "serve/admission.py",
                       "serve/loadgen.py")


#: the membership and elasticity plane's modules, held by name too
MEMBERSHIP_AND_ELASTIC = ("core/manager.py", "core/fleet.py", "utils/metrics.py",
                          "utils/trace.py", "learner/workload.py", "learner/elastic.py",
                          "learner/sgd.py", "learner/dense.py")


#: the observability plane's modules, held by name too
OBSERVABILITY = ("core/telemetry.py", "utils/slo.py", "utils/trace.py", "utils/metrics.py",
                 "scenario/__init__.py", "scenario/dsl.py", "scenario/runner.py",
                 "scenario/scorecard.py")


#: the transformer workloads' modules (configs #4 and #5), held by name too
TRANSFORMER_WORKLOADS = ("models/transformer.py", "models/layers.py", "convert.py",
                         "learner/lm.py", "learner/hybrid.py", "learner/dense.py")


#: the factorization machine, DARLIN, the text data layer, offline
#: evaluation and the app / CLI entry points, held by name too
FM_BCD_DATA_APP = ("utils/countmin.py", "data/text.py", "data/fs.py", "data/reader.py",
                   "data/tailfilter.py", "data/__init__.py", "models/fm.py", "learner/fm.py",
                   "learner/bcd.py", "evaluation.py", "app.py", "cli.py")


#: the mesh layer: platform forcing, the mesh and process groups, the
#: multi-host runtime, the TP rules, SPMD LR and its launcher, held by name too
MESH_LAYER = ("utils/platform.py", "parallel/mesh.py", "parallel/distributed.py",
              "parallel/tp.py", "parallel/lr_spmd.py", "launch_spmd.py")


#: config #5 across processes and sequence parallelism, held by name too
DUAL_PLANE_AND_SEQ_PARALLEL = ("launch_hybrid.py", "ops/ring_attention.py", "ops/ulysses.py",
                               "parallel/sp_lm.py", "parallel/sp_fsdp.py")
PIPELINE_FEASIBILITY_DRYRUN = ("parallel/pp.py", "parallel/feasibility.py", "dryrun.py")


def test_the_import_scan_sees_every_module():
    assert len(SOURCES) >= 25
    scanned = {str(p.relative_to(PORT)) for p in SOURCES if PORT in p.parents}
    assert set(SERVING_AND_REPLICA) <= scanned
    assert set(MEMBERSHIP_AND_ELASTIC) <= scanned
    assert set(OBSERVABILITY) <= scanned
    assert set(TRANSFORMER_WORKLOADS) <= scanned
    assert set(FM_BCD_DATA_APP) <= scanned
    assert set(MESH_LAYER) <= scanned
    assert set(DUAL_PLANE_AND_SEQ_PARALLEL) <= scanned
    assert set(PIPELINE_FEASIBILITY_DRYRUN) <= scanned
    assert {str(p.relative_to(PORT)) for p in (PORT / "learner").glob("*.py")} <= scanned
    assert _forbidden("jax.numpy") and _forbidden("parameter_server_tpu.kv.table")
    assert not _forbidden("parameter_server_tpu_torch.kv.table")


#: attribute calls that read device state back or wait for the device
SYNCING = {"item", "cpu", "tolist", "numpy", "to", "synchronize", "asarray",
           "array", "copy_", "_readback", "block_until_ready"}


def _method_bodies():
    tree = ast.parse((PORT / "kv" / "server.py").read_text())
    cls = next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == "KVServer")
    return {f.name: f for f in cls.body if isinstance(f, ast.FunctionDef)}


def _gate_branch(methods):
    """The consistency gate of ``_validate_data_request``: its statements
    that read the ``__cstep__`` stamp or the ``_consist`` state, as one
    module node ``_reached_calls`` can walk."""
    fn = methods["_validate_data_request"]
    stmts = [n for n in fn.body
             if "CONSIST_STEP_KEY" in ast.unparse(n) or "self._consist" in ast.unparse(n)]
    return ast.Module(body=stmts, type_ignores=[])


#: the push-ack path's roots: the JAX package's ``SYNC_FREE_FUNCS``
#: (``tools/check_wrappers.py``)
SYNC_FREE_ROOTS = ("_ack_push", "_apply_push_group", "_push_group_rounds",
                   "_push_group_combined")
#: host -> device staging the grouped apply calls before its launches: they
#: fill pinned host buffers (``.numpy()`` of a host tensor) and upload them
UPLOAD_HELPERS = {"_upload_ids", "_upload_values", "_stack_planes", "_pinned"}
#: what an upload helper may not do either: wait, or read the device back
UPLOAD_BANNED = {"item", "cpu", "tolist", "synchronize", "_readback",
                 "block_until_ready", "query"}


def _reached_calls(methods, roots, skip=()):
    """``(seen, [(method, attr)])``: the attribute calls of ``roots`` and of
    every server method they reach through ``self.<method>(...)``, not
    entering ``skip``."""
    seen, todo, calls = set(), list(roots), []
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        for node in ast.walk(methods[name]):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
                calls.append((name, node.func.attr))
                if (isinstance(node.func.value, ast.Name) and node.func.value.id == "self"
                        and node.func.attr in methods and node.func.attr not in skip):
                    todo.append(node.func.attr)
    return seen, calls


def test_ack_push_is_sync_free():
    seen, calls = _reached_calls(_method_bodies(), ["_ack_push"])
    assert {"_ack_push", "_stamp_version", "_forward_push"} <= seen
    bad = [(fn, attr) for fn, attr in calls if attr in SYNCING]
    assert not bad, f"device reads in the push ack path: {bad}"


def _gate_violations(methods):
    gate = _gate_branch(methods)
    seen, calls = _reached_calls({**methods, "<gate>": gate}, ["<gate>", "_wait_reply"])
    return gate, seen, [(fn, attr) for fn, attr in calls if attr in SYNCING]


def test_consistency_gate_is_sync_free():
    """The gate's admit / defer decision and its ``__wait__`` reply."""
    gate, seen, bad = _gate_violations(_method_bodies())
    assert any(isinstance(n, ast.If) for n in gate.body), "no gate branch found"
    assert {"<gate>", "_wait_reply", "version_max"} <= seen
    assert not bad, f"device reads in the consistency gate: {bad}"


def test_ack_push_books_groups_and_commits_gated_steps():
    """The group booking and the gate's step commit live in ``_ack_push``,
    so ``test_ack_push_is_sync_free`` scans them."""
    src = ast.unparse(_method_bodies()["_ack_push"])
    assert "GROUP_KEY" in src and "self.group_members +=" in src
    assert "CONSIST_STEP_KEY" in src and ".commit(msg.sender" in src


@pytest.mark.parametrize("planted", ["gate", "ack_group"])
def test_the_gate_and_group_scans_catch_a_planted_readback(planted):
    methods = dict(_method_bodies())
    if planted == "gate":
        src = ("def _validate_data_request(self, msg):\n"
               "    cstep = msg.task.payload.get(CONSIST_STEP_KEY)\n"
               "    if cstep is not None and tname in self._consist:\n"
               "        self.tables[tname].value.sum().item()\n")
        methods["_validate_data_request"] = ast.parse(src).body[0]
        bad = _gate_violations(methods)[2]
        assert bad == [("<gate>", "item")]
    else:
        src = ("def _ack_push(self, msg, tname, kn, segs):\n"
               "    grp = msg.task.payload.get(GROUP_KEY)\n"
               "    if grp is not None:\n"
               "        self.group_members += int(self.tables[tname].value.cpu()[0])\n")
        methods["_ack_push"] = ast.parse(src).body[0]
        _, calls = _reached_calls(methods, ["_ack_push"])
        assert [c for c in calls if c[1] in SYNCING] == [("_ack_push", "cpu")]


def test_grouped_apply_is_sync_free():
    """The bundled apply's launches, its ledger registration and its acks
    never wait for the device (JAX's ``SYNC_FREE_FUNCS``)."""
    methods = _method_bodies()
    seen, calls = _reached_calls(methods, SYNC_FREE_ROOTS, skip=UPLOAD_HELPERS)
    assert set(SYNC_FREE_ROOTS) | {"_submit_apply", "_completion_handle"} <= seen
    bad = [(fn, attr) for fn, attr in calls if attr in SYNCING]
    assert not bad, f"device reads in the grouped apply: {bad}"


def test_upload_helpers_copy_without_waiting():
    methods = _method_bodies()
    bad = {name: _banned_attr_calls(methods[name], UPLOAD_BANNED)
           for name in sorted(UPLOAD_HELPERS)}
    assert not any(bad.values()), f"an upload helper waits: {bad}"


#: the durability plane's freeze and rebuild paths
DURABLE_ROOTS = ("_export_rows", "_rebuild_table", "_commit_migration",
                 "_install_migration", "_commit_snapshot")
#: a whole table plane: ``tbl.value``, ``table.state[k]``, ``self.tables[t].value``
_WHOLE_PLANE = re.compile(r"^(tbl|table|self\.tables\[[^\]]+\])\.(value|state\[[^\]]+\])$")
#: reading a receiver to the host, and functions that read their arguments
PLANE_READ_ATTRS = {"cpu", "numpy", "tolist", "to"}
PLANE_READ_FUNCS = {"asarray", "array", "_readback", "_host_rows"}


def _whole_plane(node) -> bool:
    return bool(_WHOLE_PLANE.match(ast.unparse(node)))


def _plane_reads(methods, roots):
    """``(seen, [(method, call)])``: calls in ``roots`` and every server
    method they reach that read a whole plane to the host."""
    seen, todo, bad = set(), list(roots), []
    while todo:
        name = todo.pop()
        if name in seen or name not in methods:
            continue
        seen.add(name)
        for node in ast.walk(methods[name]):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            fname = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
            args = [a for arg in node.args
                    for a in (arg.elts if isinstance(arg, (ast.List, ast.Tuple)) else [arg])]
            if ((isinstance(f, ast.Attribute) and fname in PLANE_READ_ATTRS
                 and _whole_plane(f.value))
                    or (fname in PLANE_READ_FUNCS and any(_whole_plane(a) for a in args))):
                bad.append((name, ast.unparse(node)))
            if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                    and f.value.id == "self"):
                todo.append(f.attr)
    return seen, bad


def test_durable_paths_read_no_whole_plane():
    methods = _method_bodies()
    seen, bad = _plane_reads(methods, DURABLE_ROOTS)
    assert {*DURABLE_ROOTS, "_install_routing", "_upload_rows", "_readback"} <= seen
    assert not bad, f"whole-plane host reads on the durability plane: {bad}"
    # snap_commit is _commit_snapshot
    src = ast.unparse(methods["_handle_snapshot"])
    assert "op == 'snap_commit'" in src and "self._commit_snapshot(" in src


def _jax_server_methods():
    tree = ast.parse((ROOT / "parameter_server_tpu" / "kv" / "server.py").read_text())
    cls = next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == "KVServer")
    return {f.name: f for f in cls.body if isinstance(f, ast.FunctionDef)}


@pytest.mark.parametrize("planted", ["jax_export_rows", "jax_rebuild_table",
                                     "jax_install_migration", "readback", "state_plane"])
def test_the_plane_scan_catches_a_whole_plane_read(planted):
    """The JAX server's own versions copy whole planes (``np.asarray(tbl.
    value)``): the scan flags each; so does a planted readback."""
    methods = dict(_method_bodies())
    if planted.startswith("jax_"):
        name = planted[len("jax_"):]
        methods[name] = _jax_server_methods()[f"_{name}"]
        _, bad = _plane_reads(methods, [name])
        assert any("np.asarray(tbl" in call for _, call in bad), bad
        return
    src = {"readback": "def _export_rows(self, table, gids):\n"
                       "    tbl = self.tables[table]\n"
                       "    return self._readback([tbl.value, tbl.state['sum_sq']])\n",
           "state_plane": "def _export_rows(self, table, gids):\n"
                          "    return self.tables[table].state['sum_sq'].cpu()[gids]\n"}[planted]
    methods["_export_rows"] = ast.parse(src).body[0]
    _, bad = _plane_reads(methods, ["_export_rows"])
    assert len(bad) == 1 and bad[0][0] == "_export_rows"


#: the ledger's submit side (JAX's ``LEDGER_SYNC_FREE_FUNCS``): SYNCING plus
#: the completion handle's poll and wait
LEDGER_SYNC_FREE = ("ApplyLedger.begin", "ApplyLedger.submit", "ApplyLedger.overloaded",
                    "_Inflight.mark_host", "_Inflight.mark_h2d")
LEDGER_BANNED = SYNCING | {"synchronize", "query"}


def _banned_attr_calls(fn, banned):
    return [n.func.attr for n in ast.walk(fn)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr in banned]


def test_ledger_submit_side_is_sync_free():
    fns = _functions("kv/ledger.py")
    bad = {name: _banned_attr_calls(fns[name], LEDGER_BANNED) for name in LEDGER_SYNC_FREE}
    assert not any(bad.values()), f"the ledger's submit side waits: {bad}"
    # the reaper is where the waiting belongs
    assert _banned_attr_calls(fns["ApplyLedger._reap_loop"], LEDGER_BANNED) == ["synchronize"]
    assert _banned_attr_calls(fns["ApplyLedger._reap_once"], LEDGER_BANNED) == ["query"]


def test_the_ledger_scan_catches_a_planted_query():
    src = "def submit(self, tok, ref, fallback):\n    if ref.query():\n        pass\n"
    assert _banned_attr_calls(ast.parse(src).body[0], LEDGER_BANNED) == ["query"]


#: event kinds the ledger journals (JAX's ``REQUIRED_EVENTS`` ``apply.*``)
REQUIRED_APPLY_EVENTS = {"apply.submit", "apply.done", "apply.backlog"}


def _events_registry():
    tree = ast.parse((PORT / "core" / "flightrec.py").read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "EVENTS"):
            (arg,) = node.value.args  # frozenset({...}) of string literals
            return {e.value for e in arg.elts}
    raise AssertionError("no EVENTS literal in core/flightrec.py")


def _record_sites(tree):
    """``(kind or None, lineno)`` of every ``flightrec.record(...)`` call and
    of the ledger's aliased ``self._record(...)`` calls."""
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        f = node.func
        direct = f.attr == "record" and isinstance(f.value, ast.Name) and f.value.id == "flightrec"
        alias = f.attr == "_record" and isinstance(f.value, ast.Name) and f.value.id == "self"
        if not (direct or alias):
            continue
        first = node.args[0] if node.args else None
        literal = isinstance(first, ast.Constant) and isinstance(first.value, str)
        if direct or literal:  # the alias's own forwarding call passes a name
            yield (first.value if literal else None), node.lineno


def test_every_flightrec_record_uses_a_registered_literal_kind():
    events = _events_registry()
    assert REQUIRED_APPLY_EVENTS <= events
    seen = {}
    for path in sorted(PORT.rglob("*.py")):
        for kind, line in _record_sites(ast.parse(path.read_text())):
            where = f"{path.relative_to(ROOT)}:{line}"
            assert kind is not None, f"{where}: the kind is not a literal"
            assert kind in events, f"{where}: unregistered kind {kind!r}"
            seen[kind] = where
    assert {"fence.routing", "cancel.drop", "bundle.flush",
            *REQUIRED_APPLY_EVENTS} <= set(seen)


def test_the_record_scan_catches_a_non_literal_kind():
    tree = ast.parse("def f(k):\n    flightrec.record(k, node='S0')\n")
    assert list(_record_sites(tree)) == [(None, 2)]


def test_the_sync_scan_catches_a_readback():
    src = "def _ack_push(self):\n    return self.tables['w'].value.cpu()\n"
    fn = ast.parse(src).body[0]
    attrs = {n.func.attr for n in ast.walk(fn)
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)}
    assert attrs & SYNCING == {"cpu"}


#: calls that read device state back, wait for the device, or (unique,
#: bincount) read a size back before they return
DENSE_BANNED_ATTRS = {"item", "cpu", "tolist", "numpy", "synchronize", "unique",
                      "bincount"}
DENSE_ROOTS = {
    "learner/sgd.py": ["LocalLRTrainer.step_block_device"],
    "models/linear.py": ["dense_scan_train_step", "dense_fused_step"],
}


def _functions(rel):
    """Module-level functions and ``Class.method``s of a port module."""
    tree = ast.parse((PORT / rel).read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            out.update({f"{node.name}.{f.name}": f for f in node.body
                        if isinstance(f, ast.FunctionDef)})
    return out


def _dense_violations(fn, banned=DENSE_BANNED_ATTRS):
    """Banned calls in ``fn``: ``x.<banned>(...)`` and ``float(...)``; also
    the names of functions it calls, to follow."""
    bad, called = [], set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute):
            if f.attr in banned:
                bad.append(f.attr)
            called.add(f.attr)
        elif isinstance(f, ast.Name):
            if f.id == "float":
                bad.append("float")
            called.add(f.id)
    return bad, called


def test_dense_block_path_is_sync_free():
    """``step_block_device`` and the dense steps, with every function of
    ``models/linear.py`` and ``ops/scatter.py`` they reach, never wait on
    the device: that is what lets the prefetch producer stage block i + 1
    while block i runs."""
    linear_fns = {**_functions("ops/scatter.py"), **_functions("models/linear.py")}
    bad, seen = [], set()
    for rel, roots in DENSE_ROOTS.items():
        fns = _functions(rel)
        todo = [fns[r] for r in roots]
        while todo:
            fn = todo.pop()
            if fn.name in seen:
                continue
            seen.add(fn.name)
            found, called = _dense_violations(fn)
            bad += [(fn.name, b) for b in found]
            todo += [linear_fns[c] for c in called if c in linear_fns]
    assert {"step_block_device", "dense_scan_train_step", "dense_fused_step",
            "segment_combine", "device_slots", "_fmix32", "_mul32",
            "_dense_touched_step", "_apply_bias", "logloss", "group_slots",
            "segment_sum_sorted", "cuda_segment_sum", "segment_sum_sorted_torch",
            "apply_rows", "cuda_apply"} <= seen
    assert not bad, f"host syncs on the dense block path: {bad}"


def test_fm_fused_step_is_sync_free():
    """``models/fm.py::fused_train_step``, with every function of
    ``models/fm.py``, ``models/linear.py`` and ``ops/scatter.py`` it reaches
    (the gather and apply kernels' wrappers included), reads nothing back
    from the card: the loss the trainer returns is the step's only sync."""
    fns = {**_functions("ops/scatter.py"), **_functions("models/linear.py"),
           **_functions("models/fm.py")}
    bad, seen, todo = [], set(), [fns["fused_train_step"]]
    while todo:
        fn = todo.pop()
        if fn in seen:
            continue
        seen.add(fn)
        found, called = _dense_violations(fn)
        bad += [(fn.name, b) for b in found]
        todo += [fns[c] for c in called if c in fns]
    names = {fn.name for fn in seen}
    assert {"fused_train_step", "fm_logits", "_grad_pos", "logloss", "segment_combine",
            "gather_rows_planes", "cuda_gather_planes", "apply_rows", "cuda_apply",
            "_apply_bias"} <= names
    assert not bad, f"host syncs in the FM step: {bad}"


@pytest.mark.parametrize("src,want", [
    ("def f(x):\n    return float(x.sum())\n", ["float"]),
    ("def f(x):\n    return torch.unique(x)\n", ["unique"]),
    ("def f(x):\n    return torch.bincount(x, minlength=4)\n", ["bincount"]),
    ("def f(x):\n    torch.cuda.synchronize()\n", ["synchronize"]),
    ("def f(x):\n    return x.sum().item()\n", ["item"]),
])
def test_the_dense_sync_scan_catches_a_readback(src, want):
    assert _dense_violations(ast.parse(src).body[0])[0] == want


@pytest.mark.parametrize("entry", [KVTable, KVServer, KVWorker, AsyncLRLearner,
                                   LocalLRTrainer, PrefetchPipeline, SpmdDLRMTrainer,
                                   DenseKVServer, DenseKVWorker, SpmdDenseTrainer,
                                   AsyncDenseLearner, make_replicated_servers,
                                   restart_same_id, ElasticTrainer, scale_up,
                                   restart_server, launch, ChunkedAsyncDenseLearner,
                                   SpmdLMTrainer, HybridLMTrainer, Transformer,
                                   TransformerBody, TransformerTrunk, LocalFMTrainer,
                                   DarlinServer, DarlinWorker, create, make_mesh,
                                   initialize, launch_spmd, run_job, launch_hybrid,
                                   SpLMTrainer, SpTpLMTrainer, PipelinedLMTrainer,
                                   VirtualPipeline, dryrun_multichip],
                         ids=lambda c: c.__name__)
def test_entry_points_default_to_the_card(entry):
    fn = entry.__init__ if inspect.isclass(entry) else entry
    param = inspect.signature(fn).parameters["device"]
    assert param.default == "cuda"
    assert param.kind is inspect.Parameter.KEYWORD_ONLY


def test_serving_entry_points_build_on_the_card_by_default():
    """The serving plane's new options keep the card default: a server with
    ``device_replies`` / ``replica`` and a worker with a cache, built without
    ``device``, hold ``cuda`` (with no tables nothing is allocated, so this
    runs on a host without a card)."""
    from parameter_server_tpu_torch.kv.cache import HotRowCache

    van = LoopbackVan()
    srv = KVServer(Postoffice("S0", van), {}, 0, 1, device_replies=True, replica="R0",
                   replica_sync=True)
    try:
        wkr = KVWorker(Postoffice("W0", van), {}, 1, cache=HotRowCache(8))
        assert srv.device.type == wkr.device.type == "cuda"
        assert srv._fwd_post.node_id == "S0.fw"
    finally:
        van.close()
        srv.ledger.close()


def test_dlrm_scale_defaults_to_the_card():
    """``python -m parameter_server_tpu_torch.parallel.dlrm_scale`` runs on
    the card unless ``--device`` says otherwise."""
    assert inspect.signature(dlrm_scale.scale_run).parameters["device"].default == "cuda"
    tree = ast.parse(inspect.getsource(dlrm_scale.main))
    flags = {c.args[0].value: {k.arg: getattr(k.value, "value", None) for k in c.keywords}
             for c in ast.walk(tree) if isinstance(c, ast.Call)
             and getattr(c.func, "attr", None) == "add_argument"}
    assert flags["--device"]["default"] == "cuda"
    assert flags["--mesh"]["default"] == "1,1"


def test_chip_smoke_defines_each_top_level_name_once():
    """A second top-level ``def`` of one name silently replaces the first
    for every phase that calls it, and only a whole card run would show it."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = [n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
    assert sorted(n for n in set(names) if names.count(n) > 1) == []


def test_launch_spmd_ranks_default_to_the_card():
    """``python -m parameter_server_tpu_torch.launch_spmd`` ranks run on the
    card unless ``--device`` says otherwise, and ``launch_spmd()`` passes
    its own."""
    from parameter_server_tpu_torch import launch_spmd as mod

    tree = ast.parse(inspect.getsource(mod.main))
    flags = {c.args[0].value: {k.arg: getattr(k.value, "value", None) for k in c.keywords}
             for c in ast.walk(tree) if isinstance(c, ast.Call)
             and getattr(c.func, "attr", None) == "add_argument"}
    assert flags["--device"]["default"] == "cuda"
    assert '"--device", device' in inspect.getsource(mod.launch_spmd)


def _device_flag_default(fn):
    tree = ast.parse(inspect.getsource(fn))
    flags = {c.args[0].value: {k.arg: getattr(k.value, "value", None) for k in c.keywords}
             for c in ast.walk(tree) if isinstance(c, ast.Call)
             and getattr(c.func, "attr", None) == "add_argument"}
    return flags["--device"]["default"]


def test_launch_children_default_to_the_card():
    """``python -m parameter_server_tpu_torch.launch`` roles run on the card
    unless ``--device`` says otherwise, and ``launch()`` passes its own."""
    from parameter_server_tpu_torch import launch as launch_mod

    assert _device_flag_default(launch_mod.main) == "cuda"
    assert '"--device", device' in inspect.getsource(launch_mod.launch)


def test_launch_hybrid_children_default_to_the_card():
    """``launch_hybrid``'s servers and body ranks run on the card unless
    ``--device`` says otherwise, ``launch_hybrid()`` passes its own, and the
    servers build their tables on it."""
    from parameter_server_tpu_torch import launch_hybrid as mod

    assert _device_flag_default(mod.main) == "cuda"
    assert '"--device", device' in inspect.getsource(mod.launch_hybrid)
    assert "device=args.device" in inspect.getsource(mod.run_server)
    assert "device=args.device" in inspect.getsource(mod.run_body)


def test_server_builds_a_ledger_by_default():
    """``KVServer(devobs=...)``: keyword-only, ``None`` by default, which
    builds an enabled ledger as the JAX server does; the server's ``device``
    keeps its card default (above)."""
    param = inspect.signature(KVServer.__init__).parameters["devobs"]
    assert param.default is None and param.kind is inspect.Parameter.KEYWORD_ONLY
    assert LedgerConfig().enabled
    van = LoopbackVan()
    try:
        srv = KVServer(Postoffice("S0", van), {}, 0, 1, device="cpu")
        assert srv.ledger is not None and srv.ledger.cfg == LedgerConfig()
        off = KVServer(Postoffice("S1", van), {}, 0, 1, device="cpu",
                       devobs=LedgerConfig(enabled=False))
        assert off.ledger is None
    finally:
        van.close()


def _run_smoke(cwd):
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True,
        timeout=120, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
    )
    last = proc.stdout.strip().splitlines()[-1:] or [""]
    return proc.returncode, last[0]


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "script_alone"])
def test_chip_smoke_fails_without_a_card_or_the_package(alone, tmp_path):
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    rc, last = _run_smoke(cwd)
    assert rc != 0
    try:
        assert not json.loads(last).get("ok")
    except ValueError:
        pass  # no JSON result line at all


# -------------------------------------------------- the Van wrapper contract

sys.path.insert(0, str(ROOT / "tools"))
import check_wrappers  # noqa: E402

#: the port's Van wrapper modules, held by name
WIRE_WRAPPERS = ("core/van.py", "core/netmon.py", "core/coalesce.py", "core/frame.py",
                 "core/chaos.py", "core/resender.py")
#: the JAX package's no-pickle modules the port has not ported yet
NOT_PORTED_HOT_PATH = set()


def test_port_wrappers_keep_the_wrapper_contract():
    wrappers = sorted(str(f.relative_to(PORT)) for f in PORT.rglob("*.py")
                      if "VanWrapper" in f.read_text())
    assert set(WIRE_WRAPPERS) <= set(wrappers)
    problems = [p for rel in wrappers for p in check_wrappers.check_file(PORT / rel)]
    assert problems == [], "\n".join(problems)


def test_port_frame_path_is_pickle_free():
    present = [rel for rel in check_wrappers.NO_PICKLE_MODULES if (PORT / rel).is_file()]
    assert set(check_wrappers.NO_PICKLE_MODULES) - set(present) == NOT_PORTED_HOT_PATH
    problems = [p for rel in present + ["core/chaos.py"]
                for p in check_wrappers.check_no_pickle(PORT / rel)]
    assert problems == [], "\n".join(problems)


def test_port_shm_and_recv_fast_paths_are_copy_free():
    """The ring's write / poll / read / release and the socket van's send
    choke point, ring reader and receive dispatch make no per-frame copy
    (``.tobytes()``, ``bytes(...)``, ``ctypes.string_at``), as the JAX
    package's (``check_wrappers.check_copy_free``)."""
    problems = check_wrappers.check_copy_free(
        PORT / check_wrappers.SHM_RING_MODULE, check_wrappers.SHM_COPY_FREE_FUNCS,
        "SHM_COPY_FREE_FUNCS")
    problems += check_wrappers.check_copy_free(
        PORT / "core/tcp_van.py", check_wrappers.VAN_COPY_FREE_FUNCS, "VAN_COPY_FREE_FUNCS")
    assert problems == [], "\n".join(problems)


def test_the_copy_free_scan_catches_a_planted_copy(tmp_path):
    src = (PORT / "core/shm_ring.py").read_text()
    old = "            view = self._data[pos + 4:pos + 4 + n]\n"
    assert old in src
    bad = tmp_path / "planted.py"
    bad.write_text(src.replace(old, old + "            view = bytes(view)\n", 1))
    problems = check_wrappers.check_copy_free(bad, check_wrappers.SHM_COPY_FREE_FUNCS, "X")
    assert len(problems) == 1 and "bytes()" in problems[0]


@pytest.mark.parametrize("planted", ["flush", "close", "counters", "pickle", "ml_dtypes"])
def test_the_wrapper_scans_catch_a_planted_violation(planted, tmp_path):
    """A copy of a port module with one violation planted: the scan that
    holds the real module must flag the copy."""
    if planted in ("flush", "close"):
        src = (PORT / "core/resender.py").read_text()
        old = {"flush": "return self.inner.flush(max(deadline - time.monotonic(), 0.0))",
               "close": "self._thread.join(timeout=5)\n        self.inner.close()"}[planted]
        assert old in src
        src = src.replace(old, {"flush": "return True", "close": "self._thread.join(timeout=5)"}[planted])
    elif planted == "counters":
        src = (PORT / "core/chaos.py").read_text()
        old = "            return {\n                \"chaos_drops\""
        assert old in src
        src = src.replace(old, "            return {**self.inner.counters(),\n                \"chaos_drops\"")
    else:
        src = (PORT / "core/frame.py").read_text().replace(
            "import zlib\n", "import zlib\nimport pickle\n" if planted == "pickle"
            else "import zlib\nimport ml_dtypes\n", 1)
    bad = tmp_path / "planted.py"
    bad.write_text(src)
    if planted == "pickle":
        assert len(check_wrappers.check_no_pickle(bad)) == 1
    elif planted == "ml_dtypes":
        assert [m for m in _imported_modules(bad) if _forbidden(m)] == ["ml_dtypes"]
    else:
        problems = check_wrappers.check_file(bad)
        assert len(problems) == 1 and planted in problems[0]


# ------------------------------------------------ the sampling gate of tracing


def test_trace_records_sit_behind_the_sampling_gate():
    """The JAX package's ``TRACE_GATED_FUNCS`` contract on the port: every
    registered module and function exists here, records ``trace.*`` kinds,
    and records them only under an ``if``."""
    problems = []
    for rel, funcs in sorted(check_wrappers.TRACE_GATED_FUNCS.items()):
        assert (PORT / rel).is_file(), rel
        problems += check_wrappers.check_trace_gated(PORT / rel, funcs, "TRACE_GATED_FUNCS")
    assert problems == [], "\n".join(problems)


@pytest.mark.parametrize("planted", ["ungated", "removed"])
def test_the_trace_gate_scan_catches_a_planted_violation(planted, tmp_path):
    src = (PORT / "kv/worker.py").read_text()
    if planted == "ungated":
        old = "        if tctx is not None:\n            with self._trace_lock:\n"
        assert old in src
        src = src.replace(old, "        if True:\n            pass\n        flightrec.record("
                          "\"trace.submit\", tid=tctx)\n        if tctx is not None:\n"
                          "            with self._trace_lock:\n", 1)
    else:
        src = src.replace("def _trace_submitted(", "def _trace_submitted_renamed(", 1)
    bad = tmp_path / "worker.py"
    bad.write_text(src)
    problems = check_wrappers.check_trace_gated(
        bad, check_wrappers.TRACE_GATED_FUNCS["kv/worker.py"], "TRACE_GATED_FUNCS")
    assert len(problems) == 1
    assert ("unconditionally" if planted == "ungated" else "missing") in problems[0]
