"""Package rules of the PyTorch port, checked on the source.

- ``parameter_server_tpu_torch/`` and ``chip_smoke.py`` import neither
  ``jax`` nor anything of the JAX package ``parameter_server_tpu``.
- The server's ``_ack_push`` (and every method of the server it calls) never
  reads device state back: no ``.item()``, ``.cpu()``, ``.tolist()``,
  ``.numpy()``, ``.to()``, ``synchronize()`` or numpy conversion.
- ``LocalLRTrainer.step_block_device`` and the dense steps of
  ``models/linear.py`` never wait on the device: no ``.item()``, ``.cpu()``,
  ``.tolist()``, ``.numpy()``, ``float(...)``, ``torch.unique``,
  ``torch.bincount`` or ``synchronize()``.
- Every entry point's ``device`` defaults to ``"cuda"``.
- ``chip_smoke.py`` fails, and prints no result, where there is no card or
  no package beside it.
"""

import ast
import inspect
import json
import pathlib
import shutil
import subprocess
import sys

import pytest

from parameter_server_tpu_torch.data.prefetch import PrefetchPipeline
from parameter_server_tpu_torch.kv.server import KVServer
from parameter_server_tpu_torch.kv.table import KVTable
from parameter_server_tpu_torch.kv.worker import KVWorker
from parameter_server_tpu_torch.learner.sgd import AsyncLRLearner, LocalLRTrainer

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
    return top in ("jax", "jaxlib", "parameter_server_tpu")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_the_jax_package(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_import_scan_sees_every_module():
    assert len(SOURCES) >= 25
    assert _forbidden("jax.numpy") and _forbidden("parameter_server_tpu.kv.table")
    assert not _forbidden("parameter_server_tpu_torch.kv.table")


#: attribute calls that read device state back or wait for the device
SYNCING = {"item", "cpu", "tolist", "numpy", "to", "synchronize", "asarray",
           "array", "copy_", "_readback", "block_until_ready"}


def _method_bodies():
    tree = ast.parse((PORT / "kv" / "server.py").read_text())
    cls = next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == "KVServer")
    return {f.name: f for f in cls.body if isinstance(f, ast.FunctionDef)}


def test_ack_push_is_sync_free():
    methods = _method_bodies()
    seen, todo, calls = set(), ["_ack_push"], []
    while todo:  # _ack_push and every server method it reaches
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        for node in ast.walk(methods[name]):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
                calls.append((name, node.func.attr))
                if (isinstance(node.func.value, ast.Name) and node.func.value.id == "self"
                        and node.func.attr in methods):
                    todo.append(node.func.attr)
    assert {"_ack_push", "_stamp_version"} <= seen
    bad = [(fn, attr) for fn, attr in calls if attr in SYNCING]
    assert not bad, f"device reads in the push ack path: {bad}"


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
            "_loss_and_residual", "_apply_bias", "logloss"} <= seen
    assert not bad, f"host syncs on the dense block path: {bad}"


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
                                   LocalLRTrainer, PrefetchPipeline],
                         ids=lambda c: c.__name__)
def test_entry_points_default_to_the_card(entry):
    param = inspect.signature(entry.__init__).parameters["device"]
    assert param.default == "cuda"
    assert param.kind is inspect.Parameter.KEYWORD_ONLY


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
