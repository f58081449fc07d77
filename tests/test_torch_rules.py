"""Package rules of the PyTorch port, checked on the source.

- ``parameter_server_tpu_torch/`` and ``chip_smoke.py`` import neither
  ``jax`` nor anything of the JAX package ``parameter_server_tpu``.
- The server's ``_ack_push`` (and every method of the server it calls) never
  reads device state back: no ``.item()``, ``.cpu()``, ``.tolist()``,
  ``.numpy()``, ``.to()``, ``synchronize()`` or numpy conversion.
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

from parameter_server_tpu_torch.kv.server import KVServer
from parameter_server_tpu_torch.kv.table import KVTable
from parameter_server_tpu_torch.kv.worker import KVWorker
from parameter_server_tpu_torch.learner.sgd import AsyncLRLearner

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


@pytest.mark.parametrize("entry", [KVTable, KVServer, KVWorker, AsyncLRLearner],
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
