"""The port's app factory and ``psx`` CLI against the JAX package's, on the
CPU (every app built with ``device="cpu"``).

Twins of ``tests/test_app.py``: config loading (yaml and json), unknown
apps and fields, duplicate registration, ``async_lr`` with checkpoints,
``psx run`` / ``apps`` / ``eval``, and file-driven training from a local
glob and from ``psfs://`` (losses rtol 1e-6 between the two, as there).  The
registry and the CLI's subcommands are the JAX package's; ``sparse_lr``
from a config gives the JAX app's losses on the same data (rtol 1e-5), and
``fm`` and ``llama_hybrid`` run from configs.  The two long-context apps run
from a config in this process (a world of one rank: sp 1) and give the JAX
apps' losses (8 virtual devices on sp) at 1e-4 from the JAX trainers'
initial weights; ``psx launch-hybrid --device cpu`` runs 2 hosts.
"""

import argparse
import ast
import inspect
import json

import numpy as np
import pytest

from parameter_server_tpu import app as japp
from parameter_server_tpu import cli as jcli
from parameter_server_tpu_torch import app as app_lib
from parameter_server_tpu_torch import cli
from parameter_server_tpu_torch.config import OptimizerConfig, TableConfig, TopologyConfig

CPU = "cpu"

CFG_YAML = """
app: sparse_lr
steps: 30
eval_batches: 2
table:
  name: w
  rows: 4096
  optimizer: {kind: adagrad, learning_rate: 0.1}
data: {kind: synthetic, key_space: 8192, nnz: 8, batch_size: 256, seed: 1}
"""


def _write(tmp_path, text, name="cfg.yaml"):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def test_load_config_and_create(tmp_path):
    cfg = app_lib.load_config(_write(tmp_path, CFG_YAML))
    assert cfg.app == "sparse_lr"
    assert cfg.table.rows == 4096
    assert cfg.table.optimizer.kind == "adagrad"
    assert cfg.data.batch_size == 256
    out = app_lib.create(cfg, device=CPU)()
    assert len(out["losses"]) == 30
    assert np.mean(out["losses"][-5:]) < np.mean(out["losses"][:5])
    assert 0.0 <= out["auc"] <= 1.0


def test_unknown_app_and_field(tmp_path):
    with pytest.raises(ValueError, match="unknown app"):
        app_lib.create(app_lib.AppConfig(app="nope", table=TableConfig(name="w", rows=8)),
                       device=CPU)
    bad = CFG_YAML.replace("steps: 30", "stepz: 30")
    with pytest.raises(ValueError, match="unknown field"):
        app_lib.load_config(_write(tmp_path, bad))


def test_json_config_and_consistency_enum(tmp_path):
    raw = {
        "app": "fm",
        "steps": 5,
        "table": {
            "name": "fm", "rows": 64, "dim": 3, "init_scale": 0.1,
            "optimizer": {"kind": "adagrad", "learning_rate": 0.1},
        },
        "data": {"kind": "synthetic", "key_space": 128, "nnz": 4, "batch_size": 64},
        "consistency": {"mode": "ssp", "max_delay": 3},
    }
    path = _write(tmp_path, json.dumps(raw), "cfg.json")
    cfg = app_lib.load_config(path)
    assert cfg.consistency.bound == 3
    out = app_lib.create(cfg, device=CPU)()
    assert len(out["losses"]) == 5


def test_register_app_duplicate_rejected():
    with pytest.raises(ValueError, match="already registered"):
        app_lib.register_app("sparse_lr")(lambda cfg, device: lambda: {})


ASYNC_YAML = """
app: async_lr
steps: 12
table:
  name: w
  rows: 2048
  optimizer: {kind: adagrad, learning_rate: 0.1}
data: {kind: synthetic, key_space: 4096, nnz: 8, batch_size: 128, seed: 2}
consistency: {mode: asp}
topology: {num_workers: 2, num_servers: 2}
ckpt_every: 2
"""


def test_async_lr_app_end_to_end(tmp_path):
    cfg = app_lib.load_config(_write(tmp_path, ASYNC_YAML + f"ckpt_root: {tmp_path / 'ckpt'}\n"))
    out = app_lib.create(cfg, device=CPU)()
    assert out["steps"] >= 12
    assert out["last_ckpt_step"] is not None


def test_cli_run_and_apps(tmp_path, capsys):
    path = _write(tmp_path, CFG_YAML)
    assert cli.main(["run", path, "--steps", "10", "--device", CPU]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["app"] == "sparse_lr" and out["steps"] == 10
    assert "final_loss" in out
    # the same run through --config
    assert cli.main(["run", "--config", path, "--steps", "10", "--device", CPU]) == 0
    assert json.loads(capsys.readouterr().out) == out

    assert cli.main(["apps"]) == 0
    listed = capsys.readouterr().out.split()
    assert {"sparse_lr", "fm", "async_lr"} <= set(listed)
    with pytest.raises(SystemExit):
        cli.main(["run", "--device", CPU])  # no config at all


def test_cli_eval(tmp_path, capsys):
    # train briefly via the app, checkpointing, then eval from the CLI
    cfg_text = f"""
app: async_lr
steps: 8
table:
  name: w
  rows: 2048
  optimizer: {{kind: adagrad, learning_rate: 0.1}}
data: {{kind: synthetic, key_space: 4096, nnz: 8, batch_size: 128, seed: 3}}
topology: {{num_workers: 1, num_servers: 2}}
consistency: {{mode: asp}}
ckpt_root: {tmp_path / 'ckpt'}
ckpt_every: 1
"""
    app_lib.create(app_lib.load_config(_write(tmp_path, cfg_text)), device=CPU)()
    args = ["eval", str(tmp_path / "ckpt"), "--table", "w", "--rows", "2048",
            "--key-space", "4096", "--nnz", "8", "--batch-size", "128",
            "--seed", "3", "--batches", "4"]
    assert cli.main(args) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["examples"] == 512
    assert 0.0 <= report["auc"] <= 1.0
    # the JAX CLI scores the port's checkpoint identically
    assert jcli.main(args) == 0
    assert json.loads(capsys.readouterr().out) == report


def _planted_shards(tmp_path):
    rng = np.random.default_rng(0)
    shard_dir = tmp_path / "shards"
    shard_dir.mkdir()
    # planted signal: label = key parity over a small keyspace
    for part in range(2):
        lines = []
        for _ in range(400):
            keys = sorted(rng.choice(64, size=4, replace=False))
            label = int(sum(keys) % 2 == 0)
            lines.append(f"{label} " + " ".join(f"{k}:1" for k in keys))
        (shard_dir / f"part{part}.txt").write_text("\n".join(lines) + "\n")
    return shard_dir


def _file_cfg(mod, path):
    return mod._hydrate(
        mod.AppConfig,
        {
            "app": "sparse_lr",
            "table": {"name": "w", "rows": 4096, "dim": 1,
                      "optimizer": {"kind": "adagrad", "learning_rate": 0.2}},
            "data": {"kind": "libsvm", "path": path, "batch_size": 128},
            "steps": 30,
        },
    )


def test_sparse_lr_app_trains_from_files_local_and_remote(tmp_path):
    """File-driven training: the sparse_lr app streams libsvm shards via a
    glob — and the same config trains from a remote psfs:// shard server."""
    from parameter_server_tpu_torch.data import fs

    shard_dir = _planted_shards(tmp_path)
    local = app_lib.create(_file_cfg(app_lib, str(shard_dir / "part*.txt")), device=CPU)()
    assert np.mean(local["losses"][-5:]) < np.mean(local["losses"][:5])

    srv = fs.FileServer(str(shard_dir), host="127.0.0.1").start()
    try:
        remote = app_lib.create(_file_cfg(app_lib, f"{srv.url}/part*.txt"), device=CPU)()
    finally:
        srv.stop()
    # identical shards, identical stream order -> identical trajectories
    np.testing.assert_allclose(remote["losses"], local["losses"], rtol=1e-6)


def test_sparse_lr_app_matches_the_jax_app(tmp_path):
    """The same file config through both packages' apps: losses rtol 1e-5."""
    shard_dir = _planted_shards(tmp_path)
    path = str(shard_dir / "part*.txt")
    ours = app_lib.create(_file_cfg(app_lib, path), device=CPU)()
    theirs = japp.create(_file_cfg(japp, path))()
    np.testing.assert_allclose(ours["losses"], theirs["losses"], rtol=1e-5)


def test_batch_fn_globs_and_literal_names(tmp_path):
    """An empty glob is a config error; a literal file name holding glob
    characters that exists still streams."""
    with pytest.raises(FileNotFoundError, match="matched no files"):
        app_lib._make_batch_fn(app_lib.DataConfig(kind="libsvm", path=str(tmp_path / "x*")))
    with pytest.raises(ValueError, match="requires data.path"):
        app_lib._make_batch_fn(app_lib.DataConfig(kind="criteo"))
    odd = tmp_path / "day[1].txt"
    odd.write_text("".join(f"{i % 2} {i}:1 {i + 1}:1\n" for i in range(64)))
    keys, labels = app_lib._make_batch_fn(
        app_lib.DataConfig(kind="libsvm", path=str(odd), batch_size=16))()
    assert keys.shape[0] == 16 and labels.shape == (16,)


@pytest.mark.parametrize("name", ["sp_lm", "sptp_lm"])
def test_long_context_apps_raise_naming_step_9(name, monkeypatch):
    """The sequence-parallel LMs run from their config: the port's trainer,
    started from the JAX app trainer's initial weights (seed 0, the dense
    twin's init), gives the JAX app's losses at 1e-4 on the same stream;
    the knobs (``seq``, the mesh) are the JAX app's where the world allows
    (sp is the world's size: 1 here, 8 virtual devices there)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from parameter_server_tpu.models import transformer as jtfm
    from parameter_server_tpu_torch.convert import placed_from_numpy, transformer_from_numpy
    from parameter_server_tpu_torch.parallel import sp_fsdp, sp_lm

    def cfg_of(pkg):
        return pkg.AppConfig(
            app=name,
            table=pkg.TableConfig(name="emb", rows=256, dim=1,
                                  optimizer=pkg.OptimizerConfig(kind="adagrad")),
            data=pkg.DataConfig(kind="synthetic", key_space=256, nnz=1, batch_size=512),
            steps=2,
        )

    jcfg = cfg_of(japp)
    model_cfg, seq, _ = japp._sp_app_knobs(jcfg, 8)
    params = jax.tree.map(np.asarray, jtfm.Transformer(
        dataclasses.replace(model_cfg, attn_impl="dense")).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    module, cls = (sp_lm, "SpLMTrainer") if name == "sp_lm" else (sp_fsdp, "SpTpLMTrainer")
    base = getattr(module, cls)

    class FromJax(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            if name == "sp_lm":
                transformer_from_numpy(self.model, params)
            else:
                placed_from_numpy(self, params)

    monkeypatch.setattr(module, cls, FromJax)
    ours = app_lib.create(cfg_of(app_lib), device=CPU)()
    theirs = japp.create(jcfg)()
    assert ours["seq"] == theirs["seq"] == seq and ours["steps"] == 2
    if name == "sptp_lm":
        assert ours["mesh"] == {"sp": 1, "model": 1}
    np.testing.assert_allclose(ours["losses"], theirs["losses"], rtol=1e-4)


def test_llama_hybrid_app_runs_from_config():
    cfg = app_lib.AppConfig(
        app="llama_hybrid",
        table=TableConfig(name="emb", rows=256, dim=1,
                          optimizer=OptimizerConfig(kind="adagrad", learning_rate=0.05)),
        data=app_lib.DataConfig(kind="synthetic", key_space=256, seed=0),
        topology=TopologyConfig(num_servers=2),
        steps=3,
    )
    out = app_lib.create(cfg, device=CPU)()
    assert out["steps"] == 3 and np.all(np.isfinite(out["losses"]))


def test_registry_equals_the_jax_registry():
    assert app_lib.registered_apps() == japp.registered_apps()


def _subcommands(parser):
    (action,) = [a for a in parser._actions if isinstance(a, argparse._SubParsersAction)]
    return action.choices


def test_cli_subcommands_equal_the_jax_ones():
    ours, theirs = _subcommands(cli.build_parser()), _subcommands(jcli.build_parser())
    assert sorted(ours) == sorted(theirs)
    for name, sub in theirs.items():
        want = {s for a in sub._actions for s in a.option_strings}
        got = {s for a in ours[name]._actions for s in a.option_strings}
        assert want <= got, (name, want - got)
    # psx launch-hybrid runs: 2 hosts of 2 gloo ranks, SSP
    rc = cli.main(["launch-hybrid", "--no-bsp", "--device", "cpu", "--num-body", "2",
                   "--cpu-devices", "2", "--steps", "2"])
    assert rc == 0


def test_cli_launch_spmd_runs_two_hosts_on_the_cpu(capsys):
    """``psx launch-spmd --device cpu``: 2 hosts of 2 gloo ranks on a (2, 2)
    mesh, a few steps; rc 0 and the JAX command's result keys."""
    rc = cli.main(["launch-spmd", "--device", "cpu", "--num-procs", "2", "--cpu-devices", "2",
                   "--steps", "3", "--rows", "1024", "--global-batch", "64"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, out
    assert sorted(out) == ["final_loss", "first_loss", "returncodes"]
    assert out["returncodes"] == [0, 0]
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["final_loss"])


def test_cli_launch_spmd_on_the_card_is_one_host(monkeypatch, capsys):
    """On the card every host would start on this machine, so ``psx
    launch-spmd`` defaults to one host of every card and a data axis of 1;
    with ``--device cpu`` it keeps the JAX command's 2 hosts on data 2."""
    from parameter_server_tpu_torch import launch_spmd as launch_lib

    calls = []

    def fake(**kw):
        calls.append(kw)
        return {"returncodes": [0] * kw["num_procs"], "losses": {0: [0.7, 0.6]}}

    monkeypatch.setattr(launch_lib, "launch_spmd", fake)
    assert cli.main(["launch-spmd"]) == 0
    assert cli.main(["launch-spmd", "--device", "cpu"]) == 0
    capsys.readouterr()
    assert [(c["device"], c["num_procs"], c["mesh_data"]) for c in calls] == [
        ("cuda", 1, 1), ("cpu", 2, 2)]


def test_entry_points_default_to_the_card():
    param = inspect.signature(app_lib.create).parameters["device"]
    assert param.default == "cuda" and param.kind is inspect.Parameter.KEYWORD_ONLY
    tree = ast.parse(inspect.getsource(cli))
    defaults = [k.value.value for c in ast.walk(tree) if isinstance(c, ast.Call)
                and getattr(c.func, "attr", None) == "add_argument"
                and c.args and getattr(c.args[0], "value", None) == "--device"
                for k in c.keywords if k.arg == "default"]
    assert defaults == ["cuda"]
    for sub in ("run", "launch", "launch-spmd", "launch-hybrid"):
        ns = cli.build_parser().parse_args([sub] + (["x.json"] if sub == "run" else []))
        assert ns.device == "cuda"
