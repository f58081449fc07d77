"""The port's memory-feasibility layer against the JAX package's, at test
sizes.

Twin of the cases of ``tests/test_feasibility.py`` that ``test_torch_tp.py``
does not already cover (``:29`` the chunked loss, ``:55`` the trunk seam,
``:102`` the analysis under each ``fsdp`` knob) and of
``tests/test_dlrm.py:153`` (the billion-row proof at test scale, never
materialised).  The JAX module reads XLA's memory analysis of an AOT
compile; the port runs the real step as rank 0 of a ``fake`` world on fake
tensors under its live-bytes tracker (``parallel/feasibility.py``).  A fake
world needs a process without a world, so every traced case runs in one
child process (``torch_world.feasibility_cases``) and the cases read its
results.  The fake trace and a real CPU step of the same tiny body step
under the same tracker agree within 1%: the trace sees every allocation an
operator makes.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_tpu.models import transformer as jtfm
from parameter_server_tpu_torch.convert import transformer_from_numpy
from parameter_server_tpu_torch.models import transformer as tfm

HERE = os.path.dirname(os.path.abspath(__file__))
BUDGET = 16 * 10**9


@pytest.fixture(scope="module")
def traced():
    code = ("import json, torch_world; "
            f"print(json.dumps(torch_world.feasibility_cases({BUDGET})))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.dirname(HERE), HERE]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=HERE, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_chunked_loss_matches_full_logits_values_and_grads():
    """The port's chunked fused-head loss equals JAX's full-logits
    ``causal_lm_loss`` in value (every chunk size, dividing or not, and past
    S) and in its gradients."""
    rng = np.random.default_rng(0)
    B, S, d, V = 2, 33, 16, 50
    hidden = rng.normal(size=(B, S, d)).astype(np.float32)
    head = rng.normal(size=(d, V)).astype(np.float32)
    tokens = rng.integers(0, V, size=(B, S)).astype(np.int32)
    ref = float(jtfm.causal_lm_loss(jnp.einsum("bsd,dv->bsv", hidden, head), tokens))
    h, w = torch.from_numpy(hidden), torch.from_numpy(head)
    t = torch.from_numpy(tokens).long()
    for chunk in (1, 7, 32, 64):
        with torch.no_grad():
            got = float(tfm.chunked_causal_lm_loss(h, w, t, chunk))
        np.testing.assert_allclose(got, ref, rtol=2e-6)
    g_ref = jax.grad(lambda a, b: jtfm.causal_lm_loss(jnp.einsum("bsd,dv->bsv", a, b),
                                                       tokens), argnums=(0, 1))(hidden, head)
    hg, wg = h.clone().requires_grad_(True), w.clone().requires_grad_(True)
    tfm.chunked_causal_lm_loss(hg, wg, t, 8).backward()
    for a, b in zip(g_ref, (hg.grad, wg.grad)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-6)


def test_trunk_params_are_body_params_minus_head():
    """A JAX ``TransformerBody``'s parameters less ``lm_head`` run in the
    port's ``TransformerTrunk``, and trunk hidden @ head is JAX's body
    logits."""
    cfg_kw = dict(causal=True, tie_embeddings=False, d_model=64, n_layers=2, n_heads=4,
                  n_kv_heads=4)
    x = np.random.default_rng(1).normal(size=(2, 8, 64)).astype(np.float32)
    jbody = jtfm.TransformerBody(jtfm.tiny_config(**cfg_kw))
    params = jax.tree.map(np.asarray, jbody.init(jax.random.PRNGKey(0), x)["params"])
    want = np.asarray(jbody.apply({"params": params}, x))
    trunk = tfm.TransformerTrunk(tfm.tiny_config(**cfg_kw), device="cpu")
    transformer_from_numpy(trunk, {k: v for k, v in params.items() if k != "lm_head"})
    with torch.no_grad():
        hidden = trunk(torch.from_numpy(x))
        head = torch.from_numpy(params["lm_head"]["kernel"].copy())
        got = torch.einsum("bsd,dv->bsv", hidden, head)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("fsdp", ["none", "state"])
def test_memory_analysis_runs_and_knobs_reduce_memory(traced, fsdp):
    """The body step's trace runs on a fake (2, 4) world and reports its
    knobs; with the moments split over data the train state a rank holds
    (the JAX argument bytes: parameters and moments) shrinks."""
    r = traced["body"][fsdp]
    assert r["peak_bytes"] > 0 and r["n_body_params"] > 0 and r["method"] == "fake_trace"
    assert r["fsdp"] == fsdp and r["loss_chunk"] == 8
    assert r["peak_bytes"] == r["resident_bytes"] + r["step_bytes"]
    assert r["fits_card"] is True and r["budget_bytes"] == BUDGET
    if fsdp == "state":
        assert r["state_bytes"] < traced["body"]["none"]["state_bytes"]
        # and with the parameters split over data too, the rank holds less still
        assert traced["body"]["full"]["state_bytes"] < r["state_bytes"]


def test_dlrm_feasibility_fake_trace_never_materializes(traced):
    """The billion-row path at test scale: the real ``SpmdDLRMTrainer`` made
    and stepped on a fake (1, 8) world; the table planes dominate, the
    step's own bytes are O(batch), and no real storage was made."""
    out = traced["dlrm"]
    assert out["table_bytes_per_device"] == 2 * ((1 << 18) + 8) * 16 * 4 // 8
    assert out["peak_bytes"] >= out["table_bytes_per_device"]
    assert out["step_bytes"] < out["table_bytes_per_device"]
    assert out["fits_card"] is True
    assert out["table_fake"] is True and out["real_bytes_max"] < out["table_bytes_per_device"]
    assert out["slots"] == 1 << 10


def test_pp_vs_dp_pipeline_rank_holds_less(traced):
    """A pipeline rank holds 1/S of the stack: its peak is under one DP
    rank's, which holds the whole model and its AdamW state."""
    out = traced["pp_vs_dp"]
    assert 0 < out["pp"]["peak_bytes"] < out["dp"]["peak_bytes"]
    assert out["pp"]["state_bytes"] < out["dp"]["state_bytes"]
    assert out["pp_beats_dp"] is False  # both fit the test budget


def test_pp_tp_rank_holds_its_share_of_the_stack(traced):
    """PP x TP: a rank's stage blocks are 1/(S x TP) of the stack (the
    norms' scales, replicated over model, add under 1%)."""
    out = traced["pp_tp"]
    share = (out["n_params"] - 512 * 64 * 2 - 64) * 4 // (2 * 2)
    assert share <= out["stack_bytes"] <= 1.01 * share, (out["stack_bytes"], share)
    assert out["devices"] == 4 and out["peak_bytes"] > out["stack_bytes"]


def test_fake_trace_matches_a_real_cpu_step(traced):
    """The fake trace of a tiny body step and the same step on real CPU
    tensors, both under the package's tracker, agree within 1%."""
    fake, real = traced["calibration"]["fake"], traced["calibration"]["real"]
    for key in ("resident_bytes", "step_bytes", "peak_bytes", "state_bytes"):
        assert abs(fake[key] - real[key]) <= 0.01 * real[key], (key, fake[key], real[key])
