"""Parity of the port's optimizer rules (parameter_server_tpu_torch/kv/optim.py)
with the JAX package's, on the CPU: ``apply`` over value + state rows and
``pull_weights``, float32 allclose at rtol = atol = 1e-5."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from parameter_server_tpu.config import OptimizerConfig as JaxOptimizerConfig
from parameter_server_tpu.kv.optim import make_optimizer as jax_make_optimizer
from parameter_server_tpu_torch.config import OptimizerConfig
from parameter_server_tpu_torch.kv.optim import make_optimizer

TOL = dict(rtol=1e-5, atol=1e-5)

CASES = {
    "sgd": dict(kind="sgd", learning_rate=0.1),
    "sgd-l2": dict(kind="sgd", learning_rate=0.1, l2=0.05),
    "adagrad": dict(kind="adagrad", learning_rate=0.05),
    "adagrad-l1-l2": dict(kind="adagrad", learning_rate=0.05, l1=0.02, l2=0.01),
    "adam": dict(kind="adam", learning_rate=0.01),
    "adam-l2": dict(kind="adam", learning_rate=0.01, l2=0.1, beta1=0.8, beta2=0.99),
    "ftrl": dict(kind="ftrl"),
    "ftrl-l1-l2": dict(kind="ftrl", l1=0.5, l2=0.1, ftrl_alpha=0.1, ftrl_beta=0.5),
}


def _rows(names, seed):
    rng = np.random.default_rng(seed)
    value = rng.normal(size=(32, 4)).astype(np.float32)
    grad = rng.normal(size=(32, 4)).astype(np.float32)
    state = {k: np.abs(rng.normal(size=(32, 4))).astype(np.float32) for k in names}
    if "t" in state:  # per-row step counts are whole numbers
        state["t"] = np.floor(state["t"] * 4)
    return value, state, grad


@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_matches_jax(case):
    opt = make_optimizer(OptimizerConfig(**CASES[case]))
    jopt = jax_make_optimizer(JaxOptimizerConfig(**CASES[case]))
    assert opt.state_shapes() == jopt.state_shapes()
    assert opt.state_names() == jopt.state_names()
    value, state, grad = _rows(opt.state_shapes(), seed=len(case))
    for step in range(3):  # feed each side its own outputs back
        new_v, new_s = opt.apply(
            torch.from_numpy(value), {k: torch.from_numpy(v) for k, v in state.items()},
            torch.from_numpy(grad),
        )
        jv, js = jopt.apply(
            jnp.asarray(value), {k: jnp.asarray(v) for k, v in state.items()},
            jnp.asarray(grad),
        )
        np.testing.assert_allclose(new_v.numpy(), np.asarray(jv), **TOL)
        for k in state:
            np.testing.assert_allclose(new_s[k].numpy(), np.asarray(js[k]), **TOL)
        value, state = np.array(jv), {k: np.array(v) for k, v in js.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pull_weights_matches_jax(case):
    opt = make_optimizer(OptimizerConfig(**CASES[case]))
    jopt = jax_make_optimizer(JaxOptimizerConfig(**CASES[case]))
    value, state, _ = _rows(opt.state_shapes(), seed=100 + len(case))
    got = opt.pull_weights(
        torch.from_numpy(value), {k: torch.from_numpy(v) for k, v in state.items()}
    )
    want = jopt.pull_weights(
        jnp.asarray(value), {k: jnp.asarray(v) for k, v in state.items()}
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(OptimizerConfig(kind="lamb"))
