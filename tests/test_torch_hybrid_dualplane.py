"""The port's dual-plane config #5 in its deployment shape, on the CPU.

Twin of ``tests/test_hybrid_dualplane.py``: KVServers on ``TcpVan`` in their
own OS processes (filters on) and a body on a ``(data 2, model 4)`` mesh
across 2 hosts of 4 gloo ranks (``launch_hybrid(device="cpu")``; 11
processes a launch: scheduler, 2 servers, 8 ranks).  The JAX in-process
reference runs its body on 8 virtual devices of one process, which the port
has no counterpart of, so the launch is held to the port's in-process
one-device hybrid over a ``LoopbackVan`` on the same seeds and batch stream
(rtol 1e-4 / atol 1e-6, the JAX test's bound) — the trainer that
``tests/test_torch_hybrid.py::test_steps_match_the_jax_trainer`` holds to
the JAX trainer.  The Van byte counters must show the embedding traffic
crossing sockets on each host (> 1000 bytes each way).
"""

import numpy as np
import pytest

from parameter_server_tpu_torch import native

if native.load("tcpvan") is None:  # pragma: no cover
    pytest.skip("no native toolchain for tcpvan", allow_module_level=True)

# heads % 4 == 0: the TP rules split attention heads over the 4-way model axis
CFG = dict(
    vocab=256, layers=2, heads=4, d_model=32, d_ff=64, seq=16,
    global_batch=8, steps=4, lr=1e-3, emb_lr=0.05, seed=0,
)
LAUNCH = dict(num_body=2, cpu_devices=4, num_servers=2, run_timeout=240.0, device="cpu")


def _inprocess_reference() -> list:
    """The one-device hybrid on the same seeds and batch stream, over a
    LoopbackVan with 2 servers (an sgd embedding optimizer)."""
    from parameter_server_tpu_torch.core.postoffice import Postoffice
    from parameter_server_tpu_torch.core.van import LoopbackVan
    from parameter_server_tpu_torch.kv.server import KVServer
    from parameter_server_tpu_torch.kv.worker import KVWorker
    from parameter_server_tpu_torch.learner import hybrid
    from parameter_server_tpu_torch.models import transformer as tfm

    cfg = tfm.TransformerConfig(
        vocab_size=CFG["vocab"], n_layers=CFG["layers"], n_heads=CFG["heads"],
        d_model=CFG["d_model"], d_ff=CFG["d_ff"], max_seq=CFG["seq"], causal=True,
        tie_embeddings=False,
    )
    van = LoopbackVan()
    servers = []
    try:
        tables = {"emb": hybrid.embedding_table_cfg(cfg, learning_rate=CFG["emb_lr"],
                                                    optimizer="sgd")}
        servers = [KVServer(Postoffice(f"S{s}", van), tables, s, 2, device="cpu")
                   for s in range(2)]
        worker = KVWorker(Postoffice("W0", van), tables, 2,
                          localizers=hybrid.embedding_localizers(cfg), device="cpu")
        tr = hybrid.HybridLMTrainer(cfg, worker, learning_rate=CFG["lr"], max_delay=0,
                                    seed=CFG["seed"], device="cpu")
        rng = np.random.default_rng(CFG["seed"] + 1)
        batches = [rng.integers(0, cfg.vocab_size, size=(CFG["global_batch"], CFG["seq"]))
                   .astype(np.int32) for _ in range(CFG["steps"] + 1)]
        losses = [tr.step(batches[s]) for s in range(CFG["steps"])]
        tr.drain()
        return losses
    finally:
        van.close()
        for s in servers:
            if s.ledger is not None:
                s.ledger.close()


def test_dualplane_matches_inprocess_and_crosses_sockets():
    from parameter_server_tpu_torch.launch_hybrid import launch_hybrid

    reference = _inprocess_reference()
    result = launch_hybrid(
        emb_optimizer="sgd",  # a linear update: two half-batch pushes == one
        bsp=True,
        # LOSSLESS wire codecs for the parity run: int8 would quantize the
        # pulled rows and pushed gradients and break loss equality by design
        filters="key_caching+zlib",
        **LAUNCH, **CFG,
    )
    assert result["returncodes"] == [0] * 5, result
    assert result["rank_returncodes"] == [0] * 8, result
    assert sorted(result["losses"]) == [0, 1]
    # the loss is the global batch's on every rank: both hosts report it
    np.testing.assert_allclose(result["losses"][0], result["losses"][1], rtol=1e-6)
    # the collectives' and the two half pushes' summation orders
    np.testing.assert_allclose(result["losses"][0], reference, rtol=1e-4, atol=1e-6)
    # the embedding traffic really crossed process boundaries
    for p in (0, 1):
        assert result["wire"][p]["sent"] > 1000, result["wire"]
        assert result["wire"][p]["recv"] > 1000, result["wire"]
        oh = result["filter_overhead"][p]
        assert oh is not None and oh["encode_calls"] > 0
    # one worker a host: each server saw 2 pushes a step (one a host)
    for srv in result["servers"].values():
        assert srv["device"] == "cpu" and srv["pushes"] == 2 * CFG["steps"], srv


def test_dualplane_overlap_mode_runs():
    """--no-bsp: prefetched pulls + max_delay pushes in flight (SSP).  Exact
    parity is impossible under staleness, but the trajectory stays within
    0.15 nats of the BSP twin's mean on the same seeded stream, and step 0
    (before any staleness) is the same."""
    from parameter_server_tpu_torch.launch_hybrid import launch_hybrid

    common = dict(LAUNCH, emb_optimizer="adagrad", max_delay=2, filters="full",
                  **dict(CFG, steps=8))
    result = launch_hybrid(bsp=False, **common)
    assert result["returncodes"] == [0] * 5, result
    for p in (0, 1):
        assert np.all(np.isfinite(result["losses"][p])), result["losses"]
        assert result["wire"][p]["sent"] > 1000
    twin = launch_hybrid(bsp=True, **common)
    assert twin["returncodes"] == [0] * 5, twin
    ssp = np.asarray(result["losses"][0], np.float64)
    bsp = np.asarray(twin["losses"][0], np.float64)
    np.testing.assert_allclose(ssp[0], bsp[0], rtol=1e-4)
    assert abs(ssp.mean() - bsp.mean()) <= 0.15, (ssp, bsp)
