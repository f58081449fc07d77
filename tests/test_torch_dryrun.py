"""The port's multi-rank dry run, ``dryrun.dryrun_multichip``, on 4 gloo
ranks: the twin of ``__graft_entry__.py::dryrun_multichip`` run as the JAX
package runs it on 4 virtual CPU devices.

Every section JAX runs at n = 4 runs and prints its ``dryrun ... OK`` line,
in JAX's order, with finite losses: the sharded PS-LR table, the DP x TP
transformer, ring attention against full attention, the SP and SP x TP
trainers, the pipeline under GPipe and 1F1B (one step from the same seed:
the same loss), config #5's hybrid over a LoopbackVan, the 2-host
``launch_spmd`` and the dual plane's ``launch_hybrid``.  None is skipped at
n = 4.
"""

import numpy as np

from parameter_server_tpu_torch.dryrun import dryrun_multichip

ORDER = ["PS-LR", "LM DPxTP", "ring-attention", "SP-LM trainer", "SPxTP trainer", "PP",
         "hybrid", "multihost", "dual-plane"]


def test_dryrun_multichip_four_ranks_on_the_cpu():
    out = dryrun_multichip(4, device="cpu", timeout=240.0)
    assert out["backend"] == "gloo" and out["rank_devices"] == ["cpu"] * 4
    assert out["skipped"] == []
    heads = [line.split(" OK")[0].removeprefix("dryrun ") for line in out["lines"]]
    assert heads == ORDER, out["lines"]
    assert out["section_devices"] == dict.fromkeys(
        ["ring_attention", "ps_lr", "lm_dp_tp", "sp_lm", "sptp", "pp", "hybrid", "multihost",
         "dual_plane"], "cpu")
    for key, value in out["losses"].items():
        assert np.isfinite(value).all(), (key, value)
    gpipe, one_f_one_b = out["losses"]["pp"]
    np.testing.assert_allclose(one_f_one_b, gpipe, rtol=2e-5)
    # on the CPU every kernel wrapper takes its plain version: no launch
    assert set(out["launches"].values()) == {0}
