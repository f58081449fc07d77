"""War-game plane: declarative fleet scenarios, a deterministic
simulated-fleet runner, and the SLO-breach-minutes scorecard.

- :mod:`parameter_server_tpu_torch.scenario.dsl` — seeded scenario specs
  (phases with load curves, fault injections) compiled to an absolute-time
  event schedule;
- :mod:`parameter_server_tpu_torch.scenario.runner` — drives a 50-200-node
  simulated fleet over a real ``ChaosVan(LoopbackVan())`` wire through the
  schedule, autoscaler closed-loop on live telemetry;
- :mod:`parameter_server_tpu_torch.scenario.scorecard` — integrates the breach
  timeline into SLO-breach-minutes and renders the JSON scorecard + the
  human incident report (postmortem chain + critpath attribution).

The port's copy of ``parameter_server_tpu/scenario/`` (host code over the
port's ``ChaosVan``, ``LoopbackVan``, telemetry, ``SloEngine`` and
``AutoscalePolicy``): the same schedules and, for the same seed, the same
scorecard.  Unlike the JAX scorecard, a repo tool the incident report needs
(``tools/postmortem.py``, ``tools/critpath.py``) that fails to import
raises instead of dropping its section.
"""

from parameter_server_tpu_torch.scenario.dsl import (  # noqa: F401
    Fault,
    LoadCurve,
    Phase,
    Scenario,
    compile_schedule,
    drill_scenario,
    reference_scenario,
    smoke_scenario,
    wargame_plane_specs,
)
from parameter_server_tpu_torch.scenario.runner import ScenarioRunner  # noqa: F401
from parameter_server_tpu_torch.scenario.scorecard import (  # noqa: F401
    build_scorecard,
    render_report,
)
