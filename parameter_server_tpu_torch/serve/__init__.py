"""Read-heavy serving plane: admission control (:mod:`.admission`) and the
open-loop synthetic load generator (:mod:`.loadgen`).  The hot-row cache is
a KV concern and lives in ``kv/cache.py``.

Counterpart of ``parameter_server_tpu/serve/``.
"""

from parameter_server_tpu_torch.serve.admission import AdmissionController, ShedError
from parameter_server_tpu_torch.serve.loadgen import LoadGenerator, LoadReport

__all__ = [
    "AdmissionController",
    "ShedError",
    "LoadGenerator",
    "LoadReport",
]
