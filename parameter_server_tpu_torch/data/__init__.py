"""Host data input pipeline: parsers, readers, synthetic generators and the
device prefetch pipeline.

Reference: ``src/data/`` (text parsers, SlotReader, StreamReader) [U].  Text
parsing runs in native C++ (``native/src/textparse.cc``) with bit-identical
numpy fallbacks; the exports are the JAX package's ``data/__init__.py``'s.
"""

from parameter_server_tpu_torch.data.prefetch import PrefetchPipeline
from parameter_server_tpu_torch.data.reader import (
    SlotReader,
    StreamReader,
    criteo_log_transform,
)
from parameter_server_tpu_torch.data.synthetic import SyntheticCTR, SyntheticDLRM
from parameter_server_tpu_torch.data.text import (
    CSRBatch,
    parse_criteo,
    parse_libsvm,
    write_libsvm,
)

__all__ = [
    "CSRBatch",
    "PrefetchPipeline",
    "SlotReader",
    "StreamReader",
    "SyntheticCTR",
    "SyntheticDLRM",
    "criteo_log_transform",
    "parse_criteo",
    "parse_libsvm",
    "write_libsvm",
]
