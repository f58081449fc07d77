"""Shared fixtures of the benchmark's tests: tiny versions of each cell's
configuration and workload (same keys, toy sizes) and the card check."""

from __future__ import annotations

import copy
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: toy sizes a CPU run holds, by driver (the widths the code paths need)
TINY = {
    "lr_local": ({"table_rows": 4096},
                 {"batch": 64, "nnz": 5, "key_space": 1 << 16, "block": 4}),
    "hybrid": ({"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
                "intermediate_size": 96, "vocab_size": 256, "num_hidden_layers": 2},
               {"batch": 2, "seq": 16, "pool_batches": 8}),
}


@pytest.fixture
def card():
    """Skips a test that needs an NVIDIA card where none is visible."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA); this machine has none")
    return torch.device("cuda")


def tiny_cell(name: str):
    """(spec, cell, config, workload) of cell ``name``, cut to toy sizes."""
    from psbench import run

    spec = run.bench_spec()
    cell, cfg, workload = run.load_cell(spec, name)
    cfg, workload = copy.deepcopy(cfg), copy.deepcopy(workload)
    over_cfg, over_traffic = TINY[workload["driver"]]
    cfg.update(over_cfg)
    workload["traffic"].update(over_traffic)
    return spec, cell, cfg, workload


@pytest.fixture
def tiny():
    """:func:`tiny_cell`, for tests to call with a cell's name."""
    return tiny_cell
