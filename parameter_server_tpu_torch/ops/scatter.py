"""Device-side sparse table primitives: row gather, scatter-set, scatter-add
and the fused push apply.

Torch counterpart of ``parameter_server_tpu/ops/scatter.py``.  Each of its
four Pallas kernels is a hand-written CUDA kernel here
(``csrc/scatter_kernels.cu``, built by ``ops/_build.py``), and each kernel has
a plain PyTorch version in this module.  The dispatchers pick by where the
table lies and by nothing else: a CUDA tensor always goes to the kernel (or
the wrapper raises), a CPU tensor always goes to the plain version.  There is
no fallback from one to the other, and no option that selects the plain
version on the card.

Unlike the Pallas kernels, the CUDA kernels take any row width (``dim = 1``
for the LR table) and any number of ids.  Tables are updated in place; the
dispatchers return the same tensors for symmetry with the JAX API.

Every kernel wrapper counts its launches in :data:`LAUNCHES`, so a run can
show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import torch

from parameter_server_tpu_torch.ops import _build

#: launches per kernel wrapper; incremented only where a kernel is launched
LAUNCHES: Dict[str, int] = {"apply": 0, "gather": 0, "scatter_set": 0, "scatter_add": 0}
_launch_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    with _launch_lock:
        return dict(LAUNCHES)


def segment_combine(
    values: torch.Tensor, inverse: torch.Tensor, num_rows: int
) -> torch.Tensor:
    """Sum per-position ``values`` rows into their unique-row slots.

    ``inverse`` maps each position to a slot in ``[0, num_rows)``; slots no
    position maps to receive zero (the pad contract).  Deterministic on every
    device: a stable sort groups each slot's positions in position order and
    ``segment_reduce`` sums each group sequentially, so the float order never
    changes from run to run (``index_add_`` on CUDA uses atomics and does).
    """
    inverse = inverse.reshape(-1).long()
    order = torch.sort(inverse, stable=True).indices
    counts = torch.bincount(inverse, minlength=num_rows)
    return torch.segment_reduce(values[order], "sum", lengths=counts, axis=0)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the reference the kernels are
# held against on the card)
# ---------------------------------------------------------------------------


def gather_rows_torch(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return torch.index_select(table, 0, ids.long())


def scatter_update_rows_torch(
    table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor
) -> torch.Tensor:
    return table.index_put_((ids.long(),), rows)


def scatter_add_rows_torch(
    table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor
) -> torch.Tensor:
    return table.index_put_((ids.long(),), rows, accumulate=True)


def apply_rows_torch(value, state, ids, grads, optimizer):
    """Gather -> ``optimizer.apply`` -> scatter-update, in place."""
    v_rows = gather_rows_torch(value, ids)
    s_rows = {k: gather_rows_torch(v, ids) for k, v in state.items()}
    new_v, new_s = optimizer.apply(v_rows, s_rows, grads)
    scatter_update_rows_torch(value, ids, new_v)
    for k in state:
        scatter_update_rows_torch(state[k], ids, new_s[k])
    return value, state


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _check_table(name: str, table: torch.Tensor) -> None:
    if not table.is_cuda:
        raise ValueError(f"{name}: table must be a CUDA tensor, got {table.device}")
    if table.dtype != torch.float32 or table.dim() != 2:
        raise ValueError(
            f"{name}: table must be 2-D float32, got {tuple(table.shape)} {table.dtype}"
        )
    if not table.is_contiguous():
        raise ValueError(f"{name}: table must be contiguous")


def _check_ids(name: str, ids: torch.Tensor, device: torch.device) -> int:
    if ids.device != device:
        raise ValueError(f"{name}: ids on {ids.device}, table on {device}")
    if ids.dtype != torch.int32 or ids.dim() != 1 or not ids.is_contiguous():
        raise ValueError(
            f"{name}: ids must be contiguous 1-D int32, got "
            f"{tuple(ids.shape)} {ids.dtype}"
        )
    return int(ids.shape[0])


def _check_rows(name: str, rows: torch.Tensor, n: int, table: torch.Tensor) -> None:
    if rows.device != table.device:
        raise ValueError(f"{name}: rows on {rows.device}, table on {table.device}")
    if rows.dtype != torch.float32 or tuple(rows.shape) != (n, table.shape[1]):
        raise ValueError(
            f"{name}: rows must be float32 {(n, table.shape[1])}, got "
            f"{tuple(rows.shape)} {rows.dtype}"
        )
    if not rows.is_contiguous():
        raise ValueError(f"{name}: rows must be contiguous")


def _launch(name: str, fn, device: torch.device, *args) -> None:
    """Call one C entry point on the current stream of ``device``; raise on a
    nonzero ``cudaGetLastError``; count the launch."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"CUDA {name} kernel launch failed: cudaError {err}")
    with _launch_lock:
        LAUNCHES[name] += 1


# Replaces _gather_kernel / _pallas_gather (parameter_server_tpu/ops/
# scatter.py:157, :167).  Bound: bytes, n*4 ids + n*dim*4 read + n*dim*4
# written, over 3.35 TB/s.  Design: one thread per element, so a dim = 1
# gather is 32 ids per warp and wide rows read coalesced.
def cuda_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    _check_table("gather", table)
    n = _check_ids("gather", ids, table.device)
    out = torch.empty((n, table.shape[1]), dtype=table.dtype, device=table.device)
    if n and table.shape[1]:
        lib = _build.load_library()
        _launch(
            "gather", lib.ps_gather, table.device,
            table.data_ptr(), ids.data_ptr(), out.data_ptr(),
            n, table.shape[1], table.shape[0],
        )
    return out


# Replaces _scatter_set_kernel / _pallas_scatter_set (:307, :322).  Bound:
# bytes, n*4 ids + n*dim*4 read + n*dim*4 written.  Write-only, one thread per
# element; repeated ids are allowed only with identical rows (trash pads).
def cuda_scatter_set(
    table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor
) -> torch.Tensor:
    _check_table("scatter_set", table)
    n = _check_ids("scatter_set", ids, table.device)
    _check_rows("scatter_set", rows, n, table)
    if n and table.shape[1]:
        lib = _build.load_library()
        _launch(
            "scatter_set", lib.ps_scatter_set, table.device,
            table.data_ptr(), ids.data_ptr(), rows.data_ptr(),
            n, table.shape[1], table.shape[0],
        )
    return table


# Replaces _scatter_add_kernel / _pallas_scatter_add (:202, :264).  Bound:
# bytes, n*4 ids + n*dim*4 rows read + n*dim*4 table read + n*dim*4 written.
# Plain read-modify-write per element (no atomics): ids must be unique, pads
# at the trash row carry zeros, so their races rewrite identical bytes.
def cuda_scatter_add(
    table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor
) -> torch.Tensor:
    _check_table("scatter_add", table)
    n = _check_ids("scatter_add", ids, table.device)
    _check_rows("scatter_add", rows, n, table)
    if n and table.shape[1]:
        lib = _build.load_library()
        _launch(
            "scatter_add", lib.ps_scatter_add, table.device,
            table.data_ptr(), ids.data_ptr(), rows.data_ptr(),
            n, table.shape[1], table.shape[0],
        )
    return table


# Replaces _apply_kernel / _pallas_apply (:385, :467).  Bound: bytes,
# n*4 ids + n*dim*4 grads + 2*(1+S)*n*dim*4 for the value and S state planes
# read and written once.  One launch gathers, steps and writes all 1+S planes
# per element in registers; one template specialisation per optimizer,
# hyperparameters as kernel arguments.
def cuda_apply(
    value: torch.Tensor,
    state: Dict[str, torch.Tensor],
    ids: torch.Tensor,
    grads: torch.Tensor,
    optimizer,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    _check_table("apply", value)
    n = _check_ids("apply", ids, value.device)
    _check_rows("apply", grads, n, value)
    names = optimizer.state_names()
    if set(names) != set(state) or len(names) > 3:
        raise ValueError(f"apply: state planes {sorted(state)} != {list(names)}")
    planes = [state[k] for k in names]
    for p in planes:
        _check_table("apply", p)
        if p.shape != value.shape or p.device != value.device:
            raise ValueError("apply: state planes must match the value table")
    ptrs = [p.data_ptr() for p in planes] + [None] * (3 - len(planes))
    cfg = optimizer.cfg
    if n and value.shape[1]:
        lib = _build.load_library()
        _launch(
            "apply", lib.ps_apply, value.device,
            optimizer.kernel_kind, value.data_ptr(), *ptrs,
            ids.data_ptr(), grads.data_ptr(),
            n, value.shape[1], value.shape[0],
            cfg.learning_rate, cfg.l1, cfg.l2, cfg.eps,
            cfg.beta1, 1 - cfg.beta1, cfg.beta2, 1 - cfg.beta2,
            cfg.ftrl_alpha, cfg.ftrl_beta,
        )
    return value, state


# ---------------------------------------------------------------------------
# Public dispatchers
# ---------------------------------------------------------------------------


def _on_card(table: torch.Tensor, what: str) -> bool:
    if table.is_cuda:
        return True
    if table.device.type == "cpu":
        return False
    raise ValueError(f"{what}: unsupported device {table.device}")


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (the Pull gather)."""
    if _on_card(table, "gather_rows"):
        return cuda_gather(table, ids)
    return gather_rows_torch(table, ids)


def scatter_add_rows(
    table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor
) -> torch.Tensor:
    """``table[ids] += rows`` in place; ids unique except trash pads."""
    if _on_card(table, "scatter_add_rows"):
        return cuda_scatter_add(table, ids, rows)
    return scatter_add_rows_torch(table, ids, rows)


def scatter_update_rows(
    table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor
) -> torch.Tensor:
    """``table[ids] = rows`` in place (the three-pass push write-back)."""
    if _on_card(table, "scatter_update_rows"):
        return cuda_scatter_set(table, ids, rows)
    return scatter_update_rows_torch(table, ids, rows)


def apply_rows(value, state, ids, grads, optimizer):
    """Fused push apply: gather -> ``optimizer`` rule -> scatter, in place.

    ``ids`` must be unique real rows; pads all point at the trash row, which
    the caller re-zeros afterwards.
    """
    if _on_card(value, "apply_rows"):
        return cuda_apply(value, state, ids, grads, optimizer)
    return apply_rows_torch(value, state, ids, grads, optimizer)


def combine_and_scatter_add(
    table: torch.Tensor,
    ids: torch.Tensor,
    inverse: torch.Tensor,
    values: torch.Tensor,
    num_rows: int,
    unique_ids: bool = False,
) -> torch.Tensor:
    """Duplicate pre-combine + scatter-add (the full push-add), in place.

    ``inverse`` combines duplicates per unique key, but distinct keys may
    share a row slot once a hashing localizer collides; unless the caller
    vouches for ``unique_ids``, colliding slots are merged first (sort-based,
    deterministic) so the scatter-add kernel only ever sees unique ids.
    """
    combined = segment_combine(values, inverse, num_rows)
    if not unique_ids:
        ids, slot_inv = torch.unique(ids, return_inverse=True)
        combined = segment_combine(combined, slot_inv, int(ids.shape[0]))
        ids = ids.to(torch.int32)
    return scatter_add_rows(table, ids.contiguous(), combined.contiguous())
