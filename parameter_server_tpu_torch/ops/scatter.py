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
from typing import Dict, List, Sequence, Tuple

import torch

from parameter_server_tpu_torch.ops import _build

#: launches per kernel wrapper; incremented only where a kernel is launched
LAUNCHES: Dict[str, int] = {"apply": 0, "gather": 0, "scatter_set": 0, "scatter_add": 0}
_launch_lock = threading.Lock()
#: planes one gather or scatter-set launch takes (a value table and up to 3
#: state planes)
_MAX_PLANES = 4


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
    changes from run to run (a float ``index_add_`` on CUDA uses atomics and
    does).  No host sync: the slot counts are an integer ``index_add_`` of
    ones into a ``[num_rows]`` buffer (integer sums are order-free) where
    ``torch.bincount`` would read its maximum back, and ``unsafe=True``
    skips ``segment_reduce``'s read-back checks of what the counts
    guarantee (none negative, summing to the position count).
    """
    inverse = inverse.reshape(-1).long()
    order = torch.sort(inverse, stable=True).indices
    counts = torch.zeros(num_rows, dtype=torch.int64, device=inverse.device)
    counts.index_add_(0, inverse, torch.ones_like(inverse))
    return torch.segment_reduce(
        torch.index_select(values, 0, order), "sum", lengths=counts, axis=0, unsafe=True
    )


def _merge_repeats(
    ids: torch.Tensor, rows: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unique ``ids`` (int32) and, for each, the sum of its ``rows``
    (deterministic, :func:`segment_combine`)."""
    uniq, inverse = torch.unique(ids, return_inverse=True)
    return uniq.to(torch.int32), segment_combine(rows, inverse, int(uniq.shape[0]))


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
    """Gather -> ``optimizer.apply`` -> scatter-update, in place.  Ids at the
    trash row (``value.shape[0] - 1``) write back what they gathered, so the
    trash row keeps its contents, as under the kernel."""
    v_rows = gather_rows_torch(value, ids)
    s_rows = {k: gather_rows_torch(v, ids) for k, v in state.items()}
    new_v, new_s = optimizer.apply(v_rows, s_rows, grads)
    pad = (ids == value.shape[0] - 1).unsqueeze(1)
    scatter_update_rows_torch(value, ids, torch.where(pad, v_rows, new_v))
    for k in state:
        scatter_update_rows_torch(state[k], ids, torch.where(pad, s_rows[k], new_s[k]))
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


def _check_plane_count(name: str, tables: Sequence[torch.Tensor]) -> None:
    if not 1 <= len(tables) <= _MAX_PLANES:
        raise ValueError(f"{name}: 1 to {_MAX_PLANES} planes, got {len(tables)}")


def _check_planes(name: str, tables: Sequence[torch.Tensor]) -> torch.Tensor:
    """1 to 4 contiguous float32 CUDA tables of one shape and device; returns
    the first."""
    _check_plane_count(name, tables)
    for t in tables:
        _check_table(name, t)
        if t.shape != tables[0].shape or t.device != tables[0].device:
            raise ValueError(f"{name}: planes must share one shape and device")
    return tables[0]


def _aligned(*tensors: torch.Tensor) -> bool:
    """Every tensor starts on a 16-byte boundary: the kernels may move rows,
    ids and gradients as float4 / int4 (else they take their scalar form)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


# Replaces _gather_kernel / _pallas_gather (parameter_server_tpu/ops/
# scatter.py:157, :167).  Bound: bytes, n*4 ids + P*n*dim*4 read + P*n*dim*4
# written for P planes, over 3.35 TB/s; at dim 1 one launch is ~10x that.
# Design: one launch gathers up to 4 planes that share the ids (the value and
# its state planes, which a pull reads together), reading each id once;
# float4 rows, several rows in flight per thread (csrc/scatter_kernels.cu).
def cuda_gather_planes(
    tables: Sequence[torch.Tensor], ids: torch.Tensor
) -> List[torch.Tensor]:
    """``[t[ids] for t in tables]`` in one kernel launch."""
    table = _check_planes("gather", tables)
    n = _check_ids("gather", ids, table.device)
    outs = [torch.empty((n, table.shape[1]), dtype=table.dtype, device=table.device)
            for _ in tables]
    if n and table.shape[1]:
        pad = [None] * (_MAX_PLANES - len(tables))
        lib = _build.load_library()
        _launch(
            "gather", lib.ps_gather, table.device, len(tables),
            *[t.data_ptr() for t in tables], *pad, *[o.data_ptr() for o in outs], *pad,
            ids.data_ptr(), n, table.shape[1], table.shape[0],
            int(_aligned(ids, *tables, *outs)),
        )
    return outs


def cuda_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: the one-plane case of :func:`cuda_gather_planes`."""
    return cuda_gather_planes([table], ids)[0]


# Replaces _scatter_set_kernel / _pallas_scatter_set (:307, :322).  Bound:
# bytes, n*4 ids + P*n*dim*4 rows read + P*u*dim*4 written for P planes and
# u touched rows.  Design: one launch writes up to 4 planes that share the ids
# (the three-pass push's value and state planes), reading each id once;
# float4 rows, several rows in flight per thread (csrc/scatter_kernels.cu).
# Repeated ids are allowed only with identical rows (trash pads).
def cuda_scatter_set_planes(
    tables: Sequence[torch.Tensor], ids: torch.Tensor, rows: Sequence[torch.Tensor]
) -> List[torch.Tensor]:
    """``t[ids] = r`` for each table ``t`` and its rows ``r``, in place, in
    one kernel launch.  The tables must not overlap: the kernel would race."""
    table = _check_planes("scatter_set", tables)
    n = _check_ids("scatter_set", ids, table.device)
    if len(rows) != len(tables):
        raise ValueError(f"scatter_set: {len(tables)} tables, {len(rows)} row sets")
    for r in rows:
        _check_rows("scatter_set", r, n, table)
    starts = sorted(t.data_ptr() for t in tables)
    if any(b - a < table.nbytes for a, b in zip(starts, starts[1:])):
        raise ValueError("scatter_set: tables overlap in memory")
    if n and table.shape[1]:
        pad = [None] * (_MAX_PLANES - len(tables))
        lib = _build.load_library()
        _launch(
            "scatter_set", lib.ps_scatter_set, table.device, len(tables),
            *[t.data_ptr() for t in tables], *pad, *[r.data_ptr() for r in rows], *pad,
            ids.data_ptr(), n, table.shape[1], table.shape[0],
            int(_aligned(ids, *tables, *rows)),
        )
    return list(tables)


def cuda_scatter_set(
    table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor
) -> torch.Tensor:
    """``table[ids] = rows``: the one-plane case of :func:`cuda_scatter_set_planes`."""
    return cuda_scatter_set_planes([table], ids, [rows])[0]


# Replaces _scatter_add_kernel / _pallas_scatter_add (:202, :264).  Bound:
# bytes, n*4 ids + n*dim*4 rows read + u*dim*4 table rows read and written.
# Read-modify-write with every load of a thread's rows issued before any
# store, no atomics (bitwise deterministic): ids must be unique, and pads at
# the trash row carry zeros, so their races rewrite identical bytes.
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
            n, table.shape[1], table.shape[0], int(_aligned(ids, table, rows)),
        )
    return table


# Replaces _apply_kernel / _pallas_apply (:385, :467).  Bound: bytes,
# n*4 ids + n*dim*4 grads + 2*(1+S)*n*dim*4 for the value and S state planes
# read and written once (pads excluded).  One launch gathers, steps and writes
# all 1+S planes in registers, several rows in flight per thread; one
# template specialisation per optimizer, hyperparameters as kernel arguments.
# Ids at the trash row (``table_rows - 1``) are neither loaded nor stored, so
# the trash row keeps its fill and bucket pads cost nothing.
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
            int(_aligned(ids, grads, value, *planes)),
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


def gather_rows_planes(
    tables: Sequence[torch.Tensor], ids: torch.Tensor
) -> List[torch.Tensor]:
    """``[t[ids] for t in tables]`` for up to 4 planes of one shape (a value
    table and its state planes): one kernel launch on the card."""
    _check_plane_count("gather", tables)
    if _on_card(tables[0], "gather_rows_planes"):
        return cuda_gather_planes(tables, ids)
    return [gather_rows_torch(t, ids) for t in tables]


def scatter_add_rows(
    table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor
) -> torch.Tensor:
    """``table[ids] += rows`` in place; repeated ids sum, as in the JAX
    package's default path.  On the card the repeats are merged first
    (deterministic ``segment_combine``), so the kernel sees unique ids."""
    if _on_card(table, "scatter_add_rows"):
        _check_table("scatter_add", table)
        _check_rows("scatter_add", rows, _check_ids("scatter_add", ids, table.device), table)
        if ids.numel():  # segment_combine takes no empty list
            ids, rows = _merge_repeats(ids, rows)
        return cuda_scatter_add(table, ids, rows.contiguous())
    return scatter_add_rows_torch(table, ids, rows)


def scatter_update_rows_planes(
    tables: Sequence[torch.Tensor], ids: torch.Tensor, rows: Sequence[torch.Tensor]
) -> List[torch.Tensor]:
    """``t[ids] = r`` in place for up to 4 tables of one shape and their rows
    (the three-pass push write-back of a value table and its state planes):
    one kernel launch on the card."""
    _check_plane_count("scatter_set", tables)
    if len(rows) != len(tables):
        raise ValueError(f"scatter_set: {len(tables)} tables, {len(rows)} row sets")
    if _on_card(tables[0], "scatter_update_rows_planes"):
        return cuda_scatter_set_planes(tables, ids, rows)
    return [scatter_update_rows_torch(t, ids, r) for t, r in zip(tables, rows)]


def scatter_update_rows(
    table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor
) -> torch.Tensor:
    """``table[ids] = rows`` in place: the one-plane case of
    :func:`scatter_update_rows_planes`."""
    return scatter_update_rows_planes([table], ids, [rows])[0]


def apply_rows(value, state, ids, grads, optimizer):
    """Fused push apply: gather -> ``optimizer`` rule -> scatter, in place.

    ``ids`` must be unique real rows; pads all point at the trash row, which
    the kernel and the plain version both leave untouched.
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
        ids, combined = _merge_repeats(ids, combined)
    ids, combined = ids.contiguous(), combined.contiguous()
    if _on_card(table, "combine_and_scatter_add"):  # ids are unique here
        return cuda_scatter_add(table, ids, combined)
    return scatter_add_rows_torch(table, ids, combined)
