"""Sharded checkpoints and partitioned snapshots of KV tables.

Torch counterpart of ``parameter_server_tpu/checkpoint.py``: the same host
numpy code and the same files, so a checkpoint or snapshot written by either
package restores in the other, bit for bit (the same npz members, dtypes and
order, the same manifest JSON, the same crc32s).  Only the two functions
that fill a table differ: :func:`restore_shard` and :func:`restore_segments`
install through :meth:`KVTable.install_rows`, which copies the host rows
onto the table's device once.

Legacy layout (one directory per step)::

    <root>/step_000042/
        MANIFEST.json                     # written LAST -> commit marker
        w.shard0-of-2.npz                 # value + optimizer state rows
        w.shard1-of-2.npz

Each shard file holds the server's contiguous row range of the uniform split
(``kv/partition.py``) without the trash row, plus its global row offset.
Restore is elastic: each restoring server reads the saved shard files that
overlap its new range.

Partitioned snapshots (format 2)::

    <root>/snap_000042/
        MANIFEST.json                     # written LAST, CRC-armored
        w.seg00000000-00000250.npz        # one file per routing SEGMENT
        w.delta.s1.npz                    # dirty-row delta log (per server)

- **partitioned**: one file per ``RoutingTable`` segment, written by its
  owner, so any post-migration layout can snapshot (the legacy format
  refuses non-uniform fleets with :class:`CheckpointLayoutError`);
- **incremental**: every segment entry records its ``__sver__`` version
  clock at commit; a later snapshot whose segment version has not advanced
  carries the old file forward, and rows written during the snapshot window
  ride a dirty delta log.  Per-entry ``step`` stamps order the replay: a
  delta row applies only when it is at least as new as its covering segment
  file, so a chain of incrementals restores bit-identical to a full save;
- **CRC-armored**: the manifest records a crc32 per referenced file and one
  over its own body; :func:`finalize_snapshot` verifies every file before
  the manifest is written, and :func:`read_snapshot` / :func:`snapshot_rows`
  re-verify on restore (:class:`CheckpointCorruptError`);
- **any fleet shape**: :func:`snapshot_rows` assembles any global row range
  from the segment files that overlap it, so a restore reshards onto any
  routing table.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from parameter_server_tpu_torch.kv.partition import RangePartition
from parameter_server_tpu_torch.kv.table import KVTable

_STEP_PREFIX = "step_"
_SNAP_PREFIX = "snap_"
_MANIFEST = "MANIFEST.json"

#: partitioned-snapshot manifest format (bumped on incompatible layout
#: changes).
SNAP_FORMAT = 2


class CheckpointLayoutError(RuntimeError):
    """The table layout cannot be saved in the requested checkpoint format.

    Raised (typed, not an opaque assert) by ``KVServer.save_checkpoint``
    when a post-migration fleet hits the legacy uniform-contiguous shard
    format — the caller should use the partitioned snapshot path
    (``KVWorker.save_snapshot``) instead.
    """


class CheckpointCorruptError(RuntimeError):
    """A snapshot file or manifest failed its CRC/consistency check.

    Torn files (a server killed mid-write), bit rot, and truncated
    manifests all land here — restore-source selection treats the snapshot
    as absent and falls back to the next source rather than loading
    corrupt rows.
    """


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"{_STEP_PREFIX}{step:06d}")


def _shard_path(step_dir: str, table: str, s: int, n: int) -> str:
    return os.path.join(step_dir, f"{table}.shard{s}-of-{n}.npz")


@dataclasses.dataclass(frozen=True)
class CheckpointInfo:
    step: int
    num_servers: int
    tables: Dict[str, int]  # table name -> global rows
    clocks: List[int]
    extras: Dict[str, Any]


def save_arrays_shard(
    root: str,
    step: int,
    table_name: str,
    server_index: int,
    num_servers: int,
    row_offset: int,
    value: np.ndarray,
    state: Dict[str, np.ndarray],
) -> str:
    """Write one server's row-range as raw arrays (the low-level writer).

    Safe to call concurrently from all servers: each writes a distinct file
    via an adjacent temp name + atomic rename.
    """
    step_dir = _step_dir(root, step)
    os.makedirs(step_dir, exist_ok=True)
    path = _shard_path(step_dir, table_name, server_index, num_servers)
    arrays = {
        "value": np.asarray(value),
        "row_offset": np.asarray(row_offset, dtype=np.int64),
    }
    for k, v in state.items():
        arrays[f"state.{k}"] = np.asarray(v)
    fd, tmp = tempfile.mkstemp(dir=step_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def save_shard(
    root: str,
    step: int,
    table_name: str,
    table: KVTable,
    server_index: int,
    num_servers: int,
    row_offset: int,
) -> str:
    """Write one KVTable shard's row-range (value + optimizer state).

    The trash row (last) is excluded — it is reconstructed on restore.  The
    rows are copied to the host once, plane by plane.
    """
    return save_arrays_shard(
        root,
        step,
        table_name,
        server_index,
        num_servers,
        row_offset,
        _host_rows(table.value, table.rows),
        {k: _host_rows(v, table.rows) for k, v in table.state.items()},
    )


def _host_rows(plane, rows: int) -> np.ndarray:
    """The first ``rows`` rows of a table plane (a tensor on any device, or
    an array) as host numpy."""
    if hasattr(plane, "detach"):
        return plane[:rows].detach().to("cpu").numpy()
    return np.asarray(plane)[:rows]


def finalize(
    root: str,
    step: int,
    num_servers: int,
    tables: Dict[str, int],
    clocks: Optional[List[int]] = None,
    extras: Optional[Dict[str, Any]] = None,
) -> None:
    """Coordinator commit: verify every shard exists, then write MANIFEST.

    A step directory without MANIFEST.json is an aborted save and is ignored
    by ``latest_step``/``restore`` — the commit-marker pattern.
    """
    step_dir = _step_dir(root, step)
    for t, _rows in tables.items():
        for s in range(num_servers):
            p = _shard_path(step_dir, t, s, num_servers)
            if not os.path.exists(p):
                raise FileNotFoundError(f"missing shard before commit: {p}")
    manifest = {
        "step": step,
        "num_servers": num_servers,
        "tables": dict(tables),
        "clocks": list(clocks or []),
        "extras": dict(extras or {}),
    }
    tmp = os.path.join(step_dir, _MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, os.path.join(step_dir, _MANIFEST))


def list_steps(root: str) -> List[int]:
    """Committed checkpoint steps, ascending."""
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        if not name.startswith(_STEP_PREFIX):
            continue
        if not os.path.exists(os.path.join(root, name, _MANIFEST)):
            continue  # aborted save
        try:
            steps.append(int(name[len(_STEP_PREFIX) :]))
        except ValueError:
            continue
    return sorted(steps)


def latest_step(root: str) -> Optional[int]:
    steps = list_steps(root)
    return steps[-1] if steps else None


def read_info(root: str, step: int) -> CheckpointInfo:
    with open(os.path.join(_step_dir(root, step), _MANIFEST)) as f:
        m = json.load(f)
    return CheckpointInfo(
        step=m["step"],
        num_servers=m["num_servers"],
        tables={k: int(v) for k, v in m["tables"].items()},
        clocks=[int(c) for c in m["clocks"]],
        extras=m["extras"],
    )


def _load_range(
    step_dir: str,
    table_name: str,
    saved_partition: RangePartition,
    lo: int,
    hi: int,
) -> Dict[str, np.ndarray]:
    """Assemble global rows [lo, hi) of a table from the saved shard files.

    Reads only the shards overlapping the range — the elastic-restore core.
    """
    off = saved_partition.offsets
    n = saved_partition.num_servers
    pieces: Dict[str, List[np.ndarray]] = {}
    for s in range(n):
        s_lo, s_hi = int(off[s]), int(off[s + 1])
        a, b = max(lo, s_lo), min(hi, s_hi)
        if a >= b:
            continue
        with np.load(_shard_path(step_dir, table_name, s, n)) as z:
            if int(z["row_offset"]) != s_lo:
                raise ValueError(
                    f"shard {s} of {table_name}: offset {int(z['row_offset'])}"
                    f" != expected {s_lo}"
                )
            for k in z.files:
                if k == "row_offset":
                    continue
                pieces.setdefault(k, []).append(z[k][a - s_lo : b - s_lo])
    return {k: np.concatenate(v, axis=0) for k, v in pieces.items()}


def load_arrays_shard(
    root: str,
    step: int,
    table_name: str,
    server_index: int,
    num_servers: int,
) -> Dict[str, np.ndarray]:
    """Read this server's (possibly re-sharded) row-range as raw arrays.

    ``num_servers`` is the NEW server count; the saved count comes from the
    manifest.  Returns ``{"value": ..., "state.<k>": ...}``.
    """
    info = read_info(root, step)
    rows = info.tables[table_name]
    saved = RangePartition(rows, info.num_servers)
    off = RangePartition(rows, num_servers).offsets
    lo, hi = int(off[server_index]), int(off[server_index + 1])
    return _load_range(_step_dir(root, step), table_name, saved, lo, hi)


def restore_shard(
    root: str,
    step: int,
    table_name: str,
    table: KVTable,
    server_index: int,
    num_servers: int,
) -> None:
    """Load this server's (possibly re-sharded) row-range into ``table``.

    ``num_servers`` is the NEW server count; the saved count comes from the
    manifest.  The table's trash row is reset to init fills.
    """
    arrays = load_arrays_shard(root, step, table_name, server_index, num_servers)
    if arrays["value"].shape[0] != table.rows:
        raise ValueError(
            f"table shard rows {table.rows} != saved range "
            f"{arrays['value'].shape[0]}"
        )
    table.install_rows(
        arrays["value"], {k: arrays[f"state.{k}"] for k in table.state}
    )


def load_global_weights(root: str, step: int, table_name: str) -> np.ndarray:
    """Full servable weight table for offline eval (model_evaluation path).

    Note: returns the raw *value* rows; for lazy-weight optimizers (FTRL) use
    ``load_global_arrays`` and compute weights via the optimizer.
    """
    return load_global_arrays(root, step, table_name)["value"]


def load_global_arrays(root: str, step: int, table_name: str) -> Dict[str, np.ndarray]:
    info = read_info(root, step)
    rows = info.tables[table_name]
    saved = RangePartition(rows, info.num_servers)
    return _load_range(_step_dir(root, step), table_name, saved, 0, rows)


def retain(root: str, keep: int) -> None:
    """Delete all but the newest ``keep`` committed checkpoints.

    ``keep=0`` deletes every committed checkpoint; negative is an error.
    """
    import shutil

    if keep < 0:
        raise ValueError(f"retain: keep must be >= 0, got {keep}")
    steps = list_steps(root)
    for step in steps if keep == 0 else steps[:-keep]:
        shutil.rmtree(_step_dir(root, step), ignore_errors=True)


# -- durability plane: partitioned / incremental snapshots -------------------
def _snap_dir(root: str, step: int) -> str:
    return os.path.join(root, f"{_SNAP_PREFIX}{step:06d}")


def _file_crc(path: str) -> int:
    """Streaming crc32 of a file's bytes (the torn-file armor)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(1 << 20)
            if not block:
                return crc
            crc = zlib.crc32(block, crc)


def _atomic_npz(snap_dir: str, path: str, arrays: Dict[str, np.ndarray]) -> None:
    fd, tmp = tempfile.mkstemp(dir=snap_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def write_segment_file(
    root: str,
    step: int,
    table_name: str,
    lo: int,
    hi: int,
    value: np.ndarray,
    state: Dict[str, np.ndarray],
) -> dict:
    """Write one routing segment's rows ``[lo, hi)`` (value + opt state).

    Written by the segment's OWNING server; safe concurrently because every
    segment has exactly one owner and writes go through an adjacent temp
    name + atomic rename.  Returns the manifest segment entry (without the
    commit-time ``sver`` stamp, which the coordinator fills in at finalize).
    """
    if value.shape[0] != hi - lo:
        raise ValueError(
            f"segment [{lo}, {hi}) of {table_name!r}: value has "
            f"{value.shape[0]} rows"
        )
    snap_dir = _snap_dir(root, step)
    os.makedirs(snap_dir, exist_ok=True)
    fname = f"{table_name}.seg{lo:08d}-{hi:08d}.npz"
    path = os.path.join(snap_dir, fname)
    arrays = {
        "value": np.asarray(value),
        "row_offset": np.asarray(lo, dtype=np.int64),
    }
    for k, v in state.items():
        arrays[f"state.{k}"] = np.asarray(v)
    _atomic_npz(snap_dir, path, arrays)
    return {
        "table": table_name,
        "lo": int(lo),
        "hi": int(hi),
        "step": int(step),
        "file": f"{_SNAP_PREFIX}{step:06d}/{fname}",
        "crc": _file_crc(path),
        "bytes": os.path.getsize(path),
        "sver": 0,
    }


def write_delta_file(
    root: str,
    step: int,
    table_name: str,
    writer: int,
    rows: np.ndarray,
    value: np.ndarray,
    state: Dict[str, np.ndarray],
) -> Optional[dict]:
    """Write a dirty-row delta log: rows written DURING the snapshot window.

    ``writer`` disambiguates concurrent writers (one delta file per server
    per table per step).  Returns the manifest delta entry, or None when
    there is nothing to log.
    """
    rows = np.asarray(rows, dtype=np.int64)
    if rows.size == 0:
        return None
    snap_dir = _snap_dir(root, step)
    os.makedirs(snap_dir, exist_ok=True)
    fname = f"{table_name}.delta.s{writer}.npz"
    path = os.path.join(snap_dir, fname)
    arrays = {"rows": rows, "value": np.asarray(value)}
    for k, v in state.items():
        arrays[f"state.{k}"] = np.asarray(v)
    _atomic_npz(snap_dir, path, arrays)
    return {
        "table": table_name,
        "step": int(step),
        "file": f"{_SNAP_PREFIX}{step:06d}/{fname}",
        "crc": _file_crc(path),
        "bytes": os.path.getsize(path),
        "rows": int(rows.size),
    }


def _manifest_crc(body: dict) -> int:
    return zlib.crc32(
        json.dumps(body, sort_keys=True, separators=(",", ":")).encode()
    )


def _verify_entry(root: str, entry: dict) -> str:
    """Existence + CRC check of one referenced file; returns its path."""
    path = os.path.join(root, entry["file"])
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"snapshot references missing file: {entry['file']}"
        )
    crc = _file_crc(path)
    if crc != int(entry["crc"]):
        raise CheckpointCorruptError(
            f"torn/corrupt snapshot file {entry['file']}: "
            f"crc {crc} != manifest {entry['crc']}"
        )
    return path


def finalize_snapshot(
    root: str,
    step: int,
    routing_payload: dict,
    segments: List[dict],
    deltas: List[dict],
    *,
    base_step: Optional[int] = None,
    clocks: Optional[List[int]] = None,
    extras: Optional[Dict[str, Any]] = None,
) -> None:
    """Coordinator commit: verify every referenced file, then write the manifest.

    The torn-file contract: a server killed mid-snapshot leaves either a
    missing segment (FileNotFoundError here) or a temp file no entry names
    — either way the manifest is never written, ``latest_snapshot`` never
    sees the step, and the previous snapshot stays the restore point.
    Verification also re-checks CARRIED entries (files living in older snap
    dirs), so an incremental chain cannot commit over a rotted base.
    """
    by_table: Dict[str, List[dict]] = {}
    for e in segments:
        by_table.setdefault(e["table"], []).append(e)
    for t, blob in routing_payload["tables"].items():
        rows = int(blob["rows"])
        entries = sorted(by_table.get(t, []), key=lambda e: e["lo"])
        cursor = 0
        for e in entries:
            if int(e["lo"]) != cursor:
                raise CheckpointCorruptError(
                    f"snapshot of {t!r} has a segment gap/overlap at row "
                    f"{cursor} (next entry starts at {e['lo']})"
                )
            cursor = int(e["hi"])
        if cursor != rows:
            raise CheckpointCorruptError(
                f"snapshot of {t!r} covers [0, {cursor}) of {rows} rows"
            )
    for entry in list(segments) + list(deltas):
        _verify_entry(root, entry)
    body = {
        "format": SNAP_FORMAT,
        "step": int(step),
        "base_step": None if base_step is None else int(base_step),
        "routing": routing_payload,
        "segments": sorted(
            segments, key=lambda e: (e["table"], e["lo"])
        ),
        "deltas": sorted(deltas, key=lambda e: (e["step"], e["table"])),
        "clocks": list(clocks or []),
        "extras": dict(extras or {}),
    }
    snap_dir = _snap_dir(root, step)
    os.makedirs(snap_dir, exist_ok=True)
    manifest = dict(body, crc=_manifest_crc(body))
    tmp = os.path.join(snap_dir, _MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, os.path.join(snap_dir, _MANIFEST))


def list_snapshots(root: str) -> List[int]:
    """Committed partitioned-snapshot steps, ascending (no CRC check)."""
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        if not name.startswith(_SNAP_PREFIX):
            continue
        if not os.path.exists(os.path.join(root, name, _MANIFEST)):
            continue  # aborted save
        try:
            steps.append(int(name[len(_SNAP_PREFIX):]))
        except ValueError:
            continue
    return sorted(steps)


def read_snapshot(root: str, step: int) -> dict:
    """Load + CRC-verify a snapshot manifest (raises on corruption)."""
    try:
        with open(os.path.join(_snap_dir(root, step), _MANIFEST)) as f:
            m = json.load(f)
    except json.JSONDecodeError as e:
        raise CheckpointCorruptError(
            f"snapshot {step} manifest is not valid JSON: {e}"
        ) from e
    if m.get("format") != SNAP_FORMAT:
        raise CheckpointCorruptError(
            f"snapshot {step} has format {m.get('format')!r}; this build "
            f"reads format {SNAP_FORMAT}"
        )
    crc = m.pop("crc", None)
    if crc != _manifest_crc(m):
        raise CheckpointCorruptError(
            f"snapshot {step} manifest failed its CRC check "
            f"(recorded {crc})"
        )
    return m


def latest_snapshot(root: str) -> Optional[int]:
    """Newest snapshot whose manifest verifies; skips corrupt ones."""
    for step in reversed(list_snapshots(root)):
        try:
            read_snapshot(root, step)
            return step
        except (OSError, ValueError, CheckpointCorruptError):
            continue
    return None


def snapshot_rows(
    root: str, manifest: dict, table_name: str, lo: int, hi: int
) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Assemble global rows ``[lo, hi)`` of ``table_name`` from a snapshot.

    The reshard-restore core: reads only the segment files OVERLAPPING the
    requested range (each is CRC-verified first), then replays the delta
    logs in step order — a delta row applies only when its stamp is at
    least as new as the row's covering segment file, which is what makes an
    incremental chain restore bit-identical to a full snapshot.
    """
    n = hi - lo
    if n <= 0:
        raise ValueError(f"bad range [{lo}, {hi})")
    value: Optional[np.ndarray] = None
    state: Dict[str, np.ndarray] = {}
    seg_step = np.zeros(n, dtype=np.int64)
    covered = np.zeros(n, dtype=bool)
    for e in manifest["segments"]:
        if e["table"] != table_name:
            continue
        a, b = max(lo, int(e["lo"])), min(hi, int(e["hi"]))
        if a >= b:
            continue
        path = _verify_entry(root, e)
        with np.load(path) as z:
            if int(z["row_offset"]) != int(e["lo"]):
                raise CheckpointCorruptError(
                    f"{e['file']}: row_offset {int(z['row_offset'])} != "
                    f"manifest lo {e['lo']}"
                )
            sl = slice(a - int(e["lo"]), b - int(e["lo"]))
            v = z["value"]  # each member is read once
            if value is None:
                value = np.zeros((n, v.shape[1]), dtype=v.dtype)
                state = {
                    k[len("state."):]: np.zeros((n, v.shape[1]), dtype=v.dtype)
                    for k in z.files
                    if k.startswith("state.")
                }
            value[a - lo : b - lo] = v[sl]
            del v
            for k in state:
                state[k][a - lo : b - lo] = z[f"state.{k}"][sl]
        seg_step[a - lo : b - lo] = int(e["step"])
        covered[a - lo : b - lo] = True
    if value is None or not covered.all():
        missing = int(n if value is None else (~covered).sum())
        raise CheckpointCorruptError(
            f"snapshot of {table_name!r}: {missing} rows of [{lo}, {hi}) "
            "not covered by any segment file"
        )
    for d in sorted(manifest["deltas"], key=lambda e: int(e["step"])):
        if d["table"] != table_name:
            continue
        path = _verify_entry(root, d)
        with np.load(path) as z:
            rows = np.asarray(z["rows"], dtype=np.int64)
            m = (rows >= lo) & (rows < hi)
            if not m.any():
                continue
            r = rows[m] - lo
            newer = int(d["step"]) >= seg_step[r]
            r = r[newer]
            if r.size == 0:
                continue
            value[r] = z["value"][m][newer]
            for k in state:
                state[k][r] = z[f"state.{k}"][m][newer]
    return value, state


def restore_segments(
    root: str,
    manifest: dict,
    table_name: str,
    segments: List[Tuple[int, int]],
    table: KVTable,
) -> None:
    """Load a server's owned ``[(lo, hi), ...]`` ranges into ``table``.

    The restore-to-any-fleet-shape path: ``segments`` comes from the NEW
    routing table and need not match the saved layout — each range is
    assembled from whatever files overlap it.  The trash row is rebuilt
    from optimizer init fills, exactly as the legacy restore does.
    """
    pieces = [
        snapshot_rows(root, manifest, table_name, lo, hi)
        for lo, hi in segments
        if hi > lo
    ]
    if len(pieces) == 1:  # one owned range: no concatenation copy
        value, state = pieces[0]
    elif pieces:
        value = np.concatenate([v for v, _ in pieces], axis=0)
        state = {
            k: np.concatenate([s[k] for _, s in pieces], axis=0)
            for k in pieces[0][1]
        }
    else:
        value = np.zeros((0, table.dim), np.float32)
        state = {k: np.zeros((0, table.dim), np.float32) for k in table.state}
    table.install_rows(value.astype(np.float32, copy=False), state)


def retain_snapshots(root: str, keep: int) -> None:
    """Delete old snapshot dirs, preserving incremental-chain references.

    Keeps the newest ``keep`` committed snapshots PLUS any older snap dir
    their manifests still reference (carried segment files / delta logs) —
    an incremental chain must never lose its base out from under it.
    ``keep=0`` deletes everything; negative is an error.

    Aborted snapshots (a snap dir with segment files but no manifest — a
    server died mid-write, or the coordinator aborted) are swept too, but only
    at steps BELOW the newest committed one: an in-flight snapshot always
    targets a step above everything committed, so its pre-commit files are
    never yanked by a concurrent retention pass.
    """
    import shutil

    if keep < 0:
        raise ValueError(f"retain_snapshots: keep must be >= 0, got {keep}")
    steps = list_snapshots(root)
    kept = set() if keep == 0 else set(steps[-keep:])
    referenced = set()
    for step in kept:
        try:
            m = read_snapshot(root, step)
        except (OSError, ValueError, CheckpointCorruptError):
            continue
        for e in list(m["segments"]) + list(m["deltas"]):
            referenced.add(str(e["file"]).split("/", 1)[0])
    for step in steps:
        if step in kept or f"{_SNAP_PREFIX}{step:06d}" in referenced:
            continue
        shutil.rmtree(_snap_dir(root, step), ignore_errors=True)
    if steps:
        newest = steps[-1]
        for name in os.listdir(root):
            if not name.startswith(_SNAP_PREFIX) or name in referenced:
                continue
            if os.path.exists(os.path.join(root, name, _MANIFEST)):
                continue
            try:
                aborted = int(name[len(_SNAP_PREFIX):])
            except ValueError:
                continue
            if aborted < newest:
                shutil.rmtree(os.path.join(root, name), ignore_errors=True)
