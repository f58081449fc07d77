"""Flat self-describing wire frames: the zero-copy binary codec.

The port's copy of ``parameter_server_tpu/core/frame.py``: the same header
layout, flags, tags and bytes, so a frame built by either package decodes
in the other and both build the same bytes for the same message.  A frame
is::

    [52-byte fixed header][meta section][key/value planes, back to back]

- **Fixed header** (little-endian, :data:`HEADER` layout): magic, version,
  Task kind, flags, array count, the transport stamps that every receiver
  wants *before* it touches the body — per-link sequence (``__rseq__``),
  sender incarnation (``__rinc__``), routing epoch (``__repoch__``), the
  resender's end-to-end payload CRC (``__rcrc__``) — plus the plane CRC32,
  the meta CRC32, the meta/plane section lengths, and a CRC32 over the
  header bytes themselves.  Dedup, incarnation fencing, and corruption
  rejection can all be decided from fixed offsets without decoding the
  meta section.
- **Meta section**: a compact tag-based binary encoding (``_enc_obj`` /
  ``_dec_obj`` — no pickle on this path) of the Task strings and payload
  dict, followed by a fixed binary manifest block (dtype string + shape per
  plane).  Numpy scalars and enums decay to their Python values on the
  wire; unsupported types (a torch tensor inside the payload among them)
  are a typed encode error, never a silent pickle fallback.
- **Planes**: each array's raw contiguous bytes, written straight from
  ``memoryview(a).cast("B")`` (no ``tobytes()`` copies on send) and read
  back as ``np.frombuffer`` views over the received buffer (no copies on
  receive).  Decoded planes are read-only: no layer may write into one.

Torch planes, where the port differs from the JAX codec by design:

- a CPU ``torch.Tensor`` plane is framed exactly as the numpy array of the
  same values (same dtype string, same bytes);
- a ``torch.bfloat16`` plane (numpy has no such dtype without
  ``ml_dtypes``, which the port does not use) is written as its
  ``view(torch.int16)`` bits under the dtype string ``"bfloat16"``, the
  name the JAX codec gives ``ml_dtypes.bfloat16``; the float8 types the
  same way under their ``ml_dtypes`` names.  ``decode`` turns those names
  into zero-copy ``torch.frombuffer`` views of the same dtype;
- a tensor on a device (a ``KVWorker.push_device`` plane on the card) is
  not framed: :func:`encode` raises :class:`FrameError`, so
  :class:`FrameCodecVan` passes the message through unframed and counts it
  in ``frame_passthrough``.  The resender's ``payload_crc32`` skips exactly
  those planes, so sender and receiver always agree on what it covered.

CRC layering: ``header_crc`` covers the fixed header bytes; ``meta_crc``
covers the meta section (verified in :func:`decode` before any meta
parsing, so a flipped meta bit is a typed reject); ``plane_crc`` covers the
frame's plane bytes as encoded, computed incrementally during the pass that
writes them and verified in one pass over the raw buffer before any array
reconstruction.  None of these is the resender's ``__rcrc__`` stamp, which
is computed above the codec and stays the end-to-end integrity check.

Stamp lifting is loss-free: :func:`encode` pops the stamp keys out of the
payload into header fields, :func:`decode` reinstates them, so every layer
above the codec sees bitwise-identical messages.  A stamp that is absent —
or not a fixed-width int — simply stays in the meta section (flag unset).
A sampled request's trace context (``__trace__``) is ordinary meta,
decoded into a fresh dict on every receive.
"""

from __future__ import annotations

import dataclasses
import enum
import struct
import zlib
from typing import Any, Callable, Optional, Tuple

import numpy as np

import torch

from parameter_server_tpu_torch.core.messages import (
    INCARNATION_KEY,
    Message,
    Task,
    TaskKind,
)
from parameter_server_tpu_torch.core.van import Van, VanWrapper

#: transport stamp keys lifted into the fixed header (payload-borne above
#: the codec, header-borne on the wire).  SEQ/CRC are owned by
#: ``core/resender.py``, the epoch by ``kv/routing.py``; the literals are
#: repeated here (asserted equal in tests/test_torch_frame.py) because importing
#: resender would put the stamp/verify module on this module's import path.
SEQ_KEY = "__rseq__"
CRC_KEY = "__rcrc__"
ROUTING_EPOCH_KEY = "__repoch__"

MAGIC = b"PF"
VERSION = 1

#: fixed header layout (52 bytes, little-endian).
HEADER = struct.Struct(
    "<2s"  # magic
    "B"    # version
    "B"    # Task kind (index into _KINDS)
    "H"    # flags
    "H"    # n_arrays (keys, when present, is plane 0)
    "q"    # seq        (valid iff FLAG_SEQ)
    "i"    # incarnation(valid iff FLAG_INC)
    "i"    # epoch      (valid iff FLAG_EPOCH)
    "I"    # e2e_crc    (valid iff FLAG_E2E_CRC — the resender's __rcrc__)
    "I"    # plane_crc32 over the plane bytes as framed
    "I"    # meta_crc32 over the meta section bytes
    "I"    # meta_len
    "Q"    # planes_len
    "I"    # header_crc32 over the 48 bytes above
)
HEADER_SIZE = HEADER.size  # 52

FLAG_REQUEST = 1 << 0
FLAG_HAS_KEYS = 1 << 1
FLAG_SEQ = 1 << 2
FLAG_INC = 1 << 3
FLAG_EPOCH = 1 << 4
FLAG_E2E_CRC = 1 << 5
#: one or more value planes are lossily quantized: the payload
#: carries a ``COMPRESSED_KEY`` marker describing per-plane codec/scale,
#: and receivers dequantize off the frombuffer plane view before H2D.
#: Purely informational at the frame layer (decode is marker-driven);
#: exists so wire captures / foreign receivers can tell a compressed
#: plane from a raw one without parsing the meta section.
FLAG_COMPRESSED = 1 << 6

#: payload key the quantizing codec stamps (``core/filters.py``); frames
#: whose payload carries it get ``FLAG_COMPRESSED`` set in the header.
COMPRESSED_KEY = "wc_meta"

_KINDS = (TaskKind.PUSH, TaskKind.PULL, TaskKind.CONTROL)
_KIND_INDEX = {k: i for i, k in enumerate(_KINDS)}

_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def plane_view(a: np.ndarray) -> memoryview:
    """Zero-copy byte view of a contiguous array.

    ``memoryview(a).cast("B")`` for native dtypes; extension dtypes
    (bfloat16/fp8 — no buffer-protocol format) go through a ``uint8`` view
    instead.  Either way: no ``tobytes()`` copy.
    """
    if not a.ndim:
        a = a.reshape(1)
    try:
        return memoryview(a).cast("B")
    except (ValueError, TypeError):
        return memoryview(a.view(np.uint8).reshape(-1))


class FrameError(ValueError):
    """Typed rejection of a malformed/truncated/corrupted frame.

    Receivers (``TcpVan._dispatch_loop``) catch exactly this, count the
    drop, and keep the recv thread alive — wire noise must read as loss
    (repaired by the resender), never as a dead transport.
    """


# ------------------------------------------------------------- meta codec
#
# Tag-based binary object encoding for the meta section.  Covers every
# payload shape the codebase puts on the wire (None/bool/int/float/str/
# bytes/list/tuple/dict/np scalar/np ndarray — e.g. routing tables, q8
# scale arrays, trace contexts, bundle indexes).  Tuples and lists keep
# their identity (filters compare payload dicts bitwise).

_T_NONE = 0
_T_TRUE = 1
_T_FALSE = 2
_T_INT64 = 3
_T_BIGINT = 4
_T_FLOAT = 5
_T_STR = 6
_T_BYTES = 7
_T_LIST = 8
_T_TUPLE = 9
_T_DICT = 10
_T_NDARRAY = 11

_pack_q = struct.Struct("<q").pack
_pack_d = struct.Struct("<d").pack
_pack_I = struct.Struct("<I").pack
_unpack_q = struct.Struct("<q").unpack_from
_unpack_d = struct.Struct("<d").unpack_from
_unpack_I = struct.Struct("<I").unpack_from
_pack_I_into = struct.Struct("<I").pack_into

#: dtype <-> canonical string caches.  ``str(np.dtype)`` walks numpy's
#: Python-level name machinery (~2us) and ``np.dtype(str)`` re-parses it;
#: the working set is a handful of dtypes per process, so both directions
#: memoize (hot enough to show up at the top of an encode profile).
_DTYPE_TO_STR: dict = {}
_STR_TO_DTYPE: dict = {}


def _dtype_str(dt) -> str:
    s = _DTYPE_TO_STR.get(dt)
    if s is None:
        s = _DTYPE_TO_STR[dt] = str(dt)
    return s


#: torch dtypes numpy cannot hold without ``ml_dtypes``: the wire name the
#: JAX codec gives them (``str(np.dtype)`` of the ``ml_dtypes`` type) and the
#: integer type of the same width whose bits are framed.
_TORCH_EXT: dict = {}
for _name, _bits in (("bfloat16", torch.int16), ("float8_e4m3fn", torch.int8),
                     ("float8_e5m2", torch.int8), ("float8_e4m3fnuz", torch.int8),
                     ("float8_e5m2fnuz", torch.int8)):
    if isinstance(getattr(torch, _name, None), torch.dtype):
        _TORCH_EXT[getattr(torch, _name)] = (_name, _bits)
#: wire name -> torch dtype, for ``decode``
_EXT_BY_NAME = {name: dt for dt, (name, _bits) in _TORCH_EXT.items()}


def _str_dtype(s: str):
    """The dtype a wire name decodes to: a numpy dtype, or the torch dtype
    of an extension name (``"bfloat16"`` and the float8 names)."""
    dt = _STR_TO_DTYPE.get(s)
    if dt is None:
        dt = _EXT_BY_NAME.get(s)
        if dt is None:
            dt = np.dtype(s)
        _STR_TO_DTYPE[s] = dt
    return dt


def _torch_dtype_str(dt: torch.dtype) -> str:
    """Wire name of a torch dtype: its ``ml_dtypes`` name for the extension
    types, else numpy's name for the same type (``torch.float32`` ->
    ``"float32"``, ``torch.bool`` -> ``"bool"``)."""
    ext = _TORCH_EXT.get(dt)
    return ext[0] if ext is not None else str(dt).rpartition(".")[2]


def _frombuffer(buf, dt, n: int, offset: int):
    """``n`` elements of ``dt`` at byte ``offset`` of ``buf``, no copy: a
    numpy view, or a torch view for the extension dtypes."""
    if isinstance(dt, np.dtype):
        return np.frombuffer(buf, dtype=dt, count=n, offset=offset)
    if n == 0:  # torch.frombuffer refuses a zero count
        return torch.empty(0, dtype=dt)
    return torch.frombuffer(buf, dtype=dt, count=n, offset=offset)


#: per-ndim shape (de)serializers: one C pack/unpack call for the whole
#: shape tuple instead of a Python loop per dimension.
_SHAPE_STRUCTS: dict = {}


def _shape_struct(ndim: int) -> struct.Struct:
    st = _SHAPE_STRUCTS.get(ndim)
    if st is None:
        st = _SHAPE_STRUCTS[ndim] = struct.Struct(f"<{ndim}q")
    return st


def host_plane(a) -> Tuple[np.ndarray, str]:
    """A plane as ``(contiguous numpy array holding its bytes, wire dtype
    name)``, without ascontiguousarray's call overhead for the common case.

    Keeps ascontiguousarray's ndmin=1 promotion (0-d frames as shape (1,),
    the seed codec's behavior) — 0-d arrays are contiguous, so the fast
    path must not keep them.  A CPU tensor gives the numpy array of the
    same values (an extension dtype its integer bits, named as
    ``ml_dtypes`` names it); a tensor on a device, or anything else that is
    no array, is a typed :class:`FrameError`.  The resender's CRC hashes the
    same bytes."""
    if type(a) is np.ndarray and a.ndim and a.flags.c_contiguous:
        return a, _dtype_str(a.dtype)
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise FrameError(
                f"a {a.device.type} tensor plane is not framed (device-resident "
                "values pass through unframed)"
            )
        t = a.detach().resolve_conj().resolve_neg()
        t = (t.reshape(1) if not t.ndim else t).contiguous()
        ext = _TORCH_EXT.get(t.dtype)
        if ext is not None:
            return t.view(ext[1]).numpy(), ext[0]
        try:
            arr = t.numpy()
        except (TypeError, RuntimeError) as e:
            raise FrameError(f"cannot frame a {t.dtype} tensor plane: {e}") from e
        return arr, _dtype_str(arr.dtype)
    try:
        arr = np.ascontiguousarray(a)
    except (TypeError, ValueError) as e:
        raise FrameError(f"cannot frame a {type(a).__name__!r} plane: {e}") from e
    if arr.dtype.hasobject:
        raise FrameError(f"cannot frame a {type(a).__name__!r} plane of objects")
    return arr, _dtype_str(arr.dtype)


# per-type encoders dispatched on ``type(obj)`` — one dict lookup replaces
# the isinstance chain on the hottest path in ``encode`` (payload dicts).


def _enc_none(obj, out):
    out.append(_T_NONE)


def _enc_bool(obj, out):
    out.append(_T_TRUE if obj else _T_FALSE)


def _enc_int(obj, out):
    if _I64_MIN <= obj <= _I64_MAX:
        out.append(_T_INT64)
        out += _pack_q(obj)
    else:
        raw = obj.to_bytes((obj.bit_length() + 8) // 8, "little", signed=True)
        out.append(_T_BIGINT)
        out += _pack_I(len(raw))
        out += raw


def _enc_float(obj, out):
    out.append(_T_FLOAT)
    out += _pack_d(obj)


def _enc_str(obj, out):
    raw = obj.encode("utf-8")
    out.append(_T_STR)
    out += _pack_I(len(raw))
    out += raw


#: encoded-record memo for the identity strings every frame carries
#: (customer, sender, recver) — node ids and customer names form a small
#: fixed set per process, so their tag+len+utf8 records are precomputable.
#: Bounded: an unbounded payload string must never grow it.
_NAME_ENC_CACHE: dict = {}


def _enc_name(obj, out):
    rec = _NAME_ENC_CACHE.get(obj)
    if rec is None:
        raw = obj.encode("utf-8")
        rec = bytes((_T_STR,)) + _pack_I(len(raw)) + raw
        if len(_NAME_ENC_CACHE) < 4096:
            _NAME_ENC_CACHE[obj] = rec
    out += rec


def _enc_bytes(obj, out):
    out.append(_T_BYTES)
    out += _pack_I(len(obj))
    out += obj


def _enc_list(obj, out):
    out.append(_T_LIST)
    out += _pack_I(len(obj))
    for item in obj:
        _enc_obj(item, out)


def _enc_tuple(obj, out):
    out.append(_T_TUPLE)
    out += _pack_I(len(obj))
    for item in obj:
        _enc_obj(item, out)


def _enc_dict(obj, out):
    out.append(_T_DICT)
    out += _pack_I(len(obj))
    for k, v in obj.items():
        _enc_obj(k, out)
        _enc_obj(v, out)


def _enc_ndarray(obj, out):
    a, name = host_plane(obj)
    dt = name.encode("ascii")
    out.append(_T_NDARRAY)
    out.append(len(dt))
    out += dt
    out.append(a.ndim)
    if a.ndim:
        out += _shape_struct(a.ndim).pack(*a.shape)
    out += plane_view(a)


_ENC_DISPATCH: dict = {
    type(None): _enc_none,
    bool: _enc_bool,
    int: _enc_int,
    float: _enc_float,
    str: _enc_str,
    bytes: _enc_bytes,
    list: _enc_list,
    tuple: _enc_tuple,
    dict: _enc_dict,
    np.ndarray: _enc_ndarray,
}


def _enc_obj(obj: Any, out: bytearray) -> None:
    enc = _ENC_DISPATCH.get(type(obj))
    if enc is not None:
        enc(obj, out)
    elif isinstance(obj, np.ndarray):
        _enc_ndarray(obj, out)
    elif isinstance(obj, (np.bool_, np.integer, np.floating)):
        # numpy scalars decay to their Python value (payloads compare
        # equal; nothing round-trips scalar *types* on the wire)
        _enc_obj(obj.item(), out)
    elif isinstance(obj, enum.Enum):
        # enums (TaskKind, NodeRole, ...) decay to .value — NOT str(obj),
        # which is the qualified name on 3.10 and breaks receivers that
        # re-wrap, e.g. NodeRole(row["role"]) in core/manager.py
        _enc_obj(obj.value, out)
    elif isinstance(obj, int):  # bool handled above; int subclasses decay
        _enc_int(int(obj), out)
    elif isinstance(obj, str):
        _enc_str(str(obj), out)
    else:
        raise FrameError(
            f"meta codec cannot encode {type(obj).__name__!r} "
            "(wire payloads are plain data: None/bool/int/float/str/bytes/"
            "list/tuple/dict/ndarray)"
        )


def _dec_obj(buf, pos: int) -> Tuple[Any, int]:
    try:
        tag = buf[pos]
        pos += 1
        if tag == _T_NONE:
            return None, pos
        if tag == _T_TRUE:
            return True, pos
        if tag == _T_FALSE:
            return False, pos
        if tag == _T_INT64:
            return _unpack_q(buf, pos)[0], pos + 8
        if tag == _T_BIGINT:
            n = _unpack_I(buf, pos)[0]
            pos += 4
            raw = bytes(buf[pos : pos + n])
            if len(raw) != n:
                raise FrameError("meta truncated inside bigint")
            return int.from_bytes(raw, "little", signed=True), pos + n
        if tag == _T_FLOAT:
            return _unpack_d(buf, pos)[0], pos + 8
        if tag == _T_STR:
            n = _unpack_I(buf, pos)[0]
            pos += 4
            raw = bytes(buf[pos : pos + n])
            if len(raw) != n:
                raise FrameError("meta truncated inside str")
            return raw.decode("utf-8"), pos + n
        if tag == _T_BYTES:
            n = _unpack_I(buf, pos)[0]
            pos += 4
            raw = bytes(buf[pos : pos + n])
            if len(raw) != n:
                raise FrameError("meta truncated inside bytes")
            return raw, pos + n
        if tag in (_T_LIST, _T_TUPLE):
            n = _unpack_I(buf, pos)[0]
            pos += 4
            items = []
            for _ in range(n):
                item, pos = _dec_obj(buf, pos)
                items.append(item)
            return (tuple(items) if tag == _T_TUPLE else items), pos
        if tag == _T_DICT:
            n = _unpack_I(buf, pos)[0]
            pos += 4
            d = {}
            for _ in range(n):
                k, pos = _dec_obj(buf, pos)
                v, pos = _dec_obj(buf, pos)
                d[k] = v
            return d, pos
        if tag == _T_NDARRAY:
            dlen = buf[pos]
            pos += 1
            dt = _str_dtype(bytes(buf[pos : pos + dlen]).decode("ascii"))
            pos += dlen
            ndim = buf[pos]
            pos += 1
            shape = _shape_struct(ndim).unpack_from(buf, pos) if ndim else ()
            pos += 8 * ndim
            n = 1
            for d in shape:
                if d < 0:
                    # a negative dim makes the truncation check below pass
                    # (negative nbytes), frombuffer read to the buffer end,
                    # and pos move BACKWARDS — silent mis-parse, not reject
                    raise FrameError(f"negative ndarray dim {d} in meta")
                n *= d
            nbytes = n * dt.itemsize
            if pos + nbytes > len(buf):
                raise FrameError("meta truncated inside ndarray")
            arr = _frombuffer(buf, dt, n, pos)
            return arr.reshape(shape), pos + nbytes
        raise FrameError(f"unknown meta tag {tag}")
    except FrameError:
        raise
    except (IndexError, struct.error, UnicodeDecodeError, TypeError,
            ValueError, OverflowError) as e:
        # garbled bytes surface as many exception types (np.dtype parse,
        # frombuffer size math, int-to-ssize_t overflow, ...); ALL of them
        # must become the one typed reject the recv thread catches
        raise FrameError(f"garbled meta section: {e}") from e


# ------------------------------------------------------------ frame codec


#: stamp key -> the header-field range ``encode`` lifts it within; values
#: outside (or non-int) ride the meta section instead (flag unset).
#: ``frame_nbytes`` filters by the SAME ranges so its estimate stays exact
#: for out-of-range stamp values.
_STAMP_RANGES = {
    SEQ_KEY: (_I64_MIN, _I64_MAX),
    INCARNATION_KEY: (_I32_MIN, _I32_MAX),
    ROUTING_EPOCH_KEY: (_I32_MIN, _I32_MAX),
    CRC_KEY: (0, 0xFFFFFFFF),
}


def _lift_int(payload: dict, key: str, lo: int, hi: int):
    """Pop ``payload[key]`` when it is a header-width int, else leave it."""
    v = payload.get(key)
    if type(v) is int and lo <= v <= hi:
        del payload[key]
        return v
    return None


# ---------------------------------------------------- control-frame fast path
#
# No-plane control frames (resender ACKs above all: every data frame costs
# one) have META-STABLE layouts: the same (kind, customer, sender, recver,
# payload-key) signature encodes to the same bytes except for a handful of
# 8-byte int slots (time, wait_time, the meta-resident payload ints) and
# the header stamps.  ``_fast_encode`` caches the fully-encoded template
# per signature and per call only copies it, patches the int slots, and
# re-CRCs — skipping the whole meta codec walk.  Output is BYTE-IDENTICAL
# to the slow path (the payload dict is never mutated); anything outside
# the eligible shape (planes, non-int values, out-of-range stamps, non-str
# names/keys) falls through to the general encoder.

_pack_q_into = struct.Struct("<q").pack_into

_FAST_CACHE_CAP = 1024
_FAST_ENC_CACHE: dict = {}


class _FastEntry:
    __slots__ = ("buf", "slots", "dispo", "kind_idx")

    def __init__(self, buf, slots, dispo, kind_idx):
        self.buf = buf          # header placeholder + meta template bytes
        self.slots = slots      # buf offsets of the 8-byte int patch slots
        self.dispo = dispo      # [(payload key, stamp key | None), ...]
        self.kind_idx = kind_idx


def _build_fast_entry(msg: Message):
    task = msg.task
    payload = task.payload
    kind_idx = _KIND_INDEX.get(task.kind)
    if kind_idx is None:
        return None
    dispo = []
    for k, v in payload.items():
        if type(k) is not str:
            return None
        if k in _STAMP_RANGES:
            dispo.append((k, k))
        else:
            if type(v) is not int:
                return None
            dispo.append((k, None))
    meta = bytearray()
    for name in (task.customer, msg.sender, msg.recver):
        _enc_name(name, meta)
    slots = []
    for _ in range(2):  # time, wait_time
        slots.append(HEADER_SIZE + len(meta) + 1)
        meta.append(_T_INT64)
        meta += _pack_q(0)
    meta.append(_T_DICT)
    meta += _pack_I(sum(1 for _, s in dispo if s is None))
    for k, stamp in dispo:
        if stamp is None:
            _enc_name(k, meta)  # same record _enc_str writes for dict keys
            slots.append(HEADER_SIZE + len(meta) + 1)
            meta.append(_T_INT64)
            meta += _pack_q(0)
    return _FastEntry(
        bytes(HEADER_SIZE) + bytes(meta), tuple(slots), tuple(dispo), kind_idx
    )


def _fast_encode(msg: Message) -> Optional[bytes]:
    """Encode an eligible no-plane control frame off the template cache;
    None = not eligible (caller runs the general path)."""
    task = msg.task
    payload = task.payload
    if (
        type(payload) is not dict
        or type(task.customer) is not str
        or type(msg.sender) is not str
        or type(msg.recver) is not str
        or type(task.time) is not int
        or type(task.wait_time) is not int
        or not _I64_MIN <= task.time <= _I64_MAX
        or not _I64_MIN <= task.wait_time <= _I64_MAX
    ):
        return None
    key = (task.kind, task.customer, msg.sender, msg.recver, tuple(payload))
    entry = _FAST_ENC_CACHE.get(key)
    if entry is None:
        entry = _build_fast_entry(msg)
        if entry is None:
            return None
        if len(_FAST_ENC_CACHE) < _FAST_CACHE_CAP:
            _FAST_ENC_CACHE[key] = entry
    vals = [task.time, task.wait_time]
    seq = inc = epoch = e2e = None
    for k, stamp in entry.dispo:
        v = payload[k]
        if type(v) is not int:
            return None
        if stamp is None:
            if not _I64_MIN <= v <= _I64_MAX:
                return None
            vals.append(v)
        else:
            lo, hi = _STAMP_RANGES[stamp]
            if not lo <= v <= hi:
                return None  # out-of-range stamp rides meta: general path
            if stamp == SEQ_KEY:
                seq = v
            elif stamp == INCARNATION_KEY:
                inc = v
            elif stamp == ROUTING_EPOCH_KEY:
                epoch = v
            else:
                e2e = v
    buf = bytearray(entry.buf)
    for off, v in zip(entry.slots, vals):
        _pack_q_into(buf, off, v)
    flags = FLAG_REQUEST if msg.is_request else 0
    if seq is not None:
        flags |= FLAG_SEQ
    if inc is not None:
        flags |= FLAG_INC
    if epoch is not None:
        flags |= FLAG_EPOCH
    if e2e is not None:
        flags |= FLAG_E2E_CRC
    mv = memoryview(buf)
    HEADER.pack_into(
        buf, 0,
        MAGIC,
        VERSION,
        entry.kind_idx,
        flags,
        0,
        seq if seq is not None else 0,
        inc if inc is not None else 0,
        epoch if epoch is not None else 0,
        e2e if e2e is not None else 0,
        0,  # plane crc of zero planes
        zlib.crc32(mv[HEADER_SIZE:]),
        len(buf) - HEADER_SIZE,
        0,
        0,  # header crc placeholder
    )
    _pack_I_into(buf, HEADER_SIZE - 4, zlib.crc32(mv[: HEADER_SIZE - 4]))
    return bytes(buf)


def encode(msg: Message) -> bytes:
    """Message -> flat frame bytes.  One output allocation (``b"".join``);
    array planes are read straight through their buffers — no ``tobytes()``
    intermediates on the send side.  No-plane control frames (ACKs) take
    the cached-template fast path when eligible — byte-identical output."""
    if msg.keys is None and not msg.values:
        fast = _fast_encode(msg)
        if fast is not None:
            return fast
    head, meta, planes, _planes_len = _encode_parts(msg)
    return b"".join([head, meta] + planes)


def encode_vec(msg: Message) -> Tuple[list, int]:
    """Message -> ``(segments, total_len)`` for vectored (``writev``/shm)
    sends: byte-identical to :func:`encode` when the segments are laid end
    to end, but the value planes stay SEPARATE zero-copy views over the
    original array buffers — a coalesced bundle's member gradients go from
    their source buffers to the wire without ever concatenating host-side.
    The first segment is the fixed header + meta section (one small
    bytearray); every following segment is a plane ``memoryview``."""
    if msg.keys is None and not msg.values:
        fast = _fast_encode(msg)
        if fast is not None:
            return [fast], len(fast)
    head, meta, planes, planes_len = _encode_parts(msg)
    head += meta  # bytearray extend: header+meta ride one iovec slot
    return [head] + planes, len(head) + planes_len


def _encode_parts(msg: Message) -> Tuple[bytearray, bytearray, list, int]:
    """Shared general-path body of :func:`encode`/:func:`encode_vec`:
    ``(header, meta, plane_views, planes_len)``."""
    arrays = []
    for a in ([msg.keys] if msg.keys is not None else []) + list(msg.values):
        arrays.append(host_plane(a))

    payload = msg.task.payload
    flags = FLAG_REQUEST if msg.is_request else 0
    if msg.keys is not None:
        flags |= FLAG_HAS_KEYS
    seq = inc = epoch = e2e = None
    if isinstance(payload, dict) and payload:
        lifted = {
            k: v
            for k, v in payload.items()
            # only int values of header width lift; anything else rides meta
        }
        seq = _lift_int(lifted, SEQ_KEY, *_STAMP_RANGES[SEQ_KEY])
        inc = _lift_int(lifted, INCARNATION_KEY,
                        *_STAMP_RANGES[INCARNATION_KEY])
        epoch = _lift_int(lifted, ROUTING_EPOCH_KEY,
                          *_STAMP_RANGES[ROUTING_EPOCH_KEY])
        e2e = _lift_int(lifted, CRC_KEY, *_STAMP_RANGES[CRC_KEY])
        payload = lifted
    if seq is not None:
        flags |= FLAG_SEQ
    if inc is not None:
        flags |= FLAG_INC
    if epoch is not None:
        flags |= FLAG_EPOCH
    if e2e is not None:
        flags |= FLAG_E2E_CRC
    if isinstance(payload, dict) and COMPRESSED_KEY in payload:
        # lossy-quantized plane(s) aboard: decode stays marker-driven, the
        # header bit is for captures/foreign receivers (and MIGRATION.md)
        flags |= FLAG_COMPRESSED

    meta = bytearray()
    for name in (msg.task.customer, msg.sender, msg.recver):
        (_enc_name if type(name) is str else _enc_obj)(name, meta)
    _enc_obj(msg.task.time, meta)
    _enc_obj(msg.task.wait_time, meta)
    _enc_obj(payload, meta)
    # manifest block: a fixed binary record per plane (dtype str, shape) —
    # NOT the generic object codec; this is every frame's hottest meta and
    # its layout is known, so it skips the tag machinery entirely
    plane_crc = 0
    planes = []
    planes_len = 0
    for a, name in arrays:
        dt = name.encode("ascii")
        meta.append(len(dt))
        meta += dt
        meta.append(a.ndim)
        if a.ndim:
            meta += _shape_struct(a.ndim).pack(*a.shape)
        mv = plane_view(a)
        plane_crc = zlib.crc32(mv, plane_crc)
        planes.append(mv)
        planes_len += len(mv)

    if len(arrays) > 0xFFFF:
        raise FrameError(
            f"{len(arrays)} planes exceed the u16 n_arrays field "
            "(split the bundle)"
        )
    if len(meta) > 0xFFFFFFFF:
        raise FrameError(
            f"{len(meta)}-byte meta section exceeds the u32 meta_len field"
        )
    head = bytearray(HEADER_SIZE)
    HEADER.pack_into(
        head, 0,
        MAGIC,
        VERSION,
        _KIND_INDEX[msg.task.kind],
        flags,
        len(arrays),
        seq if seq is not None else 0,
        inc if inc is not None else 0,
        epoch if epoch is not None else 0,
        e2e if e2e is not None else 0,
        plane_crc & 0xFFFFFFFF,
        zlib.crc32(meta),
        len(meta),
        planes_len,
        0,  # header crc placeholder
    )
    _pack_I_into(head, HEADER_SIZE - 4,
                 zlib.crc32(memoryview(head)[: HEADER_SIZE - 4]))
    return head, meta, planes, planes_len


@dataclasses.dataclass(frozen=True)
class FrameInfo:
    """Decoded fixed header — everything dedup/fencing/accounting needs
    without touching the meta section or planes."""

    version: int
    kind: TaskKind
    flags: int
    n_arrays: int
    seq: Optional[int]
    incarnation: Optional[int]
    epoch: Optional[int]
    e2e_crc: Optional[int]
    plane_crc: int
    meta_crc: int
    meta_len: int
    planes_len: int

    @property
    def is_request(self) -> bool:
        return bool(self.flags & FLAG_REQUEST)

    @property
    def overhead(self) -> int:
        """Non-plane frame bytes: fixed header + meta section."""
        return HEADER_SIZE + self.meta_len


def peek(buf) -> FrameInfo:
    """Validate and read the fixed header alone (no meta/plane decode).

    Raises :class:`FrameError` on anything short of a well-formed header
    over a complete frame: truncation, bad magic/version, a header CRC
    mismatch (garbled headers are *typed* rejects, not struct errors
    escaping on the recv thread), or section lengths past the buffer.
    """
    if len(buf) < HEADER_SIZE:
        raise FrameError(
            f"truncated frame: {len(buf)} bytes < {HEADER_SIZE}-byte header"
        )
    (
        magic, version, kind_i, flags, n_arrays,
        seq, inc, epoch, e2e, plane_crc, meta_crc, meta_len, planes_len,
        hcrc,
    ) = HEADER.unpack_from(buf, 0)
    mv = memoryview(buf) if not isinstance(buf, memoryview) else buf
    if zlib.crc32(mv[: HEADER_SIZE - 4]) != hcrc:
        raise FrameError("header CRC mismatch (garbled header)")
    if magic != MAGIC:
        raise FrameError(f"bad magic {magic!r}")
    if version != VERSION:
        raise FrameError(f"unsupported frame version {version}")
    if kind_i >= len(_KINDS):
        raise FrameError(f"bad task kind {kind_i}")
    if HEADER_SIZE + meta_len + planes_len != len(buf):
        raise FrameError(
            f"frame length mismatch: header says "
            f"{HEADER_SIZE}+{meta_len}+{planes_len}, buffer has {len(buf)}"
        )
    return FrameInfo(
        version=version,
        kind=_KINDS[kind_i],
        flags=flags,
        n_arrays=n_arrays,
        seq=seq if flags & FLAG_SEQ else None,
        incarnation=inc if flags & FLAG_INC else None,
        epoch=epoch if flags & FLAG_EPOCH else None,
        e2e_crc=e2e if flags & FLAG_E2E_CRC else None,
        plane_crc=plane_crc,
        meta_crc=meta_crc,
        meta_len=meta_len,
        planes_len=planes_len,
    )


def verify_planes(buf, info: Optional[FrameInfo] = None) -> bool:
    """One-pass plane CRC check over the raw buffer — zero numpy work."""
    if info is None:
        info = peek(buf)
    mv = memoryview(buf) if not isinstance(buf, memoryview) else buf
    start = HEADER_SIZE + info.meta_len
    crc = zlib.crc32(mv[start : start + info.planes_len])
    return crc == info.plane_crc


def decode(buf, *, verify: bool = True) -> Message:
    """Flat frame bytes -> Message; arrays are zero-copy views over ``buf``.

    ``verify=True`` (the wire path) CRC-checks the plane bytes in one pass
    over the raw buffer and raises :class:`FrameError` on mismatch —
    BEFORE any meta decode or array reconstruction.  ``verify=False`` is
    for callers that intentionally decode damaged planes (ChaosVan's
    bit-flip injection, which relies on the resender's end-to-end CRC to
    catch the corruption downstream).  The meta CRC is checked on BOTH
    paths: a garbled meta section cannot be parsed meaningfully, only
    rejected (ChaosVan flips plane bytes exclusively, so this never fires
    on its injection path).
    """
    # header handling is inlined (same checks, same order, same typed
    # rejects as peek()) rather than routed through peek(): this is the
    # per-frame hot path of every wire AND shm receive, and building a
    # frozen FrameInfo per frame costs more than the whole plane CRC
    if len(buf) < HEADER_SIZE:
        raise FrameError(
            f"truncated frame: {len(buf)} bytes < {HEADER_SIZE}-byte header"
        )
    (
        magic, version, kind_i, flags, n_arrays,
        seq, inc, epoch, e2e, plane_crc, meta_crc, meta_len, planes_len,
        hcrc,
    ) = HEADER.unpack_from(buf, 0)
    mv = memoryview(buf) if not isinstance(buf, memoryview) else buf
    if zlib.crc32(mv[: HEADER_SIZE - 4]) != hcrc:
        raise FrameError("header CRC mismatch (garbled header)")
    if magic != MAGIC:
        raise FrameError(f"bad magic {magic!r}")
    if version != VERSION:
        raise FrameError(f"unsupported frame version {version}")
    if kind_i >= len(_KINDS):
        raise FrameError(f"bad task kind {kind_i}")
    meta_end = HEADER_SIZE + meta_len
    if meta_end + planes_len != len(buf):
        raise FrameError(
            f"frame length mismatch: header says "
            f"{HEADER_SIZE}+{meta_len}+{planes_len}, buffer has {len(buf)}"
        )
    if verify and zlib.crc32(mv[meta_end : meta_end + planes_len]) != plane_crc:
        raise FrameError("plane CRC mismatch (corrupt frame body)")
    meta = mv[HEADER_SIZE:meta_end]
    if zlib.crc32(meta) != meta_crc:
        raise FrameError("meta CRC mismatch (corrupt meta section)")
    customer, p = _dec_obj(meta, 0)
    sender, p = _dec_obj(meta, p)
    recver, p = _dec_obj(meta, p)
    time_, p = _dec_obj(meta, p)
    wait_time, p = _dec_obj(meta, p)
    payload, p = _dec_obj(meta, p)
    if not isinstance(payload, dict):
        raise FrameError("meta section inconsistent with header")
    # reinstate the lifted stamps: layers above the codec see the payload
    # dict bitwise as the sender's stack stamped it
    if flags & FLAG_SEQ:
        payload[SEQ_KEY] = seq
    if flags & FLAG_INC:
        payload[INCARNATION_KEY] = inc
    if flags & FLAG_EPOCH:
        payload[ROUTING_EPOCH_KEY] = epoch
    if flags & FLAG_E2E_CRC:
        payload[CRC_KEY] = e2e
    # manifest block (fixed binary records, one per plane — see encode)
    # fused with plane reconstruction: one pass, no intermediate tuples
    arrays = []
    off = meta_end
    try:
        for _ in range(n_arrays):
            dlen = meta[p]
            p += 1
            dt = _str_dtype(bytes(meta[p : p + dlen]).decode("ascii"))
            p += dlen
            ndim = meta[p]
            p += 1
            if ndim:
                shape = _shape_struct(ndim).unpack_from(meta, p)
                p += 8 * ndim
                n = 1
                for d in shape:
                    if d < 0:
                        raise FrameError(
                            f"negative plane dim in manifest: {shape}"
                        )
                    n *= d
            else:
                shape = ()
                n = 1
            arrays.append(_frombuffer(mv, dt, n, off).reshape(shape))
            off += n * dt.itemsize
    except FrameError:
        raise
    except (IndexError, struct.error, UnicodeDecodeError, TypeError,
            ValueError, OverflowError) as e:
        # same contract as _dec_obj: EVERY decode failure mode is the one
        # typed reject — nothing escapes to kill the recv thread
        raise FrameError(f"garbled manifest block: {e}") from e
    keys = arrays.pop(0) if flags & FLAG_HAS_KEYS else None
    return Message(
        task=Task(
            kind=_KINDS[kind_i], customer=customer, time=time_,
            wait_time=wait_time, payload=payload,
        ),
        sender=sender,
        recver=recver,
        keys=keys,
        values=arrays,
        is_request=bool(flags & FLAG_REQUEST),
    )


def frame_nbytes(msg: Message) -> Tuple[int, int]:
    """(total frame bytes, non-plane overhead bytes) for ``msg`` as the
    codec would put it on the wire — exact, without building the frame.

    Plane sizes, dtypes and ranks are read off the arrays and tensors
    (metadata only: no device sync for a tensor on the card, which is sized
    as the CPU tensor of the same values would be framed); the overhead is
    the fixed header plus the meta section actually encoded (stamps lifted
    into the header contribute zero variable bytes, so the estimate is
    invariant to resender/metering stamps by construction).
    """
    planes = 0
    manifest_len = 0
    for v in ([msg.keys] if msg.keys is not None else []) + list(msg.values):
        if isinstance(v, torch.Tensor):
            name = _torch_dtype_str(v.dtype)
        else:
            if not isinstance(v, np.ndarray):
                v = np.asarray(v)
            name = _dtype_str(v.dtype)
        planes += int(v.nbytes)
        # max(ndim, 1): the codec frames 0-d planes as shape (1,)
        manifest_len += 2 + len(name) + 8 * max(v.ndim, 1)
    payload = msg.task.payload
    if isinstance(payload, dict) and payload:
        # drop exactly the stamps encode would lift: int-typed AND within
        # the header field's range — an out-of-range stamp rides the meta
        # section in the real frame, so it must stay in the estimate too
        payload = {
            k: v
            for k, v in payload.items()
            if (r := _STAMP_RANGES.get(k)) is None
            or type(v) is not int
            or not r[0] <= v <= r[1]
        }
    meta = bytearray()
    for name in (msg.task.customer, msg.sender, msg.recver):
        (_enc_name if type(name) is str else _enc_obj)(name, meta)
    _enc_obj(msg.task.time, meta)
    _enc_obj(msg.task.wait_time, meta)
    _enc_obj(payload, meta)
    overhead = HEADER_SIZE + len(meta) + manifest_len
    return overhead + planes, overhead


class FrameCodecVan(VanWrapper):
    """Force every message through the flat wire representation.

    In-process stacks (LoopbackVan) normally deliver Message objects by
    reference; wrapping the base van in a ``FrameCodecVan`` makes them ride
    the exact bytes a TcpVan would put on the wire — encode, then decode
    into frombuffer views — so parity/chaos tests exercise the production
    frame path without sockets.  Non-codable messages (a tensor plane on
    the card: ``KVWorker.push_device``) pass through unframed, counted in
    ``frame_passthrough``.
    """

    def __init__(self, inner: Van) -> None:
        super().__init__(inner)
        self.frames = 0
        self.frame_bytes = 0
        self.frame_overhead_bytes = 0
        self.frame_passthrough = 0
        self.frame_rejects = 0

    def send(self, msg: Message) -> bool:
        try:
            data = encode(msg)
        except FrameError:
            self.frame_passthrough += 1
            return self.inner.send(msg)
        try:
            out = decode(data)
        except FrameError:
            self.frame_rejects += 1
            return True  # accepted by the "wire", lost to corruption
        self.frames += 1
        self.frame_bytes += len(data)
        self.frame_overhead_bytes += peek(data).overhead
        return self.inner.send(out)

    def counters(self) -> dict:
        return {
            "frames": self.frames,
            "frame_bytes": self.frame_bytes,
            "frame_overhead_bytes": self.frame_overhead_bytes,
            "frame_passthrough": self.frame_passthrough,
            "frame_rejects": self.frame_rejects,
        }
