"""Wire filters: symmetric per-link message codecs.

The port's copy of ``parameter_server_tpu/core/filters.py``.  Each link of
a van may apply a filter chain on send and the inverse chain on receive:
key-list caching (skip resending an identical key array), zlib compression,
float -> int8 fixed point (``ops/quantize.py``), and the error-feedback
int8 / fp8 codec that ``CoalescingVan(codec=...)`` runs once a frame.

Filters mutate copies of the Message and satisfy ``decode(encode(msg)) ==
msg`` (up to quantization error for the lossy ones).  For the same values
every filter writes the same arrays and payload entries as the JAX
package's, so the frames on the wire are byte-identical.

A plane may be a numpy array or a tensor.  A CPU tensor is read in place
(``Tensor.numpy()``); a plane on the card is copied to the host once, with
a synchronising ``Tensor.cpu()``, where a filter must read its values: the
JAX filters read a ``jax.Array`` the same way (``np.asarray``).  A socket
never sees such a plane: ``TcpVan.send`` refuses it before any filter runs
(``core/tcp_van.py``).
"""

from __future__ import annotations

import hashlib
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from parameter_server_tpu_torch.config import WireCompressionConfig
from parameter_server_tpu_torch.core import flightrec
from parameter_server_tpu_torch.core.frame import COMPRESSED_KEY
from parameter_server_tpu_torch.core.messages import Message, TaskKind
from parameter_server_tpu_torch.ops.quantize import (
    dequantize_fp8,
    dequantize_int8,
    quantize_fp8,
    quantize_int8,
)

# Bundle frame constants, mirrored from core/coalesce.py (importing it here
# would cycle through core/van.py); test_compress asserts they stay equal.
_BUNDLE_CUSTOMER = "__bundle__"
_BUNDLE_KEY = "__subs__"
# Hierarchical-push group stamp, mirrored from kv/routing.py::GROUP_KEY
# (same cycle argument); test_group asserts they stay equal.  A PUSH whose
# stamp says ``ef: "bypass"`` skips the quantizer entirely: under rotating
# leader election the error-feedback residual owner would change every
# step, so compression is DISABLED for group frames rather than replaying
# another member's carried error (``ef: "leader"`` — fixed election — keeps
# quantizing; the pinned leader's (sender, table) store owns the group's
# residual).  See config.GroupConfig.
_GROUP_KEY = "__grp__"


def _group_bypass(payload) -> bool:
    """True when a PUSH payload's group stamp opts out of quantization."""
    grp = payload.get(_GROUP_KEY) if isinstance(payload, dict) else None
    return grp is not None and grp.get("ef") == "bypass"


def _host(a) -> np.ndarray:
    """A plane's values as a numpy array: itself, a CPU tensor's numpy view,
    or one synchronising copy of a tensor on another device."""
    if isinstance(a, torch.Tensor):
        t = a.detach()
        return (t if t.device.type == "cpu" else t.cpu()).numpy()
    return np.asarray(a)


def _msg_copy(msg: Message) -> Message:
    import dataclasses

    # copy the Task too: filters rewrite payload, and the sender's Message
    # object must stay untouched (Customer bookkeeping aliases it).
    task = dataclasses.replace(msg.task, payload=dict(msg.task.payload))
    return Message(
        task=task,
        sender=msg.sender,
        recver=msg.recver,
        keys=msg.keys,
        values=list(msg.values),
        is_request=msg.is_request,
    )


class Filter:
    """Filters with mutable per-link state guard it themselves (``_lock``);
    the Van applies chains concurrently from many sender threads."""

    name = "base"
    #: True when encode/decode need no per-link shared state, so the codec
    #: may run on paths without a route-table identity (e.g. TcpVan replies
    #: over the requester's connection).  KeyCaching is the stateful one.
    stateless = True

    def encode(self, msg: Message) -> Message:
        return msg

    def decode(self, msg: Message) -> Message:
        return msg

    def on_send_failed(
        self, msg: Message, encoded: Optional[Message] = None
    ) -> None:
        """Hook: the wire write for an encoded ``msg`` did not happen.

        Filters that committed per-link state during encode must roll it
        back here, or the link state desynchronizes from what the receiver
        actually saw.  ``encoded`` (when the Van has it) is the post-chain
        message, for filters whose rollback needs the encoded sizes.
        """


class KeyCachingFilter(Filter):
    """Drop the key array when the receiver has seen it (hash match).

    The reference caches key lists per link with a checksum
    (``src/filter/key_caching.h``); repeated pulls/pushes over the same
    key set (block iterations) then ship only the hash.
    """

    name = "key_caching"
    stateless = False

    def __init__(self) -> None:
        self._send_cache: Dict[tuple, Tuple[int, np.ndarray]] = {}
        self._recv_cache: Dict[tuple, Tuple[int, np.ndarray]] = {}
        self._lock = threading.Lock()
        self.hits = 0

    @staticmethod
    def _link(msg: Message) -> tuple:
        return (msg.sender, msg.recver, msg.task.customer, msg.task.kind)

    @staticmethod
    def _hash(keys: np.ndarray) -> int:
        # Order- and multiplicity-sensitive: hash the raw bytes (a permuted
        # key array must NOT hash-match, or values silently misalign).
        a = np.ascontiguousarray(_host(keys))
        d = hashlib.blake2b(
            a.tobytes(), digest_size=8, person=a.dtype.str.encode()
        )
        return int.from_bytes(d.digest(), "little")

    def encode(self, msg: Message) -> Message:
        if msg.keys is None:
            return msg
        link = self._link(msg)
        h = self._hash(msg.keys)
        out = _msg_copy(msg)
        out.task.payload = dict(msg.task.payload, key_hash=h)
        with self._lock:
            cached = self._send_cache.get(link)
            if cached is not None and cached[0] == h:
                out.keys = None  # receiver restores from its cache
                self.hits += 1
            else:
                self._send_cache[link] = (h, msg.keys)
        return out

    def on_send_failed(
        self, msg: Message, encoded: Optional[Message] = None
    ) -> None:
        # The receiver never saw this frame: drop the link's send cache so
        # the next send re-ships the key list instead of a hash the peer
        # cannot resolve (which would poison every later hit on this set).
        with self._lock:
            self._send_cache.pop(self._link(msg), None)

    def decode(self, msg: Message) -> Message:
        h = msg.task.payload.get("key_hash")
        if h is None:
            return msg
        link = self._link(msg)
        out = _msg_copy(msg)
        with self._lock:
            if out.keys is None:
                cached = self._recv_cache.get(link)
                if cached is None or cached[0] != h:
                    raise RuntimeError(
                        f"key-cache miss on {link}: receiver lost the key list"
                    )
                out.keys = cached[1]
            else:
                self._recv_cache[link] = (h, out.keys)
        out.task.payload = {
            k: v for k, v in out.task.payload.items() if k != "key_hash"
        }
        return out


class CompressingFilter(Filter):
    """zlib-compress value AND key arrays (the reference's LZ4 role).

    Keys matter as much as values on this wire: pull requests are nothing
    but keys, and the sorted unique row ids the worker ships compress far
    better than random bytes.
    """

    name = "compressing"

    def __init__(self, level: int = 1) -> None:
        self.level = level
        self.bytes_in = 0
        self.bytes_out = 0
        self._lock = threading.Lock()  # counters only; codec is stateless

    def _compress(self, arr: np.ndarray) -> np.ndarray:
        raw = np.ascontiguousarray(_host(arr)).tobytes()
        comp = zlib.compress(raw, self.level)
        with self._lock:
            self.bytes_in += len(raw)
            self.bytes_out += len(comp)
        return np.frombuffer(comp, np.uint8)

    def encode(self, msg: Message) -> Message:
        out = _msg_copy(msg)
        blobs = []
        meta = []
        for v in msg.values:
            v = _host(v)
            blobs.append(self._compress(v))
            meta.append((v.dtype.str, v.shape))
        out.values = blobs
        payload = dict(msg.task.payload, zlib_meta=meta)
        if msg.keys is not None:
            k = _host(msg.keys)
            out.keys = self._compress(k)
            payload["zlib_keys"] = (k.dtype.str, k.shape)
        out.task.payload = payload
        return out

    def on_send_failed(
        self, msg: Message, encoded: Optional[Message] = None
    ) -> None:
        # Undo the byte accounting: encode committed bytes_in/bytes_out, but
        # the frame never hit the wire, so compressed_bytes()/wire totals
        # would overstate traffic on lossy links.  The encoded
        # message carries everything needed: blob sizes are the uint8 arrays
        # themselves, raw sizes reconstruct from the zlib_meta dtypes/shapes.
        if encoded is None:
            return
        meta = encoded.task.payload.get("zlib_meta")
        if meta is None:
            return
        raw = sum(
            int(np.dtype(dt).itemsize * np.prod(shape, dtype=np.int64))
            for dt, shape in meta
        )
        comp = sum(np.asarray(b).nbytes for b in encoded.values)
        kmeta = encoded.task.payload.get("zlib_keys")
        if kmeta is not None and encoded.keys is not None:
            dt, shape = kmeta
            raw += int(np.dtype(dt).itemsize * np.prod(shape, dtype=np.int64))
            comp += np.asarray(encoded.keys).nbytes
        with self._lock:
            self.bytes_in -= raw
            self.bytes_out -= comp

    def decode(self, msg: Message) -> Message:
        meta = msg.task.payload.get("zlib_meta")
        if meta is None:
            return msg
        out = _msg_copy(msg)
        out.values = [
            np.frombuffer(
                zlib.decompress(np.asarray(b).tobytes()), np.dtype(dt)
            ).reshape(shape)
            for b, (dt, shape) in zip(msg.values, meta)
        ]
        kmeta = msg.task.payload.get("zlib_keys")
        if kmeta is not None and msg.keys is not None:
            dt, shape = kmeta
            out.keys = np.frombuffer(
                zlib.decompress(np.asarray(msg.keys).tobytes()), np.dtype(dt)
            ).reshape(shape)
        out.task.payload = {
            k: v
            for k, v in out.task.payload.items()
            if k not in ("zlib_meta", "zlib_keys")
        }
        return out


def _resolve_per_row(per_row, v: np.ndarray) -> bool:
    """Resolve a ``per_row`` config (True | False | "auto") for one array.

    "auto" keeps the measured heuristic: per-row scales only pay off for
    wide rows — each costs 4 B of (uncompressed, header-borne) f32, so on
    narrow arrays (the dim=1 LR tables) they would rival the int8 payload
    itself and INFLATE wire bytes.
    """
    if per_row == "auto":
        return v.ndim >= 2 and v.shape[-1] >= 16
    return bool(per_row)


class FixingFloatFilter(Filter):
    """float32 -> int8 + scale per value array (fixing_float analogue).

    ``config`` (a :class:`WireCompressionConfig`) makes the scale layout
    and rounding explicit; legacy kwargs remain for the spec-string path.
    """

    name = "fixing_float"

    def __init__(
        self,
        stochastic: bool = False,
        seed: int = 0,
        config: Optional[WireCompressionConfig] = None,
    ) -> None:
        if config is not None:
            stochastic = stochastic or config.rounding == "stochastic"
            seed = config.seed if seed == 0 else seed
        self.per_row = config.per_row if config is not None else "auto"
        self.stochastic = stochastic
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()  # the RNG is not thread-safe

    def encode(self, msg: Message) -> Message:
        out = _msg_copy(msg)
        vals = []
        scales = []
        quantized = []
        for v in msg.values:
            v = _host(v)
            if v.dtype == np.float32 and v.size:
                per_row = _resolve_per_row(self.per_row, v)
                if self.stochastic:  # only the RNG path needs the lock
                    with self._lock:
                        q, s = quantize_int8(
                            v, per_row=per_row, stochastic=True,
                            rng=self._rng,
                        )
                else:
                    q, s = quantize_int8(v, per_row=per_row)
                vals.append(q)
                scales.append(s)
                quantized.append(True)
            else:
                vals.append(v)
                scales.append(None)
                quantized.append(False)
        out.values = vals
        out.task.payload = dict(
            msg.task.payload, q8_scales=scales, q8_mask=quantized
        )
        return out

    def decode(self, msg: Message) -> Message:
        mask = msg.task.payload.get("q8_mask")
        if mask is None:
            return msg
        scales = msg.task.payload["q8_scales"]
        out = _msg_copy(msg)
        out.values = [
            dequantize_int8(v, s) if is_q else v
            for v, s, is_q in zip(msg.values, scales, mask)
        ]
        out.task.payload = {
            k: v
            for k, v in msg.task.payload.items()
            if k not in ("q8_scales", "q8_mask")
        }
        return out


#: residual stores flip from sorted-sparse to dense slot-indexed arrays once
#: they hold this many keys (and the dense array stays under the byte cap):
#: past that point the per-push sorted merge costs more than the scatter.
_DENSE_PROMOTE_KEYS = 16384
_DENSE_MAX_BYTES = 64 << 20


class QuantizingFilter(Filter):
    """Error-feedback lossy codec for the PUSH value plane.

    Composed UNDER :class:`~parameter_server_tpu_torch.core.coalesce.CoalescingVan`
    (its ``codec=`` slot), so it runs ONCE per outgoing frame over the
    already-bundled value plane — member arrays are planes of the one
    bundle frame, quantized in a single pass with no re-encode.  Only PUSH
    *requests* are touched; PULL replies (the serving plane) stay bit-exact.

    Per ``(sender, table)`` the filter keeps a sorted-key residual store:
    the quantization error of each push is re-injected into the NEXT push
    for the same keys (gather by ``searchsorted``, commit by union merge)
    instead of lost — the EQuARX error-feedback scheme that makes lossy
    compression converge like the uncompressed run.  Residuals are keyed by
    sender because loopback test clusters share ONE van (and thus one codec
    instance) across every node.  EF is skipped (plain quantize) for planes
    whose key array is not strictly increasing: duplicate keys would make
    the residual scatter ambiguous.

    Lifecycle: :meth:`reset_residuals` drops stores on ``adopt_routing``
    (routing-epoch advance — key ranges moved), on a peer incarnation
    advance or same-id restart (``ReliableVan.on_incarnation_advance``),
    and on a failed wire write (``on_send_failed`` — the push never arrived
    and the app-level retry must not double-count carried error).

    Wire marker: payload ``COMPRESSED_KEY`` -> ``{"v": [entry|None per
    plane], "saved": bytes}`` where entry is ``(codec, fmt, dtype, shape,
    scale)``; the frame layer sets ``FLAG_COMPRESSED`` on it and MeteredVan
    uses ``saved`` to account raw vs wire bytes per link.  Decode is one
    table-gather/multiply per plane, straight off a read-only frombuffer
    view — no receive-side state.
    """

    name = "quantizing"
    stateless = True  # decode is marker-driven; residual state is keyed by
    # message content (sender/table), not by link identity

    def __init__(
        self,
        default: Optional[WireCompressionConfig] = None,
        per_table: Optional[Dict[str, WireCompressionConfig]] = None,
    ) -> None:
        self.default = default if default is not None else WireCompressionConfig()
        self.per_table = dict(per_table or {})
        self._lock = threading.Lock()
        self._rng = np.random.default_rng(self.default.seed)
        #: (sender, table) -> {"keys": int64[n] sorted, "vals": f32[n, ...],
        #: "sq": float running sum of squared residuals}
        self._residuals: Dict[Tuple[str, str], dict] = {}
        self.raw_bytes = 0
        self.wire_bytes = 0
        self.resets = 0

    # -- config -------------------------------------------------------------
    def _cfg(self, table: Optional[str]) -> WireCompressionConfig:
        cfg = self.per_table.get(table) if table is not None else None
        return cfg if cfg is not None else self.default

    # -- quantize core (callers hold self._lock: the RNG is not thread-safe)
    def _quantize_plane(self, cfg: WireCompressionConfig, g: np.ndarray):
        per_row = _resolve_per_row(cfg.per_row, g)
        stoch = cfg.rounding == "stochastic"
        rng = self._rng if stoch else None
        if cfg.codec == "int8":
            q, s = quantize_int8(g, per_row=per_row, stochastic=stoch, rng=rng)
            dq = dequantize_int8(q, s)
        else:
            q, s = quantize_fp8(
                g, fmt=cfg.fp8_format, per_row=per_row, stochastic=stoch,
                rng=rng,
            )
            dq = dequantize_fp8(q, s, fmt=cfg.fp8_format)
        return q, s, dq

    def _encode_value(
        self,
        cfg: WireCompressionConfig,
        sender: str,
        table: Optional[str],
        keys: Optional[np.ndarray],
        v: np.ndarray,
    ):
        """Quantize one plane, with error feedback when keys align with rows.

        Eligible key planes are the worker push layout: sorted unique slot
        ids, optionally padded to a power-of-two bucket with a constant
        trash-row tail (``utils.keys.localize_to_slots``).  EF covers the
        strictly-increasing real prefix; pad rows are zeros and quantize
        exactly, so skipping them loses nothing.
        """
        k = None
        n_real = 0
        if cfg.error_feedback and table is not None and keys is not None:
            ka = _host(keys)
            if ka.ndim == 1 and v.ndim >= 1 and ka.shape[0] == v.shape[0]:
                if ka.size < 2 or bool(np.all(ka[1:] > ka[:-1])):
                    n_real = ka.size
                else:
                    # padded bucket: real slots strictly increase, then a
                    # constant run of the localizer's trash row
                    p = int(np.searchsorted(ka, ka[-1], side="left"))
                    if (
                        p >= 1
                        and bool(np.all(ka[p:] == ka[-1]))
                        and bool(np.all(ka[1:p] > ka[: p - 1]))
                    ):
                        n_real = p
                if n_real:
                    k = ka[:n_real].astype(np.int64, copy=False).reshape(-1)
        if k is None:
            q, s, _dq = self._quantize_plane(cfg, v)
            return q, s
        st = self._residuals.get((sender, table))
        if st is not None and st["vals"].shape[1:] != v.shape[1:]:
            st = None  # table reshaped underneath us: the store is stale
        if st is not None and st.get("dense"):
            return self._ef_dense(cfg, st, k, n_real, v)
        pos = hit = None
        r = None
        if st is not None and len(st["keys"]):
            pos = np.minimum(
                np.searchsorted(st["keys"], k), len(st["keys"]) - 1
            )
            hit = st["keys"][pos] == k
            if hit.any():
                r = np.zeros_like(v, dtype=np.float32)
                r[:n_real][hit] = st["vals"][pos[hit]]
        g = v if r is None else v + r
        q, s, dq = self._quantize_plane(cfg, g)
        err = np.ascontiguousarray((g - dq)[:n_real], dtype=np.float32)
        if st is None:
            st = {"keys": k.copy(), "vals": err, "sq": float((err * err).sum())}
            self._residuals[(sender, table)] = st
            self._maybe_promote_dense(st)
            return q, s
        # Commit without re-sorting: both key arrays are sorted, so hits
        # update in place (reusing the gather's searchsorted) and misses
        # splice in with one O(n) np.insert — the union1d rebuild this
        # replaces cost ~2.5 ms/step at the bench's 8k-key pushes.
        sq = st["sq"] + float((err * err).sum())
        if hit is not None and hit.any():
            old = st["vals"][pos[hit]]
            sq -= float((old * old).sum())
            st["vals"][pos[hit]] = err[hit]
            new = ~hit
        else:
            new = np.ones(len(k), dtype=bool)
        if new.any():
            nk = k[new]
            idx = np.searchsorted(st["keys"], nk)
            st["keys"] = np.insert(st["keys"], idx, nk)
            st["vals"] = np.insert(st["vals"], idx, err[new], axis=0)
        st["sq"] = max(sq, 0.0)
        self._maybe_promote_dense(st)
        return q, s

    def _maybe_promote_dense(self, st: dict) -> None:
        """Flip a hot sparse store to a slot-indexed dense array.

        Slot ids are bounded by the sender's localizer capacity, so once a
        store holds enough keys the O(n) sorted-merge per push costs more
        than a dense table it could scatter into directly.  Promotion is
        gated on the projected array size so fat-dim tables stay sparse.
        """
        if len(st["keys"]) < _DENSE_PROMOTE_KEYS:
            return
        tail = st["vals"].shape[1:]
        # slot ids come from power-of-two localizer buckets: round capacity
        # up so later pushes with higher slots rarely force a regrow
        cap = 1 << int(st["keys"][-1]).bit_length()
        if cap * int(np.prod(tail, dtype=np.int64)) * 4 > _DENSE_MAX_BYTES:
            return
        dense = np.zeros((cap,) + tail, np.float32)
        dense[st["keys"]] = st["vals"]
        st["vals"] = dense
        st["dense"] = True
        del st["keys"]

    def _ef_dense(self, cfg, st: dict, k, n_real: int, v: np.ndarray):
        """Error-feedback round trip against a dense slot-indexed store."""
        dense = st["vals"]
        top = int(k[-1])
        if top >= dense.shape[0]:
            cap = 1 << top.bit_length()  # pow2 growth: amortize regrows
            pad = np.zeros(
                (cap - dense.shape[0],) + dense.shape[1:], np.float32
            )
            dense = np.concatenate([dense, pad])
            st["vals"] = dense
        old = dense[k]
        g = v.astype(np.float32, copy=True)
        g[:n_real] += old
        q, s, dq = self._quantize_plane(cfg, g)
        err = np.ascontiguousarray((g - dq)[:n_real], dtype=np.float32)
        dense[k] = err
        st["sq"] = max(
            st["sq"] + float((err * err).sum()) - float((old * old).sum()), 0.0
        )
        return q, s

    # -- codec --------------------------------------------------------------
    def encode(self, msg: Message) -> Message:
        if not msg.is_request:
            return msg
        payload = msg.task.payload
        if (
            msg.task.customer == _BUNDLE_CUSTOMER
            and payload.get(_BUNDLE_KEY) is not None
        ):
            return self._encode_bundle(msg)
        if msg.task.kind is not TaskKind.PUSH:
            return msg
        if _group_bypass(payload):
            return msg
        table = payload.get("table")
        cfg = self._cfg(table)
        if cfg.codec == "none" or not msg.values:
            return msg
        entries: List[Optional[tuple]] = [None] * len(msg.values)
        new_vals = list(msg.values)
        raw = wire = 0
        with self._lock:
            for i, v in enumerate(msg.values):
                v = _host(v)
                if v.dtype != np.float32 or not v.size:
                    continue
                q, s = self._encode_value(cfg, msg.sender, table, msg.keys, v)
                new_vals[i] = q
                entries[i] = (
                    cfg.codec, cfg.fp8_format, v.dtype.str, tuple(v.shape), s
                )
                raw += v.nbytes
                wire += q.nbytes + np.asarray(s).nbytes
        return self._finish_encode(msg, entries, new_vals, raw, wire)

    def _encode_bundle(self, msg: Message) -> Message:
        """One pass over a CoalescingVan bundle's concatenated value plane."""
        index = msg.task.payload[_BUNDLE_KEY]
        key_bytes = (
            np.ascontiguousarray(_host(msg.keys)).reshape(-1).view(np.uint8)
            if msg.keys is not None
            else np.empty(0, dtype=np.uint8)
        )
        entries: List[Optional[tuple]] = [None] * len(msg.values)
        new_vals = list(msg.values)
        raw = wire = 0
        k_off = v_off = 0
        with self._lock:
            for customer, kind, _t, _w, payload, is_request, key_meta, n_v in index:
                chunk = None
                if key_meta is not None:
                    dt, shape, nbytes = key_meta
                    chunk = key_bytes[k_off : k_off + nbytes]
                    k_off += nbytes
                if (
                    kind == TaskKind.PUSH.value
                    and is_request
                    and not _group_bypass(payload)
                ):
                    table = payload.get("table")
                    cfg = self._cfg(table)
                    if cfg.codec != "none":
                        keys = (
                            chunk.copy().view(np.dtype(dt)).reshape(shape)
                            if chunk is not None
                            else None
                        )
                        for j in range(v_off, v_off + n_v):
                            v = _host(msg.values[j])
                            if v.dtype != np.float32 or not v.size:
                                continue
                            q, s = self._encode_value(
                                cfg, msg.sender, table, keys, v
                            )
                            new_vals[j] = q
                            entries[j] = (
                                cfg.codec, cfg.fp8_format, v.dtype.str,
                                tuple(v.shape), s,
                            )
                            raw += v.nbytes
                            wire += q.nbytes + np.asarray(s).nbytes
                v_off += n_v
        return self._finish_encode(msg, entries, new_vals, raw, wire)

    def _finish_encode(self, msg, entries, new_vals, raw, wire) -> Message:
        if raw == 0:  # nothing quantizable on this frame
            return msg
        out = _msg_copy(msg)
        out.values = new_vals
        out.task.payload[COMPRESSED_KEY] = {
            "v": entries,
            "saved": int(raw - wire),
        }
        with self._lock:
            self.raw_bytes += raw
            self.wire_bytes += wire
        flightrec.record(
            "compress.encode",
            node=msg.sender,
            recver=msg.recver,
            planes=sum(e is not None for e in entries),
            bytes_in=raw,
            bytes_out=wire,
        )
        return out

    def decode(self, msg: Message) -> Message:
        wc = msg.task.payload.get(COMPRESSED_KEY)
        if wc is None:
            return msg
        out = _msg_copy(msg)
        vals = list(msg.values)
        n = 0
        for i, ent in enumerate(wc["v"]):
            if ent is None:
                continue
            codec, fmt, dt, shape, scale = ent
            q = np.asarray(vals[i])
            if codec == "int8":
                x = dequantize_int8(q, scale)
            else:
                x = dequantize_fp8(q, scale, fmt=fmt)
            vals[i] = np.ascontiguousarray(
                x.astype(np.dtype(dt), copy=False)
            ).reshape(tuple(shape))
            n += 1
        out.values = vals
        out.task.payload = {
            k: v for k, v in msg.task.payload.items() if k != COMPRESSED_KEY
        }
        flightrec.record(
            "compress.decode", node=msg.recver, sender=msg.sender, planes=n
        )
        return out

    def on_send_failed(
        self, msg: Message, encoded: Optional[Message] = None
    ) -> None:
        # The frame never hit the wire: any residual committed during its
        # encode describes error the receiver never absorbed, and the
        # app-level retry will re-push the full gradient.  Conservatively
        # drop this sender's stores rather than replay carried error twice.
        marker = (encoded or msg).task.payload.get(COMPRESSED_KEY)
        if marker is not None:
            self.reset_residuals(sender=msg.sender, reason="send_failed")

    # -- lifecycle / metrics ------------------------------------------------
    def reset_residuals(
        self,
        *,
        sender: Optional[str] = None,
        table: Optional[str] = None,
        reason: str = "manual",
    ) -> int:
        """Drop residual stores matching ``sender``/``table`` (None = all)."""
        with self._lock:
            doomed = [
                key
                for key in self._residuals
                if (sender is None or key[0] == sender)
                and (table is None or key[1] == table)
            ]
            for key in doomed:
                del self._residuals[key]
            self.resets += 1
        flightrec.record(
            "compress.residual_reset",
            node=sender if sender is not None else "*",
            table=table if table is not None else "*",
            reason=reason,
            dropped=len(doomed),
        )
        return len(doomed)

    def residual_norm(self) -> float:
        """L2 norm of every outstanding residual (the EF debt gauge)."""
        with self._lock:
            sq = sum(st["sq"] for st in self._residuals.values())
        return float(np.sqrt(max(sq, 0.0)))

    def counters(self) -> dict:
        with self._lock:
            raw, wire = self.raw_bytes, self.wire_bytes
            resets = self.resets
            sq = sum(st["sq"] for st in self._residuals.values())
        out = {
            "compress_raw_bytes": raw,
            "compress_wire_bytes": wire,
            "compress_resets": resets,
            "compress_residual_norm": round(float(np.sqrt(max(sq, 0.0))), 6),
        }
        if raw:
            out["compress_ratio_pct"] = round(100.0 * wire / raw, 2)
        return out


def find_quantizers(van) -> List[QuantizingFilter]:
    """Every QuantizingFilter reachable from a van stack, outermost-first.

    Walks ``.inner`` links, collecting CoalescingVan ``codec`` slots and any
    QuantizingFilter sitting inside a ``filter_chain`` — deduplicated by
    identity (VanWrapper ``__getattr__`` delegation would otherwise report
    the same codec at every level).  Workers use this from ``adopt_routing``
    to reset residuals without knowing the stack shape.
    """
    out: List[QuantizingFilter] = []
    seen: set = set()
    seen_vans: set = set()
    v = van
    while v is not None and id(v) not in seen_vans:
        seen_vans.add(id(v))
        codec = getattr(v, "codec", None)
        if isinstance(codec, QuantizingFilter) and id(codec) not in seen:
            seen.add(id(codec))
            out.append(codec)
        chain = getattr(v, "filter_chain", None)
        for f in getattr(chain, "filters", ()) or ():
            if isinstance(f, QuantizingFilter) and id(f) not in seen:
                seen.add(id(f))
                out.append(f)
        v = getattr(v, "inner", None)
    return out


class AddNoiseFilter(Filter):
    """Debug filter: Gaussian noise on float32 values at encode time.

    The reference ships an ``add_noise`` codec (``src/filter/add_noise.h``)
    for robustness experiments — perturb pushed gradients/pulled
    weights on the wire and watch whether training still converges (async
    SGD should; a brittle pipeline won't).  Decode is the identity: noise
    is injected, not round-tripped.
    """

    name = "add_noise"

    def __init__(self, sigma: float = 1e-3, seed: int = 0) -> None:
        self.sigma = sigma
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()  # the RNG is not thread-safe

    def encode(self, msg: Message) -> Message:
        out = _msg_copy(msg)
        vals = []
        for v in msg.values:
            v = _host(v)
            if v.dtype == np.float32 and v.size:
                with self._lock:
                    noise = self._rng.normal(0.0, self.sigma, v.shape)
                v = (v + noise).astype(np.float32)
            vals.append(v)
        out.values = vals
        return out


class FilterChain:
    """Apply filters in order on send, reverse order on receive.

    Tracks wall-clock spent encoding/decoding (``overhead()``) so the
    default-on codecs are justified by measurement: per-message codec cost
    vs the wire bytes it saves.
    """

    def __init__(self, filters: List[Filter]) -> None:
        self.filters = filters
        self._t_lock = threading.Lock()
        self.encode_ns = 0
        self.decode_ns = 0
        self.encode_calls = 0
        self.decode_calls = 0

    def encode(self, msg: Message) -> Message:
        t0 = time.perf_counter_ns()
        for f in self.filters:
            msg = f.encode(msg)
        dt = time.perf_counter_ns() - t0
        with self._t_lock:
            self.encode_ns += dt
            self.encode_calls += 1
        return msg

    def decode(self, msg: Message) -> Message:
        t0 = time.perf_counter_ns()
        for f in reversed(self.filters):
            msg = f.decode(msg)
        dt = time.perf_counter_ns() - t0
        with self._t_lock:
            self.decode_ns += dt
            self.decode_calls += 1
        return msg

    def overhead(self) -> dict:
        """Per-message codec cost: mean encode/decode microseconds."""
        with self._t_lock:
            return {
                "encode_us_per_msg": round(
                    self.encode_ns / max(self.encode_calls, 1) / 1e3, 2
                ),
                "decode_us_per_msg": round(
                    self.decode_ns / max(self.decode_calls, 1) / 1e3, 2
                ),
                "encode_calls": self.encode_calls,
                "decode_calls": self.decode_calls,
            }

    def on_send_failed(
        self, msg: Message, encoded: Optional[Message] = None
    ) -> None:
        for f in self.filters:
            f.on_send_failed(msg, encoded)

    def stateless_subchain(self) -> "FilterChain":
        """The per-link-state-free filters, SAME instances (shared counters).

        Decode is marker-driven (each filter acts only on its own payload
        keys), so a receiver's full chain correctly decodes messages encoded
        with this subset — the Van uses it on reply paths that lack a
        route-table link identity.
        """
        return FilterChain([f for f in self.filters if f.stateless])

    def compressed_bytes(self) -> Tuple[int, int]:
        """(bytes_in, bytes_out) summed over compressing members."""
        bi = bo = 0
        for f in self.filters:
            if isinstance(f, CompressingFilter):
                bi += f.bytes_in
                bo += f.bytes_out
        return bi, bo


def quantizer_from_tables(
    tables, default: Optional[WireCompressionConfig] = None
) -> Optional[QuantizingFilter]:
    """Build the CoalescingVan codec from per-table configs, or None.

    ``tables``: iterable of :class:`~parameter_server_tpu_torch.config.TableConfig`
    or a ``{name: TableConfig}`` dict (the shape servers/workers carry);
    their ``compression`` fields select per-table codecs; ``default``
    applies to tables without one.  Returns None when nothing asks for
    compression, so callers can pass the result straight to
    ``CoalescingVan(..., codec=...)``.
    """
    if isinstance(tables, dict):
        tables = tables.values()
    per_table = {
        t.name: t.compression
        for t in tables
        if getattr(t, "compression", None) is not None
    }
    if not per_table and (default is None or default.codec == "none"):
        return None
    return QuantizingFilter(default=default, per_table=per_table)


#: filter factories by spec token; order in the spec string = encode order.
_FILTER_FACTORIES = {
    "key_caching": KeyCachingFilter,
    "int8": FixingFloatFilter,
    "zlib": CompressingFilter,
    "noise": AddNoiseFilter,
    # the error-feedback int8 codec as a chain member (launcher opt-in);
    # the preferred composition is CoalescingVan(codec=...), where it runs
    # once per bundle, but in-chain it still handles bundle frames whole.
    "quantize": lambda: QuantizingFilter(
        WireCompressionConfig(codec="int8", error_feedback=True)
    ),
}

#: The launcher's default for socket vans: codecs on by default (the wire
#: reduction should not depend on remembering a flag), but the LOSSLESS pair,
#: so an unconfigured launch never trains on int8-quantized gradients.
#: ``"full"`` adds the lossy int8 quantizer as an explicit opt-in;
#: ``--filters none`` opts out entirely.  Keys and headers compress well
#: even where float mantissas do not.
DEFAULT_SPEC = "lossless"


def make_chain(spec: str) -> Optional[FilterChain]:
    """Build a chain from a launcher-friendly spec string.

    ``"none"``/empty -> None.  Otherwise a ``+``-separated pipeline over
    {key_caching, int8, zlib, noise}, applied in spec order on encode and
    reverse order on decode — e.g. ``"int8+zlib"`` quantizes then
    compresses (zlib over raw float mantissas saves ~nothing).  ``"lossless"`` = ``key_caching+zlib`` (the default — bit-
    exact on the wire); ``"full"`` = ``key_caching+int8+zlib``, which adds
    the LOSSY int8 gradient/weight quantizer and is an explicit opt-in.
    ``noise`` is the debug add_noise codec.
    """
    if spec in ("", "none", None):
        return None
    if spec == "lossless":
        spec = "key_caching+zlib"
    elif spec == "full":
        spec = "key_caching+int8+zlib"
    filters = []
    for part in spec.split("+"):
        if part not in _FILTER_FACTORIES:
            raise ValueError(
                f"unknown filter {part!r} in spec; have "
                f"{sorted(_FILTER_FACTORIES)} (or 'none'/'lossless'/'full')"
            )
        filters.append(_FILTER_FACTORIES[part]())
    return FilterChain(filters)
