"""The port's flat frame codec (``core/frame.py``) against the JAX package's.

Three parts, on the CPU:

1. **Twins of ``tests/test_frame.py``** on the port: the codec matrix
   (dtypes, empty and 0-row planes, keys=None, oversized meta), the typed
   rejects (truncation, garbled header, corrupt plane, every meta bit flip,
   fuzzing, negative dims, too many planes), the meta codec, stamp lifting,
   the control-frame fast path, ``frame_nbytes``, ``FrameCodecVan`` and the
   acceptance e2e runs (LR training over real frame bytes under drop,
   duplication and corruption; a live migration on flat frames), each
   bitwise equal to the port's own clean run.
2. **Cross-package frames**: over the codec matrix the two packages'
   ``encode`` give the same bytes, and each decodes the other's frame to an
   equal message (bfloat16: ``ml_dtypes.bfloat16`` on the JAX side,
   ``torch.bfloat16`` on the port's, equal bits); ``_fast_encode`` too; the
   two ``MeteredVan``s count the same frame bytes for the same traffic.
3. **Torch planes**: a CPU tensor frames as the numpy array of its values; a
   tensor on a device is not framed (``FrameCodecVan`` passes it through);
   a tensor in the payload is a typed reject; the resender's CRC agrees on
   both ends where the JAX one, over its own codec, does not.

Tolerances: frame bytes, stamps, counters and the port's chaos runs against
its clean run exactly; the port's clean run within 1e-4 of the JAX package's
(losses and tables, the multi-step tolerance).
"""

import random
import struct
import time
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ml_dtypes

from parameter_server_tpu import config as jax_config
from parameter_server_tpu.core import frame as jax_frame
from parameter_server_tpu.core import messages as jax_messages
from parameter_server_tpu.core import netmon as jax_netmon
from parameter_server_tpu.core import resender as jax_resender
from parameter_server_tpu.core import van as jax_van
from parameter_server_tpu.core.postoffice import Postoffice as JaxPostoffice
from parameter_server_tpu.data.synthetic import SyntheticCTR as JaxSyntheticCTR
from parameter_server_tpu.kv.server import KVServer as JaxKVServer
from parameter_server_tpu.kv.worker import KVWorker as JaxKVWorker
from parameter_server_tpu.models import linear as jax_linear
from parameter_server_tpu_torch import config as port_config
from parameter_server_tpu_torch.core import frame
from parameter_server_tpu_torch.core import messages as port_messages
from parameter_server_tpu_torch.core import resender as resender_mod
from parameter_server_tpu_torch.core.chaos import ChaosVan
from parameter_server_tpu_torch.core.coalesce import CoalescingVan
from parameter_server_tpu_torch.core.frame import FrameCodecVan, FrameError
from parameter_server_tpu_torch.core.messages import (
    INCARNATION_KEY,
    Message,
    NodeRole,
    Task,
    TaskKind,
)
from parameter_server_tpu_torch.core.netmon import MeteredVan
from parameter_server_tpu_torch.core.postoffice import Postoffice
from parameter_server_tpu_torch.core.resender import ReliableVan, payload_crc32
from parameter_server_tpu_torch.core.van import LoopbackVan
from parameter_server_tpu_torch.data.synthetic import SyntheticCTR
from parameter_server_tpu_torch.kv import routing as routing_mod
from parameter_server_tpu_torch.kv.migrate import ShardMigrator
from parameter_server_tpu_torch.kv.server import KVServer
from parameter_server_tpu_torch.kv.worker import KVWorker
from parameter_server_tpu_torch.models import linear

ROWS = 1 << 10
NUM_SERVERS = 2
STEPS = 12
TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)


def _msg(msgs=port_messages, **kw):
    defaults = dict(
        task=msgs.Task(msgs.TaskKind.PUSH, "t", payload={"table": "w"}),
        sender="W0",
        recver="S0",
        keys=np.arange(10, dtype=np.uint64),
        values=[np.arange(40, dtype=np.float32).reshape(10, 4)],
        is_request=True,
    )
    defaults.update(kw)
    return msgs.Message(**defaults)


def _roundtrip(msg):
    return frame.decode(frame.encode(msg))


def _dtype_name(x) -> str:
    return frame._torch_dtype_str(x.dtype) if isinstance(x, torch.Tensor) else str(x.dtype)


def _bits(x) -> bytes:
    """The raw bytes of an array or tensor (bfloat16 included)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous().reshape(-1)
        return t.view(torch.uint8).numpy().tobytes() if t.numel() else b""
    return np.ascontiguousarray(x).view(np.uint8).tobytes()


def _same(a, b) -> bool:
    """Payload equality across packages: arrays and tensors by dtype name,
    shape and bits; tuples and lists keep their type."""
    if isinstance(a, (np.ndarray, torch.Tensor)) or isinstance(b, (np.ndarray, torch.Tensor)):
        return (isinstance(a, (np.ndarray, torch.Tensor)) and isinstance(b, (np.ndarray, torch.Tensor))
                and _dtype_name(a) == _dtype_name(b) and tuple(a.shape) == tuple(b.shape)
                and _bits(a) == _bits(b))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same, a, b))
    return type(a) is type(b) and a == b


def _assert_messages_equal(a, b):
    assert a.task.kind.value == b.task.kind.value
    assert a.task.customer == b.task.customer
    assert a.task.time == b.task.time
    assert a.task.wait_time == b.task.wait_time
    assert _same(a.task.payload, b.task.payload)
    assert a.sender == b.sender and a.recver == b.recver
    assert a.is_request == b.is_request
    if a.keys is None:
        assert b.keys is None
    else:
        assert _same(a.keys, b.keys)
    assert len(a.values) == len(b.values)
    for va, vb in zip(a.values, b.values):
        assert _same(va, vb)


# ------------------------------------------------------- codec unit matrix


def _bf16_bits(raw):
    return (np.asarray(raw, np.float32).view(np.uint32) >> 16).astype(np.uint16)


def _bf16(raw, side="port"):
    """bfloat16 of the float32 values ``raw`` (truncated): a torch tensor on
    the port's side, an ``ml_dtypes`` array on the JAX side, equal bits."""
    bits = _bf16_bits(raw)
    if side == "jax":
        return bits.view(ml_dtypes.bfloat16)
    return torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)


@pytest.mark.parametrize("dtype", ["f32", "f16", "bf16", "int8", "bool", "int64"])
def test_value_dtype_roundtrip(dtype):
    rng = np.random.default_rng(0)
    raw = rng.standard_normal((6, 3))
    if dtype == "bf16":
        vals = _bf16(raw)
    elif dtype == "bool":
        vals = raw > 0
    else:
        vals = raw.astype({"f32": np.float32, "f16": np.float16, "int8": np.int8,
                           "int64": np.int64}[dtype])
    msg = _msg(values=[vals])
    got = _roundtrip(msg)
    _assert_messages_equal(msg, got)
    if dtype == "bf16":  # a zero-copy torch view of the frame
        assert isinstance(got.values[0], torch.Tensor) and got.values[0].dtype == torch.bfloat16


def test_empty_values_and_no_keys():
    msg = _msg(keys=None, values=[])
    _assert_messages_equal(msg, _roundtrip(msg))
    info = frame.peek(frame.encode(msg))
    assert info.n_arrays == 0 and info.planes_len == 0
    assert not info.flags & frame.FLAG_HAS_KEYS


def test_zero_row_plane_roundtrip():
    msg = _msg(keys=np.empty(0, dtype=np.uint64), values=[np.empty((0, 4), dtype=np.float32)])
    got = _roundtrip(msg)
    _assert_messages_equal(msg, got)
    assert got.values[0].shape == (0, 4)


def test_scalar_plane_promotes_like_seed_codec():
    got = _roundtrip(_msg(keys=None, values=[np.float32(3.5)]))
    assert got.values[0].shape == (1,)
    assert got.values[0][0] == np.float32(3.5)
    got = _roundtrip(_msg(keys=None, values=[torch.tensor(3.5)]))  # 0-d tensor alike
    assert got.values[0].shape == (1,) and got.values[0][0] == np.float32(3.5)


def test_oversized_meta_roundtrip():
    msg = _msg(task=Task(TaskKind.CONTROL, "t",
                         payload={"blob": "x" * 300_000, "ints": list(range(5000))}),
               keys=None, values=[])
    _assert_messages_equal(msg, _roundtrip(msg))


def test_decoded_planes_are_zero_copy_views():
    buf = frame.encode(_msg())
    got = frame.decode(buf)
    wire = np.frombuffer(buf, dtype=np.uint8)
    assert np.shares_memory(wire, got.keys)
    assert np.shares_memory(wire, got.values[0])
    assert not got.values[0].flags.writeable  # views of immutable bytes


def test_truncated_frame_is_typed_reject():
    buf = frame.encode(_msg())
    for cut in (0, 1, frame.HEADER_SIZE - 1, frame.HEADER_SIZE + 3, len(buf) - 1):
        with pytest.raises(FrameError):
            frame.decode(buf[:cut])


def test_garbled_header_is_typed_reject():
    buf = bytearray(frame.encode(_msg()))
    buf[5] ^= 0xFF
    with pytest.raises(FrameError, match="header CRC"):
        frame.peek(bytes(buf))


def test_bad_magic_and_version_are_typed_rejects():
    good = frame.encode(_msg())
    with pytest.raises(FrameError):
        frame.decode(b"ZZ" + good[2:])
    with pytest.raises(FrameError):
        frame.decode(b"\x00" * 64)


def test_corrupt_plane_is_typed_reject_and_verify_false_tolerates():
    buf = bytearray(frame.encode(_msg()))
    info = frame.peek(bytes(buf))
    buf[frame.HEADER_SIZE + info.meta_len + 7] ^= 0x10
    data = bytes(buf)
    assert not frame.verify_planes(data)
    with pytest.raises(FrameError, match="plane CRC"):
        frame.decode(data)
    assert frame.decode(data, verify=False).keys.shape == (10,)


def _fuzz_msg():
    return _msg(task=Task(TaskKind.PUSH, "t", payload={
        "table": "w",
        "scales": np.linspace(0.1, 1.0, 5, dtype=np.float32),
        "nested": (1, [2, "x"], b"\x00\xff"),
        "big": 1 << 80,
    }))


def test_every_meta_bit_flip_is_typed_reject():
    good = frame.encode(_fuzz_msg())
    info = frame.peek(good)
    for off in range(frame.HEADER_SIZE, frame.HEADER_SIZE + info.meta_len):
        for bit in (0, 3, 7):
            buf = bytearray(good)
            buf[off] ^= 1 << bit
            with pytest.raises(FrameError):
                frame.decode(bytes(buf))


def test_fuzzed_frames_never_escape_frameerror():
    good = frame.encode(_fuzz_msg())
    rng = random.Random(7)
    for _ in range(400):
        buf = bytearray(good)
        for _ in range(rng.randint(1, 4)):
            buf[rng.randrange(len(buf))] ^= 1 << rng.randrange(8)
        if rng.random() < 0.25:
            buf = buf[: rng.randrange(len(buf))]
        try:
            frame.decode(bytes(buf))
        except FrameError:
            pass


def _refix_crcs(buf: bytearray) -> bytes:
    fields = list(frame.HEADER.unpack_from(buf, 0))
    meta = bytes(buf[frame.HEADER_SIZE: frame.HEADER_SIZE + fields[11]])
    fields[10] = zlib.crc32(meta)
    frame.HEADER.pack_into(buf, 0, *fields[:-1], 0)
    struct.pack_into("<I", buf, frame.HEADER_SIZE - 4,
                     zlib.crc32(bytes(buf[: frame.HEADER_SIZE - 4])))
    return bytes(buf)


def test_negative_manifest_dim_is_typed_reject():
    buf = bytearray(frame.encode(_msg()))
    end = frame.HEADER_SIZE + frame.peek(bytes(buf)).meta_len
    assert struct.unpack_from("<q", buf, end - 8)[0] == 4
    struct.pack_into("<q", buf, end - 8, -4)
    with pytest.raises(FrameError, match="negative plane dim"):
        frame.decode(_refix_crcs(buf))


def test_negative_meta_ndarray_dim_is_typed_reject():
    out = bytearray()
    frame._enc_obj(np.arange(6, dtype=np.float32).reshape(2, 3), out)
    struct.pack_into("<q", out, 1 + 1 + 7 + 1, -2)
    with pytest.raises(FrameError, match="negative ndarray dim"):
        frame._dec_obj(bytes(out), 0)


def test_encode_overflowing_plane_count_is_typed_reject():
    msg = _msg(keys=None, values=[np.zeros(1, dtype=np.float32)] * 65600)
    with pytest.raises(FrameError, match="n_arrays"):
        frame.encode(msg)


# --------------------------------------------------- meta codec specifics


def test_meta_preserves_tuple_vs_list_and_bytes_and_bigint():
    payload = {"t": (1, 2, (3, "x")), "l": [1, 2, [3, "x"]], "b": b"\x00\xffraw",
               "big": 1 << 80, "neg": -(1 << 90), "f": 0.1, "none": None, "flag": True}
    got = _roundtrip(_msg(task=Task(TaskKind.CONTROL, "t", payload=payload),
                          keys=None, values=[]))
    gp = got.task.payload
    assert gp == payload
    assert type(gp["t"]) is tuple and type(gp["l"]) is list
    assert type(gp["t"][2]) is tuple and type(gp["l"][2]) is list
    assert type(gp["b"]) is bytes


def test_meta_ndarray_payload_roundtrip():
    scales = np.linspace(0.1, 2.0, 7, dtype=np.float32)
    out = _roundtrip(_msg(task=Task(TaskKind.PUSH, "t", payload={"q8_scales": scales})))
    out = out.task.payload["q8_scales"]
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, scales)


def test_meta_np_scalars_decay_to_python_values():
    got = _roundtrip(_msg(task=Task(TaskKind.PUSH, "t", payload={
        "n": np.int64(7), "x": np.float32(1.5), "b": np.bool_(True)}), keys=None, values=[]))
    gp = got.task.payload
    assert gp["n"] == 7 and type(gp["n"]) is int
    assert gp["x"] == 1.5 and type(gp["x"]) is float
    assert gp["b"] is True


def test_meta_enums_decay_to_their_value_not_str():
    got = _roundtrip(_msg(task=Task(TaskKind.CONTROL, "mgr", payload={
        "role": NodeRole.SCHEDULER, "kind": TaskKind.PUSH}), keys=None, values=[]))
    gp = got.task.payload
    assert gp["role"] == "scheduler"
    assert NodeRole(gp["role"]) is NodeRole.SCHEDULER
    assert TaskKind(gp["kind"]) is TaskKind.PUSH


@pytest.mark.parametrize("obj", [object(), torch.ones(3)], ids=["object", "tensor"])
def test_meta_unknown_type_is_typed_reject(obj):
    """A torch tensor inside the payload is as unknown to the meta codec as
    a ``jax.Array`` is to the JAX one."""
    with pytest.raises(FrameError, match="cannot encode"):
        frame.encode(_msg(task=Task(TaskKind.PUSH, "t", payload={"fn": obj})))


# ----------------------------------------------- header stamps + peek/dedup


def test_stamp_key_literals_match_their_owners():
    assert frame.SEQ_KEY == resender_mod.SEQ_KEY == jax_frame.SEQ_KEY
    assert frame.CRC_KEY == resender_mod.CRC_KEY == jax_frame.CRC_KEY
    assert frame.ROUTING_EPOCH_KEY == routing_mod.ROUTING_EPOCH_KEY == jax_frame.ROUTING_EPOCH_KEY
    assert frame.HEADER.format == jax_frame.HEADER.format and frame.HEADER_SIZE == 52
    assert frame.COMPRESSED_KEY == jax_frame.COMPRESSED_KEY


def _stamped_payload():
    return {"table": "w", resender_mod.SEQ_KEY: 7, INCARNATION_KEY: 2,
            routing_mod.ROUTING_EPOCH_KEY: 5, resender_mod.CRC_KEY: 123456}


def test_stamps_lift_into_header_and_reinstate():
    payload = _stamped_payload()
    buf = frame.encode(_msg(task=Task(TaskKind.PUSH, "t", payload=dict(payload))))
    info = frame.peek(buf)
    assert (info.seq, info.incarnation, info.epoch, info.e2e_crc) == (7, 2, 5, 123456)
    assert info.is_request
    bare = _msg(task=Task(TaskKind.PUSH, "t", payload={"table": "w"}))
    assert info.meta_len == frame.peek(frame.encode(bare)).meta_len
    assert frame.decode(buf).task.payload == payload


def test_encode_does_not_mutate_sender_payload():
    payload = {resender_mod.SEQ_KEY: 3, "table": "w"}
    frame.encode(_msg(task=Task(TaskKind.PUSH, "t", payload=payload)))
    assert payload == {resender_mod.SEQ_KEY: 3, "table": "w"}


def test_non_int_stamp_values_ride_meta_not_header():
    msg = _msg(task=Task(TaskKind.PUSH, "t", payload={resender_mod.SEQ_KEY: "not-an-int"}))
    buf = frame.encode(msg)
    info = frame.peek(buf)
    assert not info.flags & frame.FLAG_SEQ and info.seq is None
    assert frame.decode(buf).task.payload == {resender_mod.SEQ_KEY: "not-an-int"}


# ------------------------------------------- control-frame fast path


def _slow_encode(msg, codec=frame):
    orig = codec._fast_encode
    codec._fast_encode = lambda m: None
    try:
        return codec.encode(msg)
    finally:
        codec._fast_encode = orig


def _ctl(payload, *, kind="CONTROL", is_request=False, time=0, msgs=port_messages):
    return _msg(msgs, task=msgs.Task(msgs.TaskKind[kind], "t", time=time, payload=payload),
                keys=None, values=[], is_request=is_request)


def _fast_eligible(msgs=port_messages):
    return [
        _ctl({}, msgs=msgs),
        _ctl({resender_mod.SEQ_KEY: 7}, msgs=msgs),
        _ctl({resender_mod.SEQ_KEY: 7, INCARNATION_KEY: 2,
              routing_mod.ROUTING_EPOCH_KEY: 5, resender_mod.CRC_KEY: 123456}, msgs=msgs),
        _ctl({"rows": 42, "step": -3}, kind="PUSH", is_request=True, msgs=msgs),
        _ctl({"n": (1 << 63) - 1, "m": -(1 << 63)}, time=-12345, msgs=msgs),
    ]


def test_fast_path_is_byte_identical_to_general_encoder():
    for msg in _fast_eligible():
        fast = frame.encode(msg)
        assert frame._fast_encode(msg) is not None
        assert fast == _slow_encode(msg)
        _assert_messages_equal(frame.decode(fast), msg)


def test_fast_path_header_stamps_stay_peekable():
    info = frame.peek(frame.encode(_fast_eligible()[2]))
    assert info.seq == 7 and info.incarnation == 2
    assert info.epoch == 5 and info.e2e_crc == 123456


def test_fast_path_ineligible_payloads_fall_through():
    cases = [_ctl({"s": "text"}), _ctl({"b": True}), _ctl({"big": 1 << 70}),
             _ctl({resender_mod.SEQ_KEY: 1 << 70}), _ctl({"nested": {"x": 1}})]
    for msg in cases:
        assert frame._fast_encode(msg) is None
        _assert_messages_equal(frame.decode(frame.encode(msg)), msg)


def test_fast_path_never_mutates_payload():
    payload = {resender_mod.SEQ_KEY: 3, "count": 9}
    msg = _ctl(dict(payload))
    frame.encode(msg)
    assert msg.task.payload == payload


def test_fast_cache_hit_reencodes_value_changes(monkeypatch):
    monkeypatch.setattr(frame, "_FAST_ENC_CACHE", {})
    a = _ctl({resender_mod.SEQ_KEY: 1, "n": 10}, time=5)
    b = _ctl({resender_mod.SEQ_KEY: 2, "n": -20}, time=6)
    ea, eb = frame.encode(a), frame.encode(b)
    assert len(frame._FAST_ENC_CACHE) == 1
    assert ea != eb
    assert ea == _slow_encode(a) and eb == _slow_encode(b)


def test_fast_cache_cap_bounds_memory_not_correctness(monkeypatch):
    monkeypatch.setattr(frame, "_FAST_ENC_CACHE", {})
    monkeypatch.setattr(frame, "_FAST_CACHE_CAP", 2)
    for m in [_ctl({f"k{i}": i}) for i in range(4)]:
        assert frame.encode(m) == _slow_encode(m)
    assert len(frame._FAST_ENC_CACHE) == 2


def _nbytes_cases():
    return [
        _msg(),
        _msg(keys=None, values=[]),
        _msg(task=Task(TaskKind.PUSH, "t", payload={"table": "w", resender_mod.SEQ_KEY: 9,
                                                     INCARNATION_KEY: 1,
                                                     resender_mod.CRC_KEY: 42}),
             values=[np.arange(40, dtype=np.float32).reshape(10, 4),
                     np.arange(3, dtype=np.int32)]),
        _msg(values=[_bf16(np.zeros((5, 2)))]),
        _msg(values=[torch.arange(6, dtype=torch.float32).reshape(3, 2), torch.tensor(2.5)]),
        _msg(task=Task(TaskKind.PUSH, "t", payload={
            "table": "w", resender_mod.SEQ_KEY: 1 << 70, resender_mod.CRC_KEY: 1 << 40,
            INCARNATION_KEY: -(1 << 40), routing_mod.ROUTING_EPOCH_KEY: 1 << 35})),
    ]


def test_frame_nbytes_is_exact():
    for msg in _nbytes_cases():
        buf = frame.encode(msg)
        total, overhead = frame.frame_nbytes(msg)
        assert total == len(buf)
        assert overhead == frame.peek(buf).overhead


def test_frame_nbytes_sizes_a_device_plane_without_framing_it():
    """A tensor off the host (here on the ``meta`` device, which holds no
    data at all) is sized from its metadata as the CPU tensor of the same
    shape and dtype would frame, and ``encode`` refuses it, typed."""
    host = _msg(values=[torch.zeros((5, 3), dtype=torch.float32), _bf16(np.zeros(4))])
    dev = _msg(values=[torch.empty((5, 3), dtype=torch.float32, device="meta"),
                       torch.empty(4, dtype=torch.bfloat16, device="meta")])
    assert frame.frame_nbytes(dev) == frame.frame_nbytes(host) == (
        len(frame.encode(host)), frame.peek(frame.encode(host)).overhead)
    with pytest.raises(FrameError, match="not framed"):
        frame.encode(dev)


def test_payload_crc32_matches_header_plane_crc_for_plain_arrays():
    msg = _msg()
    assert payload_crc32(msg) == frame.peek(frame.encode(msg)).plane_crc


def _settle(predicate, deadline_s=5.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.005)
    return predicate()


def test_frame_codec_van_counters():
    van = FrameCodecVan(LoopbackVan())
    try:
        got = []
        van.bind("S0", got.append)
        msg = _msg()
        assert van.send(msg)
        assert _settle(lambda: len(got) == 1)
        _assert_messages_equal(msg, got[0])
        assert got[0] is not msg  # rode the wire bytes, not the reference
        c = van.counters()
        assert c["frames"] == 1 and c["frame_passthrough"] == 0
        assert c["frame_bytes"] == len(frame.encode(msg))
        assert c["frame_overhead_bytes"] == frame.peek(frame.encode(msg)).overhead
    finally:
        van.close()


def test_frame_codec_van_passes_a_device_plane_through_unframed():
    """The ``push_device`` shape: a plane off the host is delivered by
    reference, counted in ``frame_passthrough``; a CPU tensor plane is
    framed and arrives as the numpy array of its values."""
    van = FrameCodecVan(LoopbackVan())
    try:
        got = []
        van.bind("S0", got.append)
        dev_plane = torch.empty((10, 4), device="meta")
        assert van.send(_msg(values=[dev_plane]))
        assert van.send(_msg(values=[torch.arange(40, dtype=torch.float32).reshape(10, 4)]))
        assert _settle(lambda: len(got) == 2)
        assert got[0].values[0] is dev_plane
        assert isinstance(got[1].values[0], np.ndarray)
        np.testing.assert_array_equal(got[1].values[0], np.arange(40, dtype=np.float32).reshape(10, 4))
        c = van.counters()
        assert c["frame_passthrough"] == 1 and c["frames"] == 1
    finally:
        van.close()


# ------------------------------------------------------ cross-package frames


def _matrix(msgs, side):
    """The codec matrix, built with one package's message classes; the two
    sides' planes hold the same bits (bfloat16 as ``ml_dtypes`` on the JAX
    side, torch on the port's)."""
    rng = np.random.default_rng(11)
    raw = rng.standard_normal((6, 3))

    def m(**kw):
        return _msg(msgs, **kw)

    def t(payload, kind="PUSH", **kw):
        return msgs.Task(msgs.TaskKind[kind], "t", time=3, wait_time=2, payload=payload, **kw)

    cases = {
        "f32": m(values=[raw.astype(np.float32)]),
        "f16": m(values=[raw.astype(np.float16)]),
        "bf16": m(values=[_bf16(raw, side)]),
        "int8": m(values=[raw.astype(np.int8)]),
        "bool": m(values=[raw > 0]),
        "int64": m(values=[raw.astype(np.int64), rng.integers(0, 9, size=4).astype(np.int32)]),
        "empty_values": m(keys=None, values=[]),
        "keys_none": m(keys=None, values=[raw.astype(np.float32)]),
        "zero_rows": m(keys=np.empty(0, np.uint64), values=[np.empty((0, 4), np.float32),
                                                             _bf16(np.empty((0, 2)), side)]),
        "zero_d": m(keys=None, values=[np.float32(3.5), np.int64(-2)]),
        "tuple_list": m(task=t({"t": (1, 2, (3, "x")), "l": [1, [2, "y"]], "none": None,
                                "f": 0.1, "flag": False}, kind="CONTROL"), keys=None, values=[]),
        "bigint_bytes": m(task=t({"big": 1 << 80, "neg": -(1 << 90), "b": b"\x00\xffraw"})),
        "meta_ndarray": m(task=t({"q8_scales": np.linspace(0.1, 2.0, 7, dtype=np.float32),
                                  "routing": np.arange(6, dtype=np.int64).reshape(2, 3)})),
        "stamps_lifted": m(task=t(_stamped_payload())),
        "stamps_out_of_range": m(task=t({"table": "w", resender_mod.SEQ_KEY: 1 << 70,
                                         resender_mod.CRC_KEY: 1 << 40,
                                         INCARNATION_KEY: -(1 << 40),
                                         routing_mod.ROUTING_EPOCH_KEY: 1 << 35})),
        "trace_ctx": m(task=t({"table": "w", "__trace__": {"tid": "W0/w/3", "origin": "W0",
                                                            "t": 12.5}})),
        "compressed": m(task=t({"table": "w", frame.COMPRESSED_KEY: {
            "saved": 96, "planes": [(0, "q8", "float32", (10, 4), 0.25)]}}),
            values=[rng.integers(-127, 127, size=(10, 4)).astype(np.int8)]),
        "reply": m(task=t({"table": "w"}, kind="PULL"), is_request=False),
    }
    return cases


MATRIX = list(_matrix(port_messages, "port"))


@pytest.mark.parametrize("case", MATRIX)
def test_frames_are_byte_identical_across_packages(case):
    pm, jm = _matrix(port_messages, "port")[case], _matrix(jax_messages, "jax")[case]
    pb, jb = frame.encode(pm), jax_frame.encode(jm)
    assert pb == jb
    vec, n = frame.encode_vec(pm)
    assert n == len(pb) and b"".join(bytes(s) for s in vec) == pb
    assert frame.frame_nbytes(pm) == jax_frame.frame_nbytes(jm)
    if case == "compressed":
        assert frame.peek(pb).flags & frame.FLAG_COMPRESSED


@pytest.mark.parametrize("case", MATRIX)
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_each_package_decodes_the_others_frame(case, direction):
    pm, jm = _matrix(port_messages, "port")[case], _matrix(jax_messages, "jax")[case]
    # held to the receiving package's decode of its own frame (0-d planes
    # arrive as shape (1,) either way)
    if direction == "jax_to_port":
        got, want = frame.decode(jax_frame.encode(jm)), frame.decode(frame.encode(pm))
        assert type(got) is Message
    else:
        got, want = jax_frame.decode(frame.encode(pm)), jax_frame.decode(jax_frame.encode(jm))
    _assert_messages_equal(got, want)
    if case != "zero_d":
        _assert_messages_equal(got, pm if direction == "jax_to_port" else jm)


def test_cpu_tensor_planes_frame_as_their_numpy_arrays():
    rng = np.random.default_rng(3)
    arrs = [rng.standard_normal((7, 2)).astype(np.float32),
            rng.integers(0, 1 << 20, size=5).astype(np.int64), rng.standard_normal(3) > 0]
    as_numpy = _msg(values=arrs)
    as_tensors = _msg(values=[torch.from_numpy(a) for a in arrs])
    strided = _msg(values=[torch.from_numpy(arrs[0].T.copy()).T]
                   + [torch.from_numpy(a) for a in arrs[1:]])
    assert not strided.values[0].is_contiguous()
    assert frame.encode(as_tensors) == frame.encode(as_numpy) == jax_frame.encode(
        _msg(jax_messages, values=arrs))
    assert frame.encode(strided) == frame.encode(as_numpy)


@pytest.mark.parametrize("i", range(5))
def test_fast_encode_matches_jax(i):
    pm, jm = _fast_eligible()[i], _fast_eligible(jax_messages)[i]
    fast = frame._fast_encode(pm)
    assert fast is not None and fast == jax_frame._fast_encode(jm) == _slow_encode(jm, jax_frame)


@pytest.mark.parametrize("stamp", [False, True])
def test_metered_frame_bytes_match_jax(stamp):
    """The same traffic through both packages' ``MeteredVan``: equal payload,
    frame and overhead bytes, per link and in total."""
    pm_van = MeteredVan(LoopbackVan(), stamp=stamp)
    jm_van = jax_netmon.MeteredVan(jax_van.LoopbackVan(), stamp=stamp)
    try:
        for van in (pm_van, jm_van):
            for node in ("S0", "W0"):
                van.bind(node, lambda m: None)
        for case in MATRIX:
            for van, msgs, side in ((pm_van, port_messages, "port"), (jm_van, jax_messages, "jax")):
                assert van.send(_matrix(msgs, side)[case])
        pc, jc = pm_van.counters(), jm_van.counters()
        for k in ("wire_msgs", "wire_bytes", "wire_raw_bytes", "wire_frame_bytes",
                  "wire_overhead_bytes", "wire_links"):
            assert pc[k] == jc[k], k
        assert pc["wire_raw_bytes"] == pc["wire_bytes"] + 96  # the marker's saving
        for link, d in pm_van.links().items():
            j = jm_van.links()[link]
            assert (d["frame_bytes"], d["overhead_bytes"], d["raw_bytes"]) == (
                j["frame_bytes"], j["overhead_bytes"], j["raw_bytes"])
    finally:
        pm_van.close()
        jm_van.close()


# ------------------------------------------- the CRC rule on device planes


def test_jax_crc_disagrees_on_a_framed_device_plane_and_the_ports_agrees():
    """The JAX resender skips ``jax.Array`` planes by type, but its codec
    frames them, so the receiver hashes the numpy plane the sender skipped.
    The port frames a CPU tensor (hashed on both ends as the same bytes) and
    refuses to frame a tensor off the host (skipped on both ends)."""
    vals = np.arange(12, dtype=np.float32).reshape(4, 3)
    jm = _msg(jax_messages, values=[jnp.asarray(vals)])
    sent = jax_resender.payload_crc32(jm)
    received = jax_resender.payload_crc32(jax_frame.decode(jax_frame.encode(jm)))
    assert sent != received

    for plane in (torch.from_numpy(vals), vals, _bf16(vals)):
        pm = _msg(values=[plane])
        crc = payload_crc32(pm)
        assert crc == payload_crc32(frame.decode(frame.encode(pm)))
        assert crc == jax_resender.payload_crc32(_msg(jax_messages, values=[
            _bf16(vals, "jax") if isinstance(plane, torch.Tensor) and plane.dtype == torch.bfloat16
            else vals]))
    dev = _msg(values=[torch.empty((4, 3), device="meta")])
    with pytest.raises(FrameError):
        frame.encode(dev)  # FrameCodecVan passes it by reference ...
    assert payload_crc32(dev) == payload_crc32(_msg(values=[]))  # ... and neither end hashes it


# ----------------------------------------------------------- acceptance e2e


def _table_cfgs(cfg=port_config):
    return {"w": cfg.TableConfig(
        name="w", rows=ROWS, dim=1,
        optimizer=cfg.OptimizerConfig(kind="adagrad", learning_rate=0.1))}


def _batches(synthetic=SyntheticCTR):
    data = synthetic(key_space=4 * ROWS, nnz=8, batch_size=128, seed=3)
    return [data.next_batch() for _ in range(STEPS)]


def _train(worker, batches, on_step=None):
    losses = []
    for i, (keys, labels) in enumerate(batches):
        w_pos = worker.pull_sync("w", keys, timeout=60)
        g, _gb, loss = linear.grad_rows(torch.from_numpy(np.asarray(w_pos)),
                                        torch.from_numpy(labels.astype(np.float32)))
        worker.push_sync("w", keys, g.numpy() / labels.shape[0], timeout=60)
        losses.append(float(loss))
        if on_step is not None:
            on_step(i)
    return losses


def _cluster(van):
    servers = [KVServer(Postoffice(f"S{s}", van), _table_cfgs(), s, NUM_SERVERS, device="cpu")
               for s in range(NUM_SERVERS)]
    return servers, KVWorker(Postoffice("W0", van), _table_cfgs(), NUM_SERVERS, device="cpu")


def _tables(servers):
    return [(e["value"], e["state"]["sum_sq"]) for e in (s.export_shard()["w"] for s in servers)]


def _close(van, servers):
    van.close()
    for s in servers:
        if s.ledger is not None:
            s.ledger.close()


_CLEAN = {}


def _clean_reference():
    """The port's uninterrupted run on a clean LoopbackVan: (losses, applied
    pushes, both shards' value and sum_sq); computed once."""
    if "port" not in _CLEAN:
        van = LoopbackVan()
        servers, worker = _cluster(van)
        try:
            losses = _train(worker, _batches())
            _CLEAN["port"] = (losses, sum(s.pushes for s in servers), _tables(servers))
        finally:
            _close(van, servers)
    return _CLEAN["port"]


def _assert_tables_equal(got, want):
    for (gv, gs), (wv, ws) in zip(got, want):
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gs, ws)


def test_port_clean_run_matches_jax():
    """The clean run every chaos and framed run is held to, against the JAX
    package's clean run: losses and tables within 1e-4."""
    losses, applied, tables = _clean_reference()
    van = jax_van.LoopbackVan()
    try:
        servers = [JaxKVServer(JaxPostoffice(f"S{s}", van), _table_cfgs(jax_config), s,
                               NUM_SERVERS) for s in range(NUM_SERVERS)]
        worker = JaxKVWorker(JaxPostoffice("W0", van), _table_cfgs(jax_config), NUM_SERVERS)
        ref = []
        for keys, labels in _batches(JaxSyntheticCTR):
            w_pos = worker.pull_sync("w", keys, timeout=60)
            g, _gb, loss = jax_linear.grad_rows(jnp.asarray(w_pos), jnp.asarray(labels))
            worker.push_sync("w", keys, np.asarray(g) / labels.shape[0], timeout=60)
            ref.append(float(loss))
        np.testing.assert_allclose(losses, ref, **TRAJ_TOL)
        assert applied == sum(s.pushes for s in servers)
        for (v, sq), srv in zip(tables, servers):
            exp = srv.export_shard()["w"]
            np.testing.assert_allclose(v, np.asarray(exp["value"]), **TRAJ_TOL)
            np.testing.assert_allclose(sq, np.asarray(exp["state"]["sum_sq"]), **TRAJ_TOL)
    finally:
        van.close()


def _framed_stack(*, seed=0, timeout=0.1, max_retries=60, **chaos_kw):
    """Coalesce(Metered(Reliable(Chaos(FrameCodec(Loopback))))): every
    message is encoded to a flat frame and decoded into frombuffer views."""
    codec = FrameCodecVan(LoopbackVan())
    chaos = ChaosVan(codec, seed=seed, **chaos_kw)
    rel = ReliableVan(chaos, timeout=timeout, backoff=1.0, max_retries=max_retries, seed=seed)
    metered = MeteredVan(rel, stamp=False)
    return CoalescingVan(metered), rel, chaos, codec, metered


@pytest.mark.chaos
@pytest.mark.parametrize("seed", [0, 1])
def test_training_on_flat_frames_under_chaos_matches_clean_run(seed):
    ref_losses, ref_applied, ref_tables = _clean_reference()
    van, rel, chaos, codec, metered = _framed_stack(
        seed=seed, drop=0.05, duplicate=0.05, corrupt=0.05)
    servers = []
    try:
        servers, worker = _cluster(van)
        losses = _train(worker, _batches())
        assert losses == ref_losses  # bitwise
        _assert_tables_equal(_tables(servers), ref_tables)
        assert sum(s.pushes for s in servers) == ref_applied  # exactly once
        assert van.flush(10)
        assert rel.gave_up == 0
        assert chaos.injected_drops + chaos.injected_dups > 0
        assert chaos.injected_corrupt > 0
        assert rel.rejected_corrupt > 0
        c = codec.counters()
        assert c["frames"] > 0
        assert c["frame_passthrough"] == 0
        assert c["frame_bytes"] > c["frame_overhead_bytes"] > 0
        mc = metered.counters()
        assert mc["wire_frame_bytes"] > mc["wire_bytes"]
        assert mc["wire_overhead_bytes"] > 0
    finally:
        _close(van, servers)


@pytest.mark.migration
def test_live_migration_rides_flat_frames():
    """Mid-run migration with the worker left stale, on flat frames end to
    end: fence rejects, refresh, convergence; bitwise the clean run."""
    ref_losses, ref_applied, _ = _clean_reference()
    van, rel, chaos, codec, _metered = _framed_stack(seed=3, drop=0.02)
    servers = []
    try:
        servers, worker = _cluster(van)
        mig = ShardMigrator(Postoffice("M0", van), chunk_rows=256)
        moved = {}

        def on_step(i):
            if i == STEPS // 2:
                moved["routing"] = mig.migrate(worker.routing, "w", 768, ROWS, 0)

        losses = _train(worker, _batches(), on_step=on_step)
        assert losses == ref_losses
        assert sum(s.pushes for s in servers) == ref_applied
        assert sum(s.fenced_rejects for s in servers) > 0
        assert worker.refresh_retries > 0
        assert worker.routing.epoch == moved["routing"].epoch
        assert codec.counters()["frame_passthrough"] == 0
        assert rel.gave_up == 0
        assert van.flush(10)
    finally:
        _close(van, servers)
