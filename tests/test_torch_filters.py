"""The port's wire filters (``core/filters.py``) and quantizers
(``ops/quantize.py``) against the JAX package's, on the CPU.

- **Twins of ``tests/test_filters.py``** (11 cases) on the port's classes:
  int8 error bound and zeros, zlib roundtrip and savings, int8 fixed point,
  key caching, the full chain under a real push / pull over the port's
  ``LoopbackVan(filter_chain=...)``, the noise filter, ``make_chain`` specs,
  the chain's overhead counters and both send-failure rollbacks.
- **Cross-package bytes**: ``quantize_int8`` / ``quantize_fp8`` give the
  same codes and scales as the JAX functions for one seeded input and
  ``rng``; every filter spec encodes the same message sequence (a key-cache
  miss, then hits) into frames byte-identical to the JAX chain's, from
  numpy planes and from CPU tensor planes alike.

Tolerances: exact throughout, but for the twins' own quantization bounds
(as in the reference tests).
"""

import numpy as np
import pytest
import torch

from parameter_server_tpu.core import filters as jax_filters
from parameter_server_tpu.core import frame as jax_frame
from parameter_server_tpu.core import messages as jax_messages
from parameter_server_tpu.ops import quantize as jax_quantize
from parameter_server_tpu_torch.core import filters, frame
from parameter_server_tpu_torch.core.filters import (
    AddNoiseFilter,
    CompressingFilter,
    FilterChain,
    FixingFloatFilter,
    KeyCachingFilter,
    make_chain,
)
from parameter_server_tpu_torch.core import messages
from parameter_server_tpu_torch.core.messages import Message, Task, TaskKind
from parameter_server_tpu_torch.ops import quantize
from parameter_server_tpu_torch.ops.quantize import dequantize_int8, quantize_int8


def _msg(keys=None, values=(), msgs=messages, kind="PUSH", sender="W0"):
    return msgs.Message(
        task=msgs.Task(msgs.TaskKind[kind], "kv", payload={"table": "w"}),
        sender=sender,
        recver="S0",
        keys=keys,
        values=list(values),
    )


# -------------------------------------------------- twins of test_filters.py


def test_quantize_roundtrip_error_bound():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 16)).astype(np.float32)
    q, s = quantize_int8(x, per_row=True)
    err = np.abs(dequantize_int8(q, s) - x)
    # max error <= half a quant step per row
    step = np.max(np.abs(x), axis=1, keepdims=True) / 127.0
    assert np.all(err <= step * 0.5 + 1e-7)


def test_quantize_zero_array():
    q, s = quantize_int8(np.zeros((4, 4), np.float32))
    np.testing.assert_array_equal(dequantize_int8(q, s), 0.0)


def test_compressing_filter_roundtrip_and_savings():
    f = CompressingFilter()
    vals = [np.zeros((1000,), np.float32), np.arange(12, dtype=np.int32)]
    dec = f.decode(f.encode(_msg(values=vals)))
    np.testing.assert_array_equal(dec.values[0], vals[0])
    np.testing.assert_array_equal(dec.values[1], vals[1])
    assert f.bytes_out < f.bytes_in / 10  # zeros compress hard


def test_fixing_float_filter_roundtrip():
    f = FixingFloatFilter()
    rng = np.random.default_rng(1)
    vals = [rng.normal(size=(32, 8)).astype(np.float32),
            np.arange(5, dtype=np.int32)]  # ints pass through untouched
    dec = f.decode(f.encode(_msg(values=vals)))
    np.testing.assert_allclose(dec.values[0], vals[0], atol=0.05)
    np.testing.assert_array_equal(dec.values[1], vals[1])
    assert dec.values[1].dtype == np.int32


def test_key_caching_filter():
    f = KeyCachingFilter()
    keys = np.array([3, 5, 9], dtype=np.int32)
    m1 = f.decode(f.encode(_msg(keys=keys)))
    np.testing.assert_array_equal(m1.keys, keys)
    assert f.hits == 0
    # same keys again: the wire message drops them, decode restores them
    enc2 = f.encode(_msg(keys=keys))
    assert enc2.keys is None and f.hits == 1
    np.testing.assert_array_equal(f.decode(enc2).keys, keys)
    # different keys: cache refresh, no hit
    keys3 = np.array([1], dtype=np.int32)
    np.testing.assert_array_equal(f.decode(f.encode(_msg(keys=keys3))).keys, keys3)
    assert f.hits == 1


def test_filter_chain_end_to_end_through_van():
    """The full chain on the port's LoopbackVan under a real push / pull."""
    from parameter_server_tpu_torch.config import OptimizerConfig, TableConfig
    from parameter_server_tpu_torch.core.postoffice import Postoffice
    from parameter_server_tpu_torch.core.van import LoopbackVan
    from parameter_server_tpu_torch.kv.server import KVServer
    from parameter_server_tpu_torch.kv.worker import KVWorker

    chain = FilterChain([KeyCachingFilter(), FixingFloatFilter(), CompressingFilter()])
    van = LoopbackVan(filter_chain=chain)
    try:
        cfgs = {"w": TableConfig(name="w", rows=256, dim=4,
                                 optimizer=OptimizerConfig(kind="sgd", learning_rate=1.0))}
        _server = KVServer(Postoffice("S0", van), cfgs, 0, 1, device="cpu")
        worker = KVWorker(Postoffice("W0", van), cfgs, 1, min_bucket=16, device="cpu")
        keys = np.array([7, 7, 21], dtype=np.uint64)
        assert worker.wait(worker.push("w", keys, np.ones((3, 4), np.float32)), timeout=10)
        w = worker.pull_sync("w", keys, timeout=10)
        # lr=1 sgd: w = -combined_grad (quantization tolerance)
        np.testing.assert_allclose(w[0], -2.0, atol=0.1)
        np.testing.assert_allclose(w[2], -1.0, atol=0.1)
        worker.pull_sync("w", keys, timeout=10)  # same keys: a key-cache hit
        assert chain.filters[0].hits >= 1
    finally:
        van.close()


def test_add_noise_filter_perturbs_floats_only():
    f = AddNoiseFilter(sigma=0.1, seed=3)
    vals = [np.zeros((256,), np.float32), np.arange(4, dtype=np.int64)]
    enc = f.encode(_msg(values=vals))
    assert not np.allclose(enc.values[0], 0.0)
    assert np.abs(enc.values[0]).mean() < 0.5  # sigma-scale, not garbage
    np.testing.assert_array_equal(enc.values[1], vals[1])
    np.testing.assert_array_equal(f.decode(enc).values[0], enc.values[0])


def test_make_chain_specs():
    assert make_chain("none") is None
    assert [type(f) for f in make_chain("full").filters] == [
        KeyCachingFilter, FixingFloatFilter, CompressingFilter]
    # the launcher default: bit-exact on the wire, no int8
    assert [type(f) for f in make_chain("lossless").filters] == [
        KeyCachingFilter, CompressingFilter]
    assert [type(f) for f in make_chain("noise+zlib").filters] == [
        AddNoiseFilter, CompressingFilter]
    assert filters.DEFAULT_SPEC == jax_filters.DEFAULT_SPEC == "lossless"
    with pytest.raises(ValueError):
        make_chain("lz5")


def test_chain_records_codec_overhead():
    chain = FilterChain([FixingFloatFilter(), CompressingFilter()])
    vals = [np.ones((512,), np.float32)]
    for _ in range(3):
        chain.decode(chain.encode(_msg(values=vals)))
    oh = chain.overhead()
    assert oh["encode_calls"] == 3 and oh["decode_calls"] == 3
    assert oh["encode_us_per_msg"] > 0 and oh["decode_us_per_msg"] > 0


def test_compressing_counters_roll_back_on_send_failure():
    f = CompressingFilter()
    chain = FilterChain([f])
    keys = np.arange(64, dtype=np.int64)
    vals = [np.zeros((1024,), np.float32)]
    chain.encode(_msg(keys=keys, values=vals))
    bi_ok, bo_ok = f.bytes_in, f.bytes_out
    assert bi_ok > 0 and bo_ok > 0
    failed = chain.encode(_msg(keys=keys, values=vals))
    assert f.bytes_in == 2 * bi_ok
    chain.on_send_failed(_msg(keys=keys, values=vals), failed)
    assert (f.bytes_in, f.bytes_out) == (bi_ok, bo_ok)


def test_key_cache_rolls_back_on_send_failure():
    chain = FilterChain([KeyCachingFilter()])
    keys = np.arange(8, dtype=np.int32)

    def msg():
        return Message(task=Task(TaskKind.PULL, "kv", payload={}), sender="W0",
                       recver="S0", keys=keys)

    assert chain.encode(msg()).keys is not None  # first send ships keys
    chain.on_send_failed(msg())  # ...but the socket write failed
    again = chain.encode(msg())
    assert again.keys is not None  # MUST re-ship, not hash-hit
    chain.decode(again)  # the receiver saw it: a later send may hit
    assert chain.encode(msg()).keys is None


# ------------------------------------------------------- cross-package bytes


def _bytes(*arrays):
    return [(np.asarray(a).dtype.str, np.asarray(a).shape, np.asarray(a).tobytes())
            for a in arrays]


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("stochastic", [False, True])
def test_quantize_int8_is_bitwise_jax(per_row, stochastic):
    x = np.random.default_rng(5).normal(size=(48, 16)).astype(np.float32)
    kw = dict(per_row=per_row, stochastic=stochastic)
    got = quantize.quantize_int8(x, **kw, rng=np.random.default_rng(9) if stochastic else None)
    want = jax_quantize.quantize_int8(x, **kw,
                                      rng=np.random.default_rng(9) if stochastic else None)
    assert _bytes(*got) == _bytes(*want)
    # a CPU tensor input reads the same values
    got_t = quantize.quantize_int8(torch.from_numpy(x), **kw,
                                   rng=np.random.default_rng(9) if stochastic else None)
    assert _bytes(*got_t) == _bytes(*want)
    assert _bytes(quantize.dequantize_int8(*got)) == _bytes(jax_quantize.dequantize_int8(*want))


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("stochastic", [False, True])
def test_quantize_fp8_is_bitwise_jax(fmt, stochastic):
    x = (np.random.default_rng(6).normal(size=(40, 4)) * 3).astype(np.float32)
    kw = dict(fmt=fmt, per_row=True, stochastic=stochastic)
    got = quantize.quantize_fp8(x, **kw, seed=11 if stochastic else None)
    want = jax_quantize.quantize_fp8(x, **kw, seed=11 if stochastic else None)
    assert _bytes(*got) == _bytes(*want)
    assert _bytes(quantize.dequantize_fp8(*got, fmt=fmt)) == _bytes(
        jax_quantize.dequantize_fp8(*want, fmt=fmt))


def _sequence(msgs, tensor_planes=False):
    """Three PUSHes and a PULL on one link: fresh keys, the same keys (a
    key-cache hit), new keys; float, int and zero planes."""
    rng = np.random.default_rng(12)
    k1 = np.sort(rng.choice(4096, 300, replace=False)).astype(np.int64)
    k2 = np.sort(rng.choice(4096, 200, replace=False)).astype(np.int64)
    planes = [rng.normal(size=(300, 1)).astype(np.float32),
              rng.normal(size=(300, 1)).astype(np.float32),
              rng.normal(size=(200, 1)).astype(np.float32)]
    wrap = torch.from_numpy if tensor_planes else (lambda a: a)
    return [
        _msg(k1, [wrap(planes[0]), wrap(np.arange(5, dtype=np.int32))], msgs),
        _msg(k1, [wrap(planes[1])], msgs),
        _msg(k2, [wrap(planes[2]), wrap(np.zeros(64, np.float32))], msgs),
        _msg(k2, [], msgs, kind="PULL"),
    ]


@pytest.mark.parametrize("planes", ["numpy", "tensor"])
@pytest.mark.parametrize("spec", ["key_caching", "zlib", "int8", "noise", "full", "quantize"])
def test_every_filter_encodes_the_jax_frames(spec, planes):
    port_chain = make_chain(spec)
    jax_chain = jax_filters.make_chain(spec)
    port_msgs = _sequence(messages, tensor_planes=planes == "tensor")
    jax_msgs = _sequence(jax_messages)
    for pm, jm in zip(port_msgs, jax_msgs):
        pe, je = port_chain.encode(pm), jax_chain.encode(jm)
        assert bytes(frame.encode(pe)) == bytes(jax_frame.encode(je))
        # each side decodes the other's frame to the same message
        pd = port_chain.decode(frame.decode(jax_frame.encode(je)))
        jd = jax_chain.decode(jax_frame.decode(frame.encode(pe)))
        assert bytes(frame.encode(pd)) == bytes(jax_frame.encode(jd))
    if spec in ("key_caching", "full"):
        assert port_chain.filters[0].hits == jax_chain.filters[0].hits == 1
