"""The port's quantizer (repro_torch.core.quant) against the JAX package's
(repro.core.quant): codes, scales, zeros and dequantized values bit-equal
on the same numpy input."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro_torch.core import quant as tq


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("last", [64, 128, 300, 512])
@pytest.mark.parametrize("bits,symmetric", [(8, True), (8, False),
                                            (4, False), (4, True)])
def test_quantize_bit_equal(last, bits, symmetric):
    x = _x((3, 5, last), seed=last)
    jt = jq.quantize_blockwise(jnp.asarray(x), bits=bits,
                               symmetric=symmetric)
    tt = tq.quantize_blockwise(torch.from_numpy(x), bits=bits,
                               symmetric=symmetric)
    _eq(jt.q, tt.q)
    _eq(jt.scale, tt.scale)
    if symmetric:
        assert tt.zero is None
    else:
        _eq(jt.zero, tt.zero)
    assert (tt.bits, tt.block, tt.orig_last, tt.dtype) == \
        (jt.bits, jt.block, jt.orig_last, jt.dtype)
    assert tt.shape == jt.shape
    _eq(jq.dequantize(jt), tq.dequantize(tt))


@pytest.mark.parametrize("last", [64, 300])
def test_stochastic_rounding_same_uniforms(last):
    """Given the uniforms JAX draws, SR codes are bit-equal."""
    x = _x((4, last), seed=7)
    key = jax.random.PRNGKey(3)
    jt = jq.quantize_blockwise(jnp.asarray(x), bits=8, symmetric=True,
                               stochastic_key=key)
    pad = -(-last // 256) * 256
    u = jax.random.uniform(key, (4, pad // 256, 256), dtype=jnp.float32)
    tt = tq.quantize_blockwise(
        torch.from_numpy(x), bits=8, symmetric=True,
        uniforms=torch.from_numpy(np.array(u).reshape(4, pad)))
    _eq(jt.q, tt.q)
    _eq(jt.scale, tt.scale)


def test_gather_rows_bit_equal():
    table = _x((40, 300), seed=1)
    idx = np.random.default_rng(2).integers(0, 40, size=(3, 5))
    jt = jq.gather_rows(jq.quantize_blockwise(jnp.asarray(table), 8,
                                              symmetric=True),
                        jnp.asarray(idx))
    tt = tq.gather_rows(tq.quantize_blockwise(torch.from_numpy(table), 8,
                                              symmetric=True),
                        torch.from_numpy(idx))
    _eq(jt.q, tt.q)
    _eq(jq.dequantize(jt), tq.dequantize(tt))
    assert tuple(tq.dequantize(tt).shape) == (3, 5, 300)


def test_int4_pack_unpack_bit_equal():
    u = np.random.default_rng(4).integers(0, 16, size=(6, 64)) \
        .astype(np.uint8)
    jp = jq.pack_int4(jnp.asarray(u))
    tp = tq.pack_int4(torch.from_numpy(u))
    _eq(jp, tp)
    _eq(jq.unpack_int4(jp), tq.unpack_int4(tp))
    np.testing.assert_array_equal(tq.unpack_int4(tp).numpy(), u)


@pytest.mark.parametrize("last", [1, 3, 32, 100, 256, 1000])
def test_auto_block_matches(last):
    assert tq.auto_block(last) == jq.auto_block(last)


def test_numpy_round_trip():
    qt = tq.quantize_blockwise(torch.from_numpy(_x((8, 300))), 4)
    back = tq.from_numpy(tq.to_numpy(qt))
    for a, b in ((qt.q, back.q), (qt.scale, back.scale),
                 (qt.zero, back.zero)):
        assert torch.equal(a, b)
    assert (back.bits, back.block, back.orig_last, back.dtype) == \
        (4, 256, 300, "float32")
