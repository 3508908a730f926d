"""The PyTorch port's quantization against the JAX reference: packed codes,
scales (as raw uint16 bits) and dequantized weights are byte-equal for the
same inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro_torch.core import quantization as tq
from repro_torch.models.model import tensor_from_numpy


def bits16(t: torch.Tensor) -> np.ndarray:
    """Raw bits of a bf16 tensor."""
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def weights(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., :16, :1] = 0.0               # an all-zero group: scale 0
    jw = jnp.asarray(w).astype(dtype)
    return jw, tensor_from_numpy(np.asarray(jw), "cpu")


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("shape", [(128, 48), (3, 64, 32)])
@pytest.mark.parametrize("group", [16, 32, 64])
@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_byte_equal(bits, group, shape, dtype):
    jw, tw = weights(shape, dtype, seed=bits * 100 + group)
    jqt = jq.quantize(jw, bits, group)
    tqt = tq.quantize(tw, bits, group)
    want_q = np.asarray(jqt.q)
    assert str(tqt.q.dtype) == f"torch.{want_q.dtype}"
    np.testing.assert_array_equal(tqt.q.numpy(), want_q)
    np.testing.assert_array_equal(bits16(tqt.scales),
                                  np.asarray(jqt.scales).view(np.uint16))
    assert tqt.shape == jqt.shape and tqt.nbytes() == jqt.nbytes()
    np.testing.assert_array_equal(bits16(tq.dequantize(tqt)),
                                  np.asarray(jq.dequantize(jqt))
                                  .view(np.uint16))


@pytest.mark.parametrize("shape", [(16, 8), (2, 32, 4)])
def test_pack_unpack_equal(shape):
    rng = np.random.default_rng(7)
    codes = rng.integers(-8, 8, size=shape).astype(np.int8)
    packed = np.asarray(jq.pack_int4(jnp.asarray(codes)))
    tpacked = tq.pack_int4(torch.from_numpy(codes))
    np.testing.assert_array_equal(tpacked.numpy(), packed)
    np.testing.assert_array_equal(tq.unpack_int4(tpacked).numpy(), codes)


def test_rejects_bad_arguments():
    w = torch.zeros(64, 8)
    with pytest.raises(ValueError, match="bits must be 4 or 8"):
        tq.quantize(w, 3, 16)
    with pytest.raises(ValueError, match="not divisible"):
        tq.quantize(w, 4, 48)
    with pytest.raises(ValueError, match="K must be even"):
        tq.pack_int4(torch.zeros(3, 4, dtype=torch.int8))
