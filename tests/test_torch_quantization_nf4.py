"""The port's NF4 path and whole-tree helpers against the reference's
``repro.core.quantization``: NF4 codes and absmax byte-equal (argmin over
the codebook takes the first index at a tie in both frameworks), NF4
dequantized weights byte-equal, ``quantization_rmse`` within 1e-6
relative (a mean over the matrix summed in another order),
``quantize_tree`` / ``dequantize_tree`` byte-equal leaf by leaf with the
same leaves left untouched, and ``tree_nbytes`` equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro_torch.core import quantization as tq
from repro_torch.models.model import tensor_from_numpy


def bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.contiguous()
        return (t.view(torch.int16).numpy().view(np.uint16)
                if t.dtype == torch.bfloat16 else t.numpy())
    a = np.asarray(t)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def weights(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., :16, :1] = 0.0               # an all-zero group
    jw = jnp.asarray(w).astype(dtype)
    return jw, tensor_from_numpy(np.asarray(jw), "cpu")


def test_codebook_equal():
    np.testing.assert_array_equal(tq.NF4_CODE, jq.NF4_CODE)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("shape", [(128, 48), (3, 64, 32)])
@pytest.mark.parametrize("group", [16, 64])
def test_nf4_codes_and_absmax_byte_equal(group, shape, dtype):
    jw, tw = weights(shape, dtype, seed=group)
    jc, ja = jq.quantize_nf4(jw, group)
    tc, ta = tq.quantize_nf4(tw, group)
    assert tc.dtype == torch.uint8 and ta.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ta.numpy().view(np.uint32),
                                  np.asarray(ja).view(np.uint32))
    np.testing.assert_array_equal(
        bits(tq.dequantize_nf4(tc, ta, group)),
        bits(jq.dequantize_nf4(jc, ja, group)))


@pytest.mark.parametrize("mode", [(4, False), (8, False), (4, True)])
def test_quantization_rmse(mode):
    b, nf4 = mode
    jw, tw = weights((256, 64), jnp.bfloat16, seed=7)
    want = jq.quantization_rmse(jw, b, 64, nf4=nf4)
    got = tq.quantization_rmse(tw, b, 64, nf4=nf4)
    assert isinstance(got, float) and 0 < got < 0.2
    assert got == pytest.approx(want, rel=1e-6)


def tree_pair():
    rng = np.random.default_rng(3)
    arrays = {
        "layers": {"w": rng.standard_normal((2, 128, 32)),
                   "norm": rng.standard_normal((2, 128)),
                   "small_k": rng.standard_normal((64, 32))},
        "head": [rng.standard_normal((256, 16)),
                 rng.standard_normal((130, 16))],
    }
    jt = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                arrays)
    tt = jax.tree_util.tree_map(
        lambda a: tensor_from_numpy(np.asarray(a), "cpu"), jt)
    return jt, tt


@pytest.mark.parametrize("b", [4, 8])
def test_quantize_tree_round_trip(b):
    jt, tt = tree_pair()
    jqt = jq.quantize_tree(jt, b)
    tqt = tq.quantize_tree(tt, b)
    assert tq.tree_nbytes(tqt) == jq.tree_nbytes(jqt)
    assert tq.tree_nbytes(tt) == jq.tree_nbytes(jt)
    jl = jax.tree_util.tree_leaves(
        jqt, is_leaf=lambda x: isinstance(x, jq.QTensor))
    tl = list(tq._leaves(tqt))
    assert len(tl) == len(jl) == 5
    for got, want in zip(tl, jl):
        assert isinstance(got, tq.QTensor) == isinstance(want, jq.QTensor)
        if isinstance(want, jq.QTensor):
            np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
            np.testing.assert_array_equal(bits(got.scales),
                                          bits(want.scales))
        else:
            assert got.shape == want.shape
    # which leaves were quantized: K >= 128 and K % 64 == 0 only
    assert isinstance(tqt["layers"]["w"], tq.QTensor)
    assert isinstance(tqt["head"][0], tq.QTensor)
    assert not isinstance(tqt["head"][1], tq.QTensor)
    assert tqt["layers"]["norm"] is tt["layers"]["norm"]
    jd = jax.tree_util.tree_leaves(jq.dequantize_tree(jqt))
    td = list(tq._leaves(tq.dequantize_tree(tqt)))
    for got, want in zip(td, jd):
        np.testing.assert_array_equal(bits(got), bits(want))


def test_quantize_tree_takes_numpy_leaves():
    w = np.random.default_rng(0).standard_normal((128, 32)).astype(
        np.float32)
    tree = tq.quantize_tree({"w": w, "b": np.zeros(4, np.float32)}, 4)
    want = jq.quantize(jnp.asarray(w), 4)
    np.testing.assert_array_equal(tree["w"].q.numpy(), np.asarray(want.q))
    assert isinstance(tree["b"], np.ndarray)
    assert tq.tree_nbytes(tree) == want.nbytes() + 16
