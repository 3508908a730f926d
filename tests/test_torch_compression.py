"""The port's int8 gradient compression against the reference's on the
same numpy inputs: codes, scales, decoded gradients and error feedback
byte-equal (one step and a chain of steps), and the wire-byte count."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import compression as J
from repro_torch.training import compression as T


def grads_np(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"a": {"w": (rng.standard_normal((16, 24)) * 0.3).astype(dtype),
                  "b": (rng.standard_normal((24,)) * 1e-3).astype(dtype)},
            "emb": (rng.standard_normal((40, 8)) * 5.0).astype(dtype),
            "zero": np.zeros((3, 3), dtype)}


def as_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_quantize_codes_and_scales_byte_equal(seed):
    for leaf in jax.tree_util.tree_leaves(grads_np(seed)):
        q, s = T.quantize_grad(torch.from_numpy(leaf))
        jq, js = J.quantize_grad(jnp.asarray(leaf))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert q.numpy().tobytes() == np.asarray(jq).tobytes()
        assert s.numpy().tobytes() == np.asarray(js).tobytes()


def test_round_half_to_even_like_the_reference():
    # absmax 127 -> scale exactly 1: the codes are round(g) of .5 values
    g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5],
                 np.float32)
    q, _ = T.quantize_grad(torch.from_numpy(g))
    jq, _ = J.quantize_grad(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.tolist() == [127, 0, 2, 2, 0, -2, -2, 4]


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_error_feedback_chain_byte_equal(dtype):
    """Five steps of compress_grads: decoded grads and residuals equal
    bit for bit (bf16 grads cross as uint16 views)."""
    if dtype == "bfloat16":
        def make(seed):
            return jax.tree_util.tree_map(
                lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                grads_np(seed))

        def to_t(tree):
            return jax.tree_util.tree_map(lambda a: torch.from_numpy(
                np.array(a).view(np.uint16)).view(torch.bfloat16), tree)
    else:
        def make(seed):
            return grads_np(seed)
        to_t = as_torch
    ef_t = T.init_error_feedback(to_t(make(0)))
    ef_j = J.init_error_feedback(as_jax(make(0)))
    for step in range(5):
        g = make(step)
        gh_t, ef_t = T.compress_grads(to_t(g), ef_t)
        gh_j, ef_j = J.compress_grads(as_jax(g), ef_j)
        for a, b in zip(jax.tree_util.tree_leaves(gh_t),
                        jax.tree_util.tree_leaves(gh_j)):
            assert a.dtype == (torch.bfloat16 if dtype == "bfloat16"
                               else torch.float32)
            assert a.contiguous().view(torch.uint8).numpy().tobytes() \
                == np.asarray(b).tobytes()
        for a, b in zip(jax.tree_util.tree_leaves(ef_t),
                        jax.tree_util.tree_leaves(ef_j)):
            assert a.numpy().tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("compressed", [True, False])
def test_wire_bytes_equal(compressed):
    g = grads_np(0)
    assert T.wire_bytes(as_torch(g), compressed) \
        == J.wire_bytes(as_jax(g), compressed)
