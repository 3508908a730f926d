"""The port's dequant-matmul wrappers (their plain versions, which a CPU
tensor takes) against the reference's Pallas kernels run in interpret mode.

Bars: bf16 outputs compared in f32 within rtol = atol = 2e-2, because f32
partial sums taken in another order can move a bf16 result by one ulp
(2^-8 relative). Bit-exact where the arithmetic has no rounding choice:
integer-friendly inputs, the grouped kernel against the per-expert loop,
and an empty expert group (exact zeros)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantization import QTensor as JQTensor
from repro.core.quantization import quantize as jquantize
from repro.kernels import grouped_matmul as jgk
from repro.kernels import ops as jops
from repro.kernels import q4_matmul as jk
from repro.kernels import ref as jref
from repro_torch.core.quantization import QTensor, pack_int4, quantize
from repro_torch.kernels import cuda_lib, ops, ref
from repro_torch.kernels.grouped_matmul import grouped_quantized_matmul
from repro_torch.kernels.q4_matmul import quantized_matmul
from repro_torch.models.model import tensor_from_numpy

#: (experts_in_group, capacity, K, N, group_size), the reference's
#: tests/test_grouped_kernel.py cases
CASES = [
    (1, 8, 128, 128, 64),
    (3, 5, 128, 256, 64),
    (8, 16, 256, 128, 64),
    (4, 8, 192, 192, 64),
    (2, 20, 128, 128, 32),
    (6, 1, 128, 128, 64),
]


def to_t(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a), "cpu")


def bits16(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


def close(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def make_bank(e, c, k, n, bits, group, seed=0):
    """The same bank for both packages (quantized by the reference)."""
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((e, c, k)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((e, k, n)) / np.sqrt(k), jnp.float32)
    jqt = jquantize(w, bits, group)
    tqt = QTensor(q=to_t(jqt.q), scales=to_t(jqt.scales), bits=bits,
                  group_size=group)
    return x, jqt, to_t(x), tqt


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("e,c,k,n,group", CASES)
def test_grouped_q_matmul_matches_pallas(e, c, k, n, group, bits):
    x, jqt, tx, tqt = make_bank(e, c, k, n, bits, group)
    got = ops.grouped_q_matmul(tx, tqt)
    assert tuple(got.shape) == (e, c, n)
    close(got, jops.grouped_q_matmul(x, jqt))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("grouped", [True, False])
def test_q_expert_matmul_matches_pallas(bits, grouped):
    x, jqt, tx, tqt = make_bank(4, 8, 128, 128, bits, 64, seed=3)
    close(ops.q_expert_matmul(tx, tqt, grouped=grouped),
          jops.q_expert_matmul(x, jqt, grouped=grouped))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m", [1, 5, 20])
def test_q_matmul_matches_pallas(bits, m):
    x, jqt, tx, tqt = make_bank(1, m, 192, 192, bits, 32, seed=m)
    jq1 = JQTensor(q=jqt.q[0], scales=jqt.scales[0], bits=bits,
                   group_size=32)
    got = ops.q_matmul(tx[0], tqt.map(lambda t: t[0]))
    assert tuple(got.shape) == (m, 192)
    close(got, jops.q_matmul(x[0], jq1))


@pytest.mark.parametrize("e,c", [(5, 8), (2, 3)])
def test_grouped_bf16_matmul_matches_pallas(e, c):
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((e, c, 128)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((e, 128, 256)) / np.sqrt(128),
                    jnp.bfloat16)
    close(ops.grouped_bf16_matmul(to_t(x), to_t(w)),
          jops.grouped_bf16_matmul(x, w))


@pytest.mark.parametrize("bits", [4, 8])
def test_ref_oracles_match(bits):
    x, jqt, tx, tqt = make_bank(3, 5, 128, 128, bits, 64, seed=9)
    close(ref.expert_matmul_ref(tx, tqt.q, tqt.scales, bits=bits),
          jref.expert_matmul_ref(x, jqt.q, jqt.scales, bits=bits))
    close(ref.quantized_matmul_ref(tx[0], tqt.q[0], tqt.scales[0],
                                   bits=bits),
          jref.quantized_matmul_ref(x[0], jqt.q[0], jqt.scales[0],
                                    bits=bits))


@pytest.mark.parametrize("bits", [4, 8])
def test_integer_friendly_bit_exact(bits):
    """Small integer activations, power-of-two scales, K <= 256: every
    product and sum is exact in f32, so both packages give the exact
    result bit for bit."""
    rng = np.random.default_rng(bits)
    g, c, k, n = 2, 5, 256, 128
    x = rng.integers(-3, 4, size=(g, c, k)).astype(np.float32)
    qmax = 7 if bits == 4 else 127
    codes = rng.integers(-qmax - 1, qmax + 1, size=(g, k, n)).astype(np.int8)
    scales = np.full((g, k // 64, n), 0.125, np.float32)
    jq = jnp.asarray(codes)
    if bits == 4:
        from repro.core.quantization import pack_int4 as jpack
        jq = jpack(jq)
    jqt = JQTensor(q=jq, scales=jnp.asarray(scales, jnp.bfloat16), bits=bits,
                   group_size=64)
    tqt = QTensor(q=to_t(jqt.q), scales=to_t(jqt.scales), bits=bits,
                  group_size=64)
    jx = jnp.asarray(x, jnp.bfloat16)
    got = ops.grouped_q_matmul(to_t(jx), tqt)
    want = jops.grouped_q_matmul(jx, jqt)
    exact = torch.from_numpy(
        x.astype(np.float64) @ (codes.astype(np.float64) * 0.125))
    np.testing.assert_array_equal(bits16(got), bits16(want))
    np.testing.assert_array_equal(bits16(got),
                                  bits16(exact.to(torch.bfloat16)))


@pytest.mark.parametrize("bits", [4, 8])
def test_f32_dequant_bit_exact(bits):
    """W is dequantized in f32 and never rounded to bf16: scale 1 + 2^-7
    times codes near +-qmax needs up to 14 significant bits, yet with x in
    {-1, 0, 1} and K = 64 every product and sum is exact in f32, so both
    packages give the exact result bit for bit, while a bf16-rounded W
    misses more than a tenth of the outputs."""
    rng = np.random.default_rng(bits)
    g, c, k, n = 2, 8, 64, 256
    qmax = 7 if bits == 4 else 127
    x = rng.integers(-1, 2, size=(g, c, k)).astype(np.float64)
    codes = (rng.integers(qmax - 3, qmax + 1, size=(g, k, n))
             * rng.choice([-1, 1], size=(g, k, n))).astype(np.int8)
    scale = 1 + 2 ** -7
    jq = jnp.asarray(codes)
    if bits == 4:
        from repro.core.quantization import pack_int4 as jpack
        jq = jpack(jq)
    jqt = JQTensor(q=jq, scales=jnp.full((g, 1, n), scale, jnp.bfloat16),
                   bits=bits, group_size=64)
    tqt = QTensor(q=to_t(jqt.q), scales=to_t(jqt.scales), bits=bits,
                  group_size=64)
    jx = jnp.asarray(x, jnp.bfloat16)
    got = ops.grouped_q_matmul(to_t(jx), tqt)
    w = codes.astype(np.float64) * scale
    exact = torch.from_numpy(x @ w).to(torch.bfloat16)
    np.testing.assert_array_equal(bits16(got), bits16(exact))
    np.testing.assert_array_equal(
        bits16(jops.grouped_q_matmul(jx, jqt)), bits16(exact))
    w_bf16 = torch.from_numpy(w).to(torch.bfloat16).double().numpy()
    rounded = torch.from_numpy(x @ w_bf16).to(torch.bfloat16)
    assert (bits16(rounded) != bits16(exact)).mean() > 0.1


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("e,c,k,n,group", CASES[:4])
def test_grouped_bit_exact_vs_expert_loop(e, c, k, n, group, bits):
    _, _, tx, tqt = make_bank(e, c, k, n, bits, group, seed=e + c)
    loop = torch.stack([ops.q_matmul(tx[i], tqt.map(lambda t: t[i]))
                        for i in range(e)])
    np.testing.assert_array_equal(bits16(ops.grouped_q_matmul(tx, tqt)),
                                  bits16(loop))
    np.testing.assert_array_equal(
        bits16(ops.q_expert_matmul(tx, tqt, grouped=False)), bits16(loop))


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_empty_group_exact_zeros(bits):
    rng = np.random.default_rng(bits)
    x = torch.from_numpy(rng.standard_normal((4, 6, 128)).astype(
        np.float32)).to(torch.bfloat16)
    x[2] = 0
    w = torch.from_numpy(rng.standard_normal((4, 128, 128)).astype(
        np.float32))
    if bits == 16:
        out = ops.grouped_bf16_matmul(x, w.to(torch.bfloat16))
    else:
        out = ops.grouped_q_matmul(x, quantize(w, bits, 64))
    assert bool((out[2].float() == 0).all())
    assert bool((out[1].float() != 0).any())


def test_tile_choices_match_reference():
    for dim in (64, 128, 192, 256, 896, 4096, 14336):
        for cap in (128, 256):
            for step in (8, 16, 32, 64):
                assert ops._largest_divisor(dim, cap, step) \
                    == jops._largest_divisor(dim, cap, step)
    for m in (1, 4, 5, 8, 20, 128, 130):
        for block_m in (8, 128):
            seen = {}

            def rec(key):
                def call(xp, bm):
                    seen[key] = (tuple(xp.shape), bm)
                    return xp
                return call
            jx = jnp.ones((3, m, 16), jnp.bfloat16)
            jout = jops._with_padded_m(rec("jax"), jx, block_m=block_m,
                                       m_axis=1)
            tout = ops._with_padded_m(rec("torch"), torch.ones(3, m, 16),
                                      block_m=block_m, m_axis=1)
            assert seen["jax"] == seen["torch"]
            assert tuple(tout.shape) == tuple(jout.shape) == (3, m, 16)


def test_shape_validation_matches_reference():
    """The port raises the reference kernels' ValueErrors, word for word."""
    _, jqt, tx, tqt = make_bank(4, 8, 128, 128, 4, 64)
    jx = jnp.zeros((4, 8, 128), jnp.bfloat16)
    jq, js, tq, ts = jqt.q, jqt.scales, tqt.q, tqt.scales
    cases = [
        # (port call, reference call): group, K, bits, group|BK, BM|M
        (lambda: grouped_quantized_matmul(tx, tq[:3], ts[:3]),
         lambda: jgk.grouped_quantized_matmul(jx, jq[:3], js[:3],
                                              interpret=True)),
        (lambda: grouped_quantized_matmul(tx[:, :, :64], tq, ts),
         lambda: jgk.grouped_quantized_matmul(jx[:, :, :64], jq, js,
                                              interpret=True)),
        (lambda: grouped_quantized_matmul(tx, tq, ts, bits=3),
         lambda: jgk.grouped_quantized_matmul(jx, jq, js, bits=3,
                                              interpret=True)),
        (lambda: quantized_matmul(tx[0], tq[0], ts[0], group_size=32),
         lambda: jk.quantized_matmul(jx[0], jq[0], js[0], group_size=32,
                                     interpret=True)),
        (lambda: quantized_matmul(tx[0, :6], tq[0], ts[0], block_m=4),
         lambda: jk.quantized_matmul(jx[0, :6], jq[0], js[0], block_m=4,
                                     interpret=True)),
    ]
    for port, reference in cases:
        with pytest.raises(ValueError) as want:
            reference()
        with pytest.raises(ValueError) as got:
            port()
        assert str(got.value) == str(want.value)


def test_no_fallback_off_the_cpu():
    """Off the CPU a wrapper launches its kernel or raises: a tensor on
    another device is refused, not computed by the plain version."""
    x = torch.zeros(3, 8, 128, dtype=torch.bfloat16, device="meta")
    w = torch.zeros(3, 128, 128, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.grouped_bf16_matmul(x, w)
    assert all(v == 0 for v in cuda_lib.LAUNCHES.values())


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(cuda_lib.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_lib.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_lib.build()
    assert not (tmp_path / "kernels").exists()


def test_pack_matches_packed_codes():
    codes = torch.randint(-8, 8, (2, 64, 16), dtype=torch.int8,
                          generator=torch.Generator().manual_seed(0))
    qt = QTensor(q=pack_int4(codes), scales=torch.ones(
        2, 1, 16, dtype=torch.bfloat16), bits=4, group_size=64)
    x = torch.eye(64, dtype=torch.bfloat16)[None].repeat(2, 1, 1)
    np.testing.assert_array_equal(ops.grouped_q_matmul(x, qt).float().numpy(),
                                  codes.float().numpy())
