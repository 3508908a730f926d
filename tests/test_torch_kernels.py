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


# --------------------------------------------------------------------------
# The CUDA kernels' launch plan and arithmetic, checked on the CPU.
#
# The kernels run only on the card; what they compute is fixed here: codes
# enter the tensor core as bf16 integers, each group of min(group, 64) K
# accumulates an f32 partial that is added into the output times the
# column's f32 scale (fmaf), K splits from launch_plan are summed in split
# order and the sum is rounded once to bf16. ``emulate`` repeats that
# arithmetic in plain PyTorch (the package has no such function: its plain
# versions compute f32-dequant @ x).
# --------------------------------------------------------------------------

import importlib.util  # noqa: E402
import inspect  # noqa: E402
import math  # noqa: E402
import re  # noqa: E402
from pathlib import Path  # noqa: E402

from repro_torch.kernels import q4_matmul as tk  # noqa: E402


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def codes_of(qt: QTensor) -> torch.Tensor:
    """Signed integer codes (E, K, N) of a quantized bank."""
    q = qt.q
    if qt.bits == 4:
        lo = (q & 0xF).to(torch.int16) - 8
        hi = (q >> 4).to(torch.int16) - 8
        return torch.stack([lo, hi], dim=-2).reshape(
            q.shape[0], q.shape[1] * 2, q.shape[2])
    return q.to(torch.int16)


def emulate(x, codes, scales, *, group, bits):
    """The kernels' arithmetic for one expert: x (C, K) bf16, codes (K, N)
    integers (bits 4/8) or bf16 weights (bits 16), scales (K/group, N)."""
    c, k = x.shape
    n = codes.shape[1]
    plan = tk.launch_plan(ops._round_up(c, 8), k, n, bits)
    xf = x.float()
    wf = codes.to(torch.bfloat16).float()     # exact for |code| <= 128
    flush = min(group, 64)
    total = None
    for s in range(plan.splits):
        lo, hi = s * plan.k_chunk, min(k, (s + 1) * plan.k_chunk)
        if bits == 16:
            acc = xf[:, lo:hi] @ wf[lo:hi]
        else:
            acc = torch.zeros(c, n)
            for k0 in range(lo, hi, flush):
                part = xf[:, k0:k0 + flush] @ wf[k0:k0 + flush]
                scale = scales[k0 // group].float()
                acc = (acc.double() + part.double() * scale.double()).float()
        total = acc if total is None else total + acc
    return total.to(torch.bfloat16)


def emulate_bank(x, codes, scales, *, group, bits):
    return torch.stack([
        emulate(x[e], codes[e], None if scales is None else scales[e],
                group=group, bits=bits) for e in range(x.shape[0])])


#: the reference's cases plus one whose K the plan splits 16 ways, one
#: that the wgmma body serves (C > 64), two that the wide body serves
#: (C > 128: one 160-token tile, and two for C = 300) and one whose K the
#: wide body's byte cap splits in two at int4 and in four at int8
EMU_CASES = CASES + [(2, 8, 1024, 128, 64), (2, 100, 256, 128, 64),
                     (2, 160, 256, 128, 64), (1, 300, 512, 256, 64),
                     (1, 136, 5120, 128, 64)]

#: shapes with the port's tile contract (N % 16, K % 16, group 16/32/64k)
PLAN_SHAPES = [(8, 4096, 14336), (8, 14336, 4096), (16, 4096, 14336),
               (128, 4096, 14336), (8, 64, 64), (5, 256, 128),
               (1, 128, 128), (24, 192, 192), (256, 4096, 14336),
               (40, 14336, 4096), (8, 1024, 16)]


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("e,c,k,n,group", EMU_CASES)
def test_kernel_arithmetic_matches_pallas(e, c, k, n, group, bits):
    x, jqt, tx, tqt = make_bank(e, c, k, n, bits, group, seed=e * c)
    got = emulate_bank(tx, codes_of(tqt), tqt.scales, group=group, bits=bits)
    close(got, jops.grouped_q_matmul(x, jqt))


@pytest.mark.parametrize("e,c", [(5, 8), (2, 3), (2, 16)])
def test_kernel_arithmetic_bf16_matches_pallas(e, c):
    rng = np.random.default_rng(e + c)
    x = jnp.asarray(rng.standard_normal((e, c, 1024)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((e, 1024, 128)) / 32, jnp.bfloat16)
    got = emulate_bank(to_t(x), to_t(w), None, group=64, bits=16)
    close(got, jops.grouped_bf16_matmul(x, w))


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_kernel_arithmetic_integer_friendly_exact(bits):
    """Integer-friendly inputs over four K splits: bit-equal to float64."""
    rng = np.random.default_rng(10 + bits)
    g, c, k, n = 2, 5, 256, 128
    x = rng.integers(-3, 4, size=(g, c, k)).astype(np.float64)
    qmax = {4: 7, 8: 127, 16: 7}[bits]
    codes = rng.integers(-qmax - 1, qmax + 1, size=(g, k, n))
    scale = 0.25 if bits == 16 else 0.125
    exact = torch.from_numpy(x @ (codes * scale)).to(torch.bfloat16)
    assert tk.launch_plan(8, k, n, bits).splits == 4
    tx = torch.from_numpy(x).to(torch.bfloat16)
    if bits == 16:
        w = torch.from_numpy(codes * scale).to(torch.bfloat16)
        got = emulate_bank(tx, w, None, group=64, bits=16)
    else:
        scales = torch.full((g, k // 64, n), scale).to(torch.bfloat16)
        got = emulate_bank(tx, torch.from_numpy(codes), scales, group=64,
                           bits=bits)
    np.testing.assert_array_equal(bits16(got), bits16(exact))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("k", [64, 128])
def test_kernel_arithmetic_f32_dequant_exact(bits, k):
    """Scale 1 + 2^-7 times codes near +-qmax: the group partial is an
    integer and partial * scale is exact in f32, so the kernels'
    arithmetic is bit-equal to float64, though W in bf16 would not be."""
    rng = np.random.default_rng(20 + bits + k)
    g, c, n = 2, 8, 256
    qmax = 7 if bits == 4 else 127
    x = rng.integers(-1, 2, size=(g, c, k)).astype(np.float64)
    codes = (rng.integers(qmax - 3, qmax + 1, size=(g, k, n))
             * rng.choice([-1, 1], size=(g, k, n)))
    scale = 1 + 2 ** -7
    exact = torch.from_numpy(x @ (codes * scale)).to(torch.bfloat16)
    scales = torch.full((g, k // 64, n), scale).to(torch.bfloat16)
    got = emulate_bank(torch.from_numpy(x).to(torch.bfloat16),
                       torch.from_numpy(codes), scales, group=64, bits=bits)
    np.testing.assert_array_equal(bits16(got), bits16(exact))


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("c,k,n", PLAN_SHAPES)
def test_launch_plan_covers_k(c, k, n, bits):
    """Splits on 64-aligned boundaries that cover K exactly, a token tile
    that the kernels are built for, the kernels' one column tile; the
    token tile holds C, or C takes as many of it as of the wide tile."""
    plan = tk.launch_plan(c, k, n, bits)
    assert plan.block_n == tk.BLOCK_N and plan.block_c in tk.BLOCK_C
    assert plan.block_c >= c or math.ceil(c / plan.block_c) == math.ceil(
        c / tk.WIDE_BLOCK_C)
    assert plan.k_chunk % tk.SPLIT_GRAIN == 0
    bounds = [min(k, s * plan.k_chunk) for s in range(plan.splits + 1)]
    assert bounds[0] == 0 and bounds[-1] == k
    assert all(lo < hi for lo, hi in zip(bounds, bounds[1:]))
    assert all(b % tk.SPLIT_GRAIN == 0 for b in bounds[:-1])


def test_launch_plan_takes_no_group_count():
    """The plan is a function of one expert's shape: a bank of G experts
    runs each expert exactly as a launch of one does."""
    assert list(inspect.signature(tk.launch_plan).parameters) == [
        "c", "k", "n", "bits"]


@pytest.mark.parametrize("label", ["up", "down", "decode16", "prefill_up"])
@pytest.mark.parametrize("bits", [4, 8, 16])
def test_launch_plan_fills_the_card(label, bits):
    """The mma.sync body's shapes (C <= 64) get >= 2 blocks per SM at G =
    1; the wgmma body's prefill_up (112 column tiles, one block per SM)
    runs unsplit in one wave, the rule the card's split-vs-unsplit timings
    chose."""
    c, k, n = _chip_smoke().SHAPES[label]
    plan = tk.launch_plan(c, k, n, bits)
    blocks = (math.ceil(n / plan.block_n) * math.ceil(c / plan.block_c)
              * plan.splits)
    if c <= 64:
        assert plan.body == "mma_sync" and blocks >= 264
    else:
        assert plan.body == "wgmma" and plan.splits == 1
        assert blocks <= tk.WAVE


def test_splitk_reduce_adds_in_split_order():
    """The CPU tensor takes the plain version: f32 adds in split order,
    one rounding to bf16 (not a tree or a float64 sum)."""
    rng = np.random.default_rng(5)
    ws = torch.from_numpy(rng.standard_normal((9, 3, 8, 64)).astype(
        np.float32) * 1e3)
    want = ws[0].clone()
    for s in range(1, 9):
        want = want + ws[s]
    np.testing.assert_array_equal(bits16(tk.splitk_reduce_plain(ws)),
                                  bits16(want.to(torch.bfloat16)))
    assert all(v == 0 for v in cuda_lib.LAUNCHES.values())


def _fused_epilogue(ws: torch.Tensor, order, counter: list):
    """The split-K epilogue's arrival protocol for one tile: the split
    blocks of ``ws`` (splits, ...) arrive in ``order``, each counting
    itself in with atomicInc(counter, splits - 1) (old value back, wrap to
    0 past the limit); the block whose count returns splits - 1 adds every
    split in order and rounds once. It takes its own partial from its
    registers, where the kernels read it back from the workspace with the
    others: the sum is the same either way. A model in Python: the
    kernels' own epilogues are held to ``splitk_reduce_plain`` on the card
    (chip_smoke.py's split-K epilogue check)."""
    splits = ws.shape[0]
    out, lasts = None, []
    for block in order:
        own = ws[block].clone()               # the block's registers
        old = counter[0]
        counter[0] = 0 if old >= splits - 1 else old + 1
        if old != splits - 1:
            continue
        lasts.append(block)
        s = own if block == 0 else ws[0].clone()
        for p in range(1, splits):
            s = s + (own if p == block else ws[p])
        out = s.to(torch.bfloat16)
    return out, lasts


@pytest.mark.parametrize("splits", [3, 4, 5, 7, 9, 16])
def test_fused_epilogue_any_arrival_order(splits):
    """Whatever block of a tile arrives last, its fixed-order sum is
    bit-equal to splitk_reduce_plain, exactly one block reduces, and the
    counter is zero again for the next launch (or graph replay)."""
    rng = np.random.default_rng(splits)
    ws = torch.from_numpy(rng.standard_normal((splits, 2, 4, 32)).astype(
        np.float32) * 10.0 ** rng.integers(-3, 4, size=(splits, 1, 1, 1)))
    want = bits16(tk.splitk_reduce_plain(ws))
    counter, seen = [0], set()
    for _ in range(12):
        order = rng.permutation(splits)
        got, lasts = _fused_epilogue(ws, order, counter)
        assert lasts == [order[-1]] and counter == [0]
        np.testing.assert_array_equal(bits16(got), want)
        seen.add(int(order[-1]))
    assert len(seen) > 1


def _timed_launches():
    """(G, (C, K, N)) of every shape chip_smoke.py runs: SHAPES at a whole
    8-expert bank, the draft bank, Kimi-K2's 384-expert bank, phase 9's
    shards."""
    cs = _chip_smoke()
    cases = [(8, shp) for shp in cs.SHAPES.values()]
    cases += [(cs.DRAFT_G, shp) for shp in cs.DRAFT_SHAPES.values()]
    cases += [(cs.KIMI_G, shp) for shp in {**cs.KIMI_SHAPES,
                                           **cs.KIMI_PREFILL_SHAPES}.values()]
    cases += [(max(cs.MESH_BANKS.values()), shp)
              for shp in cs.MESH_SHAPES.values()]
    return cases


def test_split_counters_cover_every_timed_shape():
    """The counters a split launch asks for are its grid's tiles, G x
    ceil(C / block_c) x ceil(N / 128), and the first allocation holds those
    of every shape chip_smoke.py runs, so the main path never grows them."""
    split = 0
    for g, (c, k, n) in _timed_launches():
        for bits in (4, 8, 16):
            plan = tk.launch_plan(c, k, n, bits)
            tiles = tk.split_tiles(plan, g, c, n)
            grid_y = math.ceil(c / plan.block_c) * plan.splits
            assert tiles * plan.splits == g * grid_y * math.ceil(n / 128)
            if plan.splits > 1:
                split += 1
                assert tiles <= tk.MIN_COUNTERS
    assert split > 0
    # every row of SHAPES is among them, the 2048-token bucket's
    # down-projection too
    cs = _chip_smoke()
    assert cs.SHAPES["prefill640_down"] == (640, cs.D_FF, cs.D_MODEL)
    assert all((8, shp) in _timed_launches() for shp in cs.SHAPES.values())


def _py(expr: str) -> str:
    """A C integer expression as Python: integer division, the launch's
    fields and CUDA's built-ins by plain names."""
    expr = " ".join(expr.split())
    for c_name, py in (("T::BC", "BC"), ("a.", ""), ("blockIdx.", "b"),
                       ("gridDim.", "grid_"), ("/", "//")):
        expr = expr.replace(c_name, py)
    return expr


def _c_expr(text: str, start: str) -> str:
    """The C expression that follows ``start`` in ``text`` up to its
    closing parenthesis or semicolon, as Python (``_py``)."""
    i = text.index(start) + len(start)
    depth, j = 0, i
    while depth > 0 or text[j] not in ");":
        depth += {"(": 1, ")": -1}.get(text[j], 0)
        j += 1
    return _py(text[i:j])


def _csrc(name: str) -> str:
    return (Path(tk.__file__).parent / "csrc" / name).read_text()


#: (grid source, decoder head) of each body: the mma.sync body's 3-D grid
#: in dequant_matmul.cu, the wgmma bodies' 1-D grid in wgmma_body.cuh
DECODERS = {"mma_sync": ("dequant_matmul.cu", "Place grid_place("),
            "wgmma": ("wgmma_body.cuh", "Place block_place(")}


def _places(body: str, env: dict):
    """Every block of the grid that ``body``'s launcher builds, decoded by
    the kernel's own decoder read from the CUDA source, and the counter
    ``tile_index`` gives it: (linear block id, {field: array}, counter).
    The linear id is CUDA's, x fastest, then y, then z."""
    main = _csrc("dequant_matmul.cu")
    source, head = DECODERS[body]
    text = _csrc(source)
    at = text.index("const dim3 grid(")
    launcher = text[text.rindex("\nint launch", 0, at):at]
    env = dict(env)
    for name, expr in re.findall(r"const int (\w+) = ([^;]+);", launcher):
        env[name] = eval(_py(expr), {}, env)
    grid = [eval(e, {}, env)
            for e in _c_expr(text, "const dim3 grid(").split(", ")]
    grid += [1] * (3 - len(grid))
    bx, by, bz = (a.ravel() for a in np.meshgrid(
        *(np.arange(d) for d in grid), indexing="ij"))
    linear = (bz * grid[1] + by) * grid[0] + bx
    fn = text[text.index(head):]
    fn = fn[:fn.index("return Place{")]
    scope = {**env, "bx": bx, "by": by, "bz": bz, "grid_x": grid[0],
             "grid_y": grid[1], "grid_z": grid[2]}
    for name, expr in re.findall(r"const int (\w+) = ([^;]+);", fn):
        scope[name] = eval(_py(expr), {}, scope)
    fields = re.search(r"struct Place \{\s*int ([^;]+);", main).group(1)
    place = {f: np.broadcast_to(scope[f], linear.shape)
             for f in fields.split(", ")}
    tile = _c_expr(main, "int tile_index(const Place& p) {\n  return")
    counter = eval(tile.replace("p.", ""), {}, place)
    return linear, place, counter


def _check_places(body: str, plan, g: int, c: int, n: int, bits: int):
    """Every (g, split, token tile, column tile) is taken by exactly one
    block, and each of ``split_tiles`` counters by one block of each split,
    all of one (expert, token tile, column tile); the wgmma grid's pad (a
    block past an odd last token tile, which exits at once) takes none.
    Returns the decode of the blocks that take a tile."""
    # launch_pair's choice: clusters of two token tiles for the bf16 bank
    # past one token tile
    env = {"N": n, "M": c, "G": g, "splits": plan.splits,
           "BN": plan.block_n, "BC": plan.block_c,
           "PAIR": body == "wgmma" and bits == 16 and c > plan.block_c}
    linear, place, counter = _places(body, env)
    mtiles, ntiles = math.ceil(c / plan.block_c), math.ceil(n / 128)
    assert (place["mtiles"] == mtiles).all()
    assert (place["ntiles"] == ntiles).all()
    pad = place["mt"] >= mtiles
    pads = mtiles % 2 if env["PAIR"] else 0
    assert pad.sum() == g * plan.splits * ntiles * pads
    assert (place["mt"][pad] == mtiles).all()
    linear, counter = linear[~pad], counter[~pad]
    place = {f: v[~pad] for f, v in place.items()}
    key = np.stack([place[f] for f in ("g", "split", "mt", "nt")])
    want = g * plan.splits * mtiles * ntiles
    assert linear.size == want
    assert np.unique(key, axis=1).shape[1] == want
    assert key.min(axis=1).tolist() == [0, 0, 0, 0]
    assert key.max(axis=1).tolist() == [g - 1, plan.splits - 1, mtiles - 1,
                                        ntiles - 1]
    tiles = tk.split_tiles(plan, g, c, n)
    assert counter.min() == 0 and counter.max() == tiles - 1
    assert (np.bincount(counter, minlength=tiles) == plan.splits).all()
    assert np.unique(counter * plan.splits + place["split"]).size \
        == counter.size
    tile = np.stack([counter, place["g"], place["mt"], place["nt"]])
    assert np.unique(tile, axis=1).shape[1] == tiles
    return linear, place


@pytest.mark.parametrize("body", ["mma_sync", "wgmma"])
def test_tile_index_matches_split_tiles(body):
    """The kernels' block decoders and ``tile_index`` (dequant_matmul.cu)
    over every block of the grid their launcher builds (``launch`` there
    for the mma.sync body, ``launch_spf`` in wgmma_body.cuh for both wgmma
    tiles), read from the CUDA sources: at every split plan of every timed
    shape they map the blocks onto exactly ``split_tiles`` counters, each
    counter taken by one block of each split, all of one (expert, token
    tile, column tile)."""
    checked = 0
    for g, (c, k, n) in _timed_launches():
        for bits in (4, 8, 16):
            plan = tk.launch_plan(c, k, n, bits)
            if plan.splits == 1 or (plan.body == "mma_sync") != (
                    body == "mma_sync"):
                continue
            _check_places(body, plan, g, c, n, bits)
            checked += 1
    assert checked > 0


@pytest.mark.parametrize("g", [1, 3, 4])
@pytest.mark.parametrize("c", [216, 256, 320, 400, 640])
def test_wgmma_token_tiles_share_a_wave(c, g):
    """In the wgmma bodies' grid the token tiles of one (expert, split,
    column tile) are consecutive blocks, the token tile varying fastest, so
    they run in one wave and read each weight stage through L2 (in the
    bf16 bank a pair of them, one cluster, shares each stage's weight
    boxes); every (expert,
    split, token tile, column tile) has one block and each counter one
    block per split (Mixtral's up- and down-projections, every bank;
    Kimi-K2's int4 up-projection at G = 384 for C = 216; C = 400 has an odd
    last tile, whose partner in the bf16 bank's clusters is the grid's
    pad)."""
    shapes = [(4096, 14336), (14336, 4096)]
    banks = [(g, shapes)]
    if c == 216 and g == 1:
        banks.append((384, [(7168, 2048)]))
    for experts, kns in banks:
        for k, n in kns:
            for bits in (4, 8, 16):
                plan = tk.launch_plan(c, k, n, bits)
                assert plan.body in ("wgmma", "wgmma_wide")
                linear, place = _check_places("wgmma", plan, experts, c, n,
                                              bits)
                mtiles = math.ceil(c / plan.block_c)
                order = np.argsort(linear)
                mt = place["mt"][order]
                assert (mt == np.arange(linear.size) % mtiles).all()
                # consecutive but for the pad after an odd last tile
                step = np.diff(linear[order])
                assert set(step.tolist()) <= {1, 1 + (bits == 16) * (
                    mtiles % 2)}
                group = np.stack([place[f][order]
                                  for f in ("g", "split", "nt")])
                runs = group.reshape(3, -1, mtiles)
                assert (runs == runs[:, :, :1]).all()


def test_split_workspace_is_checked():
    """A caller-given workspace must match the plan: none for one split,
    a contiguous float32 (splits, G, M, N) for more."""
    split_plan = tk.launch_plan(8, 4096, 14336, 4)
    one_plan = tk.launch_plan(128, 4096, 14336, 4)
    assert split_plan.splits > 1 and one_plan.splits == 1
    out = torch.empty((2, 8, 14336), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="does not split"):
        tk._split_args(one_plan, out, torch.empty(1))
    for bad in (torch.empty((split_plan.splits + 1, 2, 8, 14336)),
                torch.empty((split_plan.splits, 2, 8, 14336),
                            dtype=torch.float16)):
        with pytest.raises(ValueError, match="workspace must be"):
            tk._split_args(split_plan, out, bad)
    assert tk._split_args(one_plan, out, None) == (None, None)


@pytest.mark.parametrize("k,group,ok", [
    (4096, 64, True), (64, 16, True), (128, 32, True), (256, 128, True),
    (4096, 48, False), (4096, 8, False), (72, 8, False)])
def test_cuda_shape_contract(k, group, ok):
    if ok:
        tk.check_cuda_shape(k, group)
    else:
        with pytest.raises(ValueError, match="CUDA dequant-matmul needs"):
            tk.check_cuda_shape(k, group)


# --------------------------------------------------------------------------
# The two bodies: which one a plan names, and where row invariance holds.
# --------------------------------------------------------------------------

#: (K, N) of every matmul the port launches at full width: Mixtral's
#: up/gate and down, Kimi-K2's, phase 9's token-gather and TP shards
FULL_KN = [(4096, 14336), (14336, 4096), (7168, 2048), (2048, 7168),
           (4096, 7168), (7168, 4096), (4096, 896), (896, 4096)]


@pytest.mark.parametrize("c", [65, 80, 108, 128, 160, 256])
@pytest.mark.parametrize("k,n", FULL_KN)
def test_launch_plan_wgmma_body(c, k, n):
    """64 < C <= 128 takes the wgmma body's 128-token tile, C = 129-160 the
    wide body's 160-token tile and C = 161-256 two 128-token tiles; the
    splits cover K on 64-aligned boundaries and fit one wave of column
    tiles at G = 1, and the f32 partials stay within half the weight bytes
    (C <= 128) or, at C > 128, within the weight bytes at 160 tokens (the
    wide body's splits whichever tile runs)."""
    for bits in (4, 8, 16):
        plan = tk.launch_plan(c, k, n, bits)
        wide = c > 128
        assert plan.body == ("wgmma_wide" if 128 < c <= 160 else "wgmma")
        assert plan.block_c == (160 if 128 < c <= 160 else 128)
        assert plan.block_n == tk.BLOCK_N
        assert plan.k_chunk % tk.SPLIT_GRAIN == 0
        bounds = [min(k, s * plan.k_chunk) for s in range(plan.splits + 1)]
        assert bounds[0] == 0 and bounds[-1] == k
        assert all(lo < hi for lo, hi in zip(bounds, bounds[1:]))
        tiles = math.ceil(n / 128)
        if 2 * tiles >= tk.WAVE:
            assert plan.splits == 1
        else:
            assert plan.splits * tiles <= tk.WAVE
        if plan.splits > 1:
            assert plan.splits * 8 * (160 if wide else 128) <= k * bits / (
                8 if wide else 16)


@pytest.mark.parametrize("label", list(_chip_smoke().SHAPES))
def test_launch_plan_row_invariance_domain(label):
    """For every timed (K, N): all C in 1..64 share one body and one K
    split (a decode row equals its verify row), and so do all C in
    65..128 (one 128-token wgmma tile: a C = 80 row equals its C = 128
    row). All C in 129..640 share one K split (a C = 160 row equals its C
    = 256 and C = 320 row: the two wgmma bodies compute a row alike on
    alike splits), on the wide body's 160-token tile but for C = 161-256,
    which run two 128-token wgmma tiles."""
    _, k, n = _chip_smoke().SHAPES[label]
    for bits in (4, 8, 16):
        for lo, hi, body in ((1, 64, "mma_sync"), (65, 128, "wgmma"),
                             (129, 160, "wgmma_wide"), (161, 256, "wgmma"),
                             (257, 640, "wgmma_wide")):
            plans = {tk.launch_plan(c, k, n, bits)._replace(block_c=0)
                     for c in range(lo, hi + 1)}
            assert len(plans) == 1
            assert plans.pop().body == body
        splits = {tk.launch_plan(c, k, n, bits)[2:4] for c in range(129, 641)}
        assert len(splits) == 1


@pytest.mark.parametrize("c", [320, 640])
@pytest.mark.parametrize("k,n", FULL_KN)
def test_launch_plan_wide_token_tiles(c, k, n):
    """Past 160 tokens the wide body's tiles multiply: C = 320 and 640
    (the 1024- and 2048-token buckets at Mixtral's top-2 of 8) run two and
    four 160-token tiles with the splits of C = 160, whatever the expert
    count: K covered on 64-aligned boundaries, at most one wave of column
    tiles at G = 1, f32 partials within the weight bytes."""
    for bits in (4, 8, 16):
        plan = tk.launch_plan(c, k, n, bits)
        assert plan == tk.launch_plan(160, k, n, bits)
        assert plan.body == "wgmma_wide" and plan.block_c == 160
        assert math.ceil(c / plan.block_c) == c // 160
        bounds = [min(k, s * plan.k_chunk) for s in range(plan.splits + 1)]
        assert bounds[0] == 0 and bounds[-1] == k
        assert all(b % tk.SPLIT_GRAIN == 0 for b in bounds[:-1])
        assert plan.splits * math.ceil(n / 128) <= max(tk.WAVE,
                                                       math.ceil(n / 128))
        if plan.splits > 1:
            assert plan.splits * 8 * 160 <= k * bits / 8


def test_m_tile_pads_on_the_cpu_only():
    """The reference's pad of M (``_with_padded_m``) holds on the CPU and
    for any device but the card, whose kernels take the true token count:
    C = 160 runs 160 rows there, not 256, and C = 5 five, not 8."""
    for m in (1, 5, 8, 12, 20, 100, 128, 130, 160, 300, 640):
        for block_m in (8, 128):
            eff = min(block_m, ops._round_up(m, 8))
            want = (ops._round_up(m, eff), eff)
            assert ops._m_tile(m, block_m, "cpu") == want
            assert ops._m_tile(m, block_m, "meta") == want
            assert ops._m_tile(m, block_m, "cuda") == (m, m)
    seen = []

    def call(xp, bm):
        seen.append((tuple(xp.shape), bm))
        return xp
    out = ops._with_padded_m(call, torch.ones(3, 160, 16), block_m=128,
                             m_axis=1)
    assert seen == [((3, 256, 16), 128)] and tuple(out.shape) == (3, 160, 16)


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("c", [160, 300])
def test_kernel_arithmetic_wide_tile_exact(bits, c):
    """Integer-friendly inputs at the wide tile's token counts (one tile of
    160, two of 160 for 300) over the plan's splits: bit-equal to
    float64."""
    rng = np.random.default_rng(30 + bits + c)
    g, k, n = 2, 512, 128
    x = rng.integers(-3, 4, size=(g, c, k)).astype(np.float64)
    qmax = {4: 7, 8: 127, 16: 7}[bits]
    codes = rng.integers(-qmax - 1, qmax + 1, size=(g, k, n))
    scale = 0.25 if bits == 16 else 0.125
    exact = torch.from_numpy(x @ (codes * scale)).to(torch.bfloat16)
    assert tk.launch_plan(c, k, n, bits).body == "wgmma_wide"
    tx = torch.from_numpy(x).to(torch.bfloat16)
    if bits == 16:
        w = torch.from_numpy(codes * scale).to(torch.bfloat16)
        got = emulate_bank(tx, w, None, group=64, bits=16)
    else:
        scales = torch.full((g, k // 64, n), scale).to(torch.bfloat16)
        got = emulate_bank(tx, torch.from_numpy(codes), scales, group=64,
                           bits=bits)
    np.testing.assert_array_equal(bits16(got), bits16(exact))


def test_launch_plan_below_65_unchanged():
    """C <= 64 plans follow the mma.sync body's rule: the smallest token
    tile, then K splits until the tiles reach 264 blocks."""
    for c in (1, 8, 12, 16, 24, 40, 64):
        for k, n in FULL_KN:
            plan = tk.launch_plan(c, k, n, 4)
            block_c = next(b for b in (8, 16, 32, 64) if c <= b)
            grains = math.ceil(k / 64)
            want = max(1, min(grains, 16, math.ceil(
                264 / (math.ceil(n / 128) * math.ceil(c / block_c)))))
            k_chunk = math.ceil(grains / want) * 64
            assert tuple(plan) == (128, block_c, k_chunk,
                                   math.ceil(k / k_chunk), "mma_sync")


@pytest.mark.parametrize("name", sorted(
    p.name for p in cuda_lib.CSRC.iterdir() if p.is_file()))
def test_library_digest_covers_every_source(name, tmp_path, monkeypatch):
    """The library's file name changes when any file under csrc/ changes
    (a header included by the .cu file too), so no stale build loads."""
    import shutil
    src = tmp_path / "csrc"
    shutil.copytree(cuda_lib.CSRC, src)
    monkeypatch.setattr(cuda_lib, "CSRC", src)
    before = cuda_lib._lib_path()
    with open(src / name, "a") as f:
        f.write("\n// edited\n")
    assert cuda_lib._lib_path() != before


def test_reset_clears_body_launches():
    cuda_lib.BODY_LAUNCHES[("grouped_q4", "wgmma")] += 1
    ops.reset_launches()
    assert not cuda_lib.BODY_LAUNCHES and ops.BODY_LAUNCHES is \
        cuda_lib.BODY_LAUNCHES


def test_reset_clears_split_launches():
    """The split launches are booked apart from every other counter, and
    reset_launches clears them; no stand-alone reduction is counted."""
    cuda_lib.SPLIT_LAUNCHES[("grouped_bf16", "mma_sync")] += 1
    ops.reset_launches()
    assert not cuda_lib.SPLIT_LAUNCHES and ops.SPLIT_LAUNCHES is \
        cuda_lib.SPLIT_LAUNCHES
    assert "splitk_reduce" not in cuda_lib.LAUNCHES


def test_wrappers_build_never_defines_the_stamps(monkeypatch, tmp_path):
    """The library the wrappers build and load is compiled with no ``-D``
    at all, so never with the wgmma bodies' stage stamps nor with their
    turns compiled out; those macros reach only a build that asks for
    them, under a name of its own, and they are the macros the sources
    test."""
    import types
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(cuda_lib, "_nvcc", lambda: "nvcc")
    seen = []

    def run(cmd, **kw):
        seen.append(cmd)
        return types.SimpleNamespace(returncode=1, stdout="stopped here")
    monkeypatch.setattr(cuda_lib.subprocess, "run", run)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cuda_lib.build()
    assert seen and not any(a.startswith("-D") for a in seen[0])
    macros = (cuda_lib.STAMP_MACRO, cuda_lib.LOCKSTEP_MACRO)
    assert not any(m in a for a in seen[0] for m in macros)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cuda_lib.build(defines=macros, build_dir=tmp_path / "timeline")
    assert all(f"-D{m}" in seen[1] for m in macros)
    assert cuda_lib._lib_path() != cuda_lib._lib_path(
        (cuda_lib.STAMP_MACRO,))
    sources = _csrc("wgmma_body.cuh") + _csrc("wgmma_wide.cuh")
    assert all(f"#ifdef {m}" in sources for m in macros)


def _timeline_tool():
    path = Path(__file__).resolve().parents[1] / "tools" / \
        "consumer_timeline.py"
    spec = importlib.util.spec_from_file_location("consumer_timeline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_timeline_reads_stamps_and_sass():
    """The timeline tool's two readers on made-up input: the consumer K
    loop found in SASS by its backward branch (not a retry stub's wider
    one) and counted per stage; stamps turned into a stage's period and
    steps in their order, each warpgroup's issue and flush windows, the
    cycles to the other's issue and the share of its flush under the
    other's wgmmas; and the points named as the sources' StampPoint."""
    ct = _timeline_tool()
    enum = _csrc("wgmma_body.cuh")
    enum = enum[enum.index("enum StampPoint {"):]
    enum = enum[:enum.index("ST_POINTS")]
    assert tuple(p.lower() for p in re.findall(r"ST_(\w+),", enum)) == \
        ct.POINTS
    sass = "\n".join(
        f"        /*{a:04x}*/  {op} ;" for a, op in enumerate([
            "MOV R1, c[0x0][0x28]",
            "HGMMA.64x128x16.F32.BF16 R24, R8, gdesc[UR4], R24",
            "HGMMA.64x128x16.F32.BF16 R24, R8, gdesc[UR4], R24",
            "FFMA R2, R3, R4, R2", "@!P0 BRA 0x4",
            "HGMMA.64x128x16.F32.BF16 R24, R8, gdesc[UR4], R24",
            "HGMMA.64x128x16.F32.BF16 R24, R8, gdesc[UR4], R24",
            "PRMT R2, R3, 0x1, R4", "WARPGROUP.ARRIVE",
            "@P1 BRA 0x1", "EXIT",
            # a barrier wait's retry stub, branching back from afar
            "@!P2 BRA 0x1"], start=0))
    (loop,) = ct.consumer_loops(sass)
    assert loop["stages"] == 1
    assert loop["per_stage"] == {"HGMMA": 4, "FFMA": 1, "conversion": 1,
                                 "MOV": 0, "sync": 1, "loads": 0, "rest": 2}
    # two warpgroups in turn, 1000 cycles a stage, warpgroup 1 500 cycles
    # behind: each one's wgmmas (issued to drained) span 300 cycles, its
    # flush 100 from its wait's return
    blocks, stages, n = 2, 16, len(ct.POINTS)
    consumer = dict(turn=-20, issued=0, waited=30, flushed=130,
                    released=140, drained=300, full=320, converted=600)
    at = [consumer, {k: v + 500 for k, v in consumer.items()},
          dict(empty=100)]
    stamps = [0] * (blocks * ct.ROLES * stages * n)
    for b in range(blocks):
        for role in range(ct.ROLES):
            for it in range(12):
                for name, off in at[role].items():
                    stamps[((b * ct.ROLES + role) * stages + it) * n
                           + ct.POINTS.index(name)] = 1000 + 1000 * it + off
    got = ct.analyse(stamps, blocks, stages, 12)
    assert got["wg0"]["period"] == 1000 and got["wg1"]["blocks"] == blocks
    assert got["wg0"]["steps"] == [
        ("turn", 380), ("issued", 20), ("waited", 30), ("flushed", 100),
        ("released", 10), ("drained", 160), ("full", 20),
        ("converted", 280)]
    for wg in ("wg0", "wg1"):
        assert got[wg]["issue_window"] == 20
        assert got[wg]["flush_window"] == 100
        assert got[wg]["to_other_issue"] == 500
    # warpgroup 0 flushes at 1030-1130 + 1000 it, before warpgroup 1's
    # wgmmas (1500-1800); warpgroup 1 flushes at 1530-1630, under
    # warpgroup 0's next stage's? no: those run 2000-2300
    assert got["wg0"]["flush_overlap"] == 0
    assert got["wg1"]["flush_overlap"] == 0
    assert got["flush_skew"] == 500 and got["producer_period"] == 1000
    # stage it + 1 could load from 2100 + 1000 it; the full wait for it
    # returned at 1320 + 1000 it
    assert got["producer_lead"] == -780
    # warpgroup 1 150 cycles behind: warpgroup 0's flush (30-130) lies
    # under none of warpgroup 1's wgmmas (150-450), warpgroup 1's flush
    # (180-280) wholly under warpgroup 0's (0-300)
    at[1] = {k: v + 150 for k, v in consumer.items()}
    for b in range(blocks):
        for it in range(12):
            for name, off in at[1].items():
                stamps[((b * ct.ROLES + 1) * stages + it) * n
                       + ct.POINTS.index(name)] = 1000 + 1000 * it + off
    got = ct.analyse(stamps, blocks, stages, 12)
    assert got["wg0"]["flush_overlap"] == 0
    assert got["wg1"]["flush_overlap"] == 1
    assert got["wg0"]["to_other_issue"] == 150
    assert got["wg1"]["to_other_issue"] == 850


#: the int consumers that take turns: (source, the K loop's function, its
#: stage functions), at the wide body's n160 and at its n96 tail
TURN_BODIES = {"160": ("wgmma_wide.cuh", "consume_wide_int", ("wide_stage",)),
               "n96": ("wgmma_wide.cuh", "consume_wide_int", ("wide_stage",))}
TURN_HELPERS = {"turn_open": "", "turn_take": "", "turn_pass": "int it, int nst"}


def _function(text: str, name: str) -> str:
    """The body of the (template) function ``name`` in ``text``: from its
    head to the closing brace at the start of a line."""
    head = re.search(rf"\n(?:template <[^\n]*>\n)?[^\n]*\bvoid {name}\(",
                     text)
    assert head, name
    body = text[head.start():]
    return body[:body.index("\n}\n") + 3]


def _turn_ops(helper: str) -> list:
    """The named-barrier operations of a turn helper of wgmma_wide.cuh:
    (C condition, "sync" | "arrive", barrier id, thread count) a line."""
    body = _function(_csrc("wgmma_wide.cuh"), helper)
    return [(cond, op, int(i), int(n)) for cond, op, i, n in re.findall(
        r'if \(([^)]*)\)\s*asm volatile\("bar\.(sync|arrive) (\d+), (\d+);',
        body)]


def _ops_of(helper: str, role: int, ops: list, **env) -> list:
    """What warpgroup ``role`` (ROLE 0 or 1; -1 the loop without turns)
    does in ``helper`` (``ops``: its lines, as _turn_ops reads them)."""
    return [(op, bar) for cond, op, bar, _ in ops
            if eval(cond.replace("&&", " and "), {}, {"ROLE": role, **env})]


def test_turn_barriers_are_immediates():
    """The int consumers' turns: named barriers with immediate ids 2 and
    3 (one a consumer warpgroup, neither split_last's 1 nor
    __syncthreads' 0) over the 256 consumer threads, in helpers
    instantiated per role (a template argument, so no role is live across
    the K loop; ROLE -1, the loop without turns, touches no barrier); they
    are the only named barriers of the wgmma bodies. The int4 wide
    consumers of a spread or one-split grid take turns, every other
    consumer one copy of the loop without them (the A/B on the card), and
    the wrappers' build keeps them (TURNS true without REPRO_LOCKSTEP)."""
    body, wide = _csrc("wgmma_body.cuh"), _csrc("wgmma_wide.cuh")
    consumers = int(re.search(r"constexpr int CONSUMERS = (\d+);",
                              body).group(1))
    assert 'asm volatile("bar.sync 1, %0;\\n" :: "n"(THREADS)' in \
        _csrc("dequant_matmul.cu")
    ops_ = {h: _turn_ops(h) for h in TURN_HELPERS}
    assert all(ops_.values())
    for helper, params in TURN_HELPERS.items():
        assert re.search(rf"template <int ROLE>\n__device__ __forceinline__ "
                         rf"void {helper}\({params}\)", wide), helper
        for cond, op, bar, count in ops_[helper]:
            assert bar in (2, 3) and count == consumers * 128 == 256
            assert cond.startswith("ROLE == ")
    for role in (0, 1):
        assert _ops_of("turn_take", role, ops_["turn_take"]) == [
            ("sync", 2 + role)]
        assert _ops_of("turn_pass", role, ops_["turn_pass"], it=0,
                       nst=2) == [("arrive", 3 - role)]
    assert _ops_of("turn_open", 0, ops_["turn_open"]) == []
    assert _ops_of("turn_open", 1, ops_["turn_open"]) == [("arrive", 2)]
    for helper in TURN_HELPERS:
        assert _ops_of(helper, -1, ops_[helper], it=0, nst=2) == []
    # no other named barrier in the bodies
    n_ops = sum(len(v) for v in ops_.values())
    assert len(re.findall(r'"bar\.', body + wide)) == n_ops
    assert re.search(r"#ifdef REPRO_LOCKSTEP\nconstexpr bool TURNS = false;"
                     r"\n#else\nconstexpr bool TURNS = true;\n#endif", wide)
    assert ("template <int BITS, bool FOLD>\nconstexpr bool TAKES_TURNS = "
            "TURNS && BITS == 4 && !FOLD;") in wide
    # who takes turns: the int4 wide loop, per role; the rest at will
    fn = _function(wide, "consume_wide")
    turns = fn[fn.index("if constexpr (TAKES_TURNS<BITS, FOLD>)"):]
    for role in (0, 1):
        assert f"consume_wide_int<BITS, SPF, BC, R, FOLD, {role}>" in turns
    assert "consume_wide_int<BITS, SPF, BC, R, FOLD, -1>" in turns
    assert "(ROLE < 0 ? role : ROLE) * 64" in _function(wide,
                                                        "consume_wide_int")
    for name in ("consume_wide_int", "wide_stage"):
        calls = re.findall(r"(turn_\w+)<([^>]*)>\(", _function(wide, name))
        assert calls and all(arg == "ROLE" for _, arg in calls), name
    for name in ("consume", "int_stage", "int_group"):
        assert not re.search(r"turn_\w+<", _function(body, name)), name


def _turn_program(body: str) -> dict:
    """What one int consumer does with its turns, read from its source:
    the turn_open calls before its K loop, the guards (on the group
    ``grp`` of a stage) of its turn_take and turn_pass calls, and the
    named-barrier operations of each helper. Checks on the way that the K
    loop runs every stage 0 .. nst - 1 in pairs and that no part of it
    reads a column bound (a warpgroup whose columns lie past N takes its
    turns like the other), nor do the folded launch's segment steps touch
    a barrier."""
    source, loop, stages = TURN_BODIES[body]
    text = _csrc(source)
    fn = _function(text, loop)
    head = fn.index("for (int it = 0; it < nst; it += 2) {")
    assert "if (it + 1 < nst)" in fn[head:]
    code = fn[head:] + "".join(_function(text, s) for s in stages)
    assert "a.N" not in code and "n0" not in code
    for step in ("fold_step", "fold_segment"):
        assert "bar." not in _function(_csrc("wgmma_body.cuh"), step)
    guards = {}
    for helper in ("turn_take", "turn_pass"):
        found = [g for s in stages for g in re.findall(
            rf"if \(([^)]*)\)\s*\{{?\s*(?:WG_STAMP\([^)]*\);\s*)?"
            rf"{helper}<ROLE>\(", _function(text, s))]
        assert len(found) == len(re.findall(
            rf"{helper}<ROLE>\(", "".join(_function(text, s)
                                          for s in stages))), helper
        guards[helper] = found
    return {"opens": fn[:head].count("turn_open<ROLE>();"),
            "guards": guards,
            "ops": {h: _turn_ops(h) for h in TURN_HELPERS}}


def _turn_table(prog: dict, nst: int) -> dict:
    """Each warpgroup's named-barrier operations in each turn helper, at
    every stage of ``nst`` (only turn_pass depends on the stage)."""
    ops = prog["ops"]
    return {"open": [_ops_of("turn_open", r, ops["turn_open"])
                     for r in (0, 1)],
            "take": [_ops_of("turn_take", r, ops["turn_take"])
                     for r in (0, 1)],
            "pass": [[_ops_of("turn_pass", r, ops["turn_pass"], it=it,
                              nst=nst) for it in range(nst)]
                     for r in (0, 1)]}


def _emulate_turns(prog: dict, nst: int, ng: int, seg, order,
                   table=None) -> list:
    """Two consumer warpgroups running ``prog`` over ``nst`` stages of
    ``ng`` groups (a folded launch's segments of ``seg`` stages add their
    running sums between stages, no barrier), interleaved by ``order``
    (which runnable warpgroup steps next); named barriers as the hardware
    counts them: a generation completes at 256 arrivals, a sync waits for
    it. Returns the warpgroups' stage issues in the order they happened;
    raises on a deadlock, an arrival no sync meets, or arrivals left over
    at the end."""
    # which groups of a stage take and pass the turn
    at = {h: [any(eval(g, {}, {"grp": grp, "NG": ng}) for g in gs)
              for grp in range(ng)] for h, gs in prog["guards"].items()}
    table = table or _turn_table(prog, nst)
    opens, takes, passes = table["open"], table["take"], table["pass"]

    def program(role):
        ev = []
        for _ in range(prog["opens"]):
            ev += opens[role]
        for it in range(nst):
            for grp in range(ng):
                if at["turn_take"][grp]:
                    ev += takes[role]
                    ev.append(("issue", it))
                if at["turn_pass"][grp]:
                    ev += passes[role][it]
            if seg and (it + 1) % seg == 0:
                ev.append(("fold", it))
        return ev

    progs = [program(0), program(1)]
    pc, count, waiting, issued = [0, 0], {2: 0, 3: 0}, {}, []
    while pc[0] < len(progs[0]) or pc[1] < len(progs[1]):
        ready = [r for r in (0, 1) if r not in waiting
                 and pc[r] < len(progs[r])]
        if not ready:
            raise AssertionError(f"deadlock at {pc}, waiting on {waiting}")
        r = order(ready)
        op, arg = progs[r][pc[r]]
        pc[r] += 1
        if op == "issue":
            issued.append((r, arg))
        elif op in ("sync", "arrive"):
            count[arg] += 128
            if count[arg] == 256:
                count[arg] = 0
                woken = [w for w, b in waiting.items() if b == arg]
                if op == "arrive" and not woken:
                    raise AssertionError(f"an arrival on {arg} met no sync")
                for w in woken:
                    del waiting[w]
            elif op == "sync":
                waiting[r] = arg
    assert count == {2: 0, 3: 0}, f"arrivals left over: {count}"
    return issued


@pytest.mark.parametrize("body", sorted(TURN_BODIES))
def test_turn_protocol_balances(body):
    """Emulated from the sources: the two consumer warpgroups' turns (one
    initial arrival, a sync at each stage's start, an arrival after its
    commit, none after warpgroup 1's last stage) balance every arrival
    against a sync, never deadlock and issue the stages strictly in turn,
    warpgroup 0 first, for 1-17 stages, 1, 2 or 4 groups a stage, spread
    or folded in segments of 1-4 stages, with either warpgroup's columns
    past N (the K loop reads no column bound), in any interleaving."""
    import random
    prog = _turn_program(body)
    rng = random.Random(0)
    orders = (lambda ready: ready[0], lambda ready: ready[-1],
              lambda ready: rng.choice(ready))
    for nst in range(1, 18):
        want = [(r, it) for it in range(nst) for r in (0, 1)]
        table = _turn_table(prog, nst)
        for ng in (1, 2, 4):
            for seg in (None, 1, 2, 3, 4):
                for order in orders:
                    assert _emulate_turns(prog, nst, ng, seg, order,
                                          table) == want


@pytest.mark.parametrize("mutation", ["no opening arrival",
                                      "an arrival after the last stage"])
def test_turn_protocol_emulation_fails_a_broken_protocol(mutation):
    """The emulation refuses the two broken protocols: warpgroup 1 not
    opening (warpgroup 0 waits forever) and warpgroup 1 passing its turn
    after its last stage (an arrival no sync meets)."""
    prog = _turn_program("160")
    if mutation == "no opening arrival":
        prog["opens"] = 0
    else:
        prog["ops"]["turn_pass"] = [
            (cond.replace(" && it + 1 < nst", ""), op, bar, n)
            for cond, op, bar, n in prog["ops"]["turn_pass"]]
    with pytest.raises(AssertionError, match="deadlock|met no sync|left"):
        _emulate_turns(prog, 3, 1, None, lambda ready: ready[0])


def _parent_launch_plan(c, k, n, bits):
    """``launch_plan`` as it stood before grids could fold, written out
    again: folding chooses blocks, never a plan, so the two must agree."""
    grains = max(1, math.ceil(k / 64))
    block_c = next((b for b in (8, 16, 32, 64, 128, 160) if c <= b), 160)
    tiles = math.ceil(n / 128)
    if block_c < 128:
        body = "mma_sync"
        want = math.ceil(264 / (tiles * math.ceil(c / block_c)))
    else:
        wide = block_c == 160
        want = 1 if 2 * tiles >= 132 else 132 // tiles
        want = min(want, k * bits // ((8 if wide else 16) * 8 * block_c))
        if 160 < c <= 256:
            block_c = 128
        body = "wgmma" if block_c == 128 else "wgmma_wide"
    want = max(1, min(grains, 16, want))
    k_chunk = math.ceil(grains / want) * 64
    return (128, block_c, k_chunk, math.ceil(k / k_chunk), body)


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_launch_plan_unchanged_by_folding(bits):
    """Over a grid of (C, K, N) the plan is the one it was before the
    grids could fold: the splits, which fix every row's bits, are the
    same, and only fold_splits sees G."""
    for c in (1, 4, 8, 12, 16, 33, 64, 65, 80, 128, 129, 160, 200, 216,
              256, 257, 320, 400, 416, 640, 1000):
        for k, n in ((4096, 14336), (14336, 4096), (7168, 2048),
                     (2048, 7168), (4096, 896), (896, 4096), (256, 128)):
            assert tuple(tk.launch_plan(c, k, n, bits)) == \
                _parent_launch_plan(c, k, n, bits)
    assert list(inspect.signature(tk.fold_splits).parameters) == [
        "plan", "g", "m", "n", "bits"]


#: (row, bits, G, C, K, N, folds): the rows whose grid the card's timings
#: settled (tools/kernel_ab.py, PERF.md): the wave model's (B3 q8 at G =
#: 4, q4 at G = 3, B2, B4 and B1 at G = 1, Kimi-K2's int4 bank at G = 384,
#: 8a's int8 bank at G = 2 and 1), the decode rows (mma.sync: folded only
#: past a wave of blocks) and the bf16 bank's weight streams
FOLD_ROWS = [
    ("B3 q8 prefill_down", 8, 4, 128, 14336, 4096, True),
    ("B3 q8 prefill160_down", 8, 4, 160, 14336, 4096, True),
    ("B3 q8 prefill320_down", 8, 4, 320, 14336, 4096, True),
    ("B3 q8 prefill640_down", 8, 4, 640, 14336, 4096, True),
    ("B3 q4 prefill_down", 4, 3, 128, 14336, 4096, True),
    ("B3 q4 prefill160_down", 4, 3, 160, 14336, 4096, False),
    ("B3 q4 prefill320_down", 4, 3, 320, 14336, 4096, False),
    ("B3 q4 prefill640_down", 4, 3, 640, 14336, 4096, True),
    ("B2 prefill_down", 8, 1, 128, 14336, 4096, False),
    ("B2 prefill160_down", 8, 1, 160, 14336, 4096, False),
    ("B2 prefill320_down", 8, 1, 320, 14336, 4096, False),
    ("B2 prefill640_down", 8, 1, 640, 14336, 4096, True),
    ("B4 prefill640_down", 16, 1, 640, 14336, 4096, True),
    ("B1 prefill640_down", 4, 1, 640, 14336, 4096, True),
    ("B3 q4 kimi_prefill216_up", 4, 384, 216, 7168, 2048, True),
    ("8a ep 1 int8 down", 8, 2, 320, 14336, 4096, True),
    ("8a ep 2 int8 down", 8, 1, 320, 14336, 4096, False),
    ("B3 q4 prefill_up (one split)", 4, 3, 128, 4096, 14336, False),
    ("B4 prefill640_up (one split)", 16, 1, 640, 4096, 14336, False),
    ("B3 q4 decode4_up (0.85 of a wave)", 4, 3, 4, 4096, 14336, False),
    ("B3 q8 up (1.13 waves)", 8, 4, 8, 4096, 14336, False),
    ("B3 q8 down", 8, 4, 8, 14336, 4096, False),
    ("B3 q4 draft_up", 4, 8, 12, 4096, 14336, False),
    ("B3 q4 kimi_up", 4, 384, 8, 7168, 2048, True),
    ("B3 q4 kimi_down", 4, 384, 8, 2048, 7168, True),
    ("B3 q8 kimi_up", 8, 384, 8, 7168, 2048, True),
    ("B3 q8 kimi_down", 8, 384, 8, 2048, 7168, True),
    ("B3 q4 kimi C=24 (32-token tile)", 4, 384, 24, 7168, 2048, False),
    ("B4 prefill_down (32 streams)", 16, 1, 128, 14336, 4096, False),
    ("B4 G=2 prefill_down (64 streams)", 16, 2, 128, 14336, 4096, True),
    ("B4 prefill320_down (a pair: 32 streams)", 16, 1, 320, 14336, 4096,
     False),
    ("B4 G=2 prefill320_down (64 streams)", 16, 2, 320, 14336, 4096, True),
    ("B4 C=400 (64 streams)", 16, 1, 400, 14336, 4096, True),
]


@pytest.mark.parametrize("row,bits,g,c,k,n,folds", FOLD_ROWS,
                         ids=[r[0] for r in FOLD_ROWS])
def test_fold_splits_rows(row, bits, g, c, k, n, folds):
    plan = tk.launch_plan(c, k, n, bits)
    assert tk.fold_splits(plan, g, c, n, bits) is folds
    if plan.splits == 1:
        assert not folds


def test_folded_launch_takes_no_workspace(monkeypatch):
    """A folded launch gets neither a workspace nor the device's counters,
    and refuses a caller's workspace; spread, the same plan gets both."""
    plan = tk.launch_plan(128, 14336, 4096, 8)
    assert plan.splits > 1
    out = torch.empty((4, 128, 4096), dtype=torch.bfloat16)
    asked = []
    monkeypatch.setattr(tk, "_counters",
                        lambda device, tiles: asked.append(tiles) or
                        torch.zeros(tiles, dtype=torch.int32))
    assert tk._split_args(plan, out, None, fold=True) == (None, None)
    assert not asked
    with pytest.raises(ValueError, match="is folded"):
        tk._split_args(plan, out, torch.empty((plan.splits, 4, 128, 4096)),
                       fold=True)
    ws_ptr, counters = tk._split_args(plan, out, None, fold=False)
    assert ws_ptr and counters and asked == [tk.split_tiles(plan, 4, 128,
                                                            4096)]


def test_folded_launches_booked_and_cleared():
    """A folded launch is booked in FOLDED_LAUNCHES beside its split plan's
    SPLIT_LAUNCHES entry, a forced grid folds only a split plan, and
    reset_launches clears the book."""
    ops.reset_launches()
    split = tk.launch_plan(128, 14336, 4096, 8)
    one = tk.launch_plan(128, 4096, 14336, 8)
    assert tk._grid(split, 4, 128, 4096, 8, None) is True
    assert tk._grid(split, 1, 128, 4096, 8, None) is False
    assert tk._grid(split, 1, 128, 4096, 8, True) is True
    assert tk._grid(one, 4, 128, 14336, 8, True) is False
    tk._book("grouped_q8", split, True)
    tk._book("q8_matmul", split, False)
    assert cuda_lib.FOLDED_LAUNCHES == {("grouped_q8", "wgmma"): 1}
    assert cuda_lib.SPLIT_LAUNCHES == {("grouped_q8", "wgmma"): 1,
                                       ("q8_matmul", "wgmma"): 1}
    assert ops.FOLDED_LAUNCHES is cuda_lib.FOLDED_LAUNCHES
    ops.reset_launches()
    assert not cuda_lib.FOLDED_LAUNCHES and not cuda_lib.SPLIT_LAUNCHES


@pytest.mark.parametrize("splits", [2, 3, 4, 5, 16])
def test_folded_running_sum_matches_split_order(splits):
    """A folded block's running sum (the first segment's partial as it
    is, each later one added, the last added to the sum in the epilogue's
    registers) gives splitk_reduce_plain's bytes: f32 addition commutes,
    so sum + partial and partial + sum round alike."""
    rng = np.random.default_rng(splits)
    ws = torch.from_numpy(rng.standard_normal((splits, 2, 4, 32)).astype(
        np.float32) * 10.0 ** rng.integers(-3, 4, size=(splits, 1, 1, 1)))
    tot = ws[0].clone()
    for s in range(1, splits - 1):
        tot = tot + ws[s]
    last = ws[splits - 1] + tot if splits > 1 else tot
    np.testing.assert_array_equal(bits16(last.to(torch.bfloat16)),
                                  bits16(tk.splitk_reduce_plain(ws)))


def test_folded_entry_points_take_a_fold_flag():
    """The C entry points and their ctypes bindings both take the grid as
    an int after the splits, and the kernels run a folded launch as one
    split over K in segments of the plan's k_chunk."""
    main = _csrc("dequant_matmul.cu")
    for entry in ("repro_dequant_matmul(", "repro_bf16_matmul("):
        head = main[main.index(f'extern "C" int {entry}'):]
        head = head[:head.index("{")]
        assert "int k_chunk, int splits, int fold," in " ".join(head.split())
    body = main[main.index("Args folded(Args a) {"):]
    body = body[:body.index("}")]
    for line in ("a.seg = a.k_chunk;", "a.k_chunk *= a.splits;",
                 "a.splits = 1;", "a.ws = nullptr;", "a.counters = nullptr;"):
        assert line in body
    assert "plan = [i32] * 5" in Path(cuda_lib.__file__).read_text()
