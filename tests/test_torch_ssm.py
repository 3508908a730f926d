"""The port's SSM module (``repro_torch.models.ssm``) against the
reference's ``repro.models.ssm``, function by function, on the same
numpy inputs: the Mamba2 SSD and RWKV6 cores (chunked, one step and the
per-token oracle), the causal conv, the token shift and the three blocks.

Bars: at float32 within 1e-5 of max |y|; at bfloat16 within one bf16 ulp
of max |y| (the frameworks round bf16 chains at other points and sum in
other orders). Every case runs a sequence that is not a multiple of the
chunk, with and without an initial state. Inside the port, chunked ==
recurrent within 1e-5 of max |y| at float32."""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as TS

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, S, CHUNK = 2, 37, 16          # 37 = 2 chunks of 16 + a padded tail


def pair(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``
    (both round f32 to bf16 to nearest even)."""
    jd, td = DTYPES[dtype]
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, jd), torch.from_numpy(a.copy()).to(td)


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def bar(ref: np.ndarray, dtype: str) -> float:
    m = float(np.abs(ref).max())
    if dtype == "float32":
        return 1e-5 * m
    return 2.0 ** (math.floor(math.log2(m)) - 7)     # one bf16 ulp of m


def assert_close(got, want, dtype):
    g, w = as_np(got), as_np(want)
    assert g.shape == w.shape
    err = float(np.abs(g - w).max())
    assert err <= bar(w, dtype), (err, bar(w, dtype))


def ssd_inputs(rng, dtype, s0: bool):
    h, p, n = 3, 8, 8
    u = pair(rng.standard_normal((B, S, h, p)), dtype)
    ld = pair(-rng.uniform(0.0, 2.0, (B, S, h)), "float32")
    b = pair(rng.standard_normal((B, S, n)) / 3, dtype)
    c = pair(rng.standard_normal((B, S, n)) / 3, dtype)
    st = pair(rng.standard_normal((B, h, p, n)), "float32") if s0 \
        else (None, None)
    return u, ld, b, c, st


def rwkv_inputs(rng, dtype, s0: bool):
    h, k = 3, 8
    r, kk, v = (pair(rng.standard_normal((B, S, h, k)) / 2, dtype)
                for _ in range(3))
    lw = pair(-JS.DECAY_CLAMP * rng.uniform(0.01, 1.0, (B, S, h, k)),
              "float32")
    bonus = pair(rng.standard_normal((h, k)) * 0.1, dtype)
    st = pair(rng.standard_normal((B, h, k, k)), "float32") if s0 \
        else (None, None)
    return r, kk, v, lw, bonus, st


CASES = [(d, s0) for d in DTYPES for s0 in (False, True)]
IDS = [f"{d}-{'s0' if s0 else 'zero'}" for d, s0 in CASES]


@pytest.mark.parametrize("dtype,s0", CASES, ids=IDS)
def test_ssd_chunked_matches(dtype, s0):
    u, ld, b, c, st = ssd_inputs(np.random.default_rng(0), dtype, s0)
    jy, js = JS.ssd_chunked(u[0], ld[0], b[0], c[0], CHUNK, s0=st[0])
    ty, ts = TS.ssd_chunked(u[1], ld[1], b[1], c[1], CHUNK, s0=st[1])
    assert ty.dtype == DTYPES[dtype][1] and ts.dtype == torch.float32
    assert_close(ty, jy, dtype)
    assert_close(ts, js, "float32" if dtype == "float32" else dtype)


@pytest.mark.parametrize("dtype,s0", CASES, ids=IDS)
def test_ssd_recurrent_ref_and_step_match(dtype, s0):
    u, ld, b, c, st = ssd_inputs(np.random.default_rng(1), dtype, s0)
    jy = JS.ssd_recurrent_ref(u[0], ld[0], b[0], c[0], s0=st[0])
    ty = TS.ssd_recurrent_ref(u[1], ld[1], b[1], c[1], s0=st[1])
    assert_close(ty, jy, dtype)
    prev = st if s0 else pair(np.zeros((B, 3, 8, 8)), "float32")
    jy1, js1 = JS.ssd_step(prev[0], u[0][:, 5], ld[0][:, 5], b[0][:, 5],
                           c[0][:, 5])
    ty1, ts1 = TS.ssd_step(prev[1], u[1][:, 5], ld[1][:, 5], b[1][:, 5],
                           c[1][:, 5])
    assert_close(ty1, jy1, dtype)
    assert_close(ts1, js1, "float32")


@pytest.mark.parametrize("dtype,s0", CASES, ids=IDS)
def test_rwkv_chunked_matches(dtype, s0):
    r, k, v, lw, bonus, st = rwkv_inputs(np.random.default_rng(2), dtype,
                                         s0)
    jy, js = JS.rwkv_chunked(r[0], k[0], v[0], lw[0], bonus[0], CHUNK,
                             s0=st[0])
    ty, ts = TS.rwkv_chunked(r[1], k[1], v[1], lw[1], bonus[1], CHUNK,
                             s0=st[1])
    assert ty.dtype == DTYPES[dtype][1] and ts.dtype == torch.float32
    assert_close(ty, jy, dtype)
    assert_close(ts, js, "float32" if dtype == "float32" else dtype)


@pytest.mark.parametrize("dtype,s0", CASES, ids=IDS)
def test_rwkv_recurrent_ref_and_step_match(dtype, s0):
    r, k, v, lw, bonus, st = rwkv_inputs(np.random.default_rng(3), dtype,
                                         s0)
    jy = JS.rwkv_recurrent_ref(r[0], k[0], v[0], lw[0], bonus[0], s0=st[0])
    ty = TS.rwkv_recurrent_ref(r[1], k[1], v[1], lw[1], bonus[1], s0=st[1])
    assert_close(ty, jy, dtype)
    prev = st if s0 else pair(np.zeros((B, 3, 8, 8)), "float32")
    jy1, js1 = JS.rwkv_step(prev[0], r[0][:, 7], k[0][:, 7], v[0][:, 7],
                            lw[0][:, 7], bonus[0])
    ty1, ts1 = TS.rwkv_step(prev[1], r[1][:, 7], k[1][:, 7], v[1][:, 7],
                            lw[1][:, 7], bonus[1])
    assert_close(ty1, jy1, dtype)
    assert_close(ts1, js1, "float32")


@pytest.mark.parametrize("s0", (False, True), ids=("zero", "s0"))
@pytest.mark.parametrize("core", ("ssd", "rwkv"))
def test_chunked_equals_recurrent_in_port(core, s0):
    """The port's chunked form against its own per-token oracle, and the
    final state against the oracle's last step, at float32."""
    rng = np.random.default_rng(4)
    if core == "ssd":
        u, ld, b, c, st = ssd_inputs(rng, "float32", s0)
        y, s_last = TS.ssd_chunked(u[1], ld[1], b[1], c[1], CHUNK,
                                   s0=st[1])
        ref = TS.ssd_recurrent_ref(u[1], ld[1], b[1], c[1], s0=st[1])
        state = st[1] if s0 else torch.zeros_like(s_last)
        for t in range(S):
            _, state = TS.ssd_step(state, u[1][:, t], ld[1][:, t],
                                   b[1][:, t], c[1][:, t])
    else:
        r, k, v, lw, bonus, st = rwkv_inputs(rng, "float32", s0)
        y, s_last = TS.rwkv_chunked(r[1], k[1], v[1], lw[1], bonus[1],
                                    CHUNK, s0=st[1])
        ref = TS.rwkv_recurrent_ref(r[1], k[1], v[1], lw[1], bonus[1],
                                    s0=st[1])
        state = st[1] if s0 else torch.zeros_like(s_last)
        for t in range(S):
            _, state = TS.rwkv_step(state, r[1][:, t], k[1][:, t],
                                    v[1][:, t], lw[1][:, t], bonus[1])
    assert_close(y, ref, "float32")
    assert_close(s_last, state, "float32")


@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv_and_token_shift_match(dtype):
    rng = np.random.default_rng(5)
    x = pair(rng.standard_normal((B, S, 12)), dtype)
    w = pair(rng.standard_normal((4, 12)) / 2, dtype)
    st = pair(rng.standard_normal((B, 3, 12)), dtype)
    for state in ((None, None), st):
        jy, jn = JS._causal_conv(x[0], w[0], state[0])
        ty, tn = TS._causal_conv(x[1], w[1], state[1])
        assert ty.dtype == DTYPES[dtype][1]
        assert_close(ty, jy, dtype)
        np.testing.assert_array_equal(as_np(tn), as_np(jn))
    prev = pair(rng.standard_normal((B, 12)), dtype)
    for p in ((None, None), prev):
        jxx, jlast = JS._token_shift(x[0], p[0])
        txx, tlast = TS._token_shift(x[1], p[1])
        np.testing.assert_array_equal(as_np(txx), as_np(jxx))
        np.testing.assert_array_equal(as_np(tlast), as_np(jlast))


@functools.lru_cache(maxsize=None)
def _layer0(arch: str, group: str, dtype: str):
    """Layer 0 of the port's smoke params of ``arch`` at ``dtype`` (the
    init rules of both packages are equal; the port's draws are fast), as
    (config, jax tree, port tree) holding the same values."""
    cfg = reduce_for_smoke(get_config(arch)).replace(dtype=dtype)
    tp = tmodel.init_params(cfg, 0, device="cpu")["layers"]
    tp = {"block": {k: v[0] for k, v in tp[group].items()},
          "attn_norm": {"scale": tp["attn_norm"]["scale"][0]}}
    jp = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.float().numpy(), DTYPES[dtype][0]), tp)
    return cfg, jp, tp


def _mode_caches(mode, cache_j, cache_t):
    """(jax cache, port cache) for a call mode: none, a prefill from a
    carried cache (chunked with s0) or a decode step."""
    return (None, None) if mode == "train" else (cache_j, cache_t)


MODES = ("train", "prefill", "decode")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba2_block_matches(dtype, mode):
    cfg, jp, tp = _layer0("zamba2-7b", "mamba", dtype)
    rng = np.random.default_rng(6)
    s = 1 if mode == "decode" else S
    x = pair(rng.standard_normal((B, s, cfg.d_model)), dtype)
    scfg = cfg.ssm
    di = scfg.expand * cfg.d_model
    h = di // scfg.head_dim
    st = pair(rng.standard_normal((B, h, scfg.head_dim, scfg.state_dim))
              / 4, "float32")
    conv = pair(rng.standard_normal((B, 3, di + 2 * scfg.state_dim)), dtype)
    cj, ct = _mode_caches(mode, {"state": st[0], "conv": conv[0]},
                          {"state": st[1], "conv": conv[1]})
    jy, jc = JS.mamba2_block(jp["block"], x[0], scfg, cj)
    ty, tc = TS.mamba2_block(tp["block"], x[1], scfg, ct)
    assert ty.dtype == DTYPES[dtype][1]
    assert_close(ty, jy, dtype)
    assert_close(tc["state"], jc["state"],
                 "float32" if dtype == "float32" else dtype)
    assert_close(tc["conv"], jc["conv"], dtype)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rwkv6_blocks_match(dtype, mode):
    cfg, jp, tp = _layer0("rwkv6-3b", "rwkv", dtype)
    rng = np.random.default_rng(7)
    s = 1 if mode == "decode" else S
    d = cfg.d_model
    x = pair(rng.standard_normal((B, s, d)), dtype)
    h = d // cfg.ssm.head_dim
    st = pair(rng.standard_normal((B, h, cfg.ssm.head_dim,
                                   cfg.ssm.head_dim)) / 4, "float32")
    xa, xf = (pair(rng.standard_normal((B, d)), dtype) for _ in range(2))
    cj, ct = _mode_caches(mode, {"state": st[0], "x_att": xa[0]},
                          {"state": st[1], "x_att": xa[1]})
    jy, jc = JS.rwkv6_timemix(jp["block"], x[0], cfg.ssm, cj)
    ty, tc = TS.rwkv6_timemix(tp["block"], x[1], cfg.ssm, ct)
    assert ty.dtype == DTYPES[dtype][1]
    assert_close(ty, jy, dtype)
    assert_close(tc["state"], jc["state"],
                 "float32" if dtype == "float32" else dtype)
    np.testing.assert_array_equal(as_np(tc["x_att"]), as_np(jc["x_att"]))
    cj, ct = _mode_caches(mode, {"x_ffn": xf[0]}, {"x_ffn": xf[1]})
    jy, jc = JS.rwkv6_channelmix(jp["block"], x[0], cj)
    ty, tc = TS.rwkv6_channelmix(tp["block"], x[1], ct)
    assert_close(ty, jy, dtype)
    np.testing.assert_array_equal(as_np(tc["x_ffn"]), as_np(jc["x_ffn"]))


def test_ssd_gradient_finite_where_reference_is_nan():
    """Decays summing past ~88 within a chunk (Zamba2's widths: dt up to
    ~1, A up to 16, chunk 128) overflow exp(diff) of the masked upper
    triangle: the reference's gradient is inf * 0 = NaN there. The port
    masks before the exp: the same forward values, a finite gradient."""
    rng = np.random.default_rng(8)
    u, _, b, c, _ = ssd_inputs(rng, "float32", False)
    ld = -rng.uniform(4.0, 7.2, (B, S, 3)).astype(np.float32)

    def jloss(x):
        return JS.ssd_chunked(u[0], x, b[0], c[0], 32)[0].sum()

    jg = jax.grad(jloss)(jnp.asarray(ld))
    assert not np.isfinite(np.asarray(jg)).all()
    t = torch.from_numpy(ld.copy()).requires_grad_(True)
    y, _ = TS.ssd_chunked(u[1], t, b[1], c[1], 32)
    y.sum().backward()
    assert torch.isfinite(t.grad).all() and float(t.grad.abs().max()) > 0
    assert_close(y.detach(), JS.ssd_chunked(u[0], jnp.asarray(ld), b[0],
                                            c[0], 32)[0], "float32")
