"""The SSM, hybrid, enc-dec and VLM families (RWKV6-3B, Zamba2-7B,
SeamlessM4T-medium, PaliGemma-3B) through the port's whole-batch entry
points (``Model.init``, ``loss_fn``, ``prefill``, ``decode_step``,
``init_cache``) against the reference's, at smoke size on the CPU, the
reference's params crossed by ``params_from_numpy``.

Bars: configs equal (``str`` and ``param_shapes``); the init rules'
deterministic leaves (ones, ``A_log``, the 0.5 token-shift mixes, the
zero ``decay_base``) byte-equal in bfloat16, at smoke and at full size;
at float32 the loss within 1e-5 relative and every gradient leaf within
1e-4 x its max |g|; prefill and three decode steps within 1e-5 of max
|logit|. Inside the port, decode == prefill (prefill of S-1 tokens plus
one ``decode_step`` against prefill of S tokens) within 1e-4 of max
|logit| at float32 and 5e-2 at bfloat16. The dense and MoE families'
``prefill``/``decode_step`` match the reference's too. The engine
refuses every family it cannot serve with the reference's ``ValueError``,
and the train CLI trains RWKV6 and Zamba2 at ``--smoke``."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.models import model as jmodel
from repro.models import transformer as jtransformer
from repro.serving.engine import AdaptiveServingEngine as JEngine
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.launch import train as tcli
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttransformer
from repro_torch.serving.api import build_engine
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.train_loop import value_and_grad

ARCHS = ("rwkv6-3b", "zamba2-7b", "seamless-m4t-medium", "paligemma-3b")
DETERMINISTIC = ("scale", "norm", "ln_x", "D", "A_log", "mix", "ffn_mix",
                 "decay_base")
B, SEQ, STEPS = 2, 24, 3


def bits(a) -> np.ndarray:
    """The raw bytes of a jax array or torch tensor, as uint8."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy().reshape(-1)
    return np.asarray(a).view(np.uint8).reshape(-1)


def make_batch(cfg, rng) -> dict:
    """numpy batch of SEQ positions: text tokens and labels, plus ``src``
    frames (enc-dec) or ``frontend`` patches (vision VLM)."""
    s_text = SEQ - (cfg.frontend_len if cfg.frontend == "vision" else 0)
    batch = {k: rng.integers(0, cfg.vocab_size, (B, s_text))
             for k in ("tokens", "labels")}
    if cfg.frontend == "vision":
        batch["frontend"] = rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["src"] = rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return batch


def jbatch(batch, dtype):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else dtype)
            for k, v in batch.items()}


def tbatch(batch, dtype):
    return {k: torch.from_numpy(v).to(torch.long if v.dtype.kind == "i"
                                      else dtype)
            for k, v in batch.items()}


def last_pos(cfg, batch) -> int:
    """Decode position of the token after ``batch``: the frontend's
    patches count for a VLM, the source frames do not for enc-dec."""
    n = batch["tokens"].shape[1]
    return n + (cfg.frontend_len if cfg.frontend == "vision" else 0)


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    """(arch, jax cfg, port cfg, jax model, port model, jax params, port
    params) at smoke size in float32, the port's params crossed from the
    reference's."""
    arch = request.param
    jcfg = jreduce(jget_config(arch)).replace(dtype="float32")
    tcfg = reduce_for_smoke(get_config(arch)).replace(dtype="float32")
    jm = jmodel.build_model(jcfg)
    jp = jm.init(jax.random.key(0))
    tp = tmodel.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  "cpu")
    return arch, jcfg, tcfg, jm, tmodel.build_model(tcfg), jp, tp


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equal(arch):
    t, j = get_config(arch), jget_config(arch)
    assert str(t) == str(j)
    assert t.param_shapes() == j.param_shapes()
    assert t.param_count() == j.param_count()
    assert str(reduce_for_smoke(t)) == str(jreduce(j))
    assert reduce_for_smoke(t).param_shapes() == jreduce(j).param_shapes()


@pytest.mark.parametrize("arch", ARCHS)
def test_init_rules_match(arch):
    """The deterministic leaves byte-equal at smoke size (whole init) and
    at full size (leaf by leaf); the drawn ``dt_bias`` is the inverse
    softplus of a dt in [1e-3, 0.1] and ``bonus`` has std ~0.1 in both."""
    jcfg, tcfg = jreduce(jget_config(arch)), reduce_for_smoke(
        get_config(arch))
    jp = dict(tree_leaves(jmodel.init_params(jcfg, jax.random.key(1))))
    tp = dict(tree_leaves(tmodel.init_params(tcfg, 1, device="cpu")))
    assert set(jp) == set(tp)
    for path, t in tp.items():
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == \
            jp[path].shape
        if path[-1] in DETERMINISTIC:
            np.testing.assert_array_equal(bits(t), bits(jp[path]))
    gen = torch.Generator().manual_seed(0)
    for name, shape in get_config(arch).param_shapes():
        last = name.rsplit("/", 1)[-1]
        if last in DETERMINISTIC:
            want = jmodel._init_one(jax.random.key(0), name, shape,
                                    jnp.bfloat16)
            got = tmodel._init_one(gen, name, shape, torch.bfloat16, "cpu")
            np.testing.assert_array_equal(bits(got), bits(want))
        elif last in ("dt_bias", "bonus"):
            want = np.asarray(jmodel._init_one(
                jax.random.key(0), name, shape, jnp.float32))
            got = tmodel._init_one(gen, name, shape, torch.float32,
                                   "cpu").numpy()
            for v in (want, got):
                if last == "dt_bias":
                    dt = np.logaddexp(v.astype(np.float64), 0.0)
                    assert dt.min() >= 1e-3 * (1 - 1e-5)
                    assert dt.max() <= 0.1 * (1 + 1e-5)
                else:
                    assert 0.05 < v.std() < 0.2


def test_loss_and_grads_match(fam):
    arch, jcfg, tcfg, jm, tm, jp, tp = fam
    batch = make_batch(tcfg, np.random.default_rng(0))
    jb = jbatch(batch, jnp.float32)
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, jb)
    tl, _, tg = value_and_grad(tm.loss_fn, tp, tbatch(batch, torch.float32))
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    jflat = dict(tree_leaves(jax.tree_util.tree_map(np.asarray, jg)))
    tflat = dict(tree_leaves(tg))
    assert set(jflat) == set(tflat)
    for path, want in jflat.items():
        got = tflat[path].numpy()
        scale = float(np.abs(want).max())
        assert scale > 0, path
        assert float(np.abs(got - want).max()) <= 1e-4 * scale, path


def _prefill_decode_pair(jcfg, tcfg, jm, tm, jp, tp):
    """The reference's prefill and greedy decode steps, then the port's
    on the reference's tokens: (port, reference) logits (1 + STEPS, B,
    V) as numpy f32."""
    batch = make_batch(tcfg, np.random.default_rng(1))
    pos = last_pos(tcfg, batch)
    jprefill, jdecode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    logits, jcache = jprefill(jp, jbatch(batch, jnp.float32),
                              jm.init_cache(B, SEQ + STEPS + 1))
    want, feed = [np.asarray(logits)], []
    for i in range(STEPS):
        tok = jnp.argmax(logits[:, :jcfg.vocab_size], -1)[:, None]
        feed.append(np.asarray(tok))
        logits, jcache = jdecode(jp, jcache, tok.astype(jnp.int32),
                                 jnp.full((B,), pos + i, jnp.int32))
        want.append(np.asarray(logits))
    logits, cache = tm.prefill(tp, tbatch(batch, torch.float32),
                               tm.init_cache(B, SEQ + STEPS + 1,
                                             device="cpu"))
    got = [logits.numpy()]
    for i, tok in enumerate(feed):
        logits, cache = tm.decode_step(tp, cache, torch.tensor(tok),
                                       torch.full((B,), pos + i))
        got.append(logits.numpy())
    return np.stack(got), np.stack(want)


def test_prefill_and_decode_match(fam):
    _, jcfg, tcfg, jm, tm, jp, tp = fam
    got, want = _prefill_decode_pair(jcfg, tcfg, jm, tm, jp, tp)
    assert got.shape == want.shape == (1 + STEPS, B, tcfg.padded_vocab)
    assert np.isfinite(got).all()
    for i in range(1 + STEPS):
        assert np.abs(got[i] - want[i]).max() <= \
            1e-5 * np.abs(want[i]).max(), i


@pytest.mark.parametrize("arch", ("mixtral-8x7b", "qwen3-8b"))
def test_dense_and_moe_prefill_and_decode_match(arch):
    """``prefill``/``decode_step`` of the MoE and dense decoders (smoke
    Mixtral and Qwen3 at float32) against the reference's."""
    jcfg = jreduce(jget_config(arch)).replace(dtype="float32")
    tcfg = reduce_for_smoke(get_config(arch)).replace(dtype="float32")
    jm = jmodel.build_model(jcfg)
    jp = jm.init(jax.random.key(0))
    tp = tmodel.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  "cpu")
    got, want = _prefill_decode_pair(jcfg, tcfg, jm,
                                     tmodel.build_model(tcfg), jp, tp)
    for i in range(1 + STEPS):
        assert np.abs(got[i] - want[i]).max() <= \
            1e-5 * np.abs(want[i]).max(), i


@pytest.mark.parametrize("dtype,bar", (("float32", 1e-4),
                                       ("bfloat16", 5e-2)))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_prefill(arch, dtype, bar):
    """Inside the port: prefill of S-1 tokens plus one decode step against
    prefill of S tokens, at a length that pads the SSM chunks."""
    cfg = reduce_for_smoke(get_config(arch)).replace(dtype=dtype)
    m = tmodel.build_model(cfg)
    p = m.init(0, device="cpu")
    td = getattr(torch, dtype)
    batch = tbatch(make_batch(cfg, np.random.default_rng(2)), td)
    full, _ = m.prefill(p, batch, m.init_cache(B, SEQ, device="cpu"))
    short = dict(batch, tokens=batch["tokens"][:, :-1])
    _, cache = m.prefill(p, short, m.init_cache(B, SEQ, device="cpu"))
    step, _ = m.decode_step(p, cache, batch["tokens"][:, -1:],
                            torch.full((B,), SEQ - 1))
    again, _ = m.prefill(p, batch, m.init_cache(B, SEQ, device="cpu"))
    assert torch.equal(full, again)
    gap = float((step - full).abs().max() / full.abs().max())
    assert gap <= bar, gap


@pytest.mark.parametrize("n", (2, 5, 7, 12, 81))
def test_hybrid_layout_matches(n):
    jcfg = jget_config("zamba2-7b").replace(num_layers=n)
    tcfg = get_config("zamba2-7b").replace(num_layers=n)
    layout = ttransformer._hybrid_layout(tcfg)
    assert layout == jtransformer._hybrid_layout(jcfg)
    full, g, rem = layout
    assert full * g + rem == n and 1 <= rem <= g
    cache = tmodel.init_cache(tcfg.replace(d_model=64), 1, 4, device="cpu")
    assert cache["attn"]["k"].shape[0] == full + 1


def _no_slot_path_configs():
    """The four families, and an MoE VLM behind a vision frontend (MoE, so
    the engine's MoE check passes and the slot-path check decides)."""
    for arch in ARCHS:
        yield arch, jget_config(arch), get_config(arch), "MoE models"
    mop = dict(family="vlm", frontend="vision", frontend_len=8)
    yield ("mixtral-vlm", jreduce(jget_config("mixtral-8x7b")).replace(**mop),
           reduce_for_smoke(get_config("mixtral-8x7b")).replace(**mop),
           "has no slot-cache decode path")


@pytest.mark.parametrize("arch,jcfg,tcfg,msg", list(_no_slot_path_configs()),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_engine_refuses_families_without_slot_path(arch, jcfg, tcfg, msg):
    assert tmodel.build_model(tcfg).prefill_into_slot is None
    assert jmodel.build_model(jcfg).prefill_into_slot is None
    with pytest.raises(ValueError, match=msg):
        JEngine(jcfg, {})
    with pytest.raises(ValueError, match=msg):
        build_engine(tcfg, {}, device="cpu")


@pytest.mark.parametrize("arch", ("rwkv6-3b", "zamba2-7b"))
def test_train_cli(arch, capsys):
    tcli.main(["--device", "cpu", "--arch", arch, "--steps", "3",
               "--batch", "2", "--seq", "16", "--log-every", "1"])
    nll = [float(v) for v in re.findall(r"step\s+\d+ nll=([0-9.]+)",
                                        capsys.readouterr().out)]
    assert len(nll) == 3 and all(np.isfinite(nll))


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_attention_rows_do_not_depend_on_later_keys(dtype):
    """A query's attention output does not change when masked keys are
    appended (prefill of S-1 against S tokens): the product of the
    rounded probabilities with V accumulates in f32 and rounds once, as
    the reference's dot does. A bf16 matmul's accumulation order in
    PyTorch depends on the key count, and over Zamba2's 81 layers those
    flips grew the decode vs prefill gap past 5e-2 of max |logit|."""
    from repro_torch.models import layers as TL
    td = getattr(torch, dtype)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 300, 4, 64), generator=g).to(td)
               for _ in range(3))
    pos = torch.arange(300)[None].expand(2, 300)
    mask = pos[:, None, :, None] >= pos[:, None, None, :]
    full = TL._sdpa(q, k, v, mask)
    short = TL._sdpa(q[:, :299], k[:, :299], v[:, :299],
                     mask[:, :, :299, :299])
    assert torch.equal(full[:, :299], short)
