"""The port's training against the reference's on the same numpy inputs.

Bars:
* ``loss_fn`` of the smoke Mixtral and SmolLM at f32: value within 1e-5
  relative, each gradient leaf within 1e-4 x max|g_ref| of
  ``jax.value_and_grad`` (also with ``cfg.remat`` "full" and "dots",
  which give the port's no-remat gradients bit for bit);
* AdamW and Adafactor on identical params and grads: step and lr equal;
  with the clip inactive, AdamW's moments within 1e-6 relative and its
  params within one ulp of their dtype. Two sums round differently
  across the frameworks, so where they enter the bars are stated against
  the size of what they feed: the global norm (a sum over every leaf in
  another order) sets the clip scale, so with the clip active moments
  are held within 1e-6 of their leaf's largest; Adafactor's ``rsqrt``
  and factor means differ by up to 2 ulps between XLA and PyTorch (both
  within 1 ulp of the true value), so its params are held within one
  ulp plus 1e-6 of the step's own size |p_new - p_old|;
* microbatched == full batch within the reference's own bar
  (``tests/test_training.py``);
* a 10-step f32 trajectory through ``make_train_step``: nll within 1e-3
  relative at every step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.data import pipeline as jpipe
from repro.models import model as jmodel
from repro.training import adafactor as JA
from repro.training import optimizer as JO
from repro.training import train_loop as JT
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import model as tmodel
from repro_torch.training import adafactor as TA
from repro_torch.training import optimizer as TO
from repro_torch.training import train_loop as TT


def smoke_pair(arch, **over):
    jcfg = jreduce(jget_config(arch)).replace(dtype="float32", **over)
    tcfg = reduce_for_smoke(get_config(arch)).replace(dtype="float32",
                                                      **over)
    return jcfg, tcfg


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def flat_np(tree):
    """{"a/b": numpy} of a JAX or a port tree (bf16 as uint16 bits)."""
    out = {}
    for path, x in TO.tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            x = x.contiguous()
            x = x.view(torch.uint16) if x.dtype == torch.bfloat16 else x
            out["/".join(path)] = x.numpy()
        else:
            x = np.asarray(x)
            out["/".join(path)] = x.view(np.uint16) \
                if x.dtype.name == "bfloat16" else x
    return out


def batch_np(seed, b=4, s=16, vocab=512):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(-1, vocab, (b, s)).astype(np.int32)}


def tbatch(b):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()}


def test_smollm_config_equals_the_reference():
    arch = "smollm-360m"
    assert str(get_config(arch)) == str(jget_config(arch))
    assert str(reduce_for_smoke(get_config(arch))) \
        == str(jreduce(jget_config(arch)))


@pytest.fixture(scope="module", params=["mixtral-8x7b", "smollm-360m"])
def model_pair(request):
    jcfg, tcfg = smoke_pair(request.param)
    jm = jmodel.build_model(jcfg)
    jp = jm.init(jax.random.key(0))
    tp = tmodel.params_from_numpy(to_np(jp), "cpu")
    batch = batch_np(0)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(arch=request.param, tcfg=tcfg, tparams=tp, batch=batch,
                loss=float(jl), metrics={k: float(v) for k, v in
                                         jmet.items()},
                grads=flat_np(jg))


def assert_grads_close(grads, ref):
    got = flat_np(grads)
    assert sorted(got) == sorted(ref)
    for k, g in ref.items():
        assert got[k].dtype == g.dtype == np.float32, k
        bar = 1e-4 * max(float(np.abs(g).max()), 1e-30)
        np.testing.assert_allclose(got[k], g, rtol=0, atol=bar, err_msg=k)


def test_loss_and_grads_match_value_and_grad(model_pair):
    m = model_pair
    loss, metrics, grads = TT.value_and_grad(
        tmodel.build_model(m["tcfg"]).loss_fn, m["tparams"],
        tbatch(m["batch"]))
    assert float(loss) == pytest.approx(m["loss"], rel=1e-5)
    assert sorted(metrics) == sorted(m["metrics"])
    for k, v in m["metrics"].items():
        assert float(metrics[k]) == pytest.approx(v, rel=1e-5, abs=1e-7), k
    assert_grads_close(grads, m["grads"])


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_same_gradients(model_pair, remat):
    m = model_pair
    fn = tmodel.build_model(m["tcfg"]).loss_fn
    fn_r = tmodel.build_model(m["tcfg"].replace(remat=remat)).loss_fn
    _, _, g0 = TT.value_and_grad(fn, m["tparams"], tbatch(m["batch"]))
    _, _, g1 = TT.value_and_grad(fn_r, m["tparams"], tbatch(m["batch"]))
    a, b = flat_np(g0), flat_np(g1)
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k
    assert_grads_close(g1, m["grads"])


def test_loss_fn_without_grad_records_no_graph(model_pair):
    m = model_pair
    loss, _ = tmodel.build_model(m["tcfg"]).loss_fn(m["tparams"],
                                                    tbatch(m["batch"]))
    assert loss.grad_fn is None and not loss.requires_grad


# --------------------------------------------------------------------------
# Optimizers on identical params and grads
# --------------------------------------------------------------------------

def opt_tree(seed, dtype):
    rng = np.random.default_rng(seed)

    def r(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)
    tree = {"layers": {"attn_norm": {"scale": 1 + r(3, 8, s=0.1)},
                       "mlp": {"w_up": r(3, 8, 12, s=0.3)}},
            "embed": {"table": r(20, 8)}, "bias": r(5, s=0.01)}
    if dtype == "bfloat16":
        tree = jax.tree_util.tree_map(
            lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), tree)
    return tree


def ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in units of the last place between two arrays of
    one float dtype (bf16 given as its uint16 bits)."""
    it = {2: np.int16, 4: np.int32}[a.dtype.itemsize]
    ia = a.view(it).astype(np.int64)
    ib = b.view(it).astype(np.int64)
    return int(np.abs(ia - ib).max())


def as_f32(bits: np.ndarray, plus_ulps: int = 0) -> np.ndarray:
    """f32 values of f32 arrays or of bf16 uint16 bits, moved by
    ``plus_ulps`` units in the last place (away from zero)."""
    if bits.dtype == np.uint16:
        b = bits.astype(np.uint32) + plus_ulps
        return (b << 16).astype(np.uint32).view(np.float32)
    return (bits.view(np.uint32) + plus_ulps).view(np.float32)


OPT = [("adamw", JO.init_opt_state, JO.adamw_update, TO.init_opt_state,
        TO.adamw_update),
       ("adafactor", JA.init_adafactor_state, JA.adafactor_update,
        TA.init_adafactor_state, TA.adafactor_update)]


@pytest.mark.parametrize("clip", [1.0, 1e3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,jinit,jupd,tinit,tupd", OPT,
                         ids=[o[0] for o in OPT])
def test_optimizer_matches_reference(name, jinit, jupd, tinit, tupd, dtype,
                                     clip):
    """Six steps across the warmup/cosine boundary, new grads each step;
    each step starts the port from the reference's params and state."""
    cfg = JO.OptConfig(lr=1e-2, warmup_steps=3, total_steps=8,
                       clip_norm=clip)
    tcfg = TO.OptConfig(lr=1e-2, warmup_steps=3, total_steps=8,
                        clip_norm=clip)
    jp = jax.tree_util.tree_map(jnp.asarray, opt_tree(0, dtype))
    tp = tmodel.params_from_numpy(opt_tree(0, dtype), "cpu")
    js = jinit(jp)
    assert sorted(flat_np(tinit(tp))) == sorted(flat_np(js))
    prev, prev_p, prev_s = flat_np(jp), jp, js
    for step in range(6):
        g = opt_tree(100 + step, dtype)
        jp, js, jm = jupd(jp, jax.tree_util.tree_map(jnp.asarray, g), js,
                          cfg)
        tp = tmodel.params_from_numpy(to_np(prev_p), "cpu")
        ts = tmodel.params_from_numpy(to_np(prev_s), "cpu")
        tp, ts, tm = tupd(tp, tmodel.params_from_numpy(g, "cpu"), ts, tcfg)
        prev_p, prev_s = jp, js
        assert int(ts["step"]) == int(js["step"]) == step + 1
        assert ts["step"].dtype == torch.int32
        assert float(tm["lr"]) == float(jm["lr"]), step
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        moments = {k: v for k, v in ts.items() if k != "step"}
        jmom = {k: v for k, v in js.items() if k != "step"}
        got, want = flat_np(moments), flat_np(jmom)
        assert sorted(got) == sorted(want)
        for k in want:
            tol = dict(rtol=1e-6, atol=0) if clip > 100 else \
                dict(rtol=0, atol=1e-6 * np.abs(want[k]).max())
            np.testing.assert_allclose(got[k], want[k], **tol,
                                       err_msg=f"{k} step {step}")
        got, want = flat_np(tp), flat_np(jp)
        for k in want:
            assert got[k].dtype == want[k].dtype
            if name == "adamw" and clip > 100:
                assert ulps(got[k], want[k]) <= 1, f"{k} step {step}"
                continue
            a, b = as_f32(got[k]), as_f32(want[k])
            spacing = np.abs(as_f32(want[k], 1) - b)     # one ulp of b
            bar = spacing + 1e-6 * np.abs(b - as_f32(prev[k]))
            assert (np.abs(a - b) <= bar).all(), f"{k} step {step}"
        prev = want


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 50, 99, 100, 150])
def test_schedule_and_global_norm_equal(step):
    cfg = JO.OptConfig(lr=1.0, warmup_steps=10, total_steps=100)
    tcfg = TO.OptConfig(lr=1.0, warmup_steps=10, total_steps=100)
    want = float(JO.schedule(cfg, jnp.asarray(step, jnp.int32)))
    got = float(TO.schedule(tcfg, torch.tensor(step, dtype=torch.int32)))
    assert got == want
    g = opt_tree(step, "float32")
    assert float(TO.global_norm(tmodel.params_from_numpy(g, "cpu"))) \
        == pytest.approx(float(JO.global_norm(g)), rel=1e-6)


@pytest.mark.parametrize("path", [("layers", "attn_norm", "scale"),
                                  ("layers", "mlp", "w_up"), ("bias",),
                                  ("embed", "table"), ("ssm", "A_log"),
                                  ("ssm", "D"), ("mix",)])
def test_is_matrix_equal(path):
    jpath = tuple(jax.tree_util.DictKey(k) for k in path)
    assert TO._is_matrix(path) == JO._is_matrix(jpath)


def test_adafactor_state_shapes():
    p = tmodel.params_from_numpy({"w": np.zeros((64, 32), np.float32),
                                  "e": np.zeros((2, 5, 7), np.float32),
                                  "b": np.zeros((64,), np.float32)}, "cpu")
    st = TA.init_adafactor_state(p)
    assert st["f"]["w"]["vr"].shape == (64,)
    assert st["f"]["w"]["vc"].shape == (32,)
    assert st["f"]["e"]["vr"].shape == (2, 5)
    assert st["f"]["e"]["vc"].shape == (2, 7)
    assert st["f"]["b"]["v"].shape == (64,)


# --------------------------------------------------------------------------
# The train step
# --------------------------------------------------------------------------

def quad_loss_t(params, batch):
    loss = torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)
    return loss, {"nll": loss}


@pytest.mark.parametrize("n", [2, 4])
def test_microbatch_equivalent_to_full(n):
    """The reference's bar (tests/test_training.py)."""
    rng = np.random.default_rng(0)
    w_true = rng.standard_normal((8, 1)).astype(np.float32)
    x = rng.standard_normal((64, 8)).astype(np.float32)
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(x @ w_true)}
    cfg = TO.OptConfig(lr=0.01, warmup_steps=0, weight_decay=0.0)
    out = []
    for m in (1, n):
        tcfg = TT.TrainConfig(opt=cfg, num_microbatches=m,
                              grad_dtype=torch.float32)
        p = {"w": torch.zeros((8, 1))}
        p, _, _ = TT.make_train_step(quad_loss_t, tcfg)(
            p, TT.init_train_state(p, tcfg), batch)
        out.append(p["w"].numpy())
    np.testing.assert_allclose(out[0], out[1], rtol=1e-4, atol=1e-6)


def test_microbatch_on_real_model():
    """Reduced SmolLM: 1 vs 2 microbatches (the reference's bar)."""
    cfg = reduce_for_smoke(get_config("smollm-360m"))
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    batch = tbatch(batch_np(0, s=16, vocab=cfg.vocab_size))
    outs = []
    for n in (1, 2):
        tcfg = TT.TrainConfig(opt=TO.OptConfig(lr=1e-3, warmup_steps=0),
                              num_microbatches=n, grad_dtype=torch.float32)
        p = TO.tree_map(torch.clone, params)
        p, _, _ = TT.make_train_step(tmodel.build_model(cfg).loss_fn, tcfg)(
            p, TT.init_train_state(p, tcfg), batch)
        outs.append(p["layers"]["mlp"]["w_up"].float().numpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=0.1, atol=2e-3)


TRAJ = [("mixtral-8x7b", "adamw", 1, None),
        ("mixtral-8x7b", "adafactor", 2, None),
        ("smollm-360m", "adamw", 2, "int8")]


@pytest.mark.parametrize("arch,opt,micro,comp", TRAJ,
                         ids=["-".join(map(str, t)) for t in TRAJ])
def test_ten_step_trajectory(arch, opt, micro, comp):
    """Ten f32 steps on the data pipeline's batches from the same params:
    nll within 1e-3 relative at every step."""
    jcfg, tcfg = smoke_pair(arch)
    jm = jmodel.build_model(jcfg)
    jp = jm.init(jax.random.key(1))
    tp = tmodel.params_from_numpy(to_np(jp), "cpu")
    ocfg = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    jt = JT.TrainConfig(opt=JO.OptConfig(**ocfg), optimizer=opt,
                        num_microbatches=micro, grad_dtype=jnp.float32,
                        grad_compression=comp)
    tt = TT.TrainConfig(opt=TO.OptConfig(**ocfg), optimizer=opt,
                        num_microbatches=micro, grad_dtype=torch.float32,
                        grad_compression=comp)
    jstep = jax.jit(JT.make_train_step(jm.loss_fn, jt))
    tstep = TT.make_train_step(tmodel.build_model(tcfg).loss_fn, tt)
    js, ts = JT.init_train_state(jp, jt), TT.init_train_state(tp, tt)
    pipe = jpipe.DataPipeline(jpipe.SyntheticCorpus(
        jpipe.SyntheticCorpusConfig(vocab_size=jcfg.vocab_size)),
        batch=4, seq=16)
    for step in range(10):
        b = pipe.next_batch()
        jp, js, jmet = jstep(jp, js, {k: jnp.asarray(v)
                                      for k, v in b.items()})
        tp, ts, tmet = tstep(tp, ts, tbatch(b))
        assert float(tmet["nll"]) == pytest.approx(float(jmet["nll"]),
                                                   rel=1e-3), step
