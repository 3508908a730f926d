"""The port's sensitivity calibration (``repro_torch.core.sensitivity``)
against the reference's (``repro.core.sensitivity``), on the smoke model
with the reference's params converted by ``params_from_numpy``:

* the scoring loop on the reference's own captured ``(x, probs)`` gives
  the reference's profile BYTE for byte (float64 numpy ``_ffn`` on both
  sides, quantize -> dequantize with byte-equal codes and scales);
* a profile file saved by either package reloads in the other to
  identical bytes;
* the whole ``calibrate_sensitivity`` (the port's own forward and
  captures) agrees with the reference's within rtol 1e-2 on ``sens`` and
  atol 1e-3 on ``freq`` (bf16 activations computed by two frameworks),
  and the port run twice is byte-identical;
* the no-cache ``loss_fn`` forward and the captured router inputs agree
  with the reference's within the bf16 tolerances stated per test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core import mixed_moe as jmixed_moe
from repro.core.precision_plan import balanced_ladder_plan as jbalanced
from repro.core.sensitivity import SensitivityProfile as JProfile
from repro.core.sensitivity import calibrate_sensitivity as jcalibrate
from repro.models.model import build_model as jbuild_model
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import cost_model, mixed_moe
from repro_torch.core.precision_plan import balanced_ladder_plan
from repro_torch.core.sensitivity import (SensitivityProfile,
                                          calibrate_sensitivity,
                                          score_sensitivity)
from repro_torch.models.model import build_model, params_from_numpy

LADDERS = [(16, 4), (16, 8, 4)]


@pytest.fixture(scope="module")
def smoke():
    jcfg = jreduce(jget_config("mixtral-8x7b"))
    tcfg = reduce_for_smoke(get_config("mixtral-8x7b"))
    jparams = jbuild_model(jcfg).init(jax.random.key(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    return jcfg, tcfg, jparams, tparams


def batch_np(cfg, seed=0, b=2, s=32):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab_size, size=(b, s), dtype=np.int32)
    labels = rng.integers(1, cfg.vocab_size, size=(b, s), dtype=np.int32)
    return tokens, labels


@pytest.fixture(scope="module")
def ref_run(smoke):
    """The reference's captures and loss on the calibration batch, and
    its profile per ladder."""
    jcfg, _, jparams, _ = smoke
    tokens, labels = batch_np(jcfg)
    model = jbuild_model(dataclasses.replace(jcfg, scan_layers=False))
    with jmixed_moe.capture_moe_inputs() as captured:
        loss, metrics = model.loss_fn(
            jparams, {"tokens": jnp.asarray(tokens),
                      "labels": jnp.asarray(labels)})
    profiles = {ld: jcalibrate(jcfg, jparams, seed=0, ladder=ld)
                for ld in LADDERS}
    return {"captured": list(captured), "profiles": profiles,
            "metrics": {k: float(v) for k, v in metrics.items()}}


@pytest.fixture(scope="module")
def port_profiles(smoke):
    _, tcfg, _, tparams = smoke
    return {ld: calibrate_sensitivity(tcfg, tparams, seed=0, ladder=ld)
            for ld in LADDERS}


@pytest.mark.parametrize("ladder", LADDERS, ids=str)
def test_profile_bytes_from_reference_captures(smoke, ref_run, ladder):
    """Tolerance: none — byte-equal ``to_json_bytes()``."""
    jcfg, _, _, tparams = smoke
    got = score_sensitivity(ref_run["captured"], tparams["layers"]["moe"],
                            ladder=ladder, group_size=jcfg.mop.group_size)
    assert got.to_json_bytes() == ref_run["profiles"][ladder].to_json_bytes()
    raw = score_sensitivity(ref_run["captured"], tparams["layers"]["moe"],
                            ladder=ladder, group_size=jcfg.mop.group_size,
                            anchor=False)
    for b in raw.sens:        # anchoring only rescales each rung
        np.testing.assert_allclose(
            raw.sens[b] / raw.sens[b].mean(),
            got.sens[b] / got.sens[b].mean(), rtol=1e-12)


@pytest.mark.parametrize("ladder", LADDERS, ids=str)
def test_profile_files_load_across_packages(ref_run, port_profiles, ladder,
                                            tmp_path):
    """Tolerance: none — a file saved by one package reloads in the other
    to identical bytes."""
    ref, port = ref_run["profiles"][ladder], port_profiles[ladder]
    ref.save(tmp_path / "ref.json")
    port.save(tmp_path / "port.json")
    assert SensitivityProfile.load(tmp_path / "ref.json").to_json_bytes() \
        == (tmp_path / "ref.json").read_bytes()
    assert JProfile.load(tmp_path / "port.json").to_json_bytes() \
        == (tmp_path / "port.json").read_bytes()
    back = SensitivityProfile.load(tmp_path / "ref.json")
    assert back.ladder == ref.ladder
    np.testing.assert_array_equal(back.freq, ref.freq)


@pytest.mark.parametrize("ladder", LADDERS, ids=str)
def test_calibration_agrees_with_reference(ref_run, port_profiles, ladder):
    """Tolerance: ``sens`` rtol 1e-2, ``freq`` atol 1e-3 (the port's own
    bf16 forward feeds the float64 scoring)."""
    ref, port = ref_run["profiles"][ladder], port_profiles[ladder]
    assert port.ladder == ref.ladder and port.shape == ref.shape
    assert sorted(port.sens) == sorted(ref.sens)
    for b in ref.sens:
        np.testing.assert_allclose(port.sens[b], ref.sens[b], rtol=1e-2)
    np.testing.assert_allclose(port.freq, ref.freq, atol=1e-3)
    assert port.freq.sum() == pytest.approx(1.0, abs=1e-12)


def test_calibration_is_byte_deterministic(smoke, port_profiles):
    _, tcfg, _, tparams = smoke
    again = calibrate_sensitivity(tcfg, tparams, seed=0, ladder=(16, 8, 4))
    assert again.to_json_bytes() \
        == port_profiles[(16, 8, 4)].to_json_bytes()
    other = calibrate_sensitivity(tcfg, tparams, seed=1, ladder=(16, 8, 4))
    assert other.to_json_bytes() != again.to_json_bytes()


def test_sens_decreases_with_bits(port_profiles):
    prof = port_profiles[(16, 8, 4)]
    assert (prof.sens[8] < prof.sens[4]).all()


def test_loss_fn_and_captures_match_reference(smoke, ref_run):
    """Tolerance: loss terms rtol 1e-3; captured router inputs atol 5e-2
    (bf16 activations of layer 1 after one bf16 layer) and router
    probabilities atol 1e-2."""
    _, tcfg, _, tparams = smoke
    tokens, labels = batch_np(tcfg)
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int64)),
             "labels": torch.from_numpy(labels.astype(np.int64))}
    with mixed_moe.capture_moe_inputs() as captured:
        loss, metrics = build_model(tcfg).loss_fn(tparams, batch)
    assert float(loss) == pytest.approx(ref_run["metrics"]["loss"],
                                        rel=1e-3)
    for k, v in ref_run["metrics"].items():
        assert float(metrics[k]) == pytest.approx(v, rel=1e-3), k
    assert len(captured) == len(ref_run["captured"]) == tcfg.num_layers
    for (x, p), (jx, jp) in zip(captured, ref_run["captured"]):
        assert x.dtype == np.float32 and p.dtype == np.float32
        assert x.shape == jx.shape and p.shape == jp.shape
        np.testing.assert_allclose(x, jx, atol=5e-2)
        np.testing.assert_allclose(p, jp, atol=1e-2)
    # capture is off outside the block
    build_model(tcfg).loss_fn(tparams, batch)
    assert len(captured) == tcfg.num_layers


def test_uniform_profile_and_quality_cost_match_reference(smoke,
                                                          port_profiles):
    """Tolerance: none — the uniform profile's bytes, the flat-table
    identity, and ``quality_cost`` / ``with_freq`` on a calibrated
    profile equal the reference's for the same plans."""
    jcfg, tcfg, _, _ = smoke
    for ld in LADDERS:
        assert SensitivityProfile.uniform(tcfg, ld).to_json_bytes() \
            == JProfile.uniform(jcfg, ld).to_json_bytes()
        assert SensitivityProfile.uniform(tcfg, ld).is_uniform()
    prof = port_profiles[(16, 8, 4)]
    jprof = JProfile(ladder=prof.ladder, sens=dict(prof.sens),
                     freq=prof.freq)
    assert not prof.is_uniform()
    rng = np.random.default_rng(5)
    freq = rng.random(prof.shape)
    for seed in range(3):
        kw = dict(ladder=(16, 8, 4), group_size=tcfg.mop.group_size,
                  seed=seed)
        plan = balanced_ladder_plan(tcfg.num_layers, tcfg.moe.num_experts,
                                    {4: 6, 8: 4}, **kw)
        jplan = jbalanced(jcfg.num_layers, jcfg.moe.num_experts,
                          {4: 6, 8: 4}, **kw)
        assert prof.quality_cost(plan) == jprof.quality_cost(jplan)
        assert prof.with_freq(freq).quality_cost(plan) \
            == jprof.with_freq(freq).quality_cost(jplan)
        assert cost_model.quality_proxy(tcfg, plan, prof) \
            == 1.0 + prof.quality_cost(plan)
    uni = SensitivityProfile.uniform(tcfg, (16, 8, 4))
    assert cost_model.quality_proxy(tcfg, plan, uni) \
        == cost_model.quality_proxy(tcfg, plan)
    assert prof.with_freq(np.zeros(prof.shape)) is prof
    with pytest.raises(ValueError, match="freq shape"):
        prof.with_freq(np.ones((1, 1)))
