"""The port's configs of this slice against the reference's: every field
(the dataclass repr), ``param_shapes`` (names and shapes, in order),
the parameter and byte counts, and the smoke-reduced configs are equal.
The registry names the same ids as the reference's, the SSM, hybrid,
enc-dec and VLM families included, and an unknown arch raises the
reference's ``KeyError``.

The dense configs run through ``Model.loss_fn`` (smoke size, float32,
the reference's params crossed by ``params_from_numpy``: within 1e-5
relative of the reference's loss) and through the train CLI (three
steps on the CPU, nll finite and printed per step)."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.models import model as jmodel
from repro_torch.configs import ARCH_IDS, get_config, reduce_for_smoke
from repro_torch.launch import train as tcli
from repro_torch.models import model as tmodel

NEW = ("qwen3-8b", "granite-3-2b", "minitron-4b", "kimi-k2-1t-a32b")


@pytest.mark.parametrize("arch", NEW)
def test_config_fields_and_shapes_equal(arch):
    t, j = get_config(arch), jget_config(arch)
    assert str(t) == str(j)
    assert t.param_shapes() == j.param_shapes()
    assert t.param_count() == j.param_count()
    assert str(reduce_for_smoke(t)) == str(jreduce(j))
    assert reduce_for_smoke(t).param_shapes() == jreduce(j).param_shapes()
    if t.moe is not None:
        for bits in (4, 8, 16):
            assert t.expert_param_bytes(bits) == j.expert_param_bytes(bits)
        assert t.non_expert_bytes() == j.non_expert_bytes()


def test_registry():
    assert set(NEW) <= set(ARCH_IDS)
    assert get_config("qwen3-8b").attention.qk_norm
    kimi = get_config("kimi-k2-1t-a32b")
    assert (kimi.moe.num_experts, kimi.moe.top_k, kimi.d_model,
            kimi.moe.d_ff_expert, kimi.mop.group_size,
            kimi.attention.head_dim) == (384, 8, 7168, 2048, 64, 112)
    for arch in ("rwkv6-3b", "zamba2-7b", "seamless-m4t-medium",
                 "paligemma-3b"):
        assert arch in ARCH_IDS
        assert str(get_config(arch)) == str(jget_config(arch))
    assert set(ARCH_IDS) == set(JARCH_IDS) | {"mixtral-mop"}
    for reg in (get_config, jget_config):
        with pytest.raises(KeyError, match="unknown arch"):
            reg("rwkv7-3b")


DENSE = ("qwen3-8b", "granite-3-2b", "minitron-4b")


@pytest.mark.parametrize("arch", DENSE)
def test_dense_loss_fn_matches(arch):
    jcfg = jreduce(jget_config(arch)).replace(dtype="float32")
    tcfg = reduce_for_smoke(get_config(arch)).replace(dtype="float32")
    jm = jmodel.build_model(jcfg)
    jp = jm.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, 16)),
             "labels": rng.integers(-1, jcfg.vocab_size, (2, 16))}
    jl, _ = jax.jit(jm.loss_fn)(jp, {k: jnp.asarray(v, jnp.int32)
                                    for k, v in batch.items()})
    tp = tmodel.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  "cpu")
    tl, _ = tmodel.build_model(tcfg).loss_fn(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_train_cli(arch, capsys):
    tcli.main(["--device", "cpu", "--arch", arch, "--steps", "3",
               "--batch", "2", "--seq", "16", "--log-every", "1"])
    nll = [float(v) for v in re.findall(r"step\s+\d+ nll=([0-9.]+)",
                                        capsys.readouterr().out)]
    assert len(nll) == 3 and all(np.isfinite(nll))
