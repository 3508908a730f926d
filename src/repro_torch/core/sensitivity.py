"""Per-expert quantization sensitivity + traffic-weighted quality
objective (``repro.core.sensitivity``, DESIGN.md §15).

The flat ``RUNG_QUALITY_COST`` table prices every expert's quality loss
identically. The *measured* quality loss of a plan is

    quality_cost(plan) = sum_{l,e} freq[l,e] * sens[l,e, bits[l,e]]

with ``freq`` the (normalized) routing frequency and ``sens`` the
activation-weighted relative RMSE each rung inflicts on that expert's FFN
output. This module provides

* :func:`calibrate_sensitivity` — the offline calibration pass: run a
  small seeded token batch through the model's no-cache forward
  (``Model.loss_fn``), capture every MoE layer's router inputs
  (``mixed_moe.capture_moe_inputs``), then score them with
  :func:`score_sensitivity`;
* :func:`score_sensitivity` — the scoring loop on captured ``(x, probs)``
  pairs: each expert's FFN in float64 numpy at bf16 and at every
  quantized rung (quantize -> dequantize with the port's
  ``core/quantization.py``, whose codes and scales are byte-equal to the
  reference's). On the same captures and weights it gives the
  reference's profile byte for byte;
* :class:`SensitivityProfile` — the serializable artifact. A *uniform*
  profile makes ``quality_cost`` collapse to the legacy rung-fraction
  sum, and ``cost_model.quality_proxy`` short-circuits to the historical
  code path in that case.

Serialization uses ``float.hex()`` (lossless, locale-independent) with
sorted keys and a fixed layout, so equal profiles are equal *bytes*, and a
profile file written by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cost_model import RUNG_QUALITY_COST
from repro_torch.core.precision_plan import PrecisionPlan, quantized_rungs
from repro_torch.core.quantization import dequantize, quantize

__all__ = ["SensitivityProfile", "calibrate_sensitivity",
           "score_sensitivity"]

#: floor for the reference-output energy in the relative-RMSE denominator
_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class SensitivityProfile:
    """Per-(layer, expert) quality prices + routing frequencies.

    ``sens`` maps each QUANTIZED ladder rung to a ``[L, E]`` float64
    array (16-bit costs 0 by definition and is not stored); ``freq`` is
    a ``[L, E]`` float64 array normalized to sum to 1.
    """
    ladder: Tuple[int, ...]
    sens: Dict[int, np.ndarray]
    freq: np.ndarray

    # -- constructors ------------------------------------------------------
    @classmethod
    def uniform(cls, cfg: ModelConfig,
                ladder: Optional[Tuple[int, ...]] = None
                ) -> "SensitivityProfile":
        """The profile equivalent to the legacy flat table: every expert
        priced at ``RUNG_QUALITY_COST[b]``, uniform traffic."""
        assert cfg.moe is not None
        ladder = tuple(ladder if ladder is not None
                       else cfg.mop.precision_ladder)
        shape = (cfg.num_layers, cfg.moe.num_experts)
        sens = {int(b): np.full(shape, RUNG_QUALITY_COST[int(b)], np.float64)
                for b in quantized_rungs(ladder)}
        freq = np.full(shape, 1.0 / (shape[0] * shape[1]), np.float64)
        return cls(ladder=ladder, sens=sens, freq=freq)

    # -- queries -----------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.freq.shape)  # type: ignore[return-value]

    def is_uniform(self) -> bool:
        """True iff this profile is *exactly* the legacy flat objective:
        every quantized rung priced at the constant ``RUNG_QUALITY_COST``
        and traffic exactly uniform."""
        n = self.freq.size
        if not bool((self.freq == 1.0 / n).all()):
            return False
        for b, s in self.sens.items():
            if b not in RUNG_QUALITY_COST:
                return False
            if not bool((s == RUNG_QUALITY_COST[b]).all()):
                return False
        return True

    def quality_cost(self, plan: PrecisionPlan) -> float:
        """Traffic-weighted quality loss of ``plan``:
        ``sum_{l,e} freq[l,e] * sens[l,e, bits[l,e]]`` (16-bit rungs are
        free)."""
        total = 0.0
        for b in quantized_rungs(plan.ladder):
            s = self.sens.get(int(b))
            if s is None:
                # rung outside the calibrated ladder: legacy flat price
                total += RUNG_QUALITY_COST[int(b)] \
                    * float((plan.bits == b).mean())
                continue
            total += float((self.freq * s * (plan.bits == b)).sum())
        return total

    def with_freq(self, freq: np.ndarray) -> "SensitivityProfile":
        """Same sensitivities, new traffic weights (normalized to sum 1;
        an all-zero histogram keeps the current weights)."""
        freq = np.asarray(freq, np.float64)
        if freq.shape != self.freq.shape:
            raise ValueError(f"freq shape {freq.shape} != {self.freq.shape}")
        tot = float(freq.sum())
        if tot <= 0.0:
            return self
        return dataclasses.replace(self, freq=freq / tot)

    # -- serialization (byte-deterministic) --------------------------------
    def to_json_bytes(self) -> bytes:
        obj = {
            "ladder": [int(b) for b in self.ladder],
            "shape": [int(d) for d in self.freq.shape],
            "freq": [v.hex() for v in self.freq.ravel().tolist()],
            "sens": {str(int(b)): [v.hex() for v in s.ravel().tolist()]
                     for b, s in sorted(self.sens.items())},
        }
        return (json.dumps(obj, sort_keys=True, indent=1) + "\n").encode()

    def save(self, path) -> None:
        Path(path).write_bytes(self.to_json_bytes())

    @classmethod
    def load(cls, path) -> "SensitivityProfile":
        obj = json.loads(Path(path).read_text())
        shape = tuple(obj["shape"])
        parse = np.vectorize(float.fromhex, otypes=[np.float64])

        def arr(vals):
            return parse(np.asarray(vals, dtype=object)).reshape(shape)

        return cls(ladder=tuple(obj["ladder"]),
                   sens={int(b): arr(v) for b, v in obj["sens"].items()},
                   freq=arr(obj["freq"]))


# ---------------------------------------------------------------------------
# Offline calibration
# ---------------------------------------------------------------------------

def _silu(x: np.ndarray) -> np.ndarray:
    return x * (1.0 / (1.0 + np.exp(-x)))


def _ffn(x: np.ndarray, w: Dict[str, np.ndarray]) -> np.ndarray:
    """The expert swiglu FFN in float32 numpy (mirrors layers.ffn)."""
    return (_silu(x @ w["w_gate"]) * (x @ w["w_up"])) @ w["w_down"]


def _host_f64(t: torch.Tensor) -> np.ndarray:
    """``t`` (bf16 or f32, on any device) as a host float64 array; the
    widening is exact, so where it runs does not change a bit."""
    return t.to(torch.float64).cpu().numpy()


def score_sensitivity(captured: Sequence[Tuple[np.ndarray, np.ndarray]],
                      moe_params: Dict[str, torch.Tensor], *,
                      ladder: Tuple[int, ...], group_size: int,
                      anchor: bool = True) -> SensitivityProfile:
    """Score captured router inputs into a profile (the loop of
    :func:`calibrate_sensitivity`).

    ``captured``: one ``(x (T,d) f32, probs (T,E) f32)`` pair per layer;
    ``moe_params``: the train-layout expert weights ``w_gate``/``w_up``/
    ``w_down`` of shape (L, E, ., .) on any device. Per (layer, expert,
    quantized rung):

        sens = sqrt( sum_t p_t ||y16_t - yb_t||^2
                     / max(sum_t p_t ||y16_t||^2, eps) )

    with ``p_t = probs[t, e]``, ``y16`` the FFN on the bf16 weights and
    ``yb`` on the weights quantized and dequantized at rung ``b`` (on the
    weights' device; bf16 result, as the reference's oracle), both in
    float64 numpy. ``freq[l, e]`` is the summed router probability mass,
    normalized globally; ``anchor`` rescales each rung's scores to mean
    ``RUNG_QUALITY_COST[b]``."""
    ladder = tuple(ladder)
    num_layers = len(captured)
    num_experts = int(captured[0][1].shape[1]) if num_layers else 0
    q_rungs = [int(b) for b in quantized_rungs(ladder)]
    sens = {b: np.zeros((num_layers, num_experts), np.float64)
            for b in q_rungs}
    freq = np.zeros((num_layers, num_experts), np.float64)

    for li in range(num_layers):
        x, probs = captured[li]                      # (T, d), (T, E)
        x = x.astype(np.float64)
        for ei in range(num_experts):
            dev = {k: moe_params[k][li, ei].to(torch.float32)
                   for k in ("w_gate", "w_up", "w_down")}
            w16 = {k: _host_f64(v) for k, v in dev.items()}
            p = probs[:, ei].astype(np.float64)      # (T,)
            freq[li, ei] = float(p.sum())
            y16 = _ffn(x, w16)
            ref = float((p * (y16 ** 2).sum(axis=-1)).sum())
            for b in q_rungs:
                wq = {k: _host_f64(dequantize(quantize(v, b, group_size)))
                      for k, v in dev.items()}
                yb = _ffn(x, wq)
                err = float((p * ((y16 - yb) ** 2).sum(axis=-1)).sum())
                sens[b][li, ei] = float(np.sqrt(err / max(ref, _EPS)))

    tot = float(freq.sum())
    freq = freq / tot if tot > 0 else np.full_like(freq, 1.0 / freq.size)
    if anchor:
        for b in q_rungs:
            mean = float(sens[b].mean())
            if mean > 0:
                sens[b] = sens[b] * (RUNG_QUALITY_COST[b] / mean)
    return SensitivityProfile(ladder=ladder, sens=sens, freq=freq)


def calibrate_sensitivity(cfg: ModelConfig, params, *, seed: int = 0,
                          batch_size: int = 2, seq_len: int = 32,
                          ladder: Optional[Tuple[int, ...]] = None,
                          group_size: Optional[int] = None,
                          anchor: bool = True) -> SensitivityProfile:
    """Offline calibration pass (DESIGN.md §15).

    Draws a seeded ``(batch_size, seq_len)`` token batch (numpy, the
    reference's draws), runs it through ``Model.loss_fn`` on the params'
    device with ``capture_moe_inputs`` on, and scores the captured
    ``(x, probs)`` pairs with :func:`score_sensitivity`. Deterministic
    per seed: same (cfg, params, seed, sizes) => byte-identical profile.
    """
    from repro_torch.core import mixed_moe
    from repro_torch.models.model import build_model

    assert cfg.moe is not None, "sensitivity calibration needs a MoE arch"
    ladder = tuple(ladder if ladder is not None
                   else cfg.mop.precision_ladder)
    gs = int(group_size if group_size is not None else cfg.mop.group_size)
    num_layers = cfg.num_layers

    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab_size,
                          size=(batch_size, seq_len), dtype=np.int32)
    labels = rng.integers(1, cfg.vocab_size,
                          size=(batch_size, seq_len), dtype=np.int32)
    dev = params["embed"]["table"].device
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int64)).to(dev),
             "labels": torch.from_numpy(labels.astype(np.int64)).to(dev)}

    model = build_model(cfg)
    with mixed_moe.capture_moe_inputs() as captured, torch.no_grad():
        model.loss_fn(params, batch)
    if len(captured) != num_layers:
        raise RuntimeError(
            f"captured {len(captured)} MoE layers, expected {num_layers} "
            f"— calibration assumes every layer is MoE")
    return score_sensitivity(list(captured), params["layers"]["moe"],
                             ladder=ladder, group_size=gs, anchor=anchor)
