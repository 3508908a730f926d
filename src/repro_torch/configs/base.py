"""Config dataclasses for every architecture family in the zoo.

Pure-python dataclasses (no flax) — a ModelConfig fully determines parameter
shapes and the serving functions built in ``repro_torch.models.model``.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class MoEConfig:
    """Routed mixture-of-experts FFN (the paper's substrate)."""
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    # Router jitter / z-loss are training-time details.
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclass(frozen=True)
class MoPConfig:
    """Mixture-of-Precisions serving plan defaults (the paper's contribution).

    ``num_q_experts`` counts 4-bit experts across the whole model (paper's
    Num_E4 knob, 0..num_layers*num_experts). Assignment is balanced-random:
    the same count per layer (see DESIGN.md §2).

    ``ladder`` declares the precision rungs a serving deployment may
    assign per expert (descending, must contain 16; DESIGN.md §11).
    ``None`` resolves to the binary ladder ``(16, bits)`` — bit-identical
    to the historical boolean plans. Set ``(16, 8, 4)`` to open the
    per-expert mixed-precision configuration space.
    """
    enabled: bool = False
    bits: int = 4                  # legacy single quantized rung (4 or 8)
    group_size: int = 64           # quantization group along the reduction dim
    num_q_experts: int = 0         # global Num_E4 (paper eq. 1 output)
    ladder: Optional[Tuple[int, ...]] = None
    # Serving-time placement knobs (host vs HBM residency).
    hbm_budget_gb: Optional[float] = None

    @property
    def precision_ladder(self) -> Tuple[int, ...]:
        """The resolved ladder: declared ``ladder`` or ``(16, bits)``."""
        return tuple(self.ladder) if self.ladder else (16, self.bits)


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba2"           # "mamba2" | "rwkv6"
    state_dim: int = 64            # N (mamba2) / head_dim (rwkv6 K==V dim)
    head_dim: int = 64             # P per SSM head
    expand: int = 2                # d_inner = expand * d_model (mamba2)
    chunk_size: int = 128          # chunked-scan block length


@dataclass(frozen=True)
class AttentionConfig:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    sliding_window: Optional[int] = None   # SWA width (Mixtral: 4096)
    rope_theta: float = 1e6
    causal: bool = True


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                    # dense|moe|ssm|hybrid|encdec|vlm|audio
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mop: MoPConfig = field(default_factory=MoPConfig)

    # Encoder-decoder (seamless): encoder depth; num_layers == decoder depth.
    num_encoder_layers: int = 0
    # Hybrid (zamba2): one shared attention block applied every k layers.
    attn_every: int = 0
    # Modality frontend stub: "none"|"audio"|"vision"; frontend emits
    # precomputed embeddings of length frontend_len (per spec).
    frontend: str = "none"
    frontend_len: int = 0

    act: str = "swiglu"            # swiglu|gelu|relu_sq
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # Pad the embedding/logits vocab so it shards evenly on the model axis
    # and tiles the MXU; logits beyond vocab_size are masked in the loss.
    vocab_pad_multiple: int = 2048
    scan_layers: bool = True       # scan over stacked layer params (O(1) HLO)
    remat: str = "none"            # none|full|dots — activation checkpointing

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_multiple)

    @property
    def attn_dim(self) -> int:
        a = self.attention
        return a.num_heads * a.head_dim if a else 0

    # ----- parameter counting (used by planner + roofline) -----
    def param_count(self) -> int:
        return sum(math.prod(s) for _, s in self.param_shapes())

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        total = self.param_count()
        if self.moe is None:
            return total
        e = self.moe
        per_expert = 3 * self.d_model * e.d_ff_expert
        experts_total = self.num_layers * e.num_experts * per_expert
        experts_active = self.num_layers * e.top_k * per_expert
        return total - experts_total + experts_active

    def expert_param_bytes(self, bits: int = 16) -> int:
        """Size of ONE expert in bytes at the given precision (paper
        Size_E*)."""
        if self.moe is None:
            return 0
        n = 3 * self.d_model * self.moe.d_ff_expert
        if bits == 16:
            return n * 2
        # packed weights + bf16 group scales
        g = self.mop.group_size
        return n * bits // 8 + (n // g) * 2

    def non_expert_bytes(self) -> int:
        if self.moe is None:
            return self.param_count() * 2
        per_expert = 3 * self.d_model * self.moe.d_ff_expert
        return (self.param_count()
                - self.num_layers * self.moe.num_experts * per_expert) * 2

    def param_shapes(self):
        """(name, shape) for every parameter — single source of truth used by
        init, sharding rules, and the analytic roofline."""
        out = []
        d, v = self.d_model, self.padded_vocab
        out.append(("embed/table", (v, d)))
        out.append(("final_norm/scale", (d,)))
        if not self.tie_embeddings:
            out.append(("lm_head/table", (v, d)))
        if self.num_encoder_layers:
            for nm, sh in self._block_shapes(kind="encoder"):
                out.append((f"encoder/{nm}", (self.num_encoder_layers,) + sh))
            out.append(("encoder_norm/scale", (d,)))
        kind = {"ssm": self.ssm.kind if self.ssm else "mamba2"}.get(
            self.family, "decoder")
        if self.family == "ssm":
            kind = self.ssm.kind
        elif self.family == "hybrid":
            kind = "mamba2"
        for nm, sh in self._block_shapes(kind=kind):
            out.append((f"layers/{nm}", (self.num_layers,) + sh))
        if self.family == "hybrid" and self.attn_every:
            for nm, sh in self._block_shapes(kind="shared_attn"):
                out.append((f"shared/{nm}", sh))
        return out

    def _attn_shapes(self, cross: bool = False):
        a = self.attention
        d, hd = self.d_model, a.head_dim
        pre = "cross_" if cross else ""
        sh = [
            (f"{pre}attn/wq", (d, a.num_heads * hd)),
            (f"{pre}attn/wk", (d, a.num_kv_heads * hd)),
            (f"{pre}attn/wv", (d, a.num_kv_heads * hd)),
            (f"{pre}attn/wo", (a.num_heads * hd, d)),
            (f"{pre}attn_norm/scale", (d,)),
        ]
        if a.qk_norm:
            sh += [(f"{pre}attn/q_norm", (hd,)), (f"{pre}attn/k_norm", (hd,))]
        return sh

    def _ffn_shapes(self):
        d = self.d_model
        if self.moe is not None:
            e = self.moe
            return [
                ("moe/router", (d, e.num_experts)),
                ("moe/w_gate", (e.num_experts, d, e.d_ff_expert)),
                ("moe/w_up", (e.num_experts, d, e.d_ff_expert)),
                ("moe/w_down", (e.num_experts, e.d_ff_expert, d)),
                ("ffn_norm/scale", (d,)),
            ]
        f = self.d_ff
        sh = [("mlp/w_up", (d, f)), ("mlp/w_down", (f, d)),
              ("ffn_norm/scale", (d,))]
        if self.act == "swiglu":
            sh.insert(0, ("mlp/w_gate", (d, f)))
        return sh

    def _ssm_shapes(self):
        s = self.ssm
        d = self.d_model
        if s.kind == "rwkv6":
            hd = s.head_dim
            h = d // hd
            lora = 64
            return [
                ("rwkv/w_r", (d, d)), ("rwkv/w_k", (d, d)),
                ("rwkv/w_v", (d, d)), ("rwkv/w_g", (d, d)),
                ("rwkv/w_o", (d, d)),
                ("rwkv/decay_lora_a", (d, lora)),
                ("rwkv/decay_lora_b", (lora, d)),
                ("rwkv/decay_base", (d,)),
                ("rwkv/bonus", (h, hd)),
                ("rwkv/ln_x", (d,)),
                ("rwkv/mix", (5, d)),            # token-shift mixing coeffs
                ("attn_norm/scale", (d,)),        # pre-norm of time-mix
                ("rwkv/ffn_k", (d, self.d_ff)),
                ("rwkv/ffn_v", (self.d_ff, d)),
                ("rwkv/ffn_r", (d, d)),
                ("rwkv/ffn_mix", (2, d)),
                ("ffn_norm/scale", (d,)),
            ]
        # mamba2
        di = s.expand * d
        h = di // s.head_dim
        return [
            ("mamba/w_in", (d, 2 * di + 2 * s.state_dim + h)),  # x,z,B,C,dt
            ("mamba/w_out", (di, d)),
            ("mamba/A_log", (h,)),
            ("mamba/D", (h,)),
            ("mamba/dt_bias", (h,)),
            ("mamba/conv", (4, di + 2 * s.state_dim)),
            ("mamba/norm", (di,)),
            ("attn_norm/scale", (d,)),
        ]

    def _block_shapes(self, kind: str):
        if kind in ("decoder", "encoder"):
            sh = list(self._attn_shapes())
            if kind == "decoder" and self.num_encoder_layers:
                sh += self._attn_shapes(cross=True)
            return sh + self._ffn_shapes()
        if kind == "mamba2":
            return self._ssm_shapes()
        if kind == "rwkv6":
            return self._ssm_shapes()
        if kind == "shared_attn":
            # zamba2: one attention+MLP block shared across depths
            sh = list(self._attn_shapes())
            d, f = self.d_model, self.d_ff
            sh += [("mlp/w_gate", (d, f)), ("mlp/w_up", (d, f)),
                   ("mlp/w_down", (f, d)), ("ffn_norm/scale", (d,))]
            return sh
        raise ValueError(kind)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# --------------------------------------------------------------------------
# Input shapes assigned to the LM family (spec: 4 shapes, per-arch skips).
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# Archs allowed to run long_500k (sub-quadratic decode state — DESIGN.md §6).
LONG_CONTEXT_ARCHS = ("zamba2-7b", "rwkv6-3b", "mixtral-8x7b")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return cfg.arch_id in LONG_CONTEXT_ARCHS
    return True


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    kw = dict(
        num_layers=2, d_model=64, d_ff=128, vocab_size=512,
        vocab_pad_multiple=64, scan_layers=True,
    )
    if cfg.attention:
        a = cfg.attention
        kw["attention"] = dataclasses.replace(
            a, num_heads=4, num_kv_heads=max(1, min(a.num_kv_heads, 2)),
            head_dim=16,
            sliding_window=64 if a.sliding_window else None)
    if cfg.moe:
        # capacity_factor=8 -> no token dropping at smoke scale, so the
        # decode==prefill invariant holds exactly
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=min(cfg.moe.num_experts, 8),
            top_k=min(cfg.moe.top_k, 2), d_ff_expert=64,
            capacity_factor=8.0)
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=16, head_dim=16, chunk_size=16)
    if cfg.num_encoder_layers:
        kw["num_encoder_layers"] = 2
    if cfg.attn_every:
        kw["attn_every"] = 2
    if cfg.frontend != "none":
        kw["frontend_len"] = 8
    if cfg.mop.enabled:
        kw["mop"] = dataclasses.replace(cfg.mop, group_size=16)
    return cfg.replace(**kw)
