"""The paper's serving configuration: Mixtral 8x7B + Mixture-of-Precisions.

Defaults match the paper's mid-range operating point: half the experts
4-bit (128/256), planner enabled with a 40 GB HBM budget.
"""
from repro_torch.configs.base import MoPConfig
from repro_torch.configs.mixtral_8x7b import CONFIG as _BASE

CONFIG = _BASE.replace(
    arch_id="mixtral-mop",
    mop=MoPConfig(enabled=True, bits=4, group_size=64, num_q_experts=128,
                  hbm_budget_gb=40.0),
)
