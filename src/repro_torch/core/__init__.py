"""The paper's contribution, ported: quantization, precision plans, the
planner and its cost model, the Pareto frontier, the expert cache and the
N-bank mixed-precision MoE layer."""
