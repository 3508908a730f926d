"""Shared engine-metric schema — the sim/real parity contract
(DESIGN.md §14.2).

The QoS controller, the multi-tenant arbiter and the control plane are
all written against "an engine-shaped object": a ``metrics`` dict plus
``apply_frontier_point``. That only works if the dict has the SAME key
set whichever engine backs it — the real
:class:`~repro.serving.engine.AdaptiveServingEngine` or the
deterministic :class:`~repro.serving.simulator.SimulatedEngine`. The key
set drifted twice already (the PR 5 ``transfer_exposed_s`` split and the
PR 6 ``kv_*`` accounting landed in the real engine only), so the schema
now lives here, in a module with no jax dependency, and BOTH engines
initialize from :func:`base_metrics`. ``tests/test_simulator.py`` pins
the parity.

Counters are ``int``, accumulated seconds/bytes-x-iterations and rates
are ``float`` — the distinction matters because the real engine resets
metrics by zeroing in place, preserving each value's type.
"""
from __future__ import annotations

from typing import Any, Dict

__all__ = ["ENGINE_METRIC_SCHEMA", "base_metrics"]

#: key -> zero of the right type. One entry per metric the real serving
#: engine maintains from construction; keys added lazily after specific
#: actions (``last_migrated_*`` after a reconfig, ``migrated_bytes_total``)
#: are NOT part of the parity contract.
ENGINE_METRIC_SCHEMA: Dict[str, Any] = {
    # generation counters
    "tokens_generated": 0,
    "iterations": 0,
    # time decomposition (DESIGN.md §2/§12)
    "decode_s": 0.0,
    "prefill_s": 0.0,
    "transfer_s": 0.0,
    "transfer_s_est": 0.0,
    "stage_s": 0.0,
    "prefetch_s": 0.0,
    "transfer_exposed_s": 0.0,
    "transfer_overlapped_s": 0.0,
    # reconfiguration / drains (DESIGN.md §10.3)
    "reconfig_s": 0.0,
    "reconfigs": 0,
    "drains": 0,
    "drain_s": 0.0,
    # expert-streaming hit accounting (DESIGN.md §8.1)
    "miss_rate": 0.0,
    "miss_rate_measured": 0.0,
    "expert_accesses": 0,
    "expert_fetches": 0,
    # KV padding accounting (DESIGN.md §13)
    "kv_allocated_bytes": 0,
    "kv_used_bytes": 0,
    "kv_alloc_byte_iters": 0.0,
    "kv_used_byte_iters": 0.0,
    "kv_capacity_bytes": 0,
    # speculative decode (DESIGN.md §17): drafts proposed / accepted by
    # the verify forward; acceptance_rate = accepted / proposed so far
    "spec_proposed": 0,
    "spec_accepted": 0,
    "acceptance_rate": 0.0,
}


def base_metrics() -> Dict[str, Any]:
    """A fresh metrics dict with every schema key zeroed (typed)."""
    return dict(ENGINE_METRIC_SCHEMA)
