"""Expert-parallel multi-device serving (``repro.serving.ep``, DESIGN.md
§16).

Two layers on top of the single-device engine:

* :func:`~repro_torch.serving.ep.mesh_engine.build_ep_engine` — ONE
  engine decoding over a (1, ep) mesh: the decode FFN runs through
  ``mixed_moe.moe_apply``'s sharded path (per-device rung-bank shards,
  the ranks' outputs summed in rank order) and the planner/frontier gain
  the PEER placement tier. Greedy output is bit-identical to the
  single-device engine.
* :class:`~repro_torch.serving.ep.replica.DPReplicaGroup` — N engine
  replicas behind one submit/run/result surface, driven by the control
  plane's :class:`~repro_torch.serving.control_plane.autoscale.
  ReplicaAutoscaler`.

One process drives every device. A device list may repeat a device
(``["cpu"] * 4`` on the CPU, ``["cuda:0"] * 4`` on one card), the
counterpart of the reference's forced host device count.
"""
from repro_torch.serving.ep.mesh_engine import (  # noqa: F401
    build_ep_engine, validate_ep_layout,
)
from repro_torch.serving.ep.replica import (  # noqa: F401
    DPReplicaGroup, make_dp_group,
)

__all__ = ["build_ep_engine", "validate_ep_layout", "DPReplicaGroup",
           "make_dp_group"]
