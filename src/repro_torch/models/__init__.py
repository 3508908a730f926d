"""Decoder layers, the dense/MoE transformer stack and the serving model
functions (slot KV cache, prefill-into-slot, routed decode)."""
