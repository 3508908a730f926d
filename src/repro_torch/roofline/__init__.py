"""The roofline of a step: op counts (``op_count``) and its three-term
bound on the H100 (``analysis``)."""
