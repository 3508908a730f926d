"""Distribution utilities: sharding rules for params, activations and IO
(``repro.dist``)."""
from repro_torch.dist import sharding  # noqa: F401
