"""Device meshes (``repro.launch.mesh``).

One process drives every device of a mesh, as one JAX process drives its
``shard_map``: a :class:`Mesh` is a named shape over an explicit tuple of
``torch.device``s; ``dist.sharding`` stores a tensor's shards on it, and
the sharded ``mixed_moe.moe_apply`` runs each mesh position's share on
that position's device. An explicit device list may repeat a
device — ``["cpu"] * 4`` is the counterpart of the reference's forced host
device count, and ``["cuda:0"] * 4`` runs four ranks on one card. Without
a list, a mesh takes distinct cards ``cuda:0, cuda:1, ...``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import resolve_device

__all__ = ["Mesh", "make_ep_mesh", "make_production_mesh", "make_test_mesh",
           "use_mesh"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices laid out in a named shape, row-major (the last axis
    fastest, as ``jax.make_mesh`` lays them out)."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"shape {self.shape} does not match axes "
                             f"{self.axis_names}")
        if math.prod(self.shape) != len(self.devices):
            raise ValueError(f"mesh {self.shape} needs "
                             f"{math.prod(self.shape)} devices, got "
                             f"{len(self.devices)}")

    @property
    def sizes(self) -> Dict[str, int]:
        """Axis name -> size (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.shape))


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh for the duration of the block (the
    reference's ``jax.set_mesh``): ``dist.sharding.full_grouped_ok`` and
    the activation rules read it. The rules installed by an enclosing
    ``activation_constraints`` stay."""
    from repro_torch.dist import sharding
    prev = getattr(sharding._ACTIVE, "mesh", None)
    sharding._ACTIVE.mesh = mesh
    try:
        yield mesh
    finally:
        sharding._ACTIVE.mesh = prev


def _device(d) -> torch.device:
    """One mesh entry: a bare ``cuda`` means the current card."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _require_devices(ndev: int, shape,
                     devices: Optional[Sequence] = None
                     ) -> List[torch.device]:
    """The first ``ndev`` devices of ``devices`` (default: every visible
    card, ``cuda:0`` first), or the actionable error every mesh builder
    raises (a short device list would otherwise build a silently
    wrong-shaped mesh)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        found = [torch.device("cuda", i) for i in range(n)]
        where = f"{n} visible CUDA device(s)"
    else:
        found = [_device(d) for d in devices]
        where = f"a devices= list of {len(found)}"
    if len(found) < ndev:
        raise RuntimeError(
            f"need {ndev} devices for mesh {tuple(shape)}; got {where} — "
            f"pass an explicit devices= list of {ndev} (a device may "
            f"repeat: devices=['cuda:0'] * {ndev} runs every rank on one "
            f"card, devices=['cpu'] * {ndev} on the CPU)")
    return found[:ndev]


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes,
                tuple(_require_devices(math.prod(shape), shape, devices)))


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   devices=None) -> Mesh:
    """A small mesh for tests (``devices=["cpu"] * n`` on the CPU)."""
    shape = tuple(shape)
    return Mesh(shape, tuple(axes),
                tuple(_require_devices(math.prod(shape), shape, devices)))


def make_ep_mesh(ep: int, *, replica: int = 0, devices=None) -> Mesh:
    """The (1, ep) serving mesh of DP replica ``replica``: axes ("data",
    "model") with the experts sharded over "model" (mixed_moe's EP axis)
    and a size-1 data axis — data parallelism is N whole engine REPLICAS
    (``serving/ep.DPReplicaGroup``), not an in-mesh axis, so each
    replica's mesh owns the device slice ``[replica*ep, (replica+1)*ep)``
    of ``devices`` (default: the visible cards). Raises the actionable
    devices error when there are too few."""
    ep = int(ep)
    if ep < 1:
        raise ValueError(f"ep must be >= 1, got {ep}")
    if replica < 0:
        raise ValueError(f"replica must be >= 0, got {replica}")
    ndev = (replica + 1) * ep
    found = _require_devices(ndev, (1, ep), devices)[replica * ep:]
    return Mesh((1, ep), ("data", "model"), tuple(found))
