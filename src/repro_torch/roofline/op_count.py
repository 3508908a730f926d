"""What the port's eager step issues, counted op by op: the counterpart of
the reference's ``roofline/hlo_parse.py``.

The reference parses the compiled, post-SPMD HLO of one device: the FLOPs
of every ``dot`` (trip-count corrected), its HBM traffic, and the wire
payload of each collective. The port has no compiler between its Python
and the card, so it counts what it issues: :class:`OpCounter`, a
``TorchDispatchMode``, sees every aten op of a step, the backward and a
``remat`` recompute included, on ``meta`` tensors (shapes, no storage) as
on real ones, and books per mesh position:

* **FLOPs** of every matmul-class op, by ``torch.utils.flop_counter``'s
  formulas (2·M·N·K for a product: the reference's ``dot`` count,
  ``cost_summary`` ``flops``), and their number (``dot_count``);
* **bytes**, the eager convention: each op reads its operands and writes
  its result once, since eager PyTorch fuses nothing. Views and reshapes
  cost 0, ``empty`` costs 0. As ``hlo_parse``'s slicing and update ops: an
  indexed read (``index``, ``index_select``, ``gather``, ``embedding``)
  reads its indices and the rows it returns and writes them; an indexed
  write (``index_put_``, ``index_copy_``, ``scatter_``, ...) reads its
  values and indices and writes the rows they cover, reading them too when
  it accumulates; ``copy_`` reads its source and writes its destination;
  ``fill_`` and ``zero_`` write their destination;
* **collective bytes** at the port's own transfer points
  (:func:`collective`), with the reference's wire-payload convention: a
  position books max(bytes it receives, bytes it contributes, its own part
  included) per collective. One process drives every position, so these
  are logical transfers: on a device list that repeats ``cuda:0`` they
  cost nothing, on distinct cards they cross NVLink;
* **live bytes**: every storage an op creates is charged to the position
  the op ran at until the storage is freed; the peak of each position is
  the reference's ``temp_bytes``. Storages the step was given (params,
  inputs, caches, optimizer state) are arguments, sized by
  :meth:`OpCounter.place`.

**Positions.** On ``meta`` every device is ``meta``, so a tensor's device
cannot tell the positions apart; the controller says where it runs.
The split forwards (``dist.sharding.Split.each``, the collectives) and
``mixed_moe.moe_apply`` issue each position's share inside
:func:`at_position`. Elsewhere (and in the backward, which runs after
those blocks closed) an op belongs to the first of its tensor operands
whose storage a position other than 0 created or holds, and otherwise to
position 0, ``mesh.devices[0]`` (where the whole-batch forwards of the
families that keep the dense compute whole run it).

The counters are off unless a counter is open: :func:`collective` returns
at once, and no op is seen.
"""
from __future__ import annotations

import hashlib
import threading
import weakref
from collections import defaultdict
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

#: the reference's collective kinds (``hlo_parse.COLLECTIVES``) and the
#: port's two of its own: ``scatter``, the token rows the home device sends
#: each position (the reference's activations are sharded already), and
#: ``reduce``, their gradients summed back on the home device
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute", "scatter", "reduce")

_aten = torch.ops.aten
_FREE = {_aten.empty, _aten.empty_like, _aten.empty_strided,
         _aten.new_empty, _aten.new_empty_strided, _aten._unsafe_view}
_INDEX_READ = {_aten.index, _aten.index_select, _aten.gather,
               _aten.embedding}
# indexed writes: (the operand that holds the values, accumulates: a bool,
# or the operand that says)
_INDEX_WRITE = {_aten.index_put_: (2, 3), _aten.index_put: (2, 3),
                _aten._index_put_impl_: (2, 3),
                _aten.index_copy_: (3, False), _aten.index_copy: (3, False),
                _aten.index_add_: (3, True), _aten.index_add: (3, True),
                _aten.scatter_: (3, False), _aten.scatter: (3, False),
                _aten.scatter_add_: (3, True), _aten.scatter_add: (3, True),
                _aten.scatter_reduce_: (3, True),
                _aten.scatter_reduce: (3, True)}
_OVERWRITE = {_aten.copy_: 1, _aten.fill_: None, _aten.zero_: None}

_NAMES: Dict[object, str] = {}      # aten overload -> its name
_OPEN: List["OpCounter"] = []        # the open counters (one as a rule)
_LOCAL = threading.local()           # .stack: positions opened by at_position


def counting() -> bool:
    """Is a counter open? Call sites test it before sizing a transfer."""
    return bool(_OPEN)


class at_position:
    """Charge the ops issued inside the block to mesh position ``p``."""

    def __init__(self, p: int):
        self.p = int(p)

    def __enter__(self):
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        stack.append(self.p)

    def __exit__(self, *exc):
        _LOCAL.stack.pop()


def collective(kind: str, results: Dict[int, float],
               operands: Dict[int, float]) -> None:
    """Book one collective: ``results[p]`` bytes arrive at position ``p``,
    ``operands[p]`` bytes leave it (its own part included). Each position
    books max(result, operands), ``hlo_parse``'s wire payload."""
    if not _OPEN:
        return
    if kind not in KINDS:
        raise ValueError(f"unknown collective kind {kind!r}")
    for c in _OPEN:
        c._book(kind, results, operands)


def issued() -> int:
    """Ops the open counter has counted so far (0 with none open): a
    long dry run's progress."""
    return _OPEN[-1].ops if _OPEN else 0


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(args, kwargs) -> List[torch.Tensor]:
    """The tensor operands of an aten call (one level of lists: ``cat``'s
    tensors, ``index``'s indices)."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class OpCounter(TorchDispatchMode):
    """Counts a step's ops per mesh position (see the module docstring);
    open it with ``with OpCounter(n) as c:`` around the step."""

    def __init__(self, positions: int = 1):
        super().__init__()
        self.n = int(positions)
        self.ops = 0
        self.flops = [0.0] * self.n
        self.dots = [0] * self.n
        self.bytes = [0.0] * self.n
        self.coll = {k: [0.0] * self.n for k in KINDS}
        self.coll_count = dict.fromkeys(KINDS, 0)
        self.args = [0] * self.n           # argument bytes per position
        self.outs = [0] * self.n           # result bytes per position
        self.live = [0] * self.n           # bytes of the step's storages
        self.peak = [0] * self.n
        self.by_op: Dict[str, List[float]] = defaultdict(
            lambda: [0, 0.0, 0.0])          # name -> [count, flops, bytes]
        self._digest = hashlib.blake2b(digest_size=16)
        self._where: Dict[int, int] = {}   # storage -> position
        self._held: List[torch.UntypedStorage] = []
        self._lock = threading.RLock()

    # -- arguments and results --------------------------------------------
    def _placed(self, tree, p: int = 0):
        """(position, tensor) of every tensor of ``tree``: a
        ``dist.sharding.Sharded`` leaf's shard ``q`` and element ``q`` of a
        per-position list of bank shards at ``q``, the rest at ``p``."""
        from repro_torch.core.quantization import QTensor
        from repro_torch.dist.sharding import Sharded
        if isinstance(tree, Sharded):
            for q, s in enumerate(tree.shards):
                yield from self._placed(s, q)
        elif isinstance(tree, QTensor):
            yield from self._placed(tree.q, p)
            yield from self._placed(tree.scales, p)
        elif isinstance(tree, dict):
            for v in tree.values():
                yield from self._placed(v, p)
        elif isinstance(tree, (list, tuple)):
            per_pos = isinstance(tree, list) and len(tree) == self.n > 1 \
                and all(isinstance(v, dict) for v in tree)
            for q, v in enumerate(tree):
                yield from self._placed(v, q if per_pos else p)
        elif isinstance(tree, torch.Tensor):
            yield p, tree

    def place(self, tree) -> None:
        """Size the step's arguments per position (see :meth:`_placed`);
        each storage counts once."""
        for p, t in self._placed(tree):
            st = t.untyped_storage()
            if st._cdata not in self._where:
                self._where[st._cdata] = p
                self._held.append(st)
                self.args[p] += st.nbytes()

    def outputs(self, tree) -> None:
        """Size the step's results that are storages of its own (an
        argument updated in place is not one), at the position that made
        each."""
        held = {st._cdata for st in self._held}
        seen = set()
        for _, t in self._placed(tree):
            key = _key(t)
            if key in held or key in seen or key not in self._where:
                continue
            seen.add(key)
            self.outs[self._where[key]] += t.untyped_storage().nbytes()

    # -- the dispatch hook -------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:
            return out
        packet = func._overloadpacket
        name = _NAMES.get(func)
        if name is None:
            name = _NAMES[func] = str(func)
        ins = _tensors(args, kwargs)
        outs = [out] if isinstance(out, torch.Tensor) \
            else _tensors(out, {}) if isinstance(out, (list, tuple)) else []
        formula = flop_registry.get(packet)
        flops = 0.0 if formula is None \
            else float(formula(*args, **kwargs, out_val=out))
        moved = self._bytes(packet, args, kwargs, ins, outs)
        with self._lock:
            p = self._position(ins)
            self.ops += 1
            self.flops[p] += flops
            self.dots[p] += formula is not None
            self.bytes[p] += moved
            row = self.by_op[name]
            row[0] += 1
            row[1] += flops
            row[2] += moved
            self._digest.update(f"{name}|{p}|{flops}|{moved};".encode())
            if not func._schema.is_mutable:
                for t in outs:
                    self._created(t, p)
        return out

    def _position(self, ins) -> int:
        stack = getattr(_LOCAL, "stack", None)
        if stack:
            return stack[-1]
        for t in ins:
            q = self._where.get(_key(t), 0)
            if q:
                return q
        return 0

    @staticmethod
    def _bytes(packet, args, kwargs, ins, outs) -> float:
        if packet in _FREE:
            return 0.0
        if packet in _INDEX_READ:
            idx = sum(nbytes(t) for t in ins[1:])
            return idx + 2.0 * sum(nbytes(t) for t in outs)
        if packet in _INDEX_WRITE:
            vi, acc = _INDEX_WRITE[packet]
            if not isinstance(acc, bool):
                acc = bool(args[acc]) if len(args) > acc \
                    else bool(kwargs.get("accumulate", False))
            vals = args[vi]
            # a scalar fill (``scatter_.value``) covers its index's rows
            region = nbytes(vals) if isinstance(vals, torch.Tensor) \
                else args[2].numel() * args[0].element_size()
            other = sum(nbytes(t) for t in ins[1:])
            return other + region * (2 if acc else 1)
        if packet in _OVERWRITE:
            src = _OVERWRITE[packet]
            read = nbytes(args[src]) if src is not None and isinstance(
                args[src], torch.Tensor) else 0
            return read + nbytes(args[0])
        return float(sum(nbytes(t) for t in ins)
                     + sum(nbytes(t) for t in outs))

    def _created(self, t: torch.Tensor, p: int) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._where:
            return
        size = st.nbytes()
        self._where[key] = p
        self.live[p] += size
        if self.live[p] > self.peak[p]:
            self.peak[p] = self.live[p]
        weakref.finalize(st, self._freed, key, p, size)

    def _freed(self, key: int, p: int, size: int) -> None:
        with self._lock:
            if self._where.get(key) == p:
                del self._where[key]
                self.live[p] -= size

    def _book(self, kind, results, operands) -> None:
        with self._lock:
            for p in set(results) | set(operands):
                self.coll[kind][p] += max(results.get(p, 0),
                                          operands.get(p, 0))
            self.coll_count[kind] += 1

    def __enter__(self):
        _OPEN.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _OPEN.remove(self)
        return super().__exit__(*exc)

    # -- summaries (hlo_parse's keys) -------------------------------------
    def digest(self) -> str:
        """A hash of the op sequence with each op's position, FLOPs and
        bytes: two steps issued the same ops iff their digests agree."""
        return self._digest.hexdigest()

    def cost_summary(self) -> Dict[str, float]:
        """``hlo_parse.cost_summary``'s keys for the busiest position of
        each (the bound of a step), with every position's numbers under
        ``per_position``."""
        return {"flops": max(self.flops), "dot_count": max(self.dots),
                "bytes_accessed": max(self.bytes),
                "per_position": {"flops": list(self.flops),
                                 "bytes_accessed": list(self.bytes)}}

    def collective_summary(self) -> Dict[str, float]:
        """``hlo_parse.collective_summary``'s keys (``<kind>_bytes``,
        ``<kind>_count``, ``total_bytes``) at the position whose total
        payload is the largest, named under ``position``."""
        totals = [sum(self.coll[k][p] for k in KINDS) for p in range(self.n)]
        p = max(range(self.n), key=totals.__getitem__)
        out: Dict[str, float] = {}
        for k in KINDS:
            out[f"{k}_bytes"] = self.coll[k][p]
            out[f"{k}_count"] = self.coll_count[k]
        out["total_bytes"] = totals[p]
        out["position"] = p
        return out

    def memory(self) -> Dict[str, float]:
        """The reference's ``memory`` record at the position with the
        largest argument + peak live bytes: ``argument_bytes``,
        ``output_bytes``, ``temp_bytes`` (the peak of the storages the
        step made; its results are among them, so the peak is arguments +
        temp), ``peak_per_device_gib`` and ``position``."""
        tot = [self.args[p] + self.peak[p] for p in range(self.n)]
        p = max(range(self.n), key=tot.__getitem__)
        return {"argument_bytes": self.args[p], "output_bytes": self.outs[p],
                "temp_bytes": self.peak[p],
                "peak_per_device_gib": tot[p] / 2**30, "position": p,
                "per_position_gib": [t / 2**30 for t in tot]}
