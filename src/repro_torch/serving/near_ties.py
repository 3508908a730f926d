"""Two engines' greedy tokens held to each other up to near-ties.

Two runs of one model whose arithmetic differs only in rounding (a mesh
that splits the dense compute against one device, or this package
against the JAX reference) give logits a small gap apart. Greedy
decoding turns that gap into another token only at a near-tie: where a
row's top-2 logit margin lies within the gap, or where a router's k-th
and (k+1)-th probabilities lie so close that the rounding picks another
expert for that row.

:class:`EngineRecorder` watches an engine serve greedily: each sampled
row's logits under the (request id, token index) of the token it chose,
and, with ``router_tie``, the tokens whose own row met a router near-tie
in the split forward that chose them (a slot prefill's last prompt row,
a decode step's slot row). :func:`hold_tokens` holds two runs to each
other: over the rows both computed from the same tokens (each request's
rows up to and including its first differing token), leaving out the
rows of a router near-tie, the logits gap stays within ``bar`` of max
|logit|, and the greedy ids are equal wherever the second run's top-2
margin exceeds twice that gap.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

Key = Tuple[int, int]          # (request id, token index)


class EngineRecorder:
    """``with EngineRecorder(engine, router_tie=None) as rec:`` while the
    engine serves with batched greedy sampling. ``rec.calls`` holds each
    ``sample`` call's logits (host f32, whole), ``rec.rows`` each sampled
    row's logits over the vocabulary by (request id, token index), and
    ``rec.ties`` the keys whose own row met a router near-tie (k-th minus
    (k+1)-th probability below ``router_tie``) in a split block
    (``transformer.decoder_block_split``, through ``mixed_moe.
    capture_moe_inputs``). Router near-ties are read from prefill and
    plain decode steps, so an engine that speculates is refused."""

    def __init__(self, engine, router_tie: Optional[float] = None):
        if router_tie is not None and engine.config.speculate:
            raise ValueError("router near-ties are read from plain decode "
                             "steps: the engine must not speculate")
        self.engine, self.router_tie = engine, router_tie
        self.calls: List[torch.Tensor] = []
        self.rows: Dict[Key, torch.Tensor] = {}
        self.ties: Set[Key] = set()
        self._prefill = None     # (request, its last prompt row)
        self._pending: Set[int] = set()   # decode rows with a tie

    def __enter__(self):
        from repro_torch.core import mixed_moe
        from repro_torch.models import transformer as TR
        from repro_torch.serving import engine as E
        eng = self.engine
        k, vocab = eng.cfg.moe.top_k, eng.cfg.vocab_size
        block, sample, prefill = (TR.decoder_block_split, E.sample,
                                  eng._prefill_slot)
        self._undo = (TR, E, block, sample)

        def blk(ps, cfg, xs, poss, rings, split, tables, **kw):
            with mixed_moe.capture_moe_inputs() as got:
                out = block(ps, cfg, xs, poss, rings, split, tables, **kw)
            for p, (_, probs) in enumerate(got):
                top = -np.sort(-probs, -1)
                live = poss[p].reshape(-1).cpu().numpy() >= 0
                rows = np.flatnonzero(
                    (top[:, k - 1] - top[:, k] < self.router_tie) & live)
                if self._prefill is not None:
                    req, last = self._prefill
                    if last in rows:
                        self.ties.add((req.rid, len(req.out_tokens)))
                else:
                    self._pending.update(split.dp[p] * probs.shape[0]
                                         + int(r) for r in rows)
            return out

        def samp(logits, **kw):
            lg = logits.detach().float().cpu()
            self.calls.append(lg)
            if self._prefill is not None:
                req = self._prefill[0]
                keys = {0: (req.rid, len(req.out_tokens))}
            else:
                if lg.shape[0] != eng.max_slots:
                    raise ValueError("the recorder follows batched greedy "
                                     "sampling")
                keys = {i: (st.req.rid, len(st.req.out_tokens))
                        for i, st in eng.scheduler.active()}
                self.ties.update(keys[r] for r in self._pending
                                 if r in keys)
                self._pending.clear()
            for r, key in keys.items():
                self.rows[key] = lg[r, :vocab]
            return sample(logits, **kw)

        def pre(slot, req, temperature):
            self._prefill = (req, len(req.prompt) - 1)
            try:
                return prefill(slot, req, temperature)
            finally:
                self._prefill = None

        if self.router_tie is not None:
            TR.decoder_block_split = blk
        E.sample = samp
        eng._prefill_slot = pre
        return self

    def __exit__(self, *exc):
        TR, E, block, sample = self._undo
        TR.decoder_block_split, E.sample = block, sample
        del self.engine._prefill_slot
        # hold no engine past the block (its memory is the caller's)
        self.engine = self._undo = None


@dataclasses.dataclass
class Holding:
    """What :func:`hold_tokens` read."""
    parted: List[Optional[int]]   # per request: first differing token
    gap: float                    # max |got - want| over the held rows
    scale: float                  # max |want| over the held rows
    bar: float
    compared: int                 # rows both runs computed alike
    held: int                     # of those, rows with no router near-tie
    firm_differ: List[Key]        # held rows whose ids differ, margin firm
    missing: List[Key]            # compared rows with no logits recorded

    @property
    def equal(self) -> int:
        return sum(j is None for j in self.parted)

    def faults(self, min_equal: int) -> List[str]:
        """Why the runs do not hold (empty if they do)."""
        out = []
        if self.missing:
            out.append(f"no logits recorded for {self.missing}")
        if self.gap > self.bar * self.scale:
            out.append(f"logits gap {self.gap:.3e} over the bar "
                       f"{self.bar * self.scale:.3e}")
        if self.firm_differ:
            out.append(f"greedy ids differ where the margin exceeds twice "
                       f"the gap at {self.firm_differ}")
        if self.equal < min_equal:
            out.append(f"{self.equal} of {len(self.parted)} requests equal, "
                       f"fewer than {min_equal}")
        if 2 * self.held < self.compared:
            out.append(f"{self.held} of {self.compared} rows held: a router "
                       "near-tie in most")
        return out

    def summary(self) -> str:
        where = [(i + 1, j) for i, j in enumerate(self.parted)
                 if j is not None]
        return (f"{self.equal} of {len(self.parted)} requests equal "
                f"(parted at (request, token) {where}); logits gap "
                f"{self.gap:.3e} of max |logit| {self.scale:.3f} over "
                f"{self.held} of {self.compared} rows (bar "
                f"{self.bar:.3g} of max)")


def hold_tokens(got: Sequence[Sequence[int]], want: Sequence[Sequence[int]],
                got_rows: Dict[Key, object], want_rows: Dict[Key, object],
                *, bar: float, exempt=()) -> Holding:
    """Hold run ``got``'s greedy tokens to run ``want``'s (request ``i``
    is id ``i + 1`` in both; rows as :class:`EngineRecorder` keys them).
    Each request's rows up to and including its first differing token
    were computed from the same tokens in both runs; of those, the rows
    in ``exempt`` (a router near-tie in their own row) are left out, and
    the rest are held: their logits gap, their greedy ids where
    ``want``'s top-2 margin exceeds twice it."""
    pairs, missing, compared = [], [], 0
    parted: List[Optional[int]] = []
    for i, (g, w) in enumerate(zip(got, want)):
        if len(g) != len(w):
            raise ValueError(f"request {i + 1}: {len(g)} tokens against "
                             f"{len(w)}")
        j = next((t for t, (a, b) in enumerate(zip(g, w)) if a != b), None)
        parted.append(j)
        for t in range(len(g) if j is None else j + 1):
            key = (i + 1, t)
            compared += 1
            if key in exempt:
                continue
            if key not in got_rows or key not in want_rows:
                missing.append(key)
                continue
            pairs.append((key, torch.as_tensor(got_rows[key]).float(),
                          torch.as_tensor(want_rows[key]).float()))
    gap = max((float((a - b).abs().max()) for _, a, b in pairs), default=0.)
    scale = max((float(b.abs().max()) for _, _, b in pairs), default=0.)
    firm = []
    for key, a, b in pairs:
        top = b.topk(2).values
        if float(top[0] - top[1]) > 2 * gap and \
                int(a.argmax()) != int(b.argmax()):
            firm.append(key)
    return Holding(parted, gap, scale, bar, compared, len(pairs), firm,
                   missing)
