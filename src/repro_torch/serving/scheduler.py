"""Iteration-level request scheduler for the continuous-batching engine
(DESIGN.md §3).

The engine owns a FIXED number of decode slots (rows of one slot-based KV
cache); the scheduler owns everything about *requests*: the admission
queue, per-slot request state, and the join/retire decisions taken at
EVERY decode iteration — a short request retires and frees its slot while
its neighbours keep decoding, and the next queued request joins mid-batch
via a prefill-into-slot (no recompile, no re-padding: the decode step is
jitted once for the full slot count).

Admission policy (``SchedulerConfig``):
  * ``max_slots``  — concurrent requests (the decode batch width);
  * ``max_len``    — per-slot KV window: prompt + max_new_tokens must fit;
  * ``max_active_tokens`` — optional cap on the summed token claim
    (prompt + max_new) of all in-flight requests, the knob that trades
    batch occupancy against KV memory under a tight budget;
  * ``max_group_tokens`` (the port's, for a page pool placed per data
    rank) — the same cap within each of ``slot_groups`` equal slot
    ranges: a request joins the first free slot whose range can take it.

Variable tokens per iteration (DESIGN.md §17): under speculative decode
an iteration may emit anywhere from 1 to ``speculate + 1`` tokens per
slot, and the engine clamps each slot's draft depth to its remaining
``max_new_tokens`` — so a request never overruns the claim admission
reserved. Because admission charges the FULL ``prompt + max_new`` claim
up front (not per-token), the in-flight claim bound holds for any
tokens-per-iteration schedule; no scheduler change is needed for
speculation, only this contract.

Admission order (DESIGN.md §9): highest :class:`RequestSLO` priority
first; within a priority class, earliest effective deadline first; then
FIFO. Requests without an SLO keep exact FIFO behaviour.

The scheduler is pure bookkeeping (no jax) and unit-testable on its own.
:class:`SamplingParams` and :class:`RequestSLO` are defined here (the
leaf of the serving import graph) and re-exported by the public surface
``repro.serving.api``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding parameters (DESIGN.md §9).

    ``temperature <= 0`` is greedy; ``top_k == 0`` disables the top-k
    filter. A request without SamplingParams inherits the engine-level
    defaults passed to ``run_iteration``/``step``."""
    temperature: float = 0.0
    top_k: int = 0


@dataclasses.dataclass(frozen=True)
class RequestSLO:
    """Per-request service-level objective (DESIGN.md §9).

    ``priority``: larger is more urgent (admitted first). ``deadline_s``
    is RELATIVE to submission; the scheduler admits earliest-deadline
    first within a priority class and ``ServeResult.deadline_met``
    reports the outcome — the scheduler never drops an expired request
    (the paper's QoS is throughput/quality, not load shedding)."""
    priority: int = 0
    deadline_s: Optional[float] = None


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int = 16
    sampling: Optional[SamplingParams] = None
    slo: RequestSLO = dataclasses.field(default_factory=RequestSLO)
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_admit: Optional[float] = None    # joined a slot (prefill ran)
    t_first: Optional[float] = None    # first output token sampled
    t_done: Optional[float] = None

    @property
    def token_claim(self) -> int:
        """KV-window footprint this request may grow to."""
        return len(self.prompt) + self.max_new_tokens

    @property
    def latency_s(self) -> Optional[float]:
        if self.t_done is None:
            return None
        return self.t_done - self.t_submit

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token (queueing + prefill)."""
        if self.t_first is None:
            return None
        return self.t_first - self.t_submit

    @property
    def deadline(self) -> Optional[float]:
        """Absolute deadline on the t_submit clock; None = best effort."""
        if self.slo.deadline_s is None:
            return None
        return self.t_submit + self.slo.deadline_s

    @property
    def deadline_met(self) -> Optional[bool]:
        """None while in flight or when no deadline was declared."""
        if self.slo.deadline_s is None or self.t_done is None:
            return None
        return self.latency_s <= self.slo.deadline_s

    def done(self) -> bool:
        return len(self.out_tokens) >= self.max_new_tokens


@dataclasses.dataclass
class SlotState:
    """Runtime state of one decode slot."""
    req: Request
    position: int          # absolute position of the NEXT token to decode
    last_token: int        # token fed to the next decode step


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    max_slots: int = 8
    max_len: int = 256                 # prompt + max_new_tokens cap
    # Prompt cap — the KV ring window. For sliding-window models this is
    # smaller than max_len: generation may extend PAST the window (the
    # ring wraps, SWA masking handles it) but a prompt must fit in one
    # prefill write.
    max_prompt_len: Optional[int] = None
    max_queue: Optional[int] = None
    max_active_tokens: Optional[int] = None
    # Slot groups (a page pool placed per data rank): the slots split into
    # ``slot_groups`` equal ranges, each with its own pages, and
    # ``max_group_tokens`` caps the summed claim within each range, so a
    # request joins the first free slot whose group can take it
    slot_groups: int = 1
    max_group_tokens: Optional[int] = None
    # Starvation control (DESIGN.md §9.2): every ``aging_s`` seconds a
    # request waits in the queue, its EFFECTIVE priority rises one class,
    # so a sustained stream of high-priority arrivals cannot starve
    # low-priority requests forever (deadline-style aging — the wait
    # itself becomes the urgency). None disables aging (strict classes).
    aging_s: Optional[float] = None


class ContinuousScheduler:
    """Admission queue + slot table. The engine calls, per iteration:

        for slot, req in sched.admit(): ...prefill req into slot...
        for slot, st in sched.active(): ...decode one token...
        sched.retire(slot)              # when st.req.done()
    """

    def __init__(self, cfg: SchedulerConfig):
        self.cfg = cfg
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[SlotState]] = [None] * cfg.max_slots
        self.done: Dict[int, Request] = {}
        self._rid = 0

    # -- submission --------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               now: Optional[float] = None, *,
               sampling: Optional[SamplingParams] = None,
               slo: Optional[RequestSLO] = None) -> int:
        prompt = np.asarray(prompt, np.int32)
        if len(prompt) < 1:
            raise ValueError("prompt must hold at least one token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (the prefill "
                             "logit already yields one token)")
        if len(prompt) + max_new_tokens > self.cfg.max_len:
            raise ValueError(
                f"request needs {len(prompt)}+{max_new_tokens} tokens; "
                f"slot window is {self.cfg.max_len}")
        if self.cfg.max_prompt_len is not None \
                and len(prompt) > self.cfg.max_prompt_len:
            raise ValueError(
                f"prompt of {len(prompt)} tokens exceeds the prefill "
                f"window {self.cfg.max_prompt_len}")
        if self.cfg.max_queue is not None \
                and len(self.queue) >= self.cfg.max_queue:
            raise RuntimeError("admission queue full")
        self._rid += 1
        self.queue.append(Request(
            rid=self._rid, prompt=prompt, max_new_tokens=max_new_tokens,
            sampling=sampling, slo=slo or RequestSLO(),
            t_submit=time.perf_counter() if now is None else now))
        return self._rid

    # -- introspection -----------------------------------------------------
    def active(self) -> List[Tuple[int, SlotState]]:
        return [(i, s) for i, s in enumerate(self.slots) if s is not None]

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def active_token_claim(self) -> int:
        return sum(s.req.token_claim for s in self.slots if s is not None)

    def has_work(self) -> bool:
        return bool(self.queue) or self.num_active > 0

    # -- join / retire -----------------------------------------------------
    def effective_priority(self, req: Request, now: Optional[float]) -> int:
        """SLO priority plus aging: one class per ``aging_s`` of queue
        wait (0 extra when aging is disabled or ``now`` is unknown)."""
        prio = req.slo.priority
        if self.cfg.aging_s is not None and now is not None:
            prio += int(max(0.0, now - req.t_submit) / self.cfg.aging_s)
        return prio

    def _admission_key(self, req: Request, now: Optional[float]):
        """Aged priority classes first, then earliest deadline, then FIFO.
        Deadline-less requests sort after any deadline in their class."""
        dl = req.deadline
        return (-self.effective_priority(req, now),
                dl if dl is not None else float("inf"),
                req.t_submit, req.rid)

    def admit(self, now: Optional[float] = None
              ) -> List[Tuple[int, Request]]:
        """Pop queued requests into free slots subject to the token budget,
        in admission order (aged priority desc, deadline asc, FIFO);
        returns [(slot, request)] for the engine to prefill. When the next
        request in admission order does not fit the token budget, admission
        stops — no skip-ahead, so a large high-priority request is never
        starved by smaller low-priority ones."""
        joined: List[Tuple[int, Request]] = []
        claim = self.active_token_claim
        # aging compares WAITED time, so it needs a consistent "now":
        # the caller's virtual clock when given, wall clock otherwise.
        key_now = now
        if key_now is None and self.cfg.aging_s is not None:
            key_now = time.perf_counter()
        free = self.free_slots()
        while free and self.queue:
            nxt = min(self.queue,
                      key=lambda r: self._admission_key(r, key_now))
            if self.cfg.max_active_tokens is not None and \
                    claim + nxt.token_claim > self.cfg.max_active_tokens \
                    and self.num_active > 0:
                break                      # wait for retirements
            slot = self._slot_for(nxt, free)
            if slot is None:
                break                      # every group with a free slot
            free.remove(slot)              # is full: wait for retirements
            self.queue.remove(nxt)
            req = nxt
            req.t_admit = time.perf_counter() if now is None else now
            # position of the first decode step = prompt length; the first
            # output token comes from the prefill logits (engine fills it)
            self.slots[slot] = SlotState(req=req,
                                         position=len(req.prompt),
                                         last_token=-1)
            claim += req.token_claim
            joined.append((slot, req))
        return joined

    def _slot_for(self, req: Request, free: List[int]) -> Optional[int]:
        """The first free slot whose group can take ``req``'s claim (a
        group with no request in flight takes any), or None."""
        cap = self.cfg.max_group_tokens
        if cap is None:
            return free[0]
        size = self.cfg.max_slots // self.cfg.slot_groups
        for slot in free:
            group = [s for s in self.slots[slot // size * size:
                                           (slot // size + 1) * size]
                     if s is not None]
            if not group or sum(s.req.token_claim for s in group) \
                    + req.token_claim <= cap:
                return slot
        return None

    def retire(self, slot: int, now: Optional[float] = None) -> Request:
        st = self.slots[slot]
        assert st is not None, f"slot {slot} already free"
        st.req.t_done = time.perf_counter() if now is None else now
        self.slots[slot] = None
        self.done[st.req.rid] = st.req
        return st.req

    def drain_queue(self) -> List[Request]:
        """Remove all queued (not yet admitted) requests; returns them."""
        out = list(self.queue)
        self.queue.clear()
        return out

    # -- metrics -----------------------------------------------------------
    def latency_percentiles(self, qs=(50, 95),
                            last_n: Optional[int] = None
                            ) -> Dict[str, float]:
        """Latency percentiles over completed requests; ``last_n``
        restricts to the most recent completions (the QoSController's
        windowed p95 — lifetime tails would let cold-start samples vote
        forever)."""
        done = [r for r in self.done.values() if r.latency_s is not None]
        if last_n is not None:
            done = sorted(done, key=lambda r: r.t_done)[-last_n:]
        lats = [r.latency_s for r in done]
        if not lats:
            return {f"p{q}": 0.0 for q in qs}
        return {f"p{q}": float(np.percentile(lats, q)) for q in qs}
