"""Open-loop request drivers for the continuous-batching engine.

Shared by the examples so the arrival bookkeeping lives in exactly one
place: requests are submitted when their exponential inter-arrival clock
fires, the engine advances one scheduler iteration at a time, and
(optionally) the tail is left in flight for the caller. ``on_iteration``
is the QoS hook: the :class:`~repro_torch.serving.qos.QoSController`
steps BETWEEN decode iterations (DESIGN.md §9), which is exactly where
this driver calls it.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Union

import numpy as np

from repro_torch.serving.scheduler import RequestSLO, SamplingParams

IntOrSampler = Union[int, Callable[[np.random.Generator], int]]
SLOSampler = Callable[[np.random.Generator], RequestSLO]


def _draw(v: IntOrSampler, rng: np.random.Generator) -> int:
    return int(v(rng)) if callable(v) else int(v)


def drive_poisson(engine, rng: np.random.Generator, *,
                  n_requests: int, mean_gap_s: float,
                  prompt_len: IntOrSampler = 16,
                  max_new_tokens: IntOrSampler = 16,
                  temperature: float = 0.0,
                  sampling: Optional[SamplingParams] = None,
                  slo: Optional[SLOSampler] = None,
                  on_iteration: Optional[Callable[[], None]] = None,
                  drain: bool = True) -> List[int]:
    """Poisson arrival process against the engine: submit each request
    when its (exponential inter-arrival) clock fires, running decode
    iterations in between. ``drain=False`` returns as soon as the last
    request was submitted, leaving the tail in flight (callers use this
    to exercise mid-flight reconfiguration). ``sampling`` attaches
    per-request SamplingParams, ``slo`` draws a per-request
    :class:`RequestSLO` (priority/deadline) from the rng, and
    ``on_iteration`` runs after every decode iteration (the
    QoSController hook). Returns the submitted rids."""
    arrivals = np.cumsum(rng.exponential(mean_gap_s, n_requests))
    rids: List[int] = []
    t0 = time.perf_counter()
    i = 0
    while i < n_requests or (drain and engine.has_work()):
        now = time.perf_counter() - t0
        while i < n_requests and arrivals[i] <= now:
            rids.append(engine.submit(
                rng.integers(1, engine.cfg.vocab_size,
                             _draw(prompt_len, rng)),
                max_new_tokens=_draw(max_new_tokens, rng),
                sampling=sampling,
                slo=slo(rng) if slo is not None else None))
            i += 1
        if engine.has_work():
            engine.run_iteration(temperature=temperature)
            if on_iteration is not None:
                on_iteration()
        elif i < n_requests:
            time.sleep(min(arrivals[i] - now, 0.005))
    return rids
