"""Pluggable admission policy for the serve engine. A copy of
``repro.serve.scheduler`` (plain Python; the port keeps its own).

Admission is a :class:`Scheduler` the engine consults each tick:

* ``add``     — a submitted request enters the wait set;
* ``pop``     — hand the engine the next request for a free slot (the
                policy decision: arrival order, prompt length, priority);
* ``remove``  — a queued request is cancelled;
* ``victims`` — which RUNNING requests to evict this tick (deadline
                enforcement; the engine frees their slots and emits
                EVICTED events).

The engine owns everything device-side (slots, caches, sampling arrays);
schedulers are pure host-side policy over ``Request`` objects and never
touch the device. That keeps a custom policy a ~20-line class: implement the
four methods (or subclass :class:`FCFS`) and pass an instance — or a
registered name — as ``ServeEngine(..., scheduler=...)``.

Built-ins (``make_scheduler``): ``fcfs`` (arrival order), ``spf``
(shortest prompt first — minimizes mean TTFT under mixed lengths),
``priority`` (highest ``SamplingParams.priority`` first, FIFO within a
level, plus deadline eviction of expired requests — queued OR running).
"""
from __future__ import annotations

import collections
from typing import Protocol, Sequence, runtime_checkable

from repro_torch.serve.session import Request


@runtime_checkable
class Scheduler(Protocol):
    """Host-side admission policy. All methods are O(queue) or better and
    called once per engine tick; ``now`` is ``time.perf_counter()``."""

    def add(self, req: Request) -> None:
        """A submitted request enters the wait set."""

    def pop(self, now: float) -> Request | None:
        """Next request to admit into a free slot (None = nothing ready)."""

    def remove(self, rid: int) -> Request | None:
        """Withdraw a queued request (cancellation); None if unknown."""

    def pending(self) -> list[Request]:
        """Queued requests in current admission order (for introspection)."""

    def victims(self, running: Sequence[Request], now: float) -> list[Request]:
        """Requests this policy evicts this tick — running ones, plus any
        QUEUED ones the policy drops (which it must also remove from its
        own wait set before returning them; the engine retires every
        victim with a terminal EVICTED event)."""

    def __len__(self) -> int: ...


class FCFS:
    """Arrival order; never evicts."""

    name = "fcfs"

    def __init__(self):
        self._q: collections.deque[Request] = collections.deque()

    def add(self, req: Request) -> None:
        self._q.append(req)

    def pop(self, now: float) -> Request | None:
        return self._q.popleft() if self._q else None

    def remove(self, rid: int) -> Request | None:
        for req in self._q:
            if req.rid == rid:
                self._q.remove(req)
                return req
        return None

    def pending(self) -> list[Request]:
        return list(self._q)

    def victims(self, running: Sequence[Request], now: float) -> list[Request]:
        return []

    def __len__(self) -> int:
        return len(self._q)


class ShortestPromptFirst(FCFS):
    """Admit the shortest queued prompt first (ties: arrival order).
    Short prompts prefill cheapest, so under mixed lengths this minimizes
    mean TTFT; never evicts."""

    name = "spf"

    def pop(self, now: float) -> Request | None:
        if not self._q:
            return None
        best = min(self._q, key=lambda r: (len(r.prompt), r.rid))
        self._q.remove(best)
        return best


class PriorityDeadline(FCFS):
    """Highest ``SamplingParams.priority`` first (FIFO within a level),
    with deadline enforcement: a request whose ``deadline_s`` budget has
    expired is never admitted (``pop`` skips it; the engine sees it via
    ``victims``) and is evicted from its slot if already running. Eviction
    is terminal — partial tokens stay on the handle, the slot frees this
    tick, and the handle's last event is EVICTED(reason="deadline")."""

    name = "priority"

    def pop(self, now: float) -> Request | None:
        live = [r for r in self._q
                if r.deadline_at is None or r.deadline_at > now]
        if not live:
            return None
        best = max(live, key=lambda r: (r.sampling.priority, -r.rid))
        self._q.remove(best)
        return best

    def victims(self, running: Sequence[Request], now: float) -> list[Request]:
        expired = [r for r in self._q
                   if r.deadline_at is not None and r.deadline_at <= now]
        for r in expired:                  # queued past-deadline: drop too
            self._q.remove(r)
        expired += [r for r in running
                    if r.deadline_at is not None and r.deadline_at <= now]
        return expired


SCHEDULERS: dict[str, type] = {c.name: c for c in
                               (FCFS, ShortestPromptFirst, PriorityDeadline)}


def make_scheduler(name: str) -> Scheduler:
    try:
        return SCHEDULERS[name]()
    except KeyError:
        raise ValueError(f"unknown scheduler {name!r}; "
                         f"registered: {sorted(SCHEDULERS)}") from None
