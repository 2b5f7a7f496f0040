"""Request-side view of the serve engine: typed events and handles. A copy
of ``repro.serve.session`` (plain Python; the port keeps its own).

``ServeEngine.submit`` returns a :class:`GenerationHandle`. The engine
pushes :class:`Event` records onto the underlying :class:`Request` as it
ticks (TOKEN per sampled token, then exactly one terminal FINISHED /
CANCELLED / EVICTED); the handle exposes them as an incremental
``stream()`` iterator that DRIVES the engine when it runs dry — the
single-threaded analogue of an async generator — plus per-request latency
metrics (TTFT, TPOT) computed from the event timestamps.

The engine stays the only mutator; handles only read request state and
call back into ``engine.step()`` / ``engine.cancel()``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Iterator

from repro_torch.serve.sampling import SamplingParams


class EventKind(enum.Enum):
    TOKEN = "token"
    FINISHED = "finished"
    CANCELLED = "cancelled"
    EVICTED = "evicted"


TERMINAL = (EventKind.FINISHED, EventKind.CANCELLED, EventKind.EVICTED)


@dataclasses.dataclass(frozen=True)
class Event:
    kind: EventKind
    rid: int
    token: int | None = None          # TOKEN events only
    reason: str = ""                  # terminal events: why (eos, max_new,
                                      # deadline, user cancel, ...)
    t: float = 0.0                    # perf_counter timestamp


@dataclasses.dataclass
class Request:
    """Engine-internal per-request state (the handle is the public face)."""

    rid: int
    prompt: list[int]
    sampling: SamplingParams
    # tenant id routing this request through its adapter delta
    # (repro/tenancy/); None = bare base via the identity bank row
    tenant: str | None = None
    generated: list[int] = dataclasses.field(default_factory=list)
    events: list[Event] = dataclasses.field(default_factory=list)
    # speculative decoding: accepted draft tokens per verify step this
    # request took part in (empty under a non-speculative engine)
    accepted_counts: list[int] = dataclasses.field(default_factory=list)
    status: EventKind | None = None   # None = queued/running; else terminal
    submitted_at: float = 0.0
    first_token_at: float = 0.0
    last_token_at: float = 0.0
    finished_at: float = 0.0

    @property
    def terminal(self) -> bool:
        return self.status is not None

    @property
    def hit_stop(self) -> bool:
        """Natural completion: EOS emitted or max_new reached."""
        s = self.sampling
        if self.generated and s.eos_id is not None \
                and self.generated[-1] == s.eos_id:
            return True
        return len(self.generated) >= s.max_new

    @property
    def deadline_at(self) -> float | None:
        d = self.sampling.deadline_s
        return None if d is None else self.submitted_at + d

    @property
    def tokens(self) -> list[int]:
        return list(self.prompt) + list(self.generated)


class GenerationHandle:
    """What ``submit()`` returns: a live view of one generation.

    Readable any time: ``generated`` / ``tokens`` (prompt + generated),
    ``status``, ``events``, and the latency metrics ``ttft_s`` (submit ->
    first token) and ``tpot_s`` (mean inter-token time after the first).
    ``stream()`` yields events incrementally, stepping the engine whenever
    no buffered event remains; ``result()`` drains it and returns the full
    token list; ``cancel()`` frees the request's slot immediately.
    """

    def __init__(self, engine, req: Request):
        self._engine = engine
        self._req = req

    # -- identity / state ---------------------------------------------------

    @property
    def rid(self) -> int:
        return self._req.rid

    @property
    def sampling(self) -> SamplingParams:
        return self._req.sampling

    @property
    def prompt(self) -> list[int]:
        return list(self._req.prompt)

    @property
    def generated(self) -> list[int]:
        return list(self._req.generated)

    @property
    def tokens(self) -> list[int]:
        return self._req.tokens

    @property
    def status(self) -> EventKind | None:
        """None while queued/running; a terminal EventKind afterwards."""
        return self._req.status

    @property
    def done(self) -> bool:
        return self._req.terminal

    @property
    def finished(self) -> bool:
        return self._req.status is EventKind.FINISHED

    @property
    def events(self) -> tuple[Event, ...]:
        return tuple(self._req.events)

    # -- latency metrics ----------------------------------------------------

    @property
    def ttft_s(self) -> float | None:
        """Time to first token (submit -> prefill's sampled token)."""
        r = self._req
        if not r.first_token_at:
            return None
        return r.first_token_at - r.submitted_at

    @property
    def tpot_s(self) -> float | None:
        """Time per output token after the first (decode steady state)."""
        r = self._req
        if len(r.generated) < 2 or not r.first_token_at:
            return None
        return (r.last_token_at - r.first_token_at) / (len(r.generated) - 1)

    # -- speculative decoding -----------------------------------------------

    @property
    def accepted_counts(self) -> list[int]:
        """Accepted draft tokens per verify step this request took part in
        (empty under a non-speculative engine); each step also emits one
        corrected or bonus token, budget and EOS permitting."""
        return list(self._req.accepted_counts)

    @property
    def acceptance_rate(self) -> float | None:
        """sum(accepted) / (steps x k), k the engine's draft length; None
        when the engine never spec-decoded this request."""
        c = self._req.accepted_counts
        k = getattr(self._engine, "spec_k", 0)
        if not c or not k:
            return None
        return sum(c) / (len(c) * k)

    # -- control ------------------------------------------------------------

    def cancel(self) -> bool:
        return self._engine.cancel(self.rid)

    def stream(self, *, drive: bool = True) -> Iterator[Event]:
        """Yield events in order, ending after the terminal one. With
        ``drive=True`` (default) a starved iterator ticks the engine —
        ``for ev in handle.stream()`` is a complete serving loop. With
        ``drive=False`` it yields only what is already buffered (use when
        something else is stepping the engine)."""
        i = 0
        while True:
            events = self._req.events
            while i < len(events):
                ev = events[i]
                i += 1
                yield ev
                if ev.kind in TERMINAL:
                    return
            if not drive:
                return
            self._engine.step()

    def result(self) -> list[int]:
        """Drive to completion; return prompt + generated tokens."""
        for _ in self.stream():
            pass
        return self.tokens

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        s = self._req.status
        return (f"GenerationHandle(rid={self.rid}, "
                f"status={s.value if s else 'active'}, "
                f"generated={len(self._req.generated)})")
