"""Deadline budgets, retry policy and circuit breakers for remote graph
nodes — the port's copy of ``seldon_core_tpu/runtime/resilience.py:61-492``.

* **Deadline**: one request-level budget carried in a contextvar (asyncio
  tasks inherit it across a ``gather`` fan-out) and on the wire as the
  ``Seldon-Deadline-Ms`` header.  Every node hop and retry attempt clamps
  its own timeout to what is left, so timeouts never stack.
* **RetryPolicy / RetryBudget**: exponential backoff with full jitter,
  transient-status classification, per-method idempotency gating
  (``route`` and ``send_feedback`` are never retried) and a token-bucket
  budget shared by every node client of a predictor, so retries cannot
  amplify an outage.
* **CircuitBreaker**: per remote node, closed -> open -> half-open over a
  sliding window of outcomes; its state shows in the engine's ``/stats``
  and ``/ready``.

Everything takes an injectable clock / rng, so tests are deterministic.
Breaker states and transitions, retry-budget exhaustion and deadline
misses go to the flight recorder (``utils/telemetry.py``, the
``seldon_tpu_breaker_*``, ``seldon_tpu_retry_budget_exhausted_total`` and
``seldon_tpu_deadline_exceeded_total`` families); the remote clients
record their retries.  The policies that act on these budgets live beside
them: admission control and the brownout ladder (``runtime/engine.py``
``_submit``, ``runtime/brownout.py``) shed with a typed 503
(``LoadShedError``) that this module's retry policy classifies transient,
and the tenant governor (``runtime/qos.py``) refuses with a 429.
"""

from __future__ import annotations

import contextvars
import random
import threading
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

from seldon_core_tpu_torch.messages import DeadlineExceededError, SeldonMessageError
from seldon_core_tpu_torch.utils.telemetry import RECORDER

__all__ = [
    "Deadline",
    "DEADLINE_VAR",
    "current_deadline",
    "remaining_s",
    "clamp_timeout",
    "deadline_scope",
    "maybe_deadline_scope",
    "deadline_ms_header",
    "deadline_header_value",
    "DEADLINE_HEADER",
    "RetryPolicy",
    "RetryBudget",
    "CircuitBreaker",
    "BreakerOpenError",
    "IDEMPOTENT_METHODS",
    "is_idempotent",
]

#: wire name of the deadline budget (milliseconds remaining) on REST hops
DEADLINE_HEADER = "Seldon-Deadline-Ms"

#: graph methods safe to retry: pure reads of unit state.  ``route`` is not
#: idempotent (a bandit router moves its exploration state per call) and
#: ``send_feedback`` is a training write.
IDEMPOTENT_METHODS = frozenset({"predict", "transform_input", "transform_output", "aggregate"})


def is_idempotent(method: str) -> bool:
    return method in IDEMPOTENT_METHODS


class BreakerOpenError(SeldonMessageError):
    """Fail-fast refusal: the node's circuit breaker is open and no call was
    attempted.  503 at the edge: the node is known unhealthy."""

    http_code = 503

    def __init__(self, node: str):
        super().__init__(f"circuit breaker open for node {node!r}")
        self.node = node


# ---------------------------------------------------------------------------
# Deadline propagation
# ---------------------------------------------------------------------------


class Deadline:
    """An absolute point on the monotonic clock; every hop, retry and
    backoff of the request draws from this one budget."""

    __slots__ = ("at", "_clock")

    def __init__(self, at: float, clock: Callable[[], float] = time.monotonic):
        self.at = float(at)
        self._clock = clock

    @classmethod
    def after(cls, budget_s: float, clock: Callable[[], float] = time.monotonic) -> "Deadline":
        return cls(clock() + float(budget_s), clock)

    def remaining_s(self) -> float:
        return self.at - self._clock()

    @property
    def expired(self) -> bool:
        return self.remaining_s() <= 0.0

    def __repr__(self) -> str:
        return f"Deadline(remaining={self.remaining_s():.3f}s)"


DEADLINE_VAR: contextvars.ContextVar[Optional[Deadline]] = contextvars.ContextVar(
    "seldon_tpu_torch_deadline", default=None)


def current_deadline() -> Optional[Deadline]:
    return DEADLINE_VAR.get()


def remaining_s() -> Optional[float]:
    """Remaining request budget in seconds, None when no deadline is set."""
    dl = DEADLINE_VAR.get()
    return None if dl is None else dl.remaining_s()


def clamp_timeout(timeout_s: float, where: str = "call") -> float:
    """A per-attempt timeout clamped to the remaining request budget.
    Raises ``DeadlineExceededError`` (504) when the budget is already gone:
    the caller must not start work it cannot finish."""
    rem = remaining_s()
    if rem is None:
        return timeout_s
    if rem <= 0.0:
        RECORDER.record_deadline_exceeded(where)
        raise DeadlineExceededError(f"request deadline exhausted before {where}")
    return min(timeout_s, rem)


@contextmanager
def deadline_scope(budget_s: float, clock: Callable[[], float] = time.monotonic):
    """Set the request deadline for everything awaited inside the scope.  A
    nested scope can only tighten an inherited deadline, never extend it."""
    dl = Deadline.after(budget_s, clock)
    cur = DEADLINE_VAR.get()
    if cur is not None and cur.at <= dl.at:
        dl = cur
    token = DEADLINE_VAR.set(dl)
    try:
        yield dl
    finally:
        DEADLINE_VAR.reset(token)


def maybe_deadline_scope(budget_s: Optional[float]):
    """``deadline_scope`` when a budget is given, a no-op otherwise."""
    if budget_s is None:
        return nullcontext()
    return deadline_scope(budget_s)


def deadline_header_value() -> Optional[str]:
    """The remaining budget for the ``Seldon-Deadline-Ms`` header, floored
    at 1 ms (a sub-millisecond remainder must never format as "0", which
    the next hop would read as no deadline); None without a deadline."""
    rem = remaining_s()
    if rem is None:
        return None
    return f"{max(rem * 1e3, 1.0):.0f}"


def deadline_ms_header(raw) -> Optional[float]:
    """A ``Seldon-Deadline-Ms`` value (str or bytes) as a budget in seconds.
    Lenient: absent, malformed or non-positive values mean no deadline."""
    if not raw:
        return None
    try:
        ms = float(raw)
    except (TypeError, ValueError):
        return None
    return ms / 1e3 if ms > 0 else None


# ---------------------------------------------------------------------------
# Retry policy + budget
# ---------------------------------------------------------------------------


@dataclass
class RetryPolicy:
    """Exponential backoff with full jitter (a delay ~ U(0, base * 2^attempt),
    capped); only transient statuses retry, and only idempotent methods."""

    max_attempts: int = 3
    base_backoff_s: float = 0.025
    max_backoff_s: float = 0.5
    #: transient HTTP statuses; 500 is left out on purpose: a deterministic
    #: handler bug retried is only more load
    retryable_statuses: frozenset = frozenset({429, 502, 503, 504})
    #: transient gRPC status names, kept for parity with the JAX package
    retryable_codes: frozenset = frozenset({"UNAVAILABLE", "RESOURCE_EXHAUSTED"})
    #: the jitter's source; tests inject random.Random(seed)
    rng: Any = field(default_factory=lambda: random, repr=False)

    def backoff_s(self, attempt: int) -> float:
        cap = min(self.max_backoff_s, self.base_backoff_s * (2.0 ** attempt))
        return self.rng.uniform(0.0, cap)

    def retryable_http(self, status: int) -> bool:
        return int(status) in self.retryable_statuses

    def retryable_grpc(self, code_name: str) -> bool:
        return str(code_name) in self.retryable_codes


class RetryBudget:
    """Token-bucket retry budget shared by every node client of a predictor:
    a completed first attempt deposits ``deposit_per_call`` tokens, a retry
    withdraws one, so under a full outage retries stay near
    ``deposit_per_call`` times the offered load."""

    def __init__(self, deposit_per_call: float = 0.2, initial_tokens: float = 10.0,
                 max_tokens: float = 100.0):
        self.deposit_per_call = float(deposit_per_call)
        self.max_tokens = float(max_tokens)
        self._tokens = min(float(initial_tokens), self.max_tokens)
        self.exhausted_total = 0
        self._lock = threading.Lock()

    def deposit(self) -> None:
        with self._lock:
            self._tokens = min(self.max_tokens, self._tokens + self.deposit_per_call)

    def withdraw(self) -> bool:
        """True when a retry may go; False (and counted) when the budget is
        spent."""
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            self.exhausted_total += 1
        RECORDER.record_retry_budget_exhausted()
        return False

    @property
    def tokens(self) -> float:
        return self._tokens

    def snapshot(self) -> Dict[str, Any]:
        return {"tokens": round(self._tokens, 3), "max_tokens": self.max_tokens,
                "deposit_per_call": self.deposit_per_call,
                "exhausted_total": self.exhausted_total}


# ---------------------------------------------------------------------------
# Circuit breaker
# ---------------------------------------------------------------------------


class CircuitBreaker:
    """Per remote node: closed -> open -> half-open.

    Once ``min_calls`` outcomes lie in the sliding ``window_s`` and the
    failure ratio reaches ``failure_ratio``, the breaker opens and every
    call fails fast (``BreakerOpenError``) for ``open_s``; then
    ``half_open_probes`` probes are let through: a success closes it (the
    window cleared), a failure opens it for another cooldown.  Lives on the
    engine's event loop; not thread-safe beyond the GIL."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"
    #: the seldon_tpu_breaker_state gauge's value per state
    _STATE_GAUGE = {CLOSED: 0.0, HALF_OPEN: 0.5, OPEN: 1.0}

    def __init__(self, node: str, window_s: float = 30.0, min_calls: int = 10,
                 failure_ratio: float = 0.5, open_s: float = 5.0, half_open_probes: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        self.node = node
        self.window_s = float(window_s)
        self.min_calls = int(min_calls)
        self.failure_ratio = float(failure_ratio)
        self.open_s = float(open_s)
        self.half_open_probes = int(half_open_probes)
        self._clock = clock
        self.state = self.CLOSED
        self._window: list = []  # [(ts, ok)], evicted by age
        self._opened_at = 0.0
        self._probes_inflight = 0
        self.transitions: Dict[str, int] = {}
        self._publish_state()

    def _publish_state(self) -> None:
        RECORDER.set_breaker_state(self.node, self.state, self._STATE_GAUGE[self.state])

    def _transition(self, to: str) -> None:
        if to == self.state:
            return
        self.state = to
        self.transitions[to] = self.transitions.get(to, 0) + 1
        if to == self.OPEN:
            self._opened_at = self._clock()
        if to in (self.OPEN, self.CLOSED):
            self._probes_inflight = 0
        if to == self.CLOSED:
            self._window = []
        RECORDER.record_breaker_transition(self.node, to)
        self._publish_state()

    def _failure_stats(self, now: float) -> Tuple[int, int]:
        cutoff = now - self.window_s
        if self._window and self._window[0][0] < cutoff:
            self._window = [e for e in self._window if e[0] >= cutoff]
        return len(self._window), sum(1 for _, ok in self._window if not ok)

    def allow(self) -> bool:
        """May a call go now?  An open breaker lets nothing through until
        its cooldown has passed, then a bounded number of probes."""
        now = self._clock()
        if self.state == self.OPEN:
            if now - self._opened_at < self.open_s:
                return False
            self._transition(self.HALF_OPEN)
        if self.state == self.HALF_OPEN:
            if self._probes_inflight >= self.half_open_probes:
                return False
            self._probes_inflight += 1
        return True

    def record(self, ok: bool) -> None:
        now = self._clock()
        if self.state == self.HALF_OPEN:
            self._probes_inflight = max(0, self._probes_inflight - 1)
            self._transition(self.CLOSED if ok else self.OPEN)
            return
        if self.state == self.OPEN:
            return  # a call admitted before the breaker opened; the cooldown governs
        self._window.append((now, bool(ok)))
        if not ok:
            calls, failures = self._failure_stats(now)
            if calls >= self.min_calls and failures / calls >= self.failure_ratio:
                self._transition(self.OPEN)

    def record_success(self) -> None:
        self.record(True)

    def record_failure(self) -> None:
        self.record(False)

    def release(self) -> None:
        """Undo an ``allow()`` that produced no outcome (an expired deadline
        or a cancellation between the gate and the call), so a half-open
        probe slot never leaks.  A no-op outside HALF_OPEN."""
        if self.state == self.HALF_OPEN:
            self._probes_inflight = max(0, self._probes_inflight - 1)

    def trip(self) -> None:
        """Force open."""
        self._transition(self.OPEN)

    def reset(self) -> None:
        self._transition(self.CLOSED)

    def snapshot(self) -> Dict[str, Any]:
        now = self._clock()
        calls, failures = self._failure_stats(now)
        out: Dict[str, Any] = {
            "state": self.state,
            "window_calls": calls,
            "window_failures": failures,
            "failure_ratio": round(failures / calls, 4) if calls else 0.0,
            "transitions": dict(self.transitions),
            "config": {"window_s": self.window_s, "min_calls": self.min_calls,
                       "failure_ratio": self.failure_ratio, "open_s": self.open_s},
        }
        if self.state == self.OPEN:
            out["reopens_in_s"] = round(max(0.0, self.open_s - (now - self._opened_at)), 3)
        return out


class _BreakerGuard:
    """Pairs every breaker admission with exactly one outcome: ``close()``
    (in a finally) releases an admission that recorded none.  One guard
    per logical call, across its retries."""

    __slots__ = ("breaker", "_admitted_unrecorded")

    def __init__(self, breaker: Optional[CircuitBreaker]):
        self.breaker = breaker
        self._admitted_unrecorded = False

    def gate(self, node_name: str) -> None:
        """Per-attempt admission: a breaker that opened mid-loop stops the
        remaining attempts."""
        if self.breaker is None:
            return
        if not self.breaker.allow():
            raise BreakerOpenError(node_name)
        self._admitted_unrecorded = True

    def record(self, ok: bool) -> None:
        if self.breaker is None:
            return
        self._admitted_unrecorded = False
        self.breaker.record(ok)

    def close(self) -> None:
        if self.breaker is not None and self._admitted_unrecorded:
            self.breaker.release()
