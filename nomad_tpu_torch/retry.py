"""Unified retry policy: bounded exponential backoff + jitter + deadline.

Port of ``nomad_tpu/retry.py``. One policy shape shared by every path
that must survive leadership churn: RPC leader-forwarding (cluster.py
_Forwarder, ``FORWARD_POLICY`` through :func:`call_with_retry`) and the
scheduler workers' dequeue/submit loops on NotLeaderError
(server/worker.py, the per-loop :class:`Backoff` behind
``WORKER_POLICY``).

Every retry increments ``nomad.rpc.retry_count.<label>`` and records a
``retry.backoff`` span on the calling thread's trace.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Optional

_rng = random.Random()


@dataclass(frozen=True)
class RetryPolicy:
    """Backoff schedule: attempt k sleeps in
    ``[d*(1-jitter), d]`` where ``d = min(max_s, base_s * multiplier**(k-1))``.
    ``deadline_s`` bounds the total budget of :func:`call_with_retry`;
    a bare :meth:`backoff` iterator (worker loops) has no deadline —
    the loop's own stop event bounds it."""

    base_s: float = 0.05
    max_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5
    deadline_s: float = 10.0

    def delay_s(self, attempt: int, rng: Optional[random.Random] = None) -> float:
        raw = min(self.max_s, self.base_s * self.multiplier ** max(0, attempt - 1))
        r = (rng or _rng).random()
        return raw * (1.0 - self.jitter) + raw * self.jitter * r

    def backoff(self, rng: Optional[random.Random] = None) -> "Backoff":
        return Backoff(self, rng)


# Defaults by call path. One source of truth so the chaos tests can
# reason about worst-case convergence bounds.
FORWARD_POLICY = RetryPolicy(base_s=0.05, max_s=1.0, deadline_s=10.0)
WORKER_POLICY = RetryPolicy(base_s=0.05, max_s=2.0, deadline_s=0.0)


class Backoff:
    """Per-loop backoff state: ``next()`` returns the next delay,
    ``reset()`` on success so one bad window doesn't tax the next."""

    __slots__ = ("policy", "attempt", "rng")

    def __init__(self, policy: RetryPolicy, rng: Optional[random.Random] = None):
        self.policy = policy
        self.attempt = 0
        self.rng = rng

    def next(self) -> float:
        self.attempt += 1
        return self.policy.delay_s(self.attempt, self.rng)

    def reset(self) -> None:
        self.attempt = 0


def call_with_retry(
    fn: Callable,
    *,
    policy: RetryPolicy,
    retry_if: Callable[[BaseException], bool],
    label: str,
    stop=None,
    rng: Optional[random.Random] = None,
):
    """Run ``fn()``; on an exception ``retry_if`` accepts, back off and
    retry until ``policy.deadline_s`` is spent (then the last error
    re-raises). ``stop`` (a threading.Event) aborts the backoff sleep
    early and re-raises — a revoked subsystem must not finish its nap
    before noticing it was stopped.

    Emits ``nomad.rpc.retry_count.<label>`` per retry and a
    ``retry.backoff`` span on the current trace.
    """
    from . import metrics, trace

    deadline = time.monotonic() + policy.deadline_s
    bo = policy.backoff(rng)
    while True:
        try:
            return fn()
        except BaseException as e:
            if not retry_if(e):
                raise
            delay = bo.next()
            # Server-provided backoff hint (429 Retry-After riding a
            # RateLimitError/APIError as `retry_after_s`): a FLOOR on
            # the computed delay — retrying sooner than the server said
            # guarantees another rejection.
            hint = getattr(e, "retry_after_s", None)
            if hint:
                try:
                    delay = max(delay, float(hint))
                except (TypeError, ValueError):
                    pass
            if time.monotonic() + delay > deadline:
                raise
            metrics.incr(f"nomad.rpc.retry_count.{label}")
            with trace.span(
                trace.current(), "retry.backoff",
                target=label, attempt=bo.attempt, error=type(e).__name__,
            ):
                if stop is not None:
                    if stop.wait(delay):
                        raise
                else:
                    time.sleep(delay)
