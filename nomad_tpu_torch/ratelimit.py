"""Token-bucket rate limiting for the RPC front door.

Port of ``nomad_tpu/ratelimit.py``. The RPC precheck
(server/cluster.py) owns two :class:`KeyedRateLimiter`s: one bucketed
per namespace for the eval-minting write verbs, one server-wide for
``Node.register``, so one namespace's burst cannot starve the others.
Throttled callers get :class:`RateLimitError` carrying a
``retry_after_s`` hint, which the shared RetryPolicy (retry.py) honors
as a backoff floor.

:class:`BrokerSaturatedError` is the queue-full sibling: raised by the
leader's eval-minting write endpoints when the eval broker's admission
depth is exhausted (server.py check_eval_admission).

All limiter state is monotonic-clock based and reconfigurable in place.
Stdlib only.
"""

from __future__ import annotations

import threading
import time
from typing import Optional


class RateLimitError(Exception):
    """Request rejected by a front-door rate limit. ``retry_after_s``
    is the caller's backoff hint (HTTP Retry-After; retry.py floor).
    The hint is embedded in the message too, so the error survives the
    RPC fabric's string serialization and the far side can re-parse it
    (see :func:`retry_after_from_text`)."""

    def __init__(self, message: str, retry_after_s: float = 1.0) -> None:
        self.retry_after_s = max(0.0, float(retry_after_s))
        super().__init__(f"{message} (retry_after={self.retry_after_s:.3f}s)")


class BrokerSaturatedError(RateLimitError):
    """The eval broker's admission depth (or a namespace's fairness cap)
    is exhausted: the write was rejected BEFORE minting an eval, so the
    caller can safely retry after the hint."""


def retry_after_from_text(text: str) -> Optional[float]:
    """Recover the retry_after hint from a stringified RateLimitError
    (an ``RPCError`` travelling back from the leader). None when the
    text carries no hint."""
    marker = "retry_after="
    i = text.find(marker)
    if i < 0:
        return None
    j = i + len(marker)
    end = j
    while end < len(text) and (text[end].isdigit() or text[end] == "."):
        end += 1
    try:
        return float(text[j:end])
    except ValueError:
        return None


def is_throttle_text(text: str) -> bool:
    """Does a fabric error string denote a rate-limit/queue-full
    rejection? (The RPC server serializes handler errors as
    ``"{type}: {message}"`` — match on the exception class names.)"""
    return "RateLimitError" in text or "BrokerSaturatedError" in text


class TokenBucket:
    """Classic token bucket on the monotonic clock. NOT thread-safe on
    its own — the owning limiter serializes access."""

    __slots__ = ("rate", "burst", "tokens", "stamp")

    def __init__(self, rate: float, burst: float,
                 now: Optional[float] = None) -> None:
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self.tokens = self.burst
        self.stamp = time.monotonic() if now is None else now

    def try_take(self, now: Optional[float] = None) -> float:
        """Take one token. Returns 0.0 on success, else the seconds
        until a token will be available (the Retry-After hint)."""
        if now is None:
            now = time.monotonic()
        if now > self.stamp:
            self.tokens = min(
                self.burst, self.tokens + (now - self.stamp) * self.rate
            )
        self.stamp = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return 0.0
        if self.rate <= 0:
            return 1.0
        return (1.0 - self.tokens) / self.rate


class KeyedRateLimiter:
    """Per-key (namespace) token buckets sharing one (rate, burst)
    config. rate <= 0 disables the limiter entirely (the default).

    The key set is bounded: least-recently-used buckets are evicted
    past ``max_keys`` so an attacker minting namespaces can't grow
    memory (an evicted key restarts with a full burst — the pessimistic
    direction for the attacker costs them nothing extra)."""

    def __init__(self, rate: float = 0.0, burst: float = 0.0,
                 max_keys: int = 1024) -> None:
        self._lock = threading.Lock()
        self.rate = float(rate)
        self.burst = float(burst) if burst else float(rate)
        self.max_keys = max_keys
        self._buckets: dict[str, TokenBucket] = {}

    @property
    def enabled(self) -> bool:
        return self.rate > 0

    def configure(self, rate: float, burst: float = 0.0) -> None:
        """Live reconfig (SIGHUP): new rate/burst apply to existing
        buckets in place; disabling clears them."""
        with self._lock:
            self.rate = float(rate)
            self.burst = float(burst) if burst else float(rate)
            if self.rate <= 0:
                self._buckets.clear()
                return
            for b in self._buckets.values():
                b.rate = self.rate
                b.burst = max(1.0, self.burst)
                b.tokens = min(b.tokens, b.burst)

    def check(self, key: str, now: Optional[float] = None) -> float:
        """Charge one request against the key's bucket. Returns 0.0 when
        admitted; else the retry-after hint in seconds (caller decides
        whether to raise)."""
        if self.rate <= 0:
            return 0.0
        with self._lock:
            bucket = self._buckets.pop(key, None)
            if bucket is None:
                if len(self._buckets) >= self.max_keys:
                    # evict least-recently-used (dict order = recency
                    # because hits re-insert)
                    self._buckets.pop(next(iter(self._buckets)))
                bucket = TokenBucket(self.rate, self.burst, now=now)
            self._buckets[key] = bucket
            return bucket.try_take(now)

    def enforce(self, key: str, what: str = "request") -> None:
        """check() and raise RateLimitError when over the limit."""
        wait = self.check(key)
        if wait > 0:
            raise RateLimitError(
                f"{what} rate limit exceeded for namespace {key!r}",
                retry_after_s=wait,
            )
