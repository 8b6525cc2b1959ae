"""Front-door rejection errors.

Port of ``nomad_tpu/ratelimit.py``, cut to the two error classes the
server's eval-minting endpoints raise (``Server.check_eval_admission``).
The token buckets and their HTTP and RPC front doors come with the
port's agent. Stdlib only.
"""

from __future__ import annotations


class RateLimitError(Exception):
    """Request rejected by a front-door rate limit. ``retry_after_s``
    is the caller's backoff hint (HTTP Retry-After; retry.py floor).
    The hint is embedded in the message too, so the error survives the
    RPC fabric's string serialization and the far side can re-parse it."""

    def __init__(self, message: str, retry_after_s: float = 1.0) -> None:
        self.retry_after_s = max(0.0, float(retry_after_s))
        super().__init__(f"{message} (retry_after={self.retry_after_s:.3f}s)")


class BrokerSaturatedError(RateLimitError):
    """The eval broker's admission depth (or a namespace's fairness cap)
    is exhausted: the write was rejected BEFORE minting an eval, so the
    caller can safely retry after the hint."""
