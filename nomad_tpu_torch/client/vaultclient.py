"""Task secrets-token derivation + renewal.

Port of ``nomad_tpu/client/vaultclient.py``.

Reference: client/vaultclient/vaultclient.go — DeriveToken :234,
RenewToken :287 with a renewal min-heap :543 driving one timer loop
:464, StopRenewToken :511. The tpu-native build derives CLUSTER tokens
(TTL'd ACL tokens minted by the server's Secrets endpoint) instead of
talking to an external Vault; the client-side lifecycle — derive, renew
at half-TTL via a heap-ordered loop, stop+revoke on task death — is the
same contract.
"""

from __future__ import annotations

import heapq
import logging
import threading
import time
from typing import Optional

logger = logging.getLogger("nomad_tpu_torch.vaultclient")


class VaultClientError(Exception):
    pass


class VaultClient:
    """One per client agent; tracks every derived token's renewal."""

    def __init__(self, rpc) -> None:
        self.rpc = rpc
        # heap of (next_renewal_monotonic, seq, accessor_id)
        self._heap: list[tuple[float, int, str]] = []
        self._tracked: dict[str, float] = {}  # accessor -> ttl_s
        self._seq = 0
        self._cv = threading.Condition()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        # tests shrink this to exercise renewals quickly
        self.renew_fraction = 0.5

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        with self._cv:
            if self._thread is not None:
                return
            self._stop = False
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="vault-renewal"
            )
            self._thread.start()

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
        self._thread = None

    # -- public verbs (reference VaultClient interface) ----------------

    def derive_token(self, alloc_id: str, task_name: str) -> dict:
        """Mint a task token and enroll it for renewal; returns the
        server's {"secret_id", "accessor_id", "ttl_s"}."""
        out = self.rpc.derive_token(alloc_id, task_name)
        self._track(out["accessor_id"], float(out["ttl_s"]))
        return out

    def track(self, accessor_id: str, ttl_s: float = 3600.0) -> None:
        """Enroll an existing token for renewal (the client-restart
        restore path: the accessor was persisted beside the token)."""
        self._track(accessor_id, ttl_s)

    def stop_renew(self, accessor_id: str, revoke: bool = True) -> None:
        """Stop renewing; optionally revoke server-side (reference
        StopRenewToken + the server's token revocation on task death)."""
        with self._cv:
            self._tracked.pop(accessor_id, None)
            self._cv.notify()
        if revoke:
            try:
                self.rpc.revoke_token(accessor_id)
            except Exception:
                logger.debug("revoke of %s failed", accessor_id[:8])

    def tracked(self) -> int:
        with self._cv:
            return len(self._tracked)

    # -- internals -----------------------------------------------------

    def _track(self, accessor_id: str, ttl_s: float) -> None:
        with self._cv:
            self._tracked[accessor_id] = ttl_s
            self._seq += 1
            heapq.heappush(
                self._heap,
                (
                    time.monotonic() + ttl_s * self.renew_fraction,
                    self._seq,
                    accessor_id,
                ),
            )
            self._cv.notify()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._stop:
                    # drop heap heads that were stop_renew'd
                    while self._heap and self._heap[0][2] not in self._tracked:
                        heapq.heappop(self._heap)
                    if not self._heap:
                        self._cv.wait()
                        continue
                    delay = self._heap[0][0] - time.monotonic()
                    if delay <= 0:
                        break
                    self._cv.wait(timeout=delay)
                if self._stop:
                    return
                _, _, accessor = heapq.heappop(self._heap)
                if accessor not in self._tracked:
                    continue
            try:
                ttl = float(self.rpc.renew_token(accessor))
                self._track(accessor, ttl)
            except Exception as e:
                msg = str(e).lower()
                if "expired" in msg or "not found" in msg:
                    # token is truly dead: stop tracking (reference
                    # propagates the terminal error on the renewal chan)
                    logger.warning(
                        "token %s renewal failed terminally: %s",
                        accessor[:8], e,
                    )
                    with self._cv:
                        self._tracked.pop(accessor, None)
                else:
                    # transient (leader election, network blip): keep the
                    # token tracked and retry well before the TTL runs
                    # out — one blip must not let a running task's token
                    # silently expire
                    ttl = self._tracked.get(accessor, 60.0)
                    retry_s = min(max(ttl * 0.1, 1.0), 30.0)
                    logger.info(
                        "token %s renewal failed (%s); retrying in %.0fs",
                        accessor[:8], e, retry_s,
                    )
                    with self._cv:
                        if accessor in self._tracked:
                            self._seq += 1
                            heapq.heappush(
                                self._heap,
                                (
                                    time.monotonic() + retry_s,
                                    self._seq,
                                    accessor,
                                ),
                            )
