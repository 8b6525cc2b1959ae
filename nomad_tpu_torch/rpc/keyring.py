"""Dual-accept keyring for the RPC fabric's shared secret.

Port of ``nomad_tpu/rpc/keyring.py``. Reference:
command/agent/keyring.go — the agent's gossip keyring installs a new key alongside the old one, uses it for new traffic, and
removes the old key once every member has rotated. This fabric
authenticates peers with a single shared ``rpc_secret`` (rpc/server.py
trust-boundary note), so the analog is a TWO-slot keyring: the
``current`` secret every new dial presents, plus the ``previous``
secret accepted for a bounded window after a rotation.

The window is what makes *live* rotation safe: operators push the new
secret agent-by-agent (config edit + SIGHUP → ``Agent.reload``), so for
a while the cluster is mixed. During the window

- an already-rotated server accepts dials from not-yet-rotated peers
  (they present the previous secret), and
- an already-rotated dialer whose new secret a not-yet-rotated server
  rejects falls back to presenting the previous secret on redial
  (rpc/client.py ConnPool auth-failure path),

so either rotation order drains cleanly with zero dropped RPCs.
Established connections are never touched — authentication happens once
per connection at dial time, exactly like the reference's TLS posture.
After the window closes the previous secret is rejected everywhere.

One Keyring instance is shared by every socket owner in a process
(the agent wires its single keyring into the server's RPCServer +
ConnPool and the client's listener/dialers), so one ``rotate()`` call
moves the whole agent atomically.
"""

from __future__ import annotations

import hashlib
import hmac
import threading
import time

from .. import metrics

DEFAULT_WINDOW_S = 60.0


def key_fingerprint(secret: str) -> str:
    """A short non-reversible identifier for a secret, for status
    surfaces and operator logs (never the secret itself)."""
    if not secret:
        return ""
    return hashlib.sha256(secret.encode()).hexdigest()[:12]


class Keyring:
    """Two-slot secret holder with a bounded dual-accept window.

    Thread-safety: every method takes the internal lock; nothing
    blocking ever runs under it (nomad-vet NV-lock-blocking).
    """

    def __init__(self, secret: str = "", window_s: float = DEFAULT_WINDOW_S):
        self._lock = threading.Lock()
        self._current = secret or ""
        self._previous = ""
        self._previous_expires = 0.0  # monotonic deadline
        self._installed_at = time.monotonic()
        self._rotated_at: float = 0.0  # 0 = never rotated
        self.window_s = float(window_s)
        # the window actually APPLIED to the open previous slot (a
        # rotate() may override the default; status must report the
        # real deadline operators pace the rollout against)
        self._applied_window_s = float(window_s)
        self.generation = 0  # bumps on every effective rotation

    # -- dial/accept ---------------------------------------------------

    @property
    def current(self) -> str:
        """The secret dialers present on new connections."""
        with self._lock:
            return self._current

    @property
    def enabled(self) -> bool:
        """Whether the fabric requires authentication at all."""
        with self._lock:
            return bool(self._current)

    def previous_active(self) -> str:
        """The previous secret while its window is open, else ''."""
        with self._lock:
            return self._previous_locked()

    def _previous_locked(self) -> str:
        if self._previous and time.monotonic() < self._previous_expires:
            return self._previous
        return ""

    def accepts(self, presented: bytes) -> bool:
        """Acceptor-side check: the current secret always passes; the
        previous secret passes only while the dual-accept window is
        open. Constant-time compares."""
        with self._lock:
            current = self._current.encode()
            previous = self._previous_locked().encode()
        if current and hmac.compare_digest(presented, current):
            return True
        if previous and hmac.compare_digest(presented, previous):
            # dual-accept hit: a not-yet-rotated peer is still dialing
            # with the old secret — expected during the window, and a
            # climbing counter near its end says the rollout stalled
            metrics.incr("nomad.keyring.accept_previous")
            return True
        metrics.incr("nomad.keyring.auth_fail")
        return False

    # -- rotation ------------------------------------------------------

    def rotate(self, new_secret: str, window_s: float | None = None) -> bool:
        """Install ``new_secret`` as current and open the dual-accept
        window for the old one. Returns False (no-op) when the secret is
        unchanged — an idempotent re-SIGHUP must not restart the window
        or demote a live secret. Rotating BACK to the previous secret
        within its window swaps the slots (the old secret becomes
        current again, the aborted one drains out through the window).

        Rotating to the empty string is refused: disabling fabric auth
        is a restart-worthy topology change, not a rotation (a window
        cannot represent "accept unauthenticated dials")."""
        if not new_secret:
            raise ValueError("cannot rotate the rpc secret to empty")
        with self._lock:
            if new_secret == self._current:
                return False
            window = self.window_s if window_s is None else float(window_s)
            old = self._current
            self._current = new_secret
            # old == "" (enabling auth on a previously open fabric) has
            # no previous to accept; the window only applies to a real
            # old secret
            self._previous = old
            self._previous_expires = (
                time.monotonic() + window if old else 0.0
            )
            self._applied_window_s = window
            self._rotated_at = time.monotonic()
            self.generation += 1
        metrics.incr("nomad.keyring.rotations")
        return True

    # -- observation ---------------------------------------------------

    def status(self) -> dict:
        """Operator-facing state for /v1/agent/self and `operator
        keyring status` — fingerprints and ages only, never secrets."""
        now = time.monotonic()
        with self._lock:
            prev = self._previous_locked()
            window_remaining = (
                max(0.0, self._previous_expires - now) if prev else 0.0
            )
            return {
                "enabled": bool(self._current),
                "generation": self.generation,
                "current_fingerprint": key_fingerprint(self._current),
                "age_s": round(
                    now - (self._rotated_at or self._installed_at), 3
                ),
                "dual_accept": bool(prev),
                "previous_fingerprint": key_fingerprint(prev),
                "window_s": (
                    self._applied_window_s if prev else self.window_s
                ),
                "window_remaining_s": round(window_remaining, 3),
            }


def ensure_keyring(secret) -> Keyring:
    """Normalize a constructor argument: callers pass either a plain
    secret string (standalone pools/servers get a private keyring) or a
    shared Keyring instance (the agent path — one rotation moves every
    socket owner)."""
    if isinstance(secret, Keyring):
        return secret
    return Keyring(secret or "")
