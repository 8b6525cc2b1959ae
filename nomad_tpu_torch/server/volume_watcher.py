"""Volume claim lifecycle watcher.

Reference: nomad/volumewatcher/volumes_watcher.go — a leader-only loop
that releases volume claims whose allocations are terminal or gone, so a
single-writer volume freed by a dead alloc becomes claimable again
without operator intervention.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

logger = logging.getLogger("nomad_tpu_torch.server.volumes")


class VolumeWatcher:
    def __init__(self, state, raft_apply, poll_interval_s: float = 1.0) -> None:
        self.state = state
        self.raft_apply = raft_apply
        self.poll_interval_s = poll_interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(self._stop,), daemon=True,
            name="volume-watcher",
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self, stop: threading.Event) -> None:
        while not stop.wait(self.poll_interval_s):
            try:
                self.run_once()
            except Exception:
                logger.exception("volume watcher pass failed")

    def run_once(self) -> None:
        stale: set[str] = set()
        for vol in self.state.volumes():
            for claim in vol.claims.values():
                alloc = self.state.alloc_by_id(claim.alloc_id)
                if alloc is None or alloc.terminal_status():
                    stale.add(claim.alloc_id)
        if stale:
            logger.info("releasing %d stale volume claims", len(stale))
            self.raft_apply("volume_claim_release", sorted(stale))
