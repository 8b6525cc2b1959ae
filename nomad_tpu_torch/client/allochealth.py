"""Alloc deployment-health tracker.

Port of ``nomad_tpu/client/allochealth.py``.

Reference: client/allochealth/tracker.go — watches an alloc that belongs to
a deployment (or is being drain-migrated) and reports healthy once every
task has been running for min_healthy_time, or unhealthy on task failure /
healthy_deadline expiry. The alloc runner forwards the verdict to the
server through the normal alloc-sync path, where the deployment watcher
consumes it.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..structs import Allocation
from ..structs.structs import AllocDeploymentStatus, now_ns


class HealthTracker:
    def __init__(
        self,
        alloc: Allocation,
        task_states_fn: Callable[[], dict],
        on_healthy: Callable[[bool], None],
        poll_interval_s: float = 0.05,
    ) -> None:
        self.alloc = alloc
        self.task_states_fn = task_states_fn
        self.on_healthy = on_healthy
        self.poll_interval_s = poll_interval_s
        self._stop = threading.Event()
        self._verdict_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

        tg = alloc.job.lookup_task_group(alloc.task_group) if alloc.job else None
        update = tg.update if tg else None
        self.min_healthy_s = update.min_healthy_time_s if update else 10.0
        self.deadline_s = update.healthy_deadline_s if update else 300.0

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"health-{self.alloc.id[:8]}"
        )
        self._thread.start()

    def stop(self) -> None:
        # Taking the verdict lock means stop() can't land between the
        # tracker's last poll and its callback: after stop returns, no
        # healthy-verdict for a being-killed alloc can be delivered.
        with self._verdict_lock:
            self._stop.set()

    def _deliver(self, healthy: bool) -> None:
        with self._verdict_lock:
            if self._stop.is_set():
                return
            self.on_healthy(healthy)

    def _run(self) -> None:
        deadline = time.monotonic() + self.deadline_s
        healthy_since: Optional[float] = None
        while not self._stop.wait(self.poll_interval_s):
            states = self.task_states_fn()
            if not states:
                continue
            if any(s.failed for s in states.values()):
                self._deliver(False)
                return
            now = time.monotonic()
            # batch-style tasks that ran to successful completion count as
            # healthy; otherwise every task must be running
            ok = all(
                s.state == "running" or s.successful() for s in states.values()
            )
            if ok:
                if healthy_since is None:
                    healthy_since = now
                if now - healthy_since >= self.min_healthy_s:
                    self._deliver(True)
                    return
            else:
                healthy_since = None
            if now > deadline:
                self._deliver(False)
                return


def new_deployment_status(healthy: bool) -> AllocDeploymentStatus:
    return AllocDeploymentStatus(healthy=healthy, timestamp_ns=now_ns())
