"""Restart tracker: local restart policy decisions.

Port of ``nomad_tpu/client/restarts.py``.

Reference: client/allocrunner/taskrunner/restarts — given a task exit and
the group's RestartPolicy, decide restart (after delay), or fail the task.
"""

from __future__ import annotations

import time

from ..structs import RestartPolicy

DECISION_RESTART = "restart"
DECISION_FAIL = "fail"


class RestartTracker:
    def __init__(self, policy: RestartPolicy) -> None:
        self.policy = policy
        self.attempts: list[float] = []  # wall-clock restart times

    def next_restart(self, exit_success: bool, batch: bool) -> tuple[str, float]:
        """(decision, delay_s) for a task exit.

        Service tasks restart on any exit; batch tasks only restart failures
        (reference: restarts.go handleWaitResult).
        """
        if exit_success and batch:
            return DECISION_FAIL, 0.0  # batch success = done, no restart
        now = time.monotonic()
        window_start = now - self.policy.interval_s
        self.attempts = [t for t in self.attempts if t > window_start]
        if len(self.attempts) >= self.policy.attempts:
            if self.policy.mode == "delay":
                # wait out the window, then restart
                delay = self.attempts[0] + self.policy.interval_s - now
                return DECISION_RESTART, max(delay, self.policy.delay_s)
            return DECISION_FAIL, 0.0
        self.attempts.append(now)
        return DECISION_RESTART, self.policy.delay_s
