"""Sends a traffic mix's calls to the system: registrations and
deregistrations through the server's entry points, from one thread (a
loop module in `loops/` decides what to send and when).

Every call is recorded with when it was due, when it was sent and its
eval id; the system's EvalWatch says when each eval ended. Calls that
raise count as failed and are not retried.
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class Call:
    kind: str  # "register" | "deregister"
    job_id: str
    due: float  # host seconds at which the loop was ready to send it
    sent: float
    eval_id: str = ""
    error: str = ""


class Driver:
    """system: port.System (or a stand-in with register, deregister,
    watch); make_job(spec) -> the program's job struct."""

    def __init__(self, system, make_job) -> None:
        self.system = system
        self.make_job = make_job
        self.calls: list = []
        self.specs: dict = {}  # job id -> spec, every job sent
        self.stopped: set = set()  # job ids deregistered
        # job ids deregistered after their registration's eval completed
        self.served: set = set()
        self._registered: dict = {}  # job id -> its registration's call

    def send(self, kind: str, spec_or_id, due: float) -> Call:
        sent = time.perf_counter()
        if kind == "register":
            self.specs[spec_or_id.id] = spec_or_id
            job_id = spec_or_id.id
        else:
            job_id = spec_or_id
            self.stopped.add(job_id)
            reg = self._registered.get(job_id)
            end = self.ended(reg) if reg is not None else None
            if end is not None and end[1] == "complete":
                self.served.add(job_id)
        call = Call(kind, job_id, due, sent)
        try:
            if kind == "register":
                job = self.make_job(spec_or_id)
                call.eval_id = self.system.register(job)
            else:
                call.eval_id = self.system.deregister(job_id)
        except Exception as e:  # a refusal is an answer: record, go on
            call.error = f"{type(e).__name__}: {e}"
        self.calls.append(call)
        if kind == "register":
            self._registered[job_id] = call
        return call

    def ended(self, call: Call):
        """(host seconds, status) of the call's eval, None if running."""
        return self.system.watch.done.get(call.eval_id)

    def drain(self, calls: list, timeout_s: float) -> None:
        """Wait until every call in `calls` that got an eval has ended,
        or timeout_s passed."""
        deadline = time.perf_counter() + timeout_s
        for call in calls:
            if not call.eval_id:
                continue
            while (self.ended(call) is None
                   and time.perf_counter() < deadline):
                time.sleep(0.01)
