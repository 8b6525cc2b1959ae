"""Periodic job dispatcher (cron-style child job launching).

Port of ``nomad_tpu/server/periodic.py``, whole. The reference takes
NotLeaderError and LeadershipLostError from its replicated log
(raft_replication), which the port does not have yet; the port's own
pair lives in raft.py. Host code: it imports no torch. Reference: nomad/periodic.go — PeriodicDispatch tracks periodic jobs in a
launch-time heap, forks child jobs named `<parent>/periodic-<unix>` and
creates their evals; prohibit_overlap skips a launch while a previous child
is live. The leader also persists launch times so restarts don't re-fire
(here: launch bookkeeping lives in the dispatcher and is rebuilt from state
on leadership, like the eval broker).

The cron engine is a self-contained 5-field parser (minute hour dom month
dow) supporting *, */n, a-b, and comma lists — the subset the reference's
cronexpr dependency sees in practice — plus `@every <seconds>s` specs.
"""

from __future__ import annotations

import calendar
import logging
import threading
import time
from typing import Optional

from ..structs import Evaluation, Job, generate_uuid, now_ns
from .raft_replication import LeadershipLostError, NotLeaderError
from ..structs.structs import (
    EVAL_STATUS_PENDING,
    EVAL_TRIGGER_PERIODIC_JOB,
    JOB_STATUS_DEAD,
)

logger = logging.getLogger("nomad_tpu_torch.periodic")

PERIODIC_LAUNCH_SUFFIX = "/periodic-"


# ---------------------------------------------------------------------------
# Cron
# ---------------------------------------------------------------------------


def _parse_field(spec: str, lo: int, hi: int) -> frozenset[int]:
    out: set[int] = set()
    for part in spec.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
        if part in ("*", ""):
            lo2, hi2 = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            lo2, hi2 = int(a), int(b)
        else:
            lo2 = hi2 = int(part)
        if not (lo <= lo2 <= hi and lo <= hi2 <= hi):
            raise ValueError(f"cron field value out of range [{lo},{hi}]: {spec!r}")
        out.update(range(lo2, hi2 + 1, step))
    return frozenset(out)


class CronSpec:
    """5-field cron: minute hour day-of-month month day-of-week."""

    def __init__(self, spec: str) -> None:
        fields = spec.split()
        if len(fields) != 5:
            raise ValueError(f"cron spec needs 5 fields: {spec!r}")
        self.minutes = _parse_field(fields[0], 0, 59)
        self.hours = _parse_field(fields[1], 0, 23)
        self.dom = _parse_field(fields[2], 1, 31)
        self.months = _parse_field(fields[3], 1, 12)
        self.dow = _parse_field(fields[4], 0, 6)  # 0 = Sunday
        self.dom_wild = fields[2] == "*"
        self.dow_wild = fields[4] == "*"
        self._hours_sorted = sorted(self.hours)
        self._minutes_sorted = sorted(self.minutes)

    def _day_match(self, y: int, mo: int, d: int) -> bool:
        # python weekday(): Monday=0 → cron Sunday=0 conversion
        wd = (calendar.weekday(y, mo, d) + 1) % 7
        dom_ok = d in self.dom
        dow_ok = wd in self.dow
        if self.dom_wild and self.dow_wild:
            return True
        if self.dom_wild:
            return dow_ok
        if self.dow_wild:
            return dom_ok
        return dom_ok or dow_ok  # standard cron OR semantics

    def next_after(self, ts: float) -> float:
        """Next matching epoch-second strictly after ts (UTC).

        Walks at day granularity (skipping whole non-matching months), so
        sparse specs like Feb-29 cost thousands of iterations, not the
        ~520k minute steps a naive walk needs — this runs inside the raft
        apply path via PeriodicDispatch.add, so it must stay cheap.
        """
        t = time.gmtime(int(ts) - int(ts) % 60 + 60)
        y, mo, d, h, mi = t.tm_year, t.tm_mon, t.tm_mday, t.tm_hour, t.tm_min
        for _ in range(366 * 6):  # day-granularity bound, ~6 years
            if mo not in self.months:
                # jump to the 1st of the next month
                mo += 1
                if mo > 12:
                    mo, y = 1, y + 1
                d, h, mi = 1, 0, 0
                continue
            if self._day_match(y, mo, d):
                for hh in self._hours_sorted:
                    if hh < h:
                        continue
                    for mm in self._minutes_sorted:
                        if hh == h and mm < mi:
                            continue
                        return calendar.timegm((y, mo, d, hh, mm, 0, 0, 0, 0))
                    h, mi = hh + 1, 0  # no minute left this hour
            d += 1
            h, mi = 0, 0
            if d > calendar.monthrange(y, mo)[1]:
                d = 1
                mo += 1
            if mo > 12:
                mo = 1
                y += 1
        raise ValueError("no cron match within 6 years")


def next_launch(periodic, after_ts: float) -> float:
    """Next launch time for a PeriodicConfig, epoch seconds."""
    spec = periodic.spec.strip()
    if spec.startswith("@every"):
        parts = spec.split(None, 1)
        if len(parts) != 2:
            raise ValueError(f"@every spec needs a duration: {spec!r}")
        dur = parts[1].strip()
        mult = {"s": 1, "m": 60, "h": 3600}.get(dur[-1])
        if mult is None:
            raise ValueError(
                f"@every duration needs an s/m/h suffix: {dur!r}"
            )
        seconds = float(dur[:-1]) * mult
        if seconds <= 0:
            # A non-positive period would fire a child on every poll pass.
            raise ValueError(f"@every duration must be positive: {dur!r}")
        return after_ts + seconds
    return CronSpec(spec).next_after(after_ts)


# ---------------------------------------------------------------------------
# Dispatcher
# ---------------------------------------------------------------------------


class PeriodicDispatch:
    """Tracks periodic jobs and launches due children.

    raft_apply-driven like every other leader subsystem; `run_once(now)`
    fires everything due, so tests control the clock.
    """

    def __init__(self, state, raft_apply, poll_interval_s: float = 1.0) -> None:
        self.state = state
        self.raft_apply = raft_apply
        self.poll_interval_s = poll_interval_s
        self._tracked: dict[tuple[str, str], Job] = {}
        self._next: dict[tuple[str, str], float] = {}
        self._lock = threading.Lock()
        # Serializes child-launch id probes. Separate from _lock:
        # raft_apply re-enters add() via the FSM job-upsert
        # side-channel, which takes _lock. The raft write itself
        # happens OUTSIDE this lock (nomad-vet NV-lock-blocking): a
        # quorum round-trip under it would stall force_launch RPCs
        # behind the timer thread (and vice versa) for seconds during
        # leadership churn. Ids claimed but not yet visible in the
        # state store live in _launch_reserved.
        self._launch_lock = threading.Lock()
        self._launch_reserved: set[tuple[str, str]] = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        self.restore()
        # Fresh Event per incarnation (see drainer.start): a thread that
        # outlives join(timeout) polls its own event and still exits.
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(self._stop,), daemon=True,
            name="periodic-dispatch"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None
        with self._lock:
            self._tracked.clear()
            self._next.clear()

    def _run(self, stop: threading.Event) -> None:
        while not stop.wait(self.poll_interval_s):
            try:
                self.run_once(time.time())
            except Exception:
                logger.exception("periodic dispatch pass failed")

    def restore(self) -> None:
        """Track all live periodic jobs (reference leader.go
        restorePeriodicDispatcher)."""
        for job in self.state.jobs_by_periodic():
            self.add(job)

    # -- tracking (FSM side-channel: job register/deregister) ----------

    def add(self, job: Job) -> None:
        if not job.is_periodic() or job.stopped():
            self.remove(job.namespace, job.id)
            return
        with self._lock:
            self._tracked[job.ns_id()] = job
            self._next[job.ns_id()] = next_launch(job.periodic, time.time())

    def remove(self, namespace: str, job_id: str) -> None:
        with self._lock:
            self._tracked.pop((namespace, job_id), None)
            self._next.pop((namespace, job_id), None)

    def tracked(self) -> list[Job]:
        with self._lock:
            return list(self._tracked.values())

    # -- launching -----------------------------------------------------

    def run_once(self, now_ts: float) -> int:
        """Launch every tracked job whose next fire time has passed."""
        due: list[Job] = []
        with self._lock:
            for key, when in list(self._next.items()):
                if when <= now_ts:
                    try:
                        self._next[key] = next_launch(
                            self._tracked[key].periodic, now_ts
                        )
                    except ValueError:
                        # A spec with no future fire time can't wedge the
                        # pass (or hot-loop): untrack it.
                        logger.exception("periodic job %s untracked", key)
                        self._tracked.pop(key, None)
                        self._next.pop(key, None)
                        continue
                    due.append(self._tracked[key])
        launched = 0
        for job in due:
            if job.periodic.prohibit_overlap and self._has_live_child(job):
                logger.info(
                    "periodic job %s skipped: prohibit_overlap and a child "
                    "is still running",
                    job.id,
                )
                continue
            self.create_child(job, int(now_ts))
            launched += 1
        return launched

    def force_launch(self, namespace: str, job_id: str) -> str:
        """`job periodic force` — immediate launch regardless of schedule."""
        with self._lock:
            job = self._tracked.get((namespace, job_id))
        if job is None:
            job = self.state.job_by_id(namespace, job_id)
        if job is None or not job.is_periodic() or job.stopped():
            raise KeyError(f"{job_id} is not a tracked periodic job")
        return self.create_child(job, int(time.time()))

    def create_child(self, parent: Job, launch_ts: int) -> str:
        """Fork `<parent>/periodic-<ts>` + eval (reference periodic.go
        createEval/deriveJob)."""
        child = parent.copy()
        # Second-granularity launch ids can collide (force_launch racing a
        # scheduled fire); the probe + reservation are atomic under the
        # launch lock, and the bump loop skips both committed children
        # and ids another launch has claimed but not yet applied — so a
        # collision can't silently upsert over an existing child. The
        # raft write runs OUTSIDE the lock: a reserved id keeps racers
        # off it without holding a lock across the quorum round-trip.
        with self._launch_lock:
            ts = launch_ts
            while True:
                cid = f"{parent.id}{PERIODIC_LAUNCH_SUFFIX}{ts}"
                key = (parent.namespace, cid)
                if (
                    key not in self._launch_reserved
                    and self.state.job_by_id(parent.namespace, cid) is None
                ):
                    break
                ts += 1
            self._launch_reserved.add(key)
        child.id = cid
        child.name = child.id
        child.parent_id = parent.id
        child.periodic = None
        child.status = ""
        ev = Evaluation(
            id=generate_uuid(),
            namespace=child.namespace,
            priority=child.priority,
            type=child.type,
            triggered_by=EVAL_TRIGGER_PERIODIC_JOB,
            job_id=child.id,
            status=EVAL_STATUS_PENDING,
            create_time=now_ns(),
            modify_time=now_ns(),
        )
        try:
            # raft_apply returns only after commit+apply, so the state
            # store sees the child before the reservation is dropped —
            # the probe above can never miss a committed launch.
            self.raft_apply("job_register", (child, ev))
        except Exception as exc:
            # Only a pre-submit leadership refusal is known NOT to have
            # reached the log. Every other failure is outcome-unknown —
            # LeadershipLostError and timeouts raise while the entry may
            # still be replicating and can commit after the raise — so
            # the reservation is kept: releasing it would let a racer
            # probe (not reserved, not yet in state), claim the same id,
            # and silently upsert over the late-committing child. The
            # kept entry just steers future launches to ts+1.
            if isinstance(exc, NotLeaderError) and not isinstance(
                exc, LeadershipLostError
            ):
                with self._launch_lock:
                    self._launch_reserved.discard(key)
            raise
        with self._launch_lock:
            self._launch_reserved.discard(key)
        return child.id

    def _has_live_child(self, parent: Job) -> bool:
        for child in self.state.jobs_by_parent(parent.namespace, parent.id):
            if child.status != JOB_STATUS_DEAD:
                return True
        return False
