"""Server-side Job.Plan dry-run.

Port of ``nomad_tpu/server/job_plan.py``, whole. The dry run's scheduler
is the server's own (``new_scheduler`` with the server's config: the
card's schedulers unless the config says ``backend="host"``). A per-eval
scheduler built here gets no ``resident`` state, so its solve uploads
its own tensors and never syncs, mutates or chains on the batch worker's
ResidentClusterState; every read of the job goes through the overlay's
``job_by_id`` (the reconciler's, and the solver's asks carry the job
object they were given). Reference: nomad/job_endpoint.go:521 (Job.Plan RPC) — snapshot current
state, overlay the CANDIDATE job (never committed), run the real scheduler
with plan annotations enabled against a planner that records instead of
applying, and return the annotated counts + a structural diff + placement
failures. The CLI's `job plan` renders this and keeps the reference's exit
codes (0 no changes / 1 changes).
"""

from __future__ import annotations

import logging
from typing import Optional

from ..scheduler import new_scheduler
from ..scheduler.context import SchedulerConfig
from ..structs import Evaluation, Job, Plan, PlanResult, generate_uuid
from ..structs.diff import DIFF_NONE, job_diff
from ..structs.structs import (
    EVAL_STATUS_PENDING,
    EVAL_TRIGGER_JOB_REGISTER,
    now_ns,
)

logger = logging.getLogger("nomad_tpu_torch.server.plan")


class _OverlaySnapshot:
    """A read snapshot with ONE job replaced by the plan candidate.

    The scheduler only reads, so overriding the job lookup is the whole
    overlay — every other table delegates to the frozen snapshot.
    """

    def __init__(self, snap, job: Job):
        self._snap = snap
        self._job = job

    def __getattr__(self, name):
        return getattr(self._snap, name)

    def job_by_id(self, namespace: str, job_id: str) -> Optional[Job]:
        if namespace == self._job.namespace and job_id == self._job.id:
            return self._job
        return self._snap.job_by_id(namespace, job_id)


class _RecordingPlanner:
    """Planner that acknowledges plans without committing anything
    (reference: the Plan RPC's scheduler.NewScheduler with a Harness)."""

    def __init__(self, snap) -> None:
        self._snap = snap
        self.plans: list[Plan] = []
        self.evals: list[Evaluation] = []
        self.updates: list[Evaluation] = []

    def submit_plan(self, plan: Plan):
        self.plans.append(plan)
        result = PlanResult(
            node_update=plan.node_update,
            node_allocation=plan.node_allocation,
            node_preemptions=plan.node_preemptions,
            deployment=plan.deployment,
            deployment_updates=plan.deployment_updates,
            alloc_index=self._snap.index,
            alloc_batches=plan.alloc_batches,
        )
        return result, None

    def create_eval(self, eval_obj: Evaluation) -> None:
        self.evals.append(eval_obj)

    def update_eval(self, eval_obj: Evaluation) -> None:
        self.updates.append(eval_obj)

    def refresh_state(self, min_index: int):
        return self._snap


def plan_job(state, candidate: Job, diff: bool = True,
             config: Optional[SchedulerConfig] = None) -> dict:
    """Dry-run the candidate job against a state snapshot.

    Returns the wire-shaped plan response: scheduler annotations
    (per-group place/stop/migrate/in-place/destructive/ignore), the
    structural job diff, per-group placement failures, and the existing
    job's modify index for `job run -check-index` fencing.
    """
    candidate = candidate.copy()
    candidate.canonicalize()
    candidate.validate()
    snap = state.snapshot()
    existing = snap.job_by_id(candidate.namespace, candidate.id)
    # Mirror upsert_job's version rule: an unchanged spec keeps the current
    # version, so the reconciler sees no drift and plans a no-op — the
    # reference gets the same effect from UpsertJob into the plan snapshot.
    if existing is None:
        candidate.version = 0
    elif candidate.specification_changed(existing):
        candidate.version = existing.version + 1
    else:
        candidate.version = existing.version

    overlay = _OverlaySnapshot(snap, candidate)
    planner = _RecordingPlanner(snap)
    ev = Evaluation(
        id=generate_uuid(),
        namespace=candidate.namespace,
        priority=candidate.priority,
        type=candidate.type,
        triggered_by=EVAL_TRIGGER_JOB_REGISTER,
        job_id=candidate.id,
        status=EVAL_STATUS_PENDING,
        annotate_plan=True,
        create_time=now_ns(),
        modify_time=now_ns(),
    )
    sched = new_scheduler(
        candidate.type, logger, overlay, planner, config
    )
    sched.process(ev)

    plan = planner.plans[-1] if planner.plans else None
    annotations = (plan.annotations if plan else None) or {
        "DesiredTGUpdates": {}
    }
    failed = {}
    for u in reversed(planner.updates):
        if u.failed_tg_allocs:
            failed = u.failed_tg_allocs
            break
    d = job_diff(existing, candidate) if diff else None
    changes = any(
        any(v for k, v in s.items() if k != "ignore")
        for s in annotations["DesiredTGUpdates"].values()
    )
    return {
        "Annotations": annotations,
        "Diff": d,
        # AllocMetric values JSON-encode via codec.json_default's struct
        # lowering at the HTTP boundary (works on forwarded RPCs too).
        "FailedTGAllocs": dict(failed),
        "JobModifyIndex": existing.job_modify_index if existing else 0,
        "Changes": bool(changes),
    }
