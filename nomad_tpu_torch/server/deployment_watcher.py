"""Leader-only deployment watcher.

Port of ``nomad_tpu/server/deployment_watcher.py``, whole. Host code: it
reads the store and writes through raft_apply, and imports no torch.
Reference: nomad/deploymentwatcher/deployments_watcher.go (interface :36) +
deployment_watcher.go — per-deployment goroutines judging alloc health,
auto-promoting canaries, auto-reverting on failure, and emitting follow-up
evals so the scheduler continues (or rolls back) the rollout.

TPU-native redesign: instead of one goroutine per deployment blocking on
state watch channels, a single reconciliation pass (`run_once`) judges ALL
active deployments against one state snapshot — the same batching philosophy
as the TPU placement solver. A background thread polls; tests call
`run_once` directly for determinism.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from ..structs import Evaluation, generate_uuid, now_ns
from ..structs.structs import (
    DEPLOYMENT_STATUS_FAILED,
    DEPLOYMENT_STATUS_SUCCESSFUL,
    EVAL_STATUS_PENDING,
    EVAL_TRIGGER_DEPLOYMENT_WATCHER,
    Deployment,
    DeploymentStatusUpdate,
    Job,
)

logger = logging.getLogger("nomad_tpu_torch.deployment_watcher")

DESC_FAILED_ALLOCS = "Failed due to unhealthy allocations"
DESC_PROGRESS_DEADLINE = "Failed due to progress deadline"
DESC_FAILED_REVERT = (
    "Failed due to unhealthy allocations - rolling back to job version %d"
)
DESC_PROMOTED = "Deployment promoted"
DESC_MANUAL_FAIL = "Deployment marked as failed"
DESC_PAUSED = "Deployment paused"
DESC_RESUMED = "Deployment is running"


def check_promotion_ready(state, d: Deployment, groups: Optional[list[str]] = None):
    """Raise unless every targeted group has its desired healthy canaries —
    run by the promote endpoint BEFORE the raft commit (reference
    deployment_watcher.go PromoteDeployment validation)."""
    targets = groups if groups else [
        g for g, s in d.task_groups.items() if s.desired_canaries > 0
    ]
    for g in targets:
        dstate = d.task_groups.get(g)
        if dstate is None:
            raise KeyError(f"deployment has no group {g!r}")
        healthy = 0
        for cid in dstate.placed_canaries:
            a = state.alloc_by_id(cid)
            if (
                a is not None
                and a.deployment_status is not None
                and a.deployment_status.is_healthy()
            ):
                healthy += 1
        if healthy < dstate.desired_canaries:
            raise ValueError(
                f"group {g!r} has {healthy}/{dstate.desired_canaries} "
                "healthy canaries — cannot promote"
            )


class DeploymentsWatcher:
    """Judges active deployments and drives their lifecycle via raft.

    raft_apply / state are the only dependencies, so the watcher runs
    identically under the test harness and the live server.
    """

    def __init__(self, state, raft_apply, poll_interval_s: float = 0.25) -> None:
        self.state = state
        self.raft_apply = raft_apply
        self.poll_interval_s = poll_interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        # Fresh Event per incarnation (see drainer.start): a thread that
        # outlives join(timeout) polls its own event and still exits.
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(self._stop,), daemon=True,
            name="deployment-watcher"
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
                logger.exception("deployment watcher pass failed")

    # -- the reconciliation pass ---------------------------------------

    def run_once(self) -> int:
        """Judge every active deployment. Returns number acted upon."""
        acted = 0
        for d in self.state.deployments():
            if d.status == DEPLOYMENT_STATUS_SUCCESSFUL:
                # A deployment may be completed by the reconciler's plan
                # (deployment_updates in the committed plan) rather than by
                # this watcher — job stability still must follow.
                self._mark_job_stable(d)
                continue
            if not d.active() or d.status == "paused":
                continue
            if self._judge(d):
                acted += 1
        return acted

    def _judge(self, d: Deployment) -> bool:
        allocs = self.state.allocs_by_deployment(d.id)
        healthy: dict[str, int] = {g: 0 for g in d.task_groups}
        unhealthy_ids: list[str] = []
        canary_healthy: dict[str, int] = {g: 0 for g in d.task_groups}
        now = now_ns()

        for a in allocs:
            if a.terminal_status():
                # Stopped/completed/lost allocs no longer count toward the
                # rollout (their replacements will be judged instead).
                continue
            ds = a.deployment_status
            g = a.task_group
            if g not in d.task_groups:
                continue
            dstate = d.task_groups[g]
            if ds is not None and ds.is_healthy():
                healthy[g] += 1
                if a.id in dstate.placed_canaries:
                    canary_healthy[g] += 1
            elif ds is not None and ds.is_unhealthy():
                unhealthy_ids.append(a.id)
            else:
                # Not yet judged: past the group's healthy deadline the
                # watcher marks it unhealthy (reference: the client's
                # allochealth watcher enforces HealthyDeadline; the server
                # backstops it here so a dead client can't wedge a rollout).
                deadline = self._healthy_deadline_ns(d, a)
                if deadline and now > deadline and not a.terminal_status():
                    unhealthy_ids.append(a.id)
                elif a.client_status == "failed":
                    unhealthy_ids.append(a.id)

        # 1. unhealthy allocs → fail (with optional auto-revert)
        if unhealthy_ids:
            self._fail(d, unhealthy_ids)
            return True

        # 2. progress deadline exceeded → fail
        for g, dstate in d.task_groups.items():
            if (
                dstate.require_progress_by_ns
                and now > dstate.require_progress_by_ns
                and healthy[g] < dstate.desired_total
            ):
                self._fail(d, [], desc=DESC_PROGRESS_DEADLINE)
                return True

        # 3. auto-promote when all canaries are healthy
        if d.requires_promotion() and d.has_auto_promote():
            ready = all(
                canary_healthy[g] >= s.desired_canaries
                for g, s in d.task_groups.items()
                if s.desired_canaries > 0
            )
            if ready:
                self.promote(d)
                return True

        # 4. counter drift: resync healthy counts so `nomad deployment
        # status` and the reconciler's computeLimit see fresh numbers.
        drift = any(
            d.task_groups[g].healthy_allocs != healthy[g] for g in d.task_groups
        )
        if drift:
            healthy_ids = [
                a.id
                for a in allocs
                if a.deployment_status is not None
                and a.deployment_status.is_healthy()
            ]
            self.raft_apply(
                "deployment_alloc_health",
                {
                    "deployment_id": d.id,
                    "healthy_ids": healthy_ids,
                    "unhealthy_ids": [],
                    "eval": self._new_eval(d),
                },
            )
            return True

        # 5. all groups fully healthy (and promoted) → successful
        complete = all(
            healthy[g] >= s.desired_total for g, s in d.task_groups.items()
        ) and not d.requires_promotion()
        if complete and d.task_groups:
            self.raft_apply(
                "deployment_status_update",
                DeploymentStatusUpdate(
                    deployment_id=d.id,
                    status=DEPLOYMENT_STATUS_SUCCESSFUL,
                    status_description="Deployment completed successfully",
                ),
            )
            self._mark_job_stable(d)
            return True
        return False

    # -- actions (also the Deployment RPC endpoints' backend) ----------

    def promote(self, d: Deployment, groups: Optional[list[str]] = None) -> None:
        """Reference: deployments_watcher.go PromoteDeployment."""
        check_promotion_ready(self.state, d, groups)
        self.raft_apply(
            "deployment_promote", (d.id, groups, self._new_eval(d))
        )

    def pause(self, d: Deployment, pause: bool) -> None:
        self.raft_apply(
            "deployment_status_update",
            DeploymentStatusUpdate(
                deployment_id=d.id,
                status="paused" if pause else "running",
                status_description=DESC_PAUSED if pause else DESC_RESUMED,
            ),
        )

    def fail_deployment(self, d: Deployment) -> None:
        self._fail(d, [], desc=DESC_MANUAL_FAIL)

    def _fail(
        self, d: Deployment, unhealthy_ids: list[str], desc: str = DESC_FAILED_ALLOCS
    ) -> None:
        revert_job: Optional[Job] = None
        if any(s.auto_revert for s in d.task_groups.values()):
            revert_job = self._latest_stable_job(d)
            if revert_job is not None:
                desc = DESC_FAILED_REVERT % revert_job.version
        self.raft_apply(
            "deployment_alloc_health",
            {
                "deployment_id": d.id,
                "healthy_ids": [],
                "unhealthy_ids": unhealthy_ids,
                "status_update": DeploymentStatusUpdate(
                    deployment_id=d.id,
                    status=DEPLOYMENT_STATUS_FAILED,
                    status_description=desc,
                ),
                "eval": self._new_eval(d),
                "revert_job": revert_job,
            },
        )

    # -- helpers -------------------------------------------------------

    def _healthy_deadline_ns(self, d: Deployment, alloc) -> int:
        job = alloc.job or self.state.job_by_id(d.namespace, d.job_id)
        if job is None:
            return 0
        tg = job.lookup_task_group(alloc.task_group)
        if tg is None or tg.update is None:
            return 0
        base = alloc.create_time or alloc.modify_time
        if not base:
            return 0
        return base + int(tg.update.healthy_deadline_s * 1e9)

    def _latest_stable_job(self, d: Deployment) -> Optional[Job]:
        """Most recent stable version BELOW the deployment's version
        (reference deployment_watcher.go latestStableJob)."""
        best: Optional[Job] = None
        for j in self.state.job_versions(d.namespace, d.job_id):
            if j.stable and j.version < d.job_version and (
                best is None or j.version > best.version
            ):
                best = j
        if best is None:
            return None
        revert = best.copy()
        revert.stable = True
        return revert

    def _mark_job_stable(self, d: Deployment) -> None:
        """Successful deployment marks the job version stable (reference
        deployment_watcher.go setDeploymentStatusImpl + job stability)."""
        job = self.state.job_by_id(d.namespace, d.job_id)
        if job is None or job.version != d.job_version or job.stable:
            return
        stable = job.copy()
        stable.stable = True
        self.raft_apply("job_register", (stable, None))

    def _new_eval(self, d: Deployment) -> Evaluation:
        job = self.state.job_by_id(d.namespace, d.job_id)
        return Evaluation(
            id=generate_uuid(),
            namespace=d.namespace,
            priority=job.priority if job else 50,
            type=job.type if job else "service",
            triggered_by=EVAL_TRIGGER_DEPLOYMENT_WATCHER,
            job_id=d.job_id,
            deployment_id=d.id,
            status=EVAL_STATUS_PENDING,
            create_time=now_ns(),
            modify_time=now_ns(),
        )
