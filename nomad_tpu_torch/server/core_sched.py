"""Core scheduler: internal `_core` evals for garbage collection.

Port of ``nomad_tpu/server/core_sched.py``: the eval, job, node,
deployment, service-registration and expired-ACL-token passes.
Reference: nomad/core_sched.go — the leader enqueues `_core` evals on a
timer (leader.go schedulePeriodic); a worker dequeues them like any other
eval and dispatches on the eval's JobID (core_sched.go:47-57): eval GC, job
GC, node GC, deployment GC, or force-GC (all at once, ignoring thresholds).
"""

from __future__ import annotations

import logging

from ..structs import Evaluation, generate_uuid, now_ns
from ..structs.structs import (
    CORE_JOB_PRIORITY,
    EVAL_STATUS_PENDING,
    JOB_STATUS_DEAD,
    JOB_TYPE_CORE,
    NODE_STATUS_DOWN,
)

logger = logging.getLogger("nomad_tpu_torch.core_sched")

CORE_JOB_EVAL_GC = "eval-gc"
CORE_JOB_JOB_GC = "job-gc"
CORE_JOB_NODE_GC = "node-gc"
CORE_JOB_DEPLOYMENT_GC = "deployment-gc"
CORE_JOB_SERVICE_GC = "service-gc"
CORE_JOB_TOKEN_GC = "token-gc"
CORE_JOB_FORCE_GC = "force-gc"

# Reference defaults (nomad/config.go): EvalGCThreshold 1h, JobGCThreshold
# 4h, DeploymentGCThreshold 1h, NodeGCThreshold 24h.
EVAL_GC_THRESHOLD_S = 3600.0
JOB_GC_THRESHOLD_S = 4 * 3600.0
NODE_GC_THRESHOLD_S = 24 * 3600.0
DEPLOYMENT_GC_THRESHOLD_S = 3600.0


def core_eval(kind: str) -> Evaluation:
    """Build a `_core` eval for the given GC kind (reference
    core_sched.go coreJobEval)."""
    return Evaluation(
        id=generate_uuid(),
        namespace="-",
        priority=CORE_JOB_PRIORITY,
        type=JOB_TYPE_CORE,
        triggered_by="scheduled",
        job_id=kind,
        status=EVAL_STATUS_PENDING,
        create_time=now_ns(),
        modify_time=now_ns(),
    )


class CoreScheduler:
    """Processes `_core` evals. Unlike the placement schedulers it mutates
    state directly through raft (reference: CoreScheduler holds *Server)."""

    def __init__(self, server, snapshot) -> None:
        self.server = server
        self.snapshot = snapshot

    def process(self, ev: Evaluation) -> None:
        kind = ev.job_id.split(":")[0]
        if kind == CORE_JOB_EVAL_GC:
            self.eval_gc()
        elif kind == CORE_JOB_JOB_GC:
            self.job_gc()
        elif kind == CORE_JOB_NODE_GC:
            self.node_gc()
        elif kind == CORE_JOB_DEPLOYMENT_GC:
            self.deployment_gc()
        elif kind == CORE_JOB_SERVICE_GC:
            self.service_gc()
        elif kind == CORE_JOB_TOKEN_GC:
            self.token_gc()
        elif kind == CORE_JOB_FORCE_GC:
            self.eval_gc(force=True)
            self.job_gc(force=True)
            self.deployment_gc(force=True)
            self.node_gc(force=True)
            self.service_gc()
            self.token_gc()
        else:
            raise ValueError(f"unknown core job {ev.job_id!r}")

    # -- GC passes -----------------------------------------------------

    def _cutoff_ns(self, threshold_s: float, force: bool) -> int:
        if force:
            return now_ns() + 1
        return now_ns() - int(threshold_s * 1e9)

    def eval_gc(self, force: bool = False) -> tuple[int, int]:
        """Delete terminal evals (and their terminal allocs) older than the
        threshold (reference core_sched.go evalGC). Batch-job evals are
        kept while the job exists so `job status` history survives."""
        cutoff = self._cutoff_ns(EVAL_GC_THRESHOLD_S, force)
        gc_evals: list[str] = []
        gc_allocs: list[str] = []
        for ev in self.snapshot.evals():
            if not ev.terminal_status() or ev.modify_time > cutoff:
                continue
            if ev.type == "batch" and not force:
                job = self.snapshot.job_by_id(ev.namespace, ev.job_id)
                if job is not None and not job.stopped():
                    continue
            allocs = self.snapshot.allocs_by_eval(ev.id)
            if any(not a.terminal_status() for a in allocs):
                continue
            old = [a for a in allocs if a.modify_time <= cutoff]
            if len(old) != len(allocs) and not force:
                continue
            gc_evals.append(ev.id)
            gc_allocs.extend(a.id for a in allocs)
        if gc_evals or gc_allocs:
            self.server.raft_apply("eval_delete", (gc_evals, gc_allocs))
        return len(gc_evals), len(gc_allocs)

    def job_gc(self, force: bool = False) -> int:
        """Purge dead jobs whose evals and allocs are all terminal and old
        (reference core_sched.go jobGC)."""
        cutoff = self._cutoff_ns(JOB_GC_THRESHOLD_S, force)
        purged = 0
        for job in self.snapshot.jobs():
            if job.status != JOB_STATUS_DEAD or job.is_periodic():
                continue
            evals = self.snapshot.evals_by_job(job.namespace, job.id)
            if any(not e.terminal_status() for e in evals):
                continue
            allocs = self.snapshot.allocs_by_job(job.namespace, job.id)
            if any(not a.terminal_status() for a in allocs):
                continue
            latest = max(
                [job.submit_time]
                + [e.modify_time for e in evals]
                + [a.modify_time for a in allocs]
            )
            if latest > cutoff:
                continue
            self.server.raft_apply(
                "job_deregister", (job.namespace, job.id, True, None)
            )
            if evals or allocs:
                self.server.raft_apply(
                    "eval_delete",
                    ([e.id for e in evals], [a.id for a in allocs]),
                )
            purged += 1
        return purged

    def node_gc(self, force: bool = False) -> int:
        """Deregister down nodes with no allocs (reference nodeGC)."""
        cutoff = self._cutoff_ns(NODE_GC_THRESHOLD_S, force)
        removed = 0
        for node in self.snapshot.nodes():
            if node.status != NODE_STATUS_DOWN:
                continue
            if node.status_updated_at > cutoff:
                continue
            if any(
                not a.terminal_status()
                for a in self.snapshot.allocs_by_node(node.id)
            ):
                continue
            self.server.raft_apply("node_deregister", node.id)
            removed += 1
        return removed

    def deployment_gc(self, force: bool = False) -> int:
        """Delete terminal deployments past the threshold (reference
        deploymentGC)."""
        cutoff = self._cutoff_ns(DEPLOYMENT_GC_THRESHOLD_S, force)
        gc: list[str] = []
        for d in self.snapshot.deployments():
            if d.active():
                continue
            if d.modify_time > cutoff:
                continue
            job = self.snapshot.job_by_id(d.namespace, d.job_id)
            if job is not None and job.version == d.job_version and not force:
                continue  # still the job's live version: keep for status
            gc.append(d.id)
        if gc:
            self.server.raft_apply("deployment_delete", gc)
        return len(gc)

    def token_gc(self) -> int:
        """Delete expired ACL tokens (reference: 1.4's
        ExpiredACLTokenGC; ours come from task-derived secrets tokens)."""
        from ..structs import now_ns as _now

        expired = self.snapshot.expired_acl_tokens(_now())
        if expired:
            self.server.raft_apply(
                "acl_token_delete", [t.accessor_id for t in expired]
            )
        return len(expired)

    def service_gc(self) -> int:
        """Drop service registrations whose alloc is terminal or gone —
        the sweep behind client-side deregistration for clients that died
        without deregistering (reference: the native-SD analog of
        core_sched's one-shot cleanups)."""
        orphaned: list[str] = []
        for ns_row in self.snapshot.service_names():
            for reg in self.snapshot.service_registrations(
                ns_row["namespace"], ns_row["service_name"]
            ):
                alloc = self.snapshot.alloc_by_id(reg.alloc_id)
                if alloc is None or alloc.terminal_status():
                    orphaned.append(reg.id)
        if orphaned:
            self.server.raft_apply("service_delete", orphaned)
        return len(orphaned)
