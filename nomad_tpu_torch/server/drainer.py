"""Leader-only node drainer.

Port of ``nomad_tpu/server/drainer.py``, whole. Host code: it imports no
torch. Reference: nomad/drainer/ — drainer.go (RaftApplier :45), watch_nodes.go
(tracks draining nodes), watch_jobs.go (per-job migrate-stanza rate
limiting), drain_heap.go (deadline timers).

Redesign: one batched `run_once` pass over a single snapshot computes, for
every draining node at once, which allocs to mark `desired_transition.
migrate` — bounded per job by the migrate stanza's max_parallel — plus
which nodes are done draining. A poll thread drives it; tests call
`run_once` directly.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from ..structs import Evaluation, generate_uuid, now_ns
from ..structs.structs import (
    ALLOC_CLIENT_STATUS_RUNNING,
    EVAL_STATUS_PENDING,
    EVAL_TRIGGER_NODE_DRAIN,
    JOB_TYPE_BATCH,
    JOB_TYPE_SERVICE,
    JOB_TYPE_SYSBATCH,
    JOB_TYPE_SYSTEM,
    DesiredTransition,
)

logger = logging.getLogger("nomad_tpu_torch.drainer")


class NodeDrainer:
    def __init__(self, state, raft_apply, poll_interval_s: float = 0.25) -> None:
        self.state = state
        self.raft_apply = raft_apply
        self.poll_interval_s = poll_interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        # Fresh Event per incarnation: a thread that outlives a
        # join(timeout) keeps polling ITS event (passed as arg) and still
        # exits, instead of seeing a cleared shared flag and resuming.
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(self._stop,), daemon=True, name="node-drainer"
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
                logger.exception("drainer pass failed")

    # -- the batched drain pass ----------------------------------------

    def run_once(self) -> int:
        """Returns the number of allocs newly marked for migration."""
        draining = [n for n in self.state.nodes() if n.drain]
        if not draining:
            return 0

        transitions: dict[str, DesiredTransition] = {}
        eval_jobs: set[tuple[str, str]] = set()
        done_nodes: dict[str, None] = {}

        # Candidate allocs to mark, grouped per task group across ALL
        # draining nodes; the migrate budget is per task group, not per
        # node (reference watch_jobs.go handleTaskGroup).
        candidates: dict[tuple[str, str, str], list] = {}
        jobs: dict[tuple[str, str, str], object] = {}

        for node in draining:
            strategy = node.drain_strategy
            force = strategy.deadline_expired()
            remaining = []
            for a in self.state.allocs_by_node(node.id):
                if a.terminal_status():
                    continue
                # Prefer the CURRENT job from state: a live migrate-stanza
                # change (e.g. raising max_parallel mid-drain) must take
                # effect; the alloc's embedded job is placement-time stale.
                job = self.state.job_by_id(a.namespace, a.job_id) or a.job
                system = job is not None and job.type in (
                    JOB_TYPE_SYSTEM,
                    JOB_TYPE_SYSBATCH,
                )
                if system and strategy.ignore_system_jobs:
                    continue
                remaining.append((a, job, system))

            if not remaining:
                done_nodes[node.id] = None
                continue
            service_left = [r for r in remaining if not r[2]]

            for a, job, system in remaining:
                if a.desired_transition.should_migrate():
                    continue  # already marked
                if system and service_left and not force:
                    # System allocs are only stopped once every service
                    # alloc has drained (reference drainer.go: system
                    # drains last) or at the deadline.
                    continue
                if force:
                    transitions[a.id] = DesiredTransition(migrate=True)
                    eval_jobs.add((a.namespace, a.job_id))
                    continue
                if job is not None and job.type == JOB_TYPE_BATCH:
                    # Batch allocs are never migrated by the rate-limited
                    # path — they run to completion (or the deadline);
                    # the node stays draining meanwhile (reference
                    # watch_jobs.go: "We don't mark batch for drain").
                    continue
                key = (a.namespace, a.job_id, a.task_group)
                candidates.setdefault(key, []).append(a)
                jobs[key] = job

        # Rate-limited marking: an alloc already drained off a draining
        # node keeps holding a max_parallel slot until its REPLACEMENT
        # reports health — expressed as the reference does it: allowed new
        # marks = healthy-anywhere − (group count − max_parallel)
        # (reference watch_jobs.go handleTaskGroup thresholdCount;
        # "healthy" there is IsHealthy — healthy==true — on any
        # non-terminal alloc; allocs without a deployment fall back to
        # client running status).
        for key, allocs in candidates.items():
            ns, job_id, tg_name = key
            job = jobs[key]
            limit = self._max_parallel(job, tg_name)
            count = self._group_count(job, tg_name)
            healthy = 0
            for a in self.state.allocs_by_job(ns, job_id):
                if a.terminal_status() or a.task_group != tg_name:
                    continue
                if a.desired_transition.should_migrate():
                    # Marked but not yet stopped by the scheduler: it is
                    # mid-migration and holds its slot (the reference sees
                    # these as terminal by the time its watcher re-fires).
                    continue
                ds = a.deployment_status
                if (ds is not None and ds.healthy is True) or (
                    ds is None and a.client_status == ALLOC_CLIENT_STATUS_RUNNING
                ):
                    healthy += 1
            allowed = healthy - (count - limit)
            for a in allocs[: max(0, allowed)]:
                transitions[a.id] = DesiredTransition(migrate=True)
                eval_jobs.add((ns, job_id))

        if transitions or done_nodes:
            evals = [
                self._drain_eval(ns, job_id) for ns, job_id in sorted(eval_jobs)
            ]
            if transitions:
                self.raft_apply(
                    "alloc_update_desired_transition", (transitions, evals)
                )
            if done_nodes:
                # Drain complete: drop the strategy, node stays ineligible
                # (reference watch_nodes.go Remove + batcher).
                self.raft_apply(
                    "batch_node_drain_update",
                    {node_id: None for node_id in done_nodes},
                )
        return len(transitions)

    def _max_parallel(self, job, group: str) -> int:
        if job is None:
            return 1
        tg = job.lookup_task_group(group)
        if tg is None or tg.migrate is None:
            return 1
        return max(1, tg.migrate.max_parallel)

    def _group_count(self, job, group: str) -> int:
        if job is None:
            return 1
        tg = job.lookup_task_group(group)
        return tg.count if tg is not None else 1

    def _drain_eval(self, namespace: str, job_id: str) -> Evaluation:
        job = self.state.job_by_id(namespace, job_id)
        return Evaluation(
            id=generate_uuid(),
            namespace=namespace,
            priority=job.priority if job else 50,
            type=job.type if job else JOB_TYPE_SERVICE,
            triggered_by=EVAL_TRIGGER_NODE_DRAIN,
            job_id=job_id,
            status=EVAL_STATUS_PENDING,
            create_time=now_ns(),
            modify_time=now_ns(),
        )
