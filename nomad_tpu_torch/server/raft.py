"""Replicated log + FSM layer.

Port of ``nomad_tpu/server/raft.py`` (reference: nomad/fsm.go +
hashicorp/raft): node (with drain and eligibility), job, eval, alloc
(with desired transitions), plan-result, deployment (upsert, status,
promotion, alloc health), summary-reconcile, ACL, namespace, volume
(with the watcher's claim release), service, secret, scaling-event and
operator-config entries. The snapshot-restore entry and the log's
``entries_since`` / ``snapshot_bytes`` need a log that keeps entries,
and come with replication. `InmemLog` is a single-node ordered log whose
apply path runs through the same FSM dispatch a replicated deployment
would use.

Every state mutation in the server goes through `raft_apply(type, payload)`
— nothing writes the state store directly — exactly the reference's
discipline (fsm.go:210-306 dispatch).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from .. import trace
from ..gctune import paused_gc
from ..state import StateStore
from ..structs import Allocation, Deployment, Evaluation, PlanResult


class NotLeaderError(Exception):
    """A write reached a server that is not (or no longer) the leader.
    The single-node log never raises it; the workers treat it as a
    leadership-churn signal and back off before the next attempt."""


class LeadershipLostError(NotLeaderError):
    """Leadership was lost after the entry was submitted: the write's
    outcome is unknown — it may still commit under the next leader
    (reference raft ErrLeadershipLost). The port has no replicated log
    yet, so nothing raises it; the periodic dispatcher tells it apart
    from a pre-submit NotLeaderError, as nomad_tpu's does."""


class FSM:
    """Applies committed log entries to the state store.

    Message types mirror the reference's MessageType set (structs.go:68-120
    / fsm.go dispatch) with snake_case names.
    """

    def __init__(self, state: StateStore) -> None:
        self.state = state
        # side-channels the leader wires up (reference fsm.go:746: the FSM
        # pokes the eval broker / blocked evals on apply)
        self.on_eval_update: Optional[Callable] = None
        self.on_node_update: Optional[Callable] = None
        self.on_alloc_client_update: Optional[Callable] = None
        self.on_job_upsert: Optional[Callable] = None  # periodic tracking
        self.on_volume_release: Optional[Callable] = None  # blocked-eval poke
        self._handlers = {
            "noop": lambda index, payload: None,  # leader election barrier
            "node_register": self._apply_node_register,
            # fleet-scale batch forms: one raft entry covers N nodes
            # (a fleet's registration, a heartbeat-wheel expiry storm —
            # server.py _invalidate_heartbeat_batch)
            "node_register_batch": self._apply_node_register_batch,
            "node_batch_update_status": self._apply_node_status_batch,
            "node_deregister": self._apply_node_deregister,
            "node_update_status": self._apply_node_status,
            "node_update_drain": self._apply_node_drain,
            "node_update_eligibility": self._apply_node_eligibility,
            "job_register": self._apply_job_register,
            "job_deregister": self._apply_job_deregister,
            "eval_update": self._apply_eval_update,
            "eval_delete": self._apply_eval_delete,
            "alloc_update": self._apply_alloc_update,
            "alloc_client_update": self._apply_alloc_client_update,
            "alloc_update_desired_transition": self._apply_desired_transition,
            "apply_plan_results": self._apply_plan_results,
            "apply_plan_results_batch": self._apply_plan_results_batch,
            "deployment_upsert": self._apply_deployment_upsert,
            "deployment_status_update": self._apply_deployment_status,
            "deployment_delete": self._apply_deployment_delete,
            "deployment_promote": self._apply_deployment_promote,
            "deployment_alloc_health": self._apply_deployment_alloc_health,
            "batch_node_drain_update": self._apply_batch_drain,
            "summaries_reconcile": lambda i, p: (
                self.state.reconcile_job_summaries(i)
            ),
            "acl_policy_upsert": lambda i, p: self.state.upsert_acl_policies(i, p),
            "acl_policy_delete": lambda i, p: self.state.delete_acl_policies(i, p),
            "acl_token_upsert": lambda i, p: self.state.upsert_acl_tokens(i, p),
            "acl_token_delete": lambda i, p: self.state.delete_acl_tokens(i, p),
            "namespace_upsert": lambda i, p: self.state.upsert_namespace(i, p),
            "namespace_delete": lambda i, p: self.state.delete_namespace(i, p),
            "volume_register": lambda i, p: self.state.upsert_volume(i, p),
            "volume_deregister": lambda i, p: self.state.delete_volume(
                i, p[0], p[1]
            ),
            "volume_claim_release": self._apply_volume_release,
            "service_upsert": lambda i, p: (
                self.state.upsert_service_registrations(i, p)
            ),
            "service_delete": lambda i, p: (
                self.state.delete_service_registrations(i, p)
            ),
            "service_delete_alloc": lambda i, p: (
                self.state.delete_services_by_alloc(i, p)
            ),
            "secret_upsert": lambda i, p: self.state.upsert_secret(i, p),
            "job_scaling_event": lambda i, p: (
                self.state.upsert_scaling_event(
                    i, p["namespace"], p["job_id"], p["group"], p["event"]
                )
            ),
            "operator_config_upsert": lambda i, p: (
                self.state.upsert_operator_config(i, p[0], p[1])
            ),
            "secret_delete": lambda i, p: self.state.delete_secret(
                i, p[0], p[1]
            ),
        }

    def apply(self, index: int, msg_type: str, payload) -> object:
        handler = self._handlers.get(msg_type)
        if handler is None:
            raise ValueError(f"unknown raft message type {msg_type!r}")
        return handler(index, payload)

    # -- handlers ------------------------------------------------------

    def _apply_node_register(self, index: int, node) -> None:
        self.state.upsert_node(index, node)
        if self.on_node_update:
            self.on_node_update(node)

    def _apply_node_register_batch(self, index: int, nodes: list) -> None:
        self.state.upsert_nodes(index, nodes)
        if self.on_node_update:
            for node in nodes:
                self.on_node_update(node)

    def _apply_node_status_batch(self, index: int, payload) -> None:
        node_ids, status = payload
        self.state.update_node_statuses(index, node_ids, status)
        if self.on_node_update:
            for node_id in node_ids:
                self.on_node_update(self.state.node_by_id(node_id))

    def _apply_node_deregister(self, index: int, node_id: str) -> None:
        self.state.delete_node(index, node_id)

    def _apply_node_status(self, index: int, payload) -> None:
        node_id, status = payload
        self.state.update_node_status(index, node_id, status)
        if self.on_node_update:
            self.on_node_update(self.state.node_by_id(node_id))

    def _apply_node_drain(self, index: int, payload) -> None:
        node_id, drain, mark_eligible = payload
        self.state.update_node_drain(index, node_id, drain, mark_eligible)

    def _apply_node_eligibility(self, index: int, payload) -> None:
        node_id, eligibility = payload
        self.state.update_node_eligibility(index, node_id, eligibility)
        if self.on_node_update:
            self.on_node_update(self.state.node_by_id(node_id))

    def _apply_job_register(self, index: int, payload) -> None:
        job, eval_obj = payload
        self.state.upsert_job(index, job)
        if self.on_job_upsert:
            self.on_job_upsert(
                self.state.job_by_id(job.namespace, job.id),
                (job.namespace, job.id),
            )
        if eval_obj is not None:
            self.state.upsert_evals(index, [eval_obj])
            if self.on_eval_update:
                self.on_eval_update([eval_obj])

    def _apply_job_deregister(self, index: int, payload) -> None:
        namespace, job_id, purge, eval_obj = payload
        if purge:
            self.state.delete_job(index, namespace, job_id)
        else:
            job = self.state.job_by_id(namespace, job_id)
            if job is not None:
                stopped = job.copy()
                stopped.stop = True
                self.state.upsert_job(index, stopped)
        if self.on_job_upsert:
            self.on_job_upsert(
                self.state.job_by_id(namespace, job_id), (namespace, job_id)
            )
        if eval_obj is not None:
            self.state.upsert_evals(index, [eval_obj])
            if self.on_eval_update:
                self.on_eval_update([eval_obj])

    def _apply_eval_update(self, index: int, evals: list[Evaluation]) -> None:
        self.state.upsert_evals(index, evals)
        if self.on_eval_update:
            self.on_eval_update(evals)

    def _apply_eval_delete(self, index: int, payload) -> None:
        eval_ids, alloc_ids = payload
        self.state.delete_evals(index, eval_ids, alloc_ids)

    def _apply_alloc_update(self, index: int, allocs: list[Allocation]) -> None:
        self.state.upsert_allocs(index, allocs)

    def _apply_alloc_client_update(self, index: int, allocs) -> None:
        self.state.update_allocs_from_client(index, allocs)
        if self.on_alloc_client_update:
            self.on_alloc_client_update(allocs)

    def _apply_desired_transition(self, index: int, payload) -> None:
        transitions, evals = payload
        self.state.update_alloc_desired_transition(index, transitions, evals)
        if evals and self.on_eval_update:
            self.on_eval_update(evals)

    def _apply_plan_results(self, index: int, result: PlanResult) -> None:
        self.state.upsert_plan_results(index, result)
        # Preempted jobs reschedule via their follow-up evals
        # (reference fsm.go ApplyPlanResults → upsertEvals side channel).
        if result.preemption_evals and self.on_eval_update:
            self.on_eval_update(result.preemption_evals)

    def _apply_plan_results_batch(
        self, index: int, results: list[PlanResult]
    ) -> None:
        """N node-disjoint plan results committed as one log entry (the
        batched plan applier's merged commit — one store transaction)."""
        self.state.upsert_plan_results_batch(index, results)
        evs = [e for r in results for e in r.preemption_evals]
        if evs and self.on_eval_update:
            self.on_eval_update(evs)

    def _apply_deployment_upsert(self, index: int, deployment: Deployment) -> None:
        self.state.upsert_deployment(index, deployment)

    def _apply_deployment_status(self, index: int, update) -> None:
        self.state.update_deployment_status(index, update)

    def _apply_deployment_delete(self, index: int, ids: list[str]) -> None:
        self.state.delete_deployment(index, ids)

    def _apply_deployment_promote(self, index: int, payload) -> None:
        """(deployment_id, groups|None, eval) — reference fsm.go
        ApplyDeploymentPromotion."""
        deployment_id, groups, eval_obj = payload
        self.state.update_deployment_promotion(index, deployment_id, groups, eval_obj)
        if eval_obj is not None and self.on_eval_update:
            self.on_eval_update([eval_obj])

    def _apply_deployment_alloc_health(self, index: int, payload) -> None:
        """dict payload — reference fsm.go ApplyDeploymentAllocHealth
        (health set + optional status update + optional job revert, atomic)."""
        self.state.update_alloc_deployment_health(
            index,
            payload["deployment_id"],
            payload.get("healthy_ids", []),
            payload.get("unhealthy_ids", []),
            payload.get("status_update"),
            payload.get("eval"),
            payload.get("revert_job"),
        )
        ev = payload.get("eval")
        if ev is not None and self.on_eval_update:
            self.on_eval_update([ev])

    def _apply_volume_release(self, index: int, payload) -> None:
        if isinstance(payload, dict):
            # scoped form (volume detach): one volume only
            released = self.state.release_volume_claims_scoped(
                index,
                payload["namespace"],
                payload["volume_id"],
                list(payload["alloc_ids"]),
            )
        else:
            released = self.state.release_volume_claims(
                index, list(payload)
            )
        if released and self.on_volume_release:
            # A freed claim can make a blocked single-writer job feasible
            # again; the leader re-runs blocked evals.
            self.on_volume_release()

    def _apply_batch_drain(self, index: int, payload) -> None:
        # {node_id: DrainStrategy|None}
        for node_id, drain in payload.items():
            self.state.update_node_drain(index, node_id, drain)


class InmemLog:
    """Single-node ordered log: serial, applied in memory. It keeps no
    entries: nothing in this package replicates or restores from the
    log, so encoding each entry would be work no reader needs."""

    def __init__(self, fsm: FSM, start_index: int = 0) -> None:
        self.fsm = fsm
        self._lock = threading.Lock()
        # start_index: first entry gets start_index+1 — lets a log wrap a
        # state store that already holds indexed writes (bench harnesses).
        self._index = start_index

    @property
    def last_index(self) -> int:
        with self._lock:
            return self._index

    def apply(self, msg_type: str, payload) -> int:
        """Index + apply. Returns the entry's index. The FSM applies the
        submitted payload directly (leader-direct apply): submitted
        payloads transfer ownership to the FSM, the contract the
        reference's plan-owned allocs follow (the store stamps them in
        place)."""
        from .. import metrics
        import time as _time

        tracing = trace.enabled() and trace.current() is not None
        apply_t0 = _time.monotonic_ns()
        with paused_gc():
            with self._lock:
                self._index += 1
                index = self._index
            t0 = _time.monotonic_ns() if tracing else 0
            self.fsm.apply(index, msg_type, payload)
            if tracing:
                trace.stage("fsm.apply", _time.monotonic_ns() - t0)
        # one observation per raft entry (entries batch many payloads,
        # so this is far off the per-alloc hot loop): index + fsm apply
        # — the commit half of every state mutation
        metrics.time_ns(
            "nomad.raft.apply_seconds", _time.monotonic_ns() - apply_t0
        )
        return index

    def apply_async(self, msg_type: str, payload):
        """Async-apply contract: (index, wait_fn). Single-node in-memory
        apply is synchronous, so the waiter is already resolved — the plan
        applier's pipeline degenerates to serial here, which is correct."""
        index = self.apply(msg_type, payload)
        return index, (lambda: index)
