"""Member side of the solver-pool tier.

Port of ``nomad_tpu/scheduler/tpu/remote_solve.py``. A pool member is any
server (follower or dedicated ``solver``-role agent) that hosts a warm
ResidentClusterState replica on its card and solves eval batches the
leader streams out over ``SolverPool.Solve``. The member never touches
raft: plan-apply authority stays with the leader, whose plan
verification catches anything a slightly stale replica solved
optimistically — the same optimistic-concurrency bet the plan queue
already makes for local solves.

What makes the tier worth having is that this state — the loaded kernel
library, the device-resident cap/used tensors, the warm eval-context
caches — lives outside the leader. Leadership churn re-points the
dispatch stream at the same warm replicas instead of cold-starting a
new worker's solver.

This module lives under scheduler/gpu and reaches the card through it;
the server-side tracker (server/solver_pool.py) imports no torch.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ... import faultplane, metrics
from ..context import SchedulerConfig
from .scheduler import solve_eval_batch_begin
from .solver import ResidentClusterState


class CollectingPlanner:
    """Planner stand-in for a remote solve: followup evals minted by
    reconcile (``results.followup_evals``) are COLLECTED and shipped
    back to the leader instead of raft-applied here — a follower's
    ``raft_apply`` would only bounce with NotLeaderError. The leader
    applies them on its own planner when the batch lands
    (RemotePendingBatch.finish)."""

    def __init__(self) -> None:
        self.followups: list = []

    def create_eval(self, eval_obj) -> None:
        self.followups.append(eval_obj)

    def update_eval(self, eval_obj) -> None:
        self.followups.append(eval_obj)


class RemoteSolver:
    """One pool member's warm solve engine.

    ``host`` is anything with a ``.state`` exposing
    ``snapshot_min_index(index, timeout_s)`` — a cluster server, or a
    plain shim whose replica is the leader's own store (a perfectly
    synced replica). The member keeps its OWN SchedulerConfig and
    ResidentClusterState: two members in one process solve on their own
    resident tensors, even on one card.

    Single-writer per member: a lock serializes solves the same way the
    leader's eval broker serializes the local worker's (the resident
    tensors are single-writer by design).

    A CUDA fault in a solve (faultplane.DeviceLost) leaves this member's
    CUDA context unusable: the member records it and answers every later
    warm or solve with an error, which the leader's dispatch counts as a
    member fault and re-solves on its host path."""

    def __init__(self, host, config: Optional[SchedulerConfig] = None,
                 node_id: str = "") -> None:
        self.host = host
        self.node_id = node_id
        self.config = config or SchedulerConfig(backend="gpu")
        self._lock = threading.Lock()
        self._resident: Optional[ResidentClusterState] = None
        # warmups counts COLD STARTS (resident-state construction): a
        # leadership change must cost the surviving members none.
        self.warmups = 0
        self.solves = 0
        self.syncs = 0
        self.in_flight = 0
        # the CUDA fault's text once the member's context died
        self.device_lost: Optional[str] = None

    def _ensure_resident(self) -> ResidentClusterState:
        if self.device_lost is not None:
            raise RuntimeError(
                f"pool member {self.node_id} lost its device: "
                f"{self.device_lost}"
            )
        if self._resident is None:
            device = self.config.device
            mesh = None
            if (getattr(self.config, "mesh_devices", 0) or 0) > 1:
                from .sharding import solver_mesh

                try:
                    mesh = solver_mesh(self.config.mesh_devices, device)
                except ValueError:
                    self.config.mesh_devices = 0
            self._resident = ResidentClusterState(device, mesh=mesh)
            self.warmups += 1
            metrics.incr("nomad.solver.pool.warmups")
        return self._resident

    @property
    def last_sync(self) -> str:
        return self._resident.last_sync if self._resident else "cold"

    def warm(self, min_index: int = 0,
             datacenters: tuple = ("*",)) -> str:
        """Periodic delta sync (the member's sync loop): pull the local
        replica forward and ship only the changed usage rows to the
        device. ``ready_nodes_in_dcs`` iterates the store's node table
        in a stable order, so the ``("*",)`` warm universe carries the
        same (id, modify_index) fingerprint as a matching solve's dc
        set — the first dispatched batch after a warm hits the delta
        path, not a full re-upload."""
        with self._lock:
            resident = self._ensure_resident()
            snapshot = self.host.state.snapshot_min_index(
                min_index, timeout_s=2
            )
            nodes, _ = resident.ready_nodes(snapshot, tuple(datacenters))
            if nodes:
                staging: list = []
                resident.sync(snapshot, nodes, staging)
                if staging and resident.device.type == "cuda":
                    import torch

                    # the delta's pinned staging buffers live until the
                    # copies that read them are done
                    torch.cuda.current_stream(resident.device).synchronize()
            self.syncs += 1
            return resident.last_sync

    def solve(self, evals: list, min_index: int,
              extra_usage: Optional[dict] = None,
              timeout_s: float = 5.0) -> dict:
        """One dispatched batch: wait for the local replica to reach the
        leader's snapshot index, solve on the warm resident state, and
        return the plan columns + collected followup evals. Raises if
        the replica can't catch up in time — the leader's dispatch
        fault path (host fallback) covers it."""
        self.in_flight += 1
        try:
            with self._lock:
                resident = self._ensure_resident()
                snapshot = self.host.state.snapshot_min_index(
                    min_index, timeout_s=timeout_s
                )
                planner = CollectingPlanner()
                t0 = time.perf_counter()
                try:
                    pending = solve_eval_batch_begin(
                        snapshot, planner, evals, self.config,
                        resident=resident, extra_usage=extra_usage,
                    )
                    plans = pending.finish()
                except faultplane.DeviceLost as e:
                    self.device_lost = str(e)
                    metrics.incr("nomad.solver.pool.device_lost")
                    raise
                dt = time.perf_counter() - t0
                self.solves += 1
                metrics.incr("nomad.solver.pool.solves")
                metrics.observe("nomad.solver.pool.solve_seconds", dt)
                return {
                    "plans": plans,
                    "followups": planner.followups,
                    "telemetry": {
                        "member": self.node_id,
                        "last_sync": resident.last_sync,
                        "used_micro": bool(pending.used_micro),
                        "solve_seconds": dt,
                    },
                }
        finally:
            self.in_flight -= 1

    def stats(self) -> dict:
        """Live member counters for SolverPool.Status (same
        stats_snapshot() idiom as the broker/plan-queue gauges)."""
        return {
            "node_id": self.node_id,
            "warmups": self.warmups,
            "solves": self.solves,
            "syncs": self.syncs,
            "in_flight": self.in_flight,
            "last_sync": self.last_sync,
            "resident": self._resident is not None,
            "device": str(self.config.device),
            "device_lost": self.device_lost,
        }
