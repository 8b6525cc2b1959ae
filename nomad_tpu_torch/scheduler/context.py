"""Per-evaluation scheduling context and caches.

Reference: scheduler/context.go — EvalContext :76, ProposedAllocs :120,
EvalEligibility :190. The context carries the state snapshot, the plan being
built, per-eval regex/version caches, the computed-class eligibility
memoization that lets feasibility run once per node class instead of once per
node, and the eval's random source (node shuffles, dynamic port draws).
"""

from __future__ import annotations

import random
import re
from typing import Optional

from ..structs import Allocation, Plan
from ..structs.funcs import filter_terminal_allocs
from ..structs.node_class import escaped_constraint_target

# Eligibility states for (job/tg, class) pairs.
ELIGIBILITY_UNKNOWN = 0
ELIGIBILITY_ELIGIBLE = 1
ELIGIBILITY_INELIGIBLE = 2
ELIGIBILITY_ESCAPED = 3  # constraints reference unique attrs; no memoization


class SchedulerConfig:
    """Cluster-operator scheduler knobs (reference: structs/operator.go
    SchedulerConfiguration, applied at rank.go:164-170)."""

    def __init__(
        self,
        algorithm: str = "binpack",  # binpack | spread
        preemption_service: bool = True,
        preemption_batch: bool = False,
        preemption_system: bool = True,
        preemption_sysbatch: bool = False,
        backend: str = "gpu",  # gpu | host — which placement backend to use
        small_batch_threshold: int = 48,
        mesh_devices: Optional[int] = None,
        micro_solve_threshold: Optional[int] = None,
        device: str = "cuda",
        memory_oversubscription: bool = False,
    ) -> None:
        import os

        # The torch device the batch solver's tensors and kernels live
        # on: "cuda" (the hand-written kernels on the card) unless the
        # caller asks for "cpu" (the kernels' plain PyTorch twins).
        self.device = device

        # Host microsolve bound (the interactive fast path): a small
        # batch whose node-count x group-count product is at or below
        # this solves with the numpy compact kernel (scheduler/gpu/
        # microsolve.py) — dense-path semantics, zero device round-trip.
        # 0 disables (every small batch keeps the host iterator stack);
        # NOMAD_TPU_MICRO_NG overrides.
        if micro_solve_threshold is None:
            micro_solve_threshold = int(
                os.environ.get("NOMAD_TPU_MICRO_NG", "8192") or 0
            )
        self.micro_solve_threshold = micro_solve_threshold

        # Mesh: split the solve's node axis into this many shards over
        # the visible cards of `device` (scheduler/gpu/sharding.py;
        # NOMAD_TPU_MESH_DEVICES overrides). 0 = the single-card route.
        if mesh_devices is None:
            mesh_devices = int(
                os.environ.get("NOMAD_TPU_MESH_DEVICES", "0") or 0
            )
        self.mesh_devices = mesh_devices

        self.algorithm = algorithm
        self.preemption_service = preemption_service
        self.preemption_batch = preemption_batch
        self.preemption_system = preemption_system
        self.preemption_sysbatch = preemption_sysbatch
        # "gpu": the batch solver's schedulers (scheduler/gpu), on
        # `device`; "host": the iterator stack alone. new_scheduler
        # reads it.
        if backend not in ("gpu", "host"):
            raise ValueError(f"unknown scheduler backend {backend!r}")
        self.backend = backend
        # Whether a task's memory_max_mb survives job admission (the
        # server's register and plan strip it otherwise: Server.
        # apply_memory_oversubscription_gate).
        self.memory_oversubscription = memory_oversubscription
        # Batches asking for fewer total placements than this skip the
        # tensor solve: the device round-trip dominates tiny solves, so
        # they run the host iterator stack instead (reference per-eval
        # latency: scheduler/generic_sched.go:125).
        self.small_batch_threshold = small_batch_threshold

    def preemption_enabled(self, scheduler_type: str) -> bool:
        return {
            "service": self.preemption_service,
            "batch": self.preemption_batch,
            "system": self.preemption_system,
            "sysbatch": self.preemption_sysbatch,
        }.get(scheduler_type, False)


class EvalEligibility:
    """Computed-class feasibility memo (reference: context.go:190)."""

    def __init__(self) -> None:
        self.job: dict[str, int] = {}  # class -> eligibility
        self.job_escaped = False
        self.tg: dict[str, dict[str, int]] = {}  # tg -> class -> eligibility
        self.tg_escaped: dict[str, bool] = {}
        self.quota_reached: str = ""

    def set_job(self, job) -> None:
        self.job_escaped = any(
            escaped_constraint_target(c.ltarget) for c in job.constraints
        )
        for tg in job.task_groups:
            escaped = any(escaped_constraint_target(c.ltarget) for c in tg.constraints)
            if not escaped:
                for task in tg.tasks:
                    if any(
                        escaped_constraint_target(c.ltarget) for c in task.constraints
                    ):
                        escaped = True
                        break
            self.tg_escaped[tg.name] = escaped

    def job_status(self, klass: str) -> int:
        if self.job_escaped or not klass:
            return ELIGIBILITY_ESCAPED
        return self.job.get(klass, ELIGIBILITY_UNKNOWN)

    def set_job_eligibility(self, eligible: bool, klass: str) -> None:
        self.job[klass] = ELIGIBILITY_ELIGIBLE if eligible else ELIGIBILITY_INELIGIBLE

    def task_group_status(self, tg: str, klass: str) -> int:
        if self.tg_escaped.get(tg, False) or not klass:
            return ELIGIBILITY_ESCAPED
        return self.tg.get(tg, {}).get(klass, ELIGIBILITY_UNKNOWN)

    def set_task_group_eligibility(self, eligible: bool, tg: str, klass: str) -> None:
        self.tg.setdefault(tg, {})[klass] = (
            ELIGIBILITY_ELIGIBLE if eligible else ELIGIBILITY_INELIGIBLE
        )

    def has_escaped(self) -> bool:
        return self.job_escaped or any(self.tg_escaped.values())

    def get_classes(self) -> dict[str, bool]:
        """class -> eligible, for blocked-eval unblocking. Task-group
        verdicts outrank the job-level ones: a class that passed job
        constraints but failed every group's is NOT eligible
        (reference: context.go GetClasses)."""
        out: dict[str, bool] = {}
        for tg_classes in self.tg.values():
            for klass, status in tg_classes.items():
                if status == ELIGIBILITY_ELIGIBLE:
                    out[klass] = True
        for tg_classes in self.tg.values():
            for klass, status in tg_classes.items():
                if status == ELIGIBILITY_INELIGIBLE:
                    out.setdefault(klass, False)
        for klass, status in self.job.items():
            out.setdefault(klass, status == ELIGIBILITY_ELIGIBLE)
        return out


class EvalContext:
    """Everything one evaluation's scheduling pass needs."""

    def __init__(self, state, plan: Optional[Plan] = None, logger=None,
                 scheduler_config: Optional[SchedulerConfig] = None,
                 extra_plans: Optional[list] = None,
                 rng: Optional[random.Random] = None) -> None:
        self.state = state  # StateSnapshot
        self.plan = plan
        # Other in-flight plans of the SAME batch solve (the small-batch
        # host path): proposed-alloc accounting must see their placements
        # or two evals in one batch double-book a node — the dense path
        # coordinates through its shared caches instead.
        self.extra_plans = extra_plans or []
        self.logger = logger
        self.scheduler_config = scheduler_config or SchedulerConfig()
        self._regex_cache: dict[str, re.Pattern] = {}
        self._version_cache: dict[str, object] = {}
        self.eligibility = EvalEligibility()
        self.metrics_nodes_evaluated = 0
        # Every random draw of the eval (the stack's node shuffle, the
        # dynamic port picks) comes from this generator: the caller's,
        # so a run can be replayed from a seed, or a fresh one.
        self.rng = rng if rng is not None else random.Random()

    def set_plan(self, plan: Plan) -> None:
        self.plan = plan

    def regex(self, pattern: str) -> Optional[re.Pattern]:
        pat = self._regex_cache.get(pattern)
        if pat is None:
            try:
                pat = re.compile(pattern)
            except re.error:
                return None
            self._regex_cache[pattern] = pat
        return pat

    def proposed_allocs(self, node_id: str) -> list[Allocation]:
        """The node's allocs if the current plan were applied.

        state allocs − plan.node_update − (updated ids) + plan.node_allocation,
        terminal filtered (reference: context.go:120).
        """
        existing = self.state.allocs_by_node_terminal(node_id, False)
        plans = [self.plan] if self.plan is not None else []
        plans.extend(self.extra_plans)
        for plan in plans:
            update_ids = {a.id for a in plan.node_update.get(node_id, [])}
            preempt_ids = {a.id for a in plan.node_preemptions.get(node_id, [])}
            drop = update_ids | preempt_ids
            proposed_new = plan.node_allocation.get(node_id, [])
            new_ids = {a.id for a in proposed_new}
            existing = [a for a in existing if a.id not in drop and a.id not in new_ids]
            existing = existing + list(proposed_new)
        live, _ = filter_terminal_allocs(existing)
        return live
