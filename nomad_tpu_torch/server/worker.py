"""Scheduler workers: dequeue evals, invoke a scheduler, submit plans.

Port of ``nomad_tpu/server/worker.py``. The batch worker keeps its
reference name, TPUBatchWorker; its batches solve on the card through
``scheduler.gpu`` (the hand-written kernels), or on their plain PyTorch
twins when the config asks for the CPU. Host code: this module imports
no torch; ``scheduler.gpu`` comes in at the batch worker's start.

Reference: nomad/worker.go — run :105, dequeueEvaluation :142,
snapshotMinIndex :228, invokeScheduler :244, SubmitPlan :277 (the Planner
implementation backed by the plan queue).

Two worker flavors:
  * Worker — the reference-shaped loop: one eval at a time through the
    scheduler factory (host or GPU backend per SchedulerConfig).
  * TPUBatchWorker — drains many ready evals and solves them in ONE tensor
    batch (scheduler/gpu solve_eval_batch), submitting one plan per eval.
    This is what the ≥20x throughput target rides on: the broker's per-job
    serialization still holds (each dequeued eval is a different job).
"""

from __future__ import annotations

import logging
import queue as queue_mod
import threading
import time
from concurrent.futures import CancelledError
from typing import Optional

from .. import metrics, trace
from ..retry import WORKER_POLICY
from ..scheduler import new_scheduler
from ..scheduler.context import SchedulerConfig
from ..structs import Evaluation, Plan, PlanResult
from .. import faultplane
from .raft import NotLeaderError

logger = logging.getLogger("nomad_tpu_torch.worker")

DEQUEUE_TIMEOUT_S = 0.5


def _retriable_device_error(e: BaseException) -> bool:
    """Classify a device-stage failure: retriable ⇒ the batch falls back
    to the host solve path; terminal ⇒ the existing nack path.

    Retriable is exactly one thing: an injected DeviceFault marked
    retriable (the failover scenario). Everything else is terminal: a
    real CUDA fault at the device wait or readback
    (faultplane.DeviceLost, after which every later launch fails too),
    an out-of-memory, a kernel library that fails to build or load, or
    a launch the library rejects. Each nacks like any commit error and
    never becomes a quiet host path."""
    return isinstance(e, faultplane.DeviceFault) and e.retriable


class Backpressure:
    """Couples the TPU worker's drain/batch sizing to the plan-apply
    side's health: plan-queue depth (the applier's backlog) and an EWMA
    of plan-submit latency (queue wait + verify + raft apply as the
    worker sees it). Without this, the pipelined solve stage keeps
    inflating batches an overwhelmed applier can't drain — queue depth
    and commit latency grow without bound while the solver reports
    great throughput (the overload failure mode).

    Policy: depth <= queue_hwm runs at the configured batch size; each
    unit past the hwm halves the batch (floor 1); depth >= stall_depth
    pauses dequeue entirely until the applier catches up. A submit-
    latency EWMA past latency_hwm_s halves the batch once more —
    latency-based coupling catches a slow-but-shallow queue (fsync
    stalls under fault injection) that depth alone misses."""

    def __init__(
        self,
        queue_hwm: int = 2,
        stall_depth: int = 8,
        latency_hwm_s: float = 5.0,
        alpha: float = 0.3,
    ) -> None:
        self.queue_hwm = queue_hwm
        self.stall_depth = stall_depth
        self.latency_hwm_s = latency_hwm_s
        self.alpha = alpha
        self._ewma_s = 0.0

    def note_submit_latency(self, dt_s: float) -> None:
        self._ewma_s = (
            dt_s
            if self._ewma_s == 0.0
            else self.alpha * dt_s + (1 - self.alpha) * self._ewma_s
        )

    @property
    def submit_ewma_s(self) -> float:
        return self._ewma_s

    def should_stall(self, queue_depth: int) -> bool:
        return queue_depth >= self.stall_depth

    def batch_limit(self, configured: int, queue_depth: int) -> int:
        limit = configured
        if queue_depth > self.queue_hwm:
            limit = max(1, configured >> (queue_depth - self.queue_hwm))
        if self._ewma_s > self.latency_hwm_s:
            limit = max(1, limit // 2)
        # level: 0 = wide open, 1 = fully stalled (for `operator top`)
        level = min(1.0, max(
            queue_depth / max(1, self.stall_depth),
            0.0 if self.latency_hwm_s <= 0
            else min(1.0, self._ewma_s / (2 * self.latency_hwm_s)),
        ))
        metrics.set_gauge("nomad.worker.backpressure_level", level)
        metrics.set_gauge("nomad.worker.batch_limit", limit)
        return limit


class WorkerPlanner:
    """Planner interface backed by the server's plan queue + raft apply.
    ``on_submit_latency`` — optional hook (the TPU worker installs its
    Backpressure.note_submit_latency) fed every plan-submit wall time."""

    def __init__(self, server) -> None:
        self.server = server
        self.on_submit_latency = None

    def submit_plan(self, plan: Plan):
        ctx = trace.current()
        t0 = time.perf_counter()
        with trace.span(ctx, "plan.submit") as h:
            tref = (ctx, h.span) if ctx is not None else None
            fut = self.server.plan_queue.enqueue(plan, trace_ctx=tref)
            result: PlanResult = fut.result(timeout=30)
        # queue wait + verify + raft apply, as the worker saw it
        dt = time.perf_counter() - t0
        metrics.observe("nomad.plan.submit_seconds", dt)
        if self.on_submit_latency is not None:
            self.on_submit_latency(dt)
        new_state = None
        if result.refresh_index > 0:
            with trace.span(ctx, "snapshot.refresh"):
                new_state = self.server.state.snapshot_min_index(
                    result.refresh_index, timeout_s=5
                )
        return result, new_state

    def submit_plan_batch(self, plans: list[Plan]) -> list[PlanResult]:
        """Submit a whole batch of same-snapshot plans as one queue item;
        the applier merges the node-disjoint subset into a single raft
        apply (plan_apply.py). One snapshot wait covers every partial
        commit in the batch, so retry evals never race their own
        refresh index."""
        ctx = trace.current()
        t0 = time.perf_counter()
        with trace.span(ctx, "plan.submit", plans=len(plans)) as h:
            tref = (ctx, h.span) if ctx is not None else None
            futs = self.server.plan_queue.enqueue_batch(
                plans, trace_ctx=tref
            )
            results: list[PlanResult] = [f.result(timeout=60) for f in futs]
        dt = time.perf_counter() - t0
        metrics.observe("nomad.plan.submit_seconds", dt)
        if self.on_submit_latency is not None:
            self.on_submit_latency(dt)
        max_refresh = max((r.refresh_index for r in results), default=0)
        if max_refresh > 0:
            with trace.span(ctx, "snapshot.refresh"):
                self.server.state.snapshot_min_index(
                    max_refresh, timeout_s=5
                )
        return results

    def update_eval(self, eval_obj: Evaluation) -> None:
        self.server.raft_apply("eval_update", [eval_obj])

    def create_eval(self, eval_obj: Evaluation) -> None:
        self.server.raft_apply("eval_update", [eval_obj])

    def refresh_state(self, min_index: int):
        return self.server.state.snapshot_min_index(min_index, timeout_s=5)


class Worker:
    def __init__(
        self,
        server,
        schedulers: list[str],
        config: Optional[SchedulerConfig] = None,
        name: str = "worker",
    ) -> None:
        self.server = server
        self.schedulers = schedulers
        self.config = config or SchedulerConfig()
        self.name = name
        self.planner = WorkerPlanner(server)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.processed = 0

    def start(self) -> None:
        # Fresh Event per incarnation: a thread that outlives join(timeout)
        # (e.g. blocked in submit_plan) polls ITS event and still exits,
        # instead of seeing a cleared shared flag and resuming as a twin.
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(self._stop,), daemon=True, name=self.name
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: float = 2.0) -> None:
        if self._thread:
            self._thread.join(timeout)

    def _run(self, stop: threading.Event) -> None:
        broker = self.server.eval_broker
        # NotLeaderError backoff (retry.py): during a revoke window the
        # broker still hands out evals for a beat, and every submit
        # fails NotLeaderError — without backoff this loop nacks and
        # redequeues at full speed (the hot loop the chaos harness
        # reproduces with a leader kill). Resets on the next success.
        backoff = WORKER_POLICY.backoff()
        while not stop.is_set():
            ev, token = broker.dequeue(self.schedulers, timeout_s=DEQUEUE_TIMEOUT_S)
            if ev is None:
                continue
            t0 = time.perf_counter()
            try:
                with trace.use(broker.trace_context(ev.id)):
                    self._process(ev)
                backoff.reset()
            except (Exception, CancelledError) as e:
                # CancelledError included: a leadership revoke disables
                # the plan queue mid-submit and the cancelled future
                # raises BaseException — it must nack and back off, not
                # kill the worker thread with the eval un-nacked.
                logger.exception("%s: eval %s failed", self.name, ev.id)
                metrics.incr("nomad.worker.invoke.failed")
                try:
                    broker.nack(ev.id, token)
                except ValueError:
                    pass
                if isinstance(e, (NotLeaderError, CancelledError)):
                    metrics.incr("nomad.rpc.retry_count.worker.invoke")
                    stop.wait(backoff.next())
                continue
            # reference telemetry: nomad.worker.invoke_scheduler.<type>
            metrics.observe(
                f"nomad.worker.invoke_seconds.{ev.type}",
                time.perf_counter() - t0,
            )
            try:
                broker.ack(ev.id, token)
            except ValueError:
                pass
            self.processed += 1

    def _process(self, ev: Evaluation) -> None:
        ctx = trace.current()
        # Wait until our snapshot has caught up to the eval's creation
        # (reference: worker.go:121 snapshotMinIndex).
        wait_index = max(ev.modify_index, ev.snapshot_index)
        with trace.span(ctx, "snapshot.wait", index=wait_index):
            snapshot = self.server.state.snapshot_min_index(
                wait_index, timeout_s=5
            )
        if ev.type == "_core":
            # GC evals dispatch to the CoreScheduler, which mutates state
            # through the server's raft rather than submitting plans
            # (reference worker.go invokeScheduler: eval.Type == "_core").
            from .core_sched import CoreScheduler

            CoreScheduler(self.server, snapshot).process(ev)
            # Core evals are broker-only, never persisted (reference
            # leader.go schedulePeriodic enqueues without Raft) — acking
            # is all the cleanup they need.
            return
        sched = new_scheduler(ev.type, logger, snapshot, self.planner, self.config)
        with trace.span(ctx, "scheduler.invoke", type=ev.type):
            sched.process(ev)


class TPUBatchWorker:
    """Drains up to `batch_size` ready evals per cycle and solves them in
    one batched tensor program.

    Two-stage pipeline (docs/pipeline.md): the SOLVE stage (this worker's
    main thread) dequeues a batch, snapshots, and runs the device solve;
    the COMMIT stage (a dedicated thread) materializes plan submission,
    eval updates, and ack/nack. A bounded handoff queue of depth 1 means
    batch N+1's dequeue/lower/device dispatch overlaps batch N's plan
    commit — the same depth-1 optimistic overlap the reference plan
    applier runs (plan_apply.go:54-63), won here at the worker layer
    where the GIL releases during the device round-trip. `pipeline=False`
    degrades to the old solve-then-commit loop (the bench's
    non-overlapped comparator)."""

    def __init__(
        self,
        server,
        schedulers: list[str] = ("service", "batch"),
        batch_size: int = 64,
        config: Optional[SchedulerConfig] = None,
        pipeline: bool = True,
        lane_priority: Optional[int] = None,
    ) -> None:
        import os

        self.server = server
        self.schedulers = list(schedulers)
        self.batch_size = batch_size
        self.config = config or SchedulerConfig()
        self.planner = WorkerPlanner(server)
        # Interactive priority lane (docs/pipeline.md § Priority lanes):
        # evals at or above this priority never wait for — or ride in —
        # a mega-batch. They preempt the drain stage, solve alone
        # (usually via the host microsolve), and commit inline on the
        # solve thread, jumping ahead of the in-flight batch's commit.
        # Mirrors the broker's admission classification: the broker
        # displaces strictly-below-priority work; the lane fast-paths
        # strictly-above-default work. 0 disables the lane.
        if lane_priority is None:
            lane_priority = int(
                os.environ.get("NOMAD_TPU_LANE_PRIORITY", "60") or 0
            )
        self.lane_priority = lane_priority
        # an interactive eval pulled mid-drain, solved FIRST next
        # cycle: (eval, token, hold time — its running lane clock)
        self._held: Optional[tuple[Evaluation, str, float]] = None
        # Interactive-placement ledger: (raft index, {node_id: (cpu,
        # mem, disk)}) per lane commit that landed while a mega-batch
        # chain was in flight. A chained solve supersedes the committed
        # aggregate with the parent's used' tensor, which never saw
        # these placements — the ledger feeds them back as usage deltas
        # (solver extra_usage) so a jumped eval still places
        # conflict-free with its chained followers.
        self._lane_ledger: list[tuple[int, dict]] = []
        # plan-apply backpressure: the solve stage sizes (and stalls)
        # its drains from the applier's queue depth + submit latency
        self.backpressure = Backpressure()
        self.planner.on_submit_latency = self.backpressure.note_submit_latency
        self.pipeline = pipeline
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._cthread: Optional[threading.Thread] = None
        # depth-1 handoff: at most ONE solved batch awaits commit while
        # the next batch solves
        self._commit_q: "queue_mod.Queue" = queue_mod.Queue(maxsize=1)
        # (pending, committed_event, outcome, basis_index) of the batch
        # handed to the commit stage: while its commit is in flight, the
        # next solve chains on its device-resident used' tensor
        # (solver.py used_chain) so the two batches place conflict-free.
        # basis_index is the chain's transitive capacity basis (the
        # oldest chained ancestor's snapshot index).
        self._prev: Optional[tuple] = None
        self.processed = 0
        # Mesh (config.mesh_devices >= 1): one ResidentClusterState per
        # worker, sharded over the mesh — resident tensors are placed
        # per-shard once and steady-state solves ship only usage deltas
        # into the owning shard. Built at the first solve.
        self._resident = None
        # Solver-pool tier (server/solver_pool.py): when a cluster node
        # attaches a tracker here, mega-batch drains dispatch to warm
        # remote members instead of the local card; the interactive lane
        # and the empty-pool case keep the local path. None on a
        # standalone Server (no cluster/pool).
        self.solver_pool = None
        # set when _ensure_resident replaced an unusable mesh by one card
        self.mesh_degraded = False
        # set (to the fault's text) when a CUDA fault killed the device
        # context: the solve stage parks, so the evals wait in the broker
        # for a restarted process instead of burning their delivery limit
        self.device_lost: Optional[str] = None
        # seconds start() spent making the fastpack extension and the
        # kernel library loadable (a build on a cold cache)
        self.warm_seconds: dict[str, float] = {}
        # Shared NotLeaderError backoff across the commit stage (see
        # Worker._run): a revoke window must throttle, not hot-loop.
        self._nl_backoff = WORKER_POLICY.backoff()

    def _ensure_resident(self) -> None:
        """Build the (possibly mesh-sharded) ResidentClusterState at the
        first solve. A misconfigured mesh (more shards than the kernels
        take) must NOT raise here: the exception would nack and
        redeliver every eval forever — the cluster accepts jobs but
        never places. Degrade loudly to one card instead, and clear
        mesh_devices so the scheduler's _mesh_for doesn't re-raise the
        same error per solve. The degrade only ever changes the shard
        count: the device stays ``config.device``, and "cuda" with no
        card raises, as the port's schedulers do — it never moves to
        the CPU.

        Single-card workers get a plain ResidentClusterState too: beyond
        the resident device tensors it carries the warm eval context —
        the cached ready-node lists, host-table skeleton, and lowered-
        group skeletons that let a repeat-shaped interactive eval skip
        the node scan and lowering entirely (solver.py)."""
        if self._resident is not None:
            return
        from ..scheduler.gpu import ResidentClusterState

        device = self.config.device
        if (getattr(self.config, "mesh_devices", 0) or 0) < 1:
            self._resident = ResidentClusterState(device)
            return
        from ..scheduler.gpu.sharding import solver_mesh

        try:
            self._resident = ResidentClusterState(
                mesh=solver_mesh(self.config.mesh_devices, device)
            )
        except ValueError as exc:
            logger.error(
                "mesh_devices=%d unusable (%s); falling back to the "
                "single-card solver — fix NOMAD_TPU_MESH_DEVICES",
                self.config.mesh_devices, exc,
            )
            self.config.mesh_devices = 0
            self.mesh_degraded = True
            self._resident = ResidentClusterState(device)

    def _warm(self) -> None:
        """Make the commit path's C fastpack and (on the card) the kernel
        library loadable NOW, outside every lock and before the first
        batch is dequeued: a first build inside _solve_batch would hold
        a dequeued batch past the broker's nack timeout. A failed build
        is logged here and fails again, terminally, at the first solve
        that needs it."""
        from .. import codec

        t0 = time.perf_counter()
        codec.warm_native()
        self.warm_seconds["fastpack"] = time.perf_counter() - t0
        if self.config.backend != "gpu" or not str(
            self.config.device
        ).startswith("cuda"):
            return
        t0 = time.perf_counter()
        try:
            from ..scheduler.gpu import libkernels

            libkernels.library()
        except Exception:
            logger.exception("kernel library build failed")
        self.warm_seconds["kernels"] = time.perf_counter() - t0
        metrics.set_gauge(
            "nomad.tpu.kernels_build_seconds", self.warm_seconds["kernels"]
        )

    def start(self) -> None:
        self._warm()
        # Fresh Event + queue per incarnation (see Worker.start).
        self._stop = threading.Event()
        self._commit_q = queue_mod.Queue(maxsize=1)
        self._prev = None
        self._held = None
        self._lane_ledger = []
        self._thread = threading.Thread(
            target=self._run, args=(self._stop,), daemon=True,
            name="tpu-batch-solve"
        )
        self._thread.start()
        if self.pipeline:
            self._cthread = threading.Thread(
                target=self._commit_loop,
                args=(self._stop, self._commit_q),
                daemon=True,
                name="tpu-batch-commit",
            )
            self._cthread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None
        if self._cthread:
            # Sentinel AFTER the solve thread is down: the commit thread
            # drains every batch handed off before it (FIFO) and exits on
            # the sentinel itself — a stop racing the hand-off can never
            # strand a solved batch between the two threads' stop checks
            # (un-acked evals would hold the broker's per-job locks
            # forever; only ack/nack release them).
            try:
                self._commit_q.put(None, timeout=15)
            except queue_mod.Full:  # pragma: no cover - commit thread dead
                pass
            self._cthread.join(timeout=15)
            self._cthread = None
        # a zombie solve thread that outlived join(5) above could still
        # have slipped one batch in after the sentinel: nack it so its
        # evals redeliver instead of leaking their job locks
        while True:
            try:
                item = self._commit_q.get_nowait()
            except queue_mod.Empty:
                break
            if item is not None:
                (batch, _pending, _snapshot, committed, outcome,
                 _chain, bctx, _t_deq) = item
                self._nack_batch(batch)
                outcome["ok"] = False
                committed.set()
                if bctx is not None:
                    bctx.finish("stopped")
        # a held interactive eval never reached a solve: nack it so its
        # job's broker lock releases instead of leaking
        if self._held is not None:
            held, self._held = self._held, None
            self._nack_batch([held[:2]])
        # a stopped worker object stays referenced by the server; don't
        # let it pin the last batch's device tensors and snapshot
        self._prev = None

    def stats_snapshot(self) -> dict:
        """Live pipeline depth (same idiom as the broker/plan-queue stats
        surfaces): reads live structures only, no locks beyond the
        queue's own."""
        prev = self._prev
        return {
            "pipeline": self.pipeline,
            "batch_size": self.batch_size,
            "processed": self.processed,
            "schedulers": list(self.schedulers),
            "commit_queue_depth": self._commit_q.qsize(),
            "chain_in_flight": bool(prev is not None and not prev[1].is_set()),
            "held_interactive": self._held is not None,
            "lane_ledger_len": len(self._lane_ledger),
            "submit_ewma_s": round(self.backpressure.submit_ewma_s, 6),
            "lane_priority": self.lane_priority,
        }

    # -- solve stage ----------------------------------------------------

    def _interactive(self, ev: Evaluation) -> bool:
        """Priority-lane classification: at or above the lane priority
        an eval is interactive — it never waits for, or rides in, a
        mega-batch (the broker's admission classification's mirror:
        admission displaces strictly-below work; the lane fast-paths
        above-default work)."""
        return self.lane_priority > 0 and ev.priority >= self.lane_priority

    def _run(self, stop: threading.Event) -> None:
        broker = self.server.eval_broker
        while not stop.is_set():
            # Drop the previous batch's PendingEvalBatch once its commit
            # lands: on an idle worker it would otherwise pin the solved
            # batch's device tensors, node tables, and snapshot until the
            # next eval arrives.
            if self._prev is not None and self._prev[1].is_set():
                self._prev = None
            if self.device_lost is not None:
                stop.wait(DEQUEUE_TIMEOUT_S)
                continue
            # Backpressure gate BEFORE the blocking dequeue: while the
            # plan queue is saturated, solving more batches only grows
            # the backlog the applier is already failing to drain — the
            # evals are safer waiting in the broker (sheddable,
            # priority-ordered) than baked into solved-but-uncommitted
            # plans.
            stalled = False
            while not stop.is_set() and self.backpressure.should_stall(
                self.server.plan_queue.depth()
            ):
                if not stalled:
                    stalled = True
                    metrics.incr("nomad.worker.backpressure_throttled")
                stop.wait(0.05)
            if stop.is_set():
                break
            batch: list[tuple[Evaluation, str]] = []
            t_deq = None
            if self._held is not None:
                # the interactive eval that preempted the last drain —
                # its lane clock started when it was HELD, so the time
                # it waited through the preempting batch's phase A
                # counts (lane starvation must read off the histogram)
                ev, token, t_deq = self._held
                self._held = None
            else:
                ev, token = broker.dequeue(
                    self.schedulers, timeout_s=DEQUEUE_TIMEOUT_S
                )
            if ev is None:
                continue
            if t_deq is None:
                t_deq = time.perf_counter()
            if self._interactive(ev):
                self._run_interactive(ev, token, t_deq)
                continue
            batch.append((ev, token))
            # Effective batch size under backpressure: plan-queue depth
            # and submit-latency EWMA shrink the drain so the solver
            # stops inflating batches the applier can't absorb.
            limit = self.backpressure.batch_limit(
                self.batch_size, self.server.plan_queue.depth()
            )
            if limit < self.batch_size:
                metrics.incr("nomad.worker.backpressure_throttled")
            # One trace per BATCH (the per-eval broker traces link to it
            # via the batch attr): solve/commit stage spans are shared
            # across the whole batch, so duplicating them per eval would
            # multiply span volume by batch_size for no information.
            bctx = trace.start_trace("tpu.batch")
            with trace.span(bctx, "broker.drain"):
                # opportunistically drain more ready evals without waiting
                while len(batch) < limit:
                    ev2, token2 = broker.dequeue(
                        self.schedulers, timeout_s=0.01
                    )
                    if ev2 is None:
                        break
                    if self._interactive(ev2):
                        # lane preempts the drain: the interactive eval
                        # is never baked into this mega-batch — it jumps
                        # the line as its own solve next cycle (held
                        # with its lane clock already running)
                        self._held = (ev2, token2, time.perf_counter())
                        metrics.incr("nomad.worker.lane.drain_preempted")
                        break
                    batch.append((ev2, token2))
            if bctx is not None:
                bctx.set_attr("evals", len(batch))
                bctx.set_attr("eval_ids", [e.id for e, _ in batch])
                bctx.set_attr(
                    "job_ids", sorted({e.job_id for e, _ in batch})
                )
                for e, _ in batch:
                    broker.annotate_trace(e.id, batch=bctx.trace_id)
            try:
                with trace.use(bctx):
                    with trace.span(bctx, "solve.dispatch"):
                        pending, snapshot, chained_on = self._solve_batch(
                            [e for e, _ in batch]
                        )
            except Exception:
                logger.exception("tpu batch solve of %d failed", len(batch))
                metrics.incr("nomad.worker.invoke.failed")
                self._nack_batch(batch)
                if bctx is not None:
                    bctx.finish("solve-failed")
                continue
            # outcome["ok"] is the commit verdict the NEXT batch (which
            # may have chained on this one's used' tensor) branches on:
            # True/False once decided, None while in flight. FIFO commit
            # order guarantees it is decided before the child commits.
            outcome: dict = {"ok": None}
            if not self.pipeline:
                self._commit(
                    batch, pending, snapshot, threading.Event(),
                    outcome, chained_on, bctx, t_deq=t_deq,
                )
                continue
            committed = threading.Event()
            handed_off = False
            hspan = trace.span(bctx, "commit.handoff")
            hspan.__enter__()
            while not stop.is_set():
                try:
                    self._commit_q.put(
                        (batch, pending, snapshot, committed,
                         outcome, chained_on, bctx, t_deq),
                        timeout=0.2,
                    )
                    handed_off = True
                    break
                except queue_mod.Full:
                    continue
            hspan.__exit__(None, None, None)
            if not handed_off:
                # stopping with a solved batch that never reached the
                # commit stage: nack so the evals redeliver cleanly
                self._nack_batch(batch)
                outcome["ok"] = False
                if bctx is not None:
                    bctx.finish("stopped")
            else:
                # this batch's effective capacity basis: its own snapshot
                # unless it chained, in which case the chain's basis
                # propagates TRANSITIVELY (a chain_out tensor built on a
                # chained input is still based on the oldest ancestor's
                # snapshot — external capacity events since then are
                # masked for every descendant)
                basis = chained_on[1] if chained_on else snapshot.index
                self._prev = (pending, committed, outcome, basis)

    def _run_interactive(self, ev: Evaluation, token: str,
                         t_deq: float) -> None:
        """The interactive lane: solve one eval alone — no drain, no
        mega-batch — and commit INLINE on the solve thread, jumping
        ahead of the in-flight batch sitting in the commit queue. Small
        evals resolve via the host microsolve (zero device round-trip);
        big high-priority evals still skip the drain wait. The used'
        chain composes through the lane ledger: a committed lane
        placement that the live chain tensor never saw is fed back to
        the next chained solve as usage deltas (_solve_batch)."""
        metrics.incr("nomad.worker.lane.interactive")
        batch = [(ev, token)]
        bctx = trace.start_trace("tpu.interactive")
        if bctx is not None:
            bctx.set_attr("eval_id", ev.id)
            bctx.set_attr("job_id", ev.job_id)
            self.server.eval_broker.annotate_trace(
                ev.id, batch=bctx.trace_id
            )
        try:
            with trace.use(bctx):
                with trace.span(bctx, "solve.dispatch"):
                    # allow_chain=False: the lane commits INLINE, ahead
                    # of the in-flight parent — a chained solve here
                    # would break the FIFO guarantee that a parent's
                    # commit verdict is decided before its child's. The
                    # solve sees committed state (+ the lane ledger);
                    # the applier's verification trims any conflict
                    # with the still-uncommitted mega batch.
                    pending, snapshot, chained_on = self._solve_batch(
                        [ev], allow_chain=False
                    )
        except Exception:
            logger.exception("interactive solve of %s failed", ev.id)
            metrics.incr("nomad.worker.invoke.failed")
            self._nack_batch(batch)
            if bctx is not None:
                bctx.finish("solve-failed")
            return
        if pending.used_micro:
            metrics.incr("nomad.worker.lane.micro")
        outcome: dict = {"ok": None}
        try:
            self._commit(
                batch, pending, snapshot, threading.Event(), outcome,
                chained_on, bctx, lane="interactive", t_deq=t_deq,
            )
        except (Exception, CancelledError):
            # same backstop as _commit_loop: an escape past _commit's
            # own guards (e.g. in the post-commit lane bookkeeping)
            # must nack, not kill the solve thread — a dead solve
            # thread silently stops ALL scheduling until restart
            logger.exception("interactive commit stage hard failure")
            self._nack_batch(batch)
            outcome["ok"] = False
            if bctx is not None:
                bctx.finish("commit-failed")

    def _lane_extra_usage(self, snapshot, chained_on) -> Optional[dict]:
        """Merge lane-ledger placements this solve's capacity view would
        otherwise miss: everything newer than the chain basis (a chained
        solve reads the parent's used' tensor, frozen at the basis) or —
        unchained — newer than the snapshot. Entries old enough for
        every future view are pruned; over-inclusion in the race windows
        is deliberate (counting a visible placement twice under-fills,
        which the applier's verification never has to repair)."""
        cutoff = (
            chained_on[1] if chained_on is not None else snapshot.index
        )
        if not self._lane_ledger:
            return None
        keep = min(cutoff, snapshot.index)
        if self._prev is not None and not self._prev[1].is_set():
            # a LIVE chain pins the prune horizon: this solve may not
            # need an entry, but the next chained solve reads from the
            # in-flight parent's (older) basis and still does
            keep = min(keep, self._prev[3])
        if keep > 0:
            self._lane_ledger = [
                e for e in self._lane_ledger if e[0] > keep
            ]
        merged: dict[str, tuple] = {}
        for idx, deltas in self._lane_ledger:
            if idx <= cutoff:
                continue
            for nid, v in deltas.items():
                cur = merged.get(nid)
                merged[nid] = (
                    v
                    if cur is None
                    else (cur[0] + v[0], cur[1] + v[1], cur[2] + v[2])
                )
        return merged or None

    @staticmethod
    def _plan_usage_deltas(plans: dict) -> dict:
        """Per-node (cpu, mem, disk) usage added by a set of plans —
        eager rows and SoA batch columns alike (stops are ignored:
        under-counting freed capacity only under-fills)."""
        out: dict[str, list] = {}
        for plan in plans.values():
            for nid, allocs in plan.node_allocation.items():
                for a in allocs:
                    r = a.comparable_resources()
                    d = out.get(nid)
                    if d is None:
                        d = out[nid] = [0, 0, 0]
                    d[0] += r.cpu
                    d[1] += r.memory_mb
                    d[2] += r.disk_mb
            for b in plan.alloc_batches:
                c = b.row_contribution()
                for nid, _ti, cnt in b.touched_nodes():
                    d = out.get(nid)
                    if d is None:
                        d = out[nid] = [0, 0, 0]
                    d[0] += c[0] * cnt
                    d[1] += c[1] * cnt
                    d[2] += c[2] * cnt
        return {k: tuple(v) for k, v in out.items()}

    def _solve_batch(self, evals: list[Evaluation],
                     allow_chain: bool = True):
        """Phase A: snapshot + reconcile + lower + async device dispatch.
        Returns the PendingEvalBatch whose finish() (run on the commit
        stage) blocks on the device and materializes the plans.
        allow_chain=False (the interactive lane) never consumes the
        in-flight parent's used' tensor — lane solves commit ahead of
        the parent, outside the FIFO the chain verdict relies on."""
        from ..scheduler.gpu import solve_eval_batch_begin

        wait_index = max(
            max(ev.modify_index for ev in evals),
            max(ev.snapshot_index for ev in evals),
        )
        with trace.span(trace.current(), "snapshot.wait", index=wait_index):
            snapshot = self.server.state.snapshot_min_index(
                wait_index, timeout_s=5
            )
        # Chain on the in-flight batch's post-solve usage tensor ONLY
        # while its commit is pending: once committed, the snapshot's
        # aggregate already carries those placements and the chain would
        # just mask newer external writes.
        chain = None
        chained_on = None
        if self._prev is not None:
            prev_pending, committed, prev_outcome, prev_basis = self._prev
            if committed.is_set():
                # drop a committed parent regardless of lane: a stream
                # of interactive solves must not keep the last mega
                # batch's device tensors and snapshot pinned
                self._prev = None
            elif allow_chain:
                chain = prev_pending.chain
                # (parent's commit-verdict holder, the chain's BASIS
                # index). The basis is the parent's own basis — NOT its
                # snapshot index — so it propagates transitively through
                # multi-hop chains: capacity freed after the oldest
                # ancestor's snapshot is masked by the chained used'
                # tensor, so any blocked eval this solve mints must watch
                # for unblocks from that index or a capacity event in the
                # gap is treated as already seen and the eval strands.
                chained_on = (prev_outcome, prev_basis)
        t0 = time.perf_counter()
        if faultplane.plane is not None:
            # injected dispatch-stage fault: surfaces through the solve
            # stage's existing failure path (nack + redeliver)
            faultplane.plane.on_device("dispatch")
        # Dispatch policy (server/solver_pool.py): mega-batch drains route
        # to the solver pool when a healthy member exists; the
        # interactive lane (allow_chain=False — the host-microsolve
        # path) always solves locally. A remote batch never consumes
        # the local used' chain: overlapping remote solves serialize
        # through the applier's plan verification instead, so
        # chained_on is dropped (the parent's verdict must not nack a
        # batch that never saw its tensor).
        if allow_chain and self.solver_pool is not None:
            with trace.span(
                trace.current(), "solver.pool.dispatch", evals=len(evals)
            ):
                remote = self.solver_pool.dispatch_batch(
                    evals, snapshot, self.planner, self.config,
                    extra_usage=self._lane_extra_usage(snapshot, None),
                )
            if remote is not None:
                metrics.observe("nomad.tpu.batch_evals", len(evals))
                metrics.observe(
                    "nomad.tpu.batch_dispatch_seconds",
                    time.perf_counter() - t0,
                )
                return remote, snapshot, None
        self._ensure_resident()
        pending = solve_eval_batch_begin(
            snapshot, self.planner, evals, self.config, used_chain=chain,
            resident=self._resident,
            extra_usage=self._lane_extra_usage(snapshot, chained_on),
        )
        if chained_on is not None and not pending.chain_accepted:
            # the solver took a path that never consumed the chain (host
            # partition, resident tensors, node-universe mismatch): this
            # solve saw only committed state, so the parent's commit
            # verdict must not nack it and its blocked evals need no
            # older basis index
            chained_on = None
        if chained_on is not None:
            # a batch solved on the in-flight parent's used' tensor
            metrics.incr("nomad.tpu.chained_batches")
        metrics.observe("nomad.tpu.batch_evals", len(evals))
        metrics.observe(
            # renamed from batch_solve_seconds when the pipeline split
            # landed: this now times ONLY phase A (reconcile + lower +
            # async dispatch) — device wait and materialization moved to
            # the commit stage's device/materialize/commit timers
            "nomad.tpu.batch_dispatch_seconds", time.perf_counter() - t0
        )
        return pending, snapshot, chained_on

    # -- commit stage ---------------------------------------------------

    def _commit_loop(
        self, stop: threading.Event, cq: "queue_mod.Queue"
    ) -> None:
        # Exits ONLY on the stop() sentinel, never on a bare stop-flag
        # check: the FIFO guarantees every batch handed off before the
        # sentinel is committed (or nacked by _commit's failure path)
        # first, so no solved batch is ever stranded with its evals
        # un-acked.
        while True:
            item = cq.get()
            if item is None:
                return
            (batch, pending, snapshot, committed, outcome,
             chained_on, bctx, t_deq) = item
            try:
                self._commit(
                    batch, pending, snapshot, committed, outcome,
                    chained_on, bctx, t_deq=t_deq,
                )
            except (Exception, CancelledError):
                # _commit has its own guards; this is the backstop that
                # keeps the commit thread alive no matter what — a dead
                # commit thread strands every later batch with its evals
                # un-acked (per-job broker locks leak forever)
                logger.exception("tpu commit stage hard failure")
                self._nack_batch(batch)
                outcome["ok"] = False
                committed.set()
                if bctx is not None:
                    bctx.finish("commit-failed")

    def _lose_device(self, e: BaseException) -> None:
        """A CUDA fault at the device wait or readback: the context is
        dead, so every later solve on it would fail. Mark the worker
        unhealthy and park its solve stage (_run) until a restart."""
        if self.device_lost is None:
            logger.critical(
                "CUDA fault at the device stage (%s); the batch worker "
                "stops dequeuing until the process restarts", e,
            )
            metrics.incr("nomad.worker.device_lost")
            metrics.set_gauge("nomad.worker.healthy", 0)
        self.device_lost = str(e)

    def _nack_batch(self, batch: list[tuple[Evaluation, str]]) -> None:
        broker = self.server.eval_broker
        for ev_, tok in batch:
            try:
                broker.nack(ev_.id, tok)
            except ValueError:
                pass

    def _commit(
        self, batch, pending, snapshot, committed, outcome, chained_on,
        bctx=None, lane: str = "batch", t_deq: Optional[float] = None,
    ) -> None:
        broker = self.server.eval_broker
        if chained_on is not None and chained_on[0].get("ok") is False:
            # This batch solved against the used' tensor of a batch whose
            # commit then FAILED: its view baked in placements that never
            # landed, so near-full nodes look occupied that are free —
            # committing would mint blocked evals waiting on a capacity
            # event that never comes. Nack instead: the evals redeliver
            # and re-solve against a clean snapshot. (FIFO commit order
            # means the parent's verdict is always decided by now.)
            metrics.incr("nomad.tpu.chain_parent_failed")
            self._nack_batch(batch)
            outcome["ok"] = False
            committed.set()
            if bctx is not None:
                bctx.finish("chain-parent-failed")
            return
        used_fallback = False
        try:
            with trace.use(bctx):
                # phase B: block on the device, read back, materialize
                # plans (device/readback/materialize stage timers become
                # spans via the solver's trace.stage calls); then the
                # plan submit is timed as the commit stage proper
                try:
                    with trace.span(bctx, "commit.finish"):
                        if faultplane.plane is not None:
                            faultplane.plane.on_device("finish")
                        plans = pending.finish()
                except (Exception, CancelledError) as de:
                    if not _retriable_device_error(de):
                        raise
                    # Graceful degradation: the device stage died but the
                    # batch's reconcile output is intact — re-solve the
                    # same asks on the host oracle path. A sick device
                    # costs throughput, not the pipeline.
                    logger.warning(
                        "device stage failed (%s: %s); falling back to "
                        "host solve for %d evals",
                        type(de).__name__, de, len(batch),
                    )
                    metrics.incr("nomad.worker.device_failover")
                    with trace.span(
                        bctx, "device.failover", error=type(de).__name__
                    ):
                        plans = pending.solve_host_fallback()
                    used_fallback = True
                t0 = time.perf_counter()
                all_full = self._commit_batch(
                    [e for e, _ in batch], plans, snapshot,
                    blocked_basis=chained_on[1] if chained_on else None,
                )
        except (Exception, CancelledError) as e:
            # CancelledError included: plan futures cancelled by a queue
            # disable (leadership loss) are BaseException since py3.8 and
            # must still nack, not kill the commit thread
            logger.exception("tpu batch commit of %d failed", len(batch))
            metrics.incr("nomad.worker.invoke.failed")
            self._nack_batch(batch)
            outcome["ok"] = False
            if bctx is not None:
                bctx.finish("commit-failed")
            if isinstance(e, faultplane.DeviceLost):
                self._lose_device(e)
            if isinstance(e, (NotLeaderError, CancelledError)):
                # leadership churn: throttle instead of hot-looping the
                # solve→commit→nack cycle until the revoke lands
                metrics.incr("nomad.rpc.retry_count.worker.submit")
                self._stop.wait(self._nl_backoff.next())
            return
        finally:
            # chain cutoff: the solve stage stops chaining on this batch
            # the moment its effects are (or will never be) committed
            committed.set()
        self._nl_backoff.reset()
        # A partial commit is a failed verdict for chaining purposes: the
        # trimmed placements are in the chained used' tensor but never
        # landed, so a follower that baked them in must re-solve too.
        # A host fallback is too: the committed placements came from the
        # host oracle, not the device tensor a chained child consumed.
        outcome["ok"] = all_full and not used_fallback
        if not all_full:
            metrics.incr("nomad.tpu.partial_commits")
        # commit_seconds joins the solver's host_prep/device/readback/
        # materialize stage registry: the full commit half of the pipeline
        metrics.observe(
            "nomad.tpu.commit_seconds", time.perf_counter() - t0
        )
        if lane == "interactive":
            # lane-ledger record: an interactive commit that landed
            # while a mega-batch chain is in flight is invisible to the
            # chained used' tensor — remember its per-node deltas so the
            # next chained solve counts them (committed.is_set() is the
            # chain cutoff the solve stage branches on; runs on the
            # solve thread, so the ledger stays single-threaded)
            if self._prev is not None and not self._prev[1].is_set():
                deltas = self._plan_usage_deltas(plans)
                if deltas:
                    self._lane_ledger.append(
                        (self.server.state.latest_index(), deltas)
                    )
                    del self._lane_ledger[:-64]
        if t_deq is not None:
            lane_dt = time.perf_counter() - t_deq
            if lane == "interactive":
                metrics.observe(
                    "nomad.worker.lane.interactive_seconds", lane_dt
                )
            else:
                metrics.observe("nomad.worker.lane.batch_seconds", lane_dt)
        with trace.span(bctx, "eval.ack"):
            for ev_, tok in batch:
                try:
                    broker.ack(ev_.id, tok)
                except ValueError:
                    pass
        if bctx is not None:
            bctx.finish("ok" if all_full else "partial")
        self.processed += len(batch)

    def _commit_batch(
        self, evals: list[Evaluation], plans, snapshot,
        blocked_basis: Optional[int] = None,
    ) -> bool:
        # One merged submission for the whole batch (the applier commits
        # the node-disjoint subset as a single raft apply + bulk store
        # transaction, serial-fallback for conflicting plans). Returns
        # whether EVERY plan committed in full — a trimmed plan means the
        # chained used' tensor carries placements that never landed.
        # blocked_basis — for a CHAINED solve, the parent's snapshot
        # index: blocked evals must not mark capacity events between the
        # chain basis and this snapshot as already seen.
        submit = [
            (ev, plans[ev.id]) for ev in evals if not plans[ev.id].is_no_op()
        ]
        results: dict[str, PlanResult] = {}
        if submit:
            got = self.planner.submit_plan_batch([p for _, p in submit])
            results = {ev.id: r for (ev, _), r in zip(submit, got)}
        all_full = True
        updates: list[Evaluation] = []
        for ev in evals:
            plan = plans[ev.id]
            failed = dict(ev.failed_tg_allocs)
            blocked: Optional[Evaluation] = None
            result = results.get(ev.id)
            if result is not None:
                full, _, _ = result.full_commit(plan)
                if not full:
                    all_full = False
                    # partial commit: requeue the eval for a fresh pass
                    retry = ev.copy()
                    retry.status = "pending"
                    retry.snapshot_index = result.refresh_index
                    self.planner.create_eval(retry)
                    continue
            if failed:
                blocked = ev.create_blocked_eval({}, True, "", failed)
                blocked.snapshot_index = (
                    blocked_basis
                    if blocked_basis is not None
                    else snapshot.index
                )
                blocked.status_description = "created to place remaining allocations"
                self.planner.create_eval(blocked)
            done = ev.copy()
            done.status = "complete"
            done.failed_tg_allocs = failed
            if blocked is not None:
                done.blocked_eval = blocked.id
            updates.append(done)
        if updates:
            self.server.raft_apply("eval_update", updates)
        return all_full
