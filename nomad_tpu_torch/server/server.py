"""The server: replicated state + leader-only scheduling subsystems.

Port of ``nomad_tpu/server/server.py``. The pipeline: the FSM and its
log, the eval broker, blocked evals, the heartbeat wheel, the plan queue
and applier, and the workers, wired as the reference wires them
(reference: nomad/server.go, nomad/leader.go:224 establishLeadership,
nomad/node_endpoint.go, nomad/job_endpoint.go).
``use_tpu_batch_worker=True`` puts the service and batch evals on the
TPUBatchWorker, which solves them on the card; system, sysbatch and
``_core`` evals go to a plain Worker (a ``_core`` eval runs the
CoreScheduler's GC passes; the GC timer and ``force_gc`` enqueue them).
The job lifecycle rides on it: job admission (Connect sidecar injection,
the memory-oversubscription gate, the Vault policy allowlist, the cron
check, the broker's saturation guard, the namespace check), job plan,
scale (with its scaling-event log), revert, dispatch and force-evaluate,
alloc stop, the deployment endpoints with the deployment watcher, node
drain and eligibility with the node drainer, the periodic dispatcher,
and the GC timer. Tenancy and the cluster tables: namespaces (``default``
bootstrapped at leadership), ACL policies and tokens with
``resolve_token``, CSI and host volumes with their claims and the volume
watcher, service registrations, secrets and Vault task tokens, the event
stream (every store write published to ``event_broker``), the alloc
watch hub behind ``get_client_allocs`` and the node-register batcher.
The metrics providers (they feed the agent's ``/v1/metrics``), the
replay barrier and ``set_raft_applier`` (they come with replication)
stay with the reference.

Every mutation flows through raft_apply. The endpoint methods here are
what an RPC layer would call.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from .. import blackbox, metrics, trace
from ..scheduler.context import SchedulerConfig
from ..state import StateStore
from ..state.events import wire_events
from ..stream import EventBroker
from ..structs import (
    Allocation,
    DrainStrategy,
    Evaluation,
    Job,
    generate_uuid,
    now_ns,
)
from ..structs.structs import (
    ALLOC_CLIENT_STATUS_FAILED,
    DEFAULT_NAMESPACE,
    EVAL_STATUS_BLOCKED,
    EVAL_STATUS_PENDING,
    EVAL_TRIGGER_JOB_DEREGISTER,
    EVAL_TRIGGER_JOB_REGISTER,
    EVAL_TRIGGER_NODE_DRAIN,
    EVAL_TRIGGER_NODE_UPDATE,
    EVAL_TRIGGER_RETRY_FAILED_ALLOC,
    JOB_TYPE_CORE,
    JOB_TYPE_SERVICE,
    NODE_STATUS_DOWN,
    NODE_STATUS_READY,
)
from .blocked_evals import BlockedEvals
from .core_sched import core_eval
from .deployment_watcher import DeploymentsWatcher
from .drainer import NodeDrainer
from .eval_broker import EvalBroker
from .heartbeat import HeartbeatWheel
from .periodic import PeriodicDispatch
from .plan_apply import PlanApplier
from .plan_queue import PlanQueue
from .raft import FSM, InmemLog
from .volume_watcher import VolumeWatcher
from .watch_hub import AllocWatchHub
from .worker import TPUBatchWorker, Worker

logger = logging.getLogger("nomad_tpu_torch.server")

class ConflictError(Exception):
    """An expected operational rejection (HTTP 400-class), e.g. re-running
    ACL bootstrap. Distinct from PermissionError so filesystem EACCES
    never masquerades as a client error."""


class _RegisterBox:
    """One submitted registration's completion slot."""

    __slots__ = ("event", "error", "fallback")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.error: Optional[BaseException] = None
        self.fallback = False


class NodeRegisterBatcher:
    """Coalesces concurrent Node.register writes into shared
    ``node_register_batch`` raft entries.

    A mass reconnect (partition heals, fleet restart) lands thousands of
    registrations in a few seconds; committing each as its own raft
    entry serializes the storm through the log at one fsync-equivalent
    apiece. The batcher holds each registration for a ~5ms coalescing
    window and commits everything that arrived as ONE entry (bounded at
    ``max_batch``), so the log cost of a reconnect storm is
    O(storm / batch) instead of O(storm). Callers still block until
    their batch commits — acknowledgement semantics are unchanged.

    Leader-only lifecycle: started at establish-leadership, stopped at
    revoke. ``submit`` returns False when not running (caller falls back
    to a direct ``node_register`` apply) so followers applying forwarded
    writes and pre-leadership tests never deadlock on a dead worker.
    """

    def __init__(
        self, raft_apply, window_s: float = 0.005, max_batch: int = 256
    ) -> None:
        self.raft_apply = raft_apply
        self.window_s = window_s
        self.max_batch = max_batch
        self._cv = threading.Condition(threading.Lock())
        self._queue: list[tuple[object, _RegisterBox]] = []
        self._running = False
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        with self._cv:
            if self._running:
                return
            self._running = True
            self._thread = threading.Thread(
                target=self._run, name="node-register-batcher", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        with self._cv:
            if not self._running:
                return
            self._running = False
            drained, self._queue = self._queue, []
            thread, self._thread = self._thread, None
            self._cv.notify_all()
        # anything still queued at revoke-leadership falls back to the
        # caller's direct apply path (which will fail NotLeader exactly
        # as an unbatched write would have)
        for _node, box in drained:
            box.fallback = True
            box.event.set()
        if thread is not None:
            thread.join(timeout=5)

    def submit(self, node) -> bool:
        """Queue a registration and block until its batch commits.
        True = committed via a batch entry; False = batcher not running,
        caller must apply directly. Re-raises the batch's raft error."""
        with self._cv:
            if not self._running:
                return False
            box = _RegisterBox()
            self._queue.append((node, box))
            self._cv.notify()
        box.event.wait()
        if box.fallback:
            return False
        if box.error is not None:
            raise box.error
        return True

    def _run(self) -> None:
        while True:
            with self._cv:
                while self._running and not self._queue:
                    self._cv.wait()
                if not self._running:
                    return
            # coalescing window: let the rest of a concurrent burst
            # arrive before cutting the batch (no locks held)
            time.sleep(self.window_s)
            with self._cv:
                batch = self._queue[: self.max_batch]
                del self._queue[: self.max_batch]
            if not batch:
                continue
            nodes = [node for node, _box in batch]
            err: Optional[BaseException] = None
            try:
                self.raft_apply("node_register_batch", nodes)
            except BaseException as exc:  # propagate to every waiter
                err = exc
            else:
                metrics.incr("nomad.fleet.node_raft_batches")
                metrics.incr(
                    "nomad.fleet.node_raft_coalesced", len(nodes)
                )
            for _node, box in batch:
                box.error = err
                box.event.set()




class Server:
    def __init__(
        self,
        num_workers: int = 2,
        scheduler_config: Optional[SchedulerConfig] = None,
        use_tpu_batch_worker: bool = False,
        enabled_schedulers: Optional[list[str]] = None,
    ) -> None:
        """enabled_schedulers — which eval types this server's workers
        serve (reference EnabledSchedulers, nomad/config.go:159 consumed
        by worker.go:146; num_workers is NumSchedulers). None = all
        types. The _core GC type is always served (the reference
        appends it implicitly)."""
        self.state = StateStore()
        self.fsm = FSM(self.state)
        self.log = InmemLog(self.fsm)
        # Event stream backbone (reference nomad/stream/event_broker.go,
        # wired from state txns via nomad/state/events.go).
        self.event_broker = EventBroker()
        wire_events(self.state, self.event_broker)
        self.scheduler_config = scheduler_config or SchedulerConfig()

        self.eval_broker = EvalBroker()
        self.plan_queue = PlanQueue()
        self.plan_applier = PlanApplier(
            self.plan_queue, self.state, self.raft_apply, self.raft_apply_async
        )
        self.blocked_evals = BlockedEvals(self._requeue_unblocked)
        # Sharded heartbeat timer wheel (heartbeat.py): one ticker
        # thread, O(1) re-arm, and expiry storms delivered as ONE batch
        # per sweep so a mass expiry commits a bounded number of raft
        # entries instead of one per node.
        self.heartbeaters = HeartbeatWheel(
            self._invalidate_heartbeat,
            on_expire_batch=self._invalidate_heartbeat_batch,
        )
        self.heartbeaters.node_count_fn = lambda: len(self.state.nodes())
        # Event-driven alloc-watch fan-out (watch_hub.py): blocking
        # client alloc watches wake per-node instead of per-write.
        # Constructed here (not at establish-leadership) because
        # followers serve Node.get_client_allocs from their replicas.
        self.watch_hub = AllocWatchHub(self.state)
        # Mass-reconnect registration coalescer: concurrent
        # Node.register writes share node_register_batch raft entries
        # (leader-only; started at establish-leadership).
        self.register_batcher = NodeRegisterBatcher(self.raft_apply)
        self.deployment_watcher = DeploymentsWatcher(self.state, self.raft_apply)
        self.drainer = NodeDrainer(self.state, self.raft_apply)
        self.volume_watcher = VolumeWatcher(self.state, self.raft_apply)
        self.periodic = PeriodicDispatch(self.state, self.raft_apply)
        # Threshold GC cadence (reference leader.go schedulePeriodic: one
        # timer per GC kind, 5m default).
        self.gc_interval_s = 300.0
        self._gc_stop = threading.Event()
        self._gc_thread: Optional[threading.Thread] = None

        all_types = ["service", "batch", "system", "sysbatch"]
        if enabled_schedulers is None:
            enabled = list(all_types)
        else:
            unknown = set(enabled_schedulers) - set(all_types)
            if unknown:
                raise ValueError(
                    f"enabled_schedulers: unknown types {sorted(unknown)}"
                )
            enabled = [t for t in all_types if t in enabled_schedulers]
        self.enabled_schedulers = enabled
        serve = enabled + [JOB_TYPE_CORE]
        self.workers: list[Worker] = []
        self.tpu_worker: Optional[TPUBatchWorker] = None
        batchable = [t for t in ("service", "batch") if t in enabled]
        if use_tpu_batch_worker and batchable:
            self.tpu_worker = TPUBatchWorker(
                self, schedulers=batchable, config=self.scheduler_config
            )
            system_worker = Worker(
                self,
                [t for t in ("system", "sysbatch") if t in enabled]
                + [JOB_TYPE_CORE],
                self.scheduler_config, name="worker-system",
            )
            self.workers.append(system_worker)
        else:
            for i in range(num_workers):
                self.workers.append(
                    Worker(
                        self,
                        list(serve),
                        self.scheduler_config,
                        name=f"worker-{i}",
                    )
                )

        # Token→ACL resolution cache, invalidated by acl table index
        # (reference nomad/acl.go aclCache).
        self._acl_cache: dict[str, tuple[int, object, int]] = {}
        self._acl_bootstrap_lock = threading.Lock()

        # Single writer draining unblocked-eval re-queues (see
        # _requeue_unblocked for why this must be async).
        import queue as _queue

        self._unblock_q: "_queue.Queue" = _queue.Queue()
        self._unblock_thread = threading.Thread(
            target=self._unblock_writer, daemon=True, name="unblock-writer"
        )
        self._unblock_thread.start()

        # FSM side-channels (reference fsm.go:746)
        self.fsm.on_eval_update = self._on_eval_update
        self.fsm.on_node_update = self._on_node_update
        self.fsm.on_alloc_client_update = self._on_alloc_client_update
        self.fsm.on_job_upsert = self._on_job_upsert
        self.fsm.on_volume_release = self.blocked_evals.unblock_all
        self._leader = False

    # -- lifecycle -----------------------------------------------------

    def establish_leadership(self) -> None:
        """Enable leader-only subsystems (reference leader.go:224)."""
        self.eval_broker.set_enabled(True)
        self.plan_queue.set_enabled(True)
        self.blocked_evals.set_enabled(True)
        self.heartbeaters.set_enabled(True)
        self.register_batcher.start()
        self.plan_applier.start()
        for w in self.workers:
            w.start()
        if self.tpu_worker:
            self.tpu_worker.start()
        self.deployment_watcher.start()
        self.drainer.start()
        self.volume_watcher.start()
        self.periodic.start()
        # Fresh Event per incarnation (see Worker.start): a thread that
        # outlives join(timeout) polls its own event and still exits.
        self._gc_stop = threading.Event()
        self._gc_thread = threading.Thread(
            target=self._gc_loop, args=(self._gc_stop,), daemon=True,
            name="gc-scheduler"
        )
        self._gc_thread.start()
        self._leader = True
        self._restore_evals()
        # Arm a liveness TTL for every node we believe is alive
        # (reference heartbeat.go initializeHeartbeatTimers): node TTL
        # timers are leader-local state and died with the old leader.
        try:
            self.heartbeaters.initialize(
                n.id
                for n in self.state.nodes()
                if n.status != NODE_STATUS_DOWN
            )
        except Exception:
            logger.exception("heartbeat timer initialization failed")
        # Bootstrap the default namespace (reference leader.go
        # establishLeadership creates it so it always lists).
        try:
            self._ensure_namespace(DEFAULT_NAMESPACE)
        except Exception:
            logger.exception("default namespace bootstrap failed")

    def revoke_leadership(self) -> None:
        self._leader = False
        self._gc_stop.set()
        if self._gc_thread:
            self._gc_thread.join(timeout=5)
            self._gc_thread = None
        self.deployment_watcher.stop()
        self.drainer.stop()
        self.volume_watcher.stop()
        self.periodic.stop()
        for w in self.workers:
            w.stop()
        for w in self.workers:
            w.join(timeout=5)
        if self.tpu_worker:
            self.tpu_worker.stop()
        self.plan_applier.stop()
        self.register_batcher.stop()
        self.eval_broker.set_enabled(False)
        self.plan_queue.set_enabled(False)
        self.blocked_evals.set_enabled(False)
        self.heartbeaters.set_enabled(False)

    def shutdown(self) -> None:
        self.revoke_leadership()
        self.watch_hub.stop()
        self._unblock_q.put(None)

    def _restore_evals(self) -> None:
        """Broker state is not persisted; rebuild from the state store
        (reference leader.go:495 restoreEvals). Idempotent across
        leadership churn: an eval the broker already tracks (enqueued by
        an FSM side-channel while the replay barrier was waiting, or by
        a previous establishment this incarnation) is skipped, so
        restore can run any number of times without double-queueing."""
        for ev in self.state.evals():
            if ev.status == EVAL_STATUS_PENDING:
                if not self.eval_broker.tracks(ev.id):
                    self.eval_broker.enqueue(ev)
            elif ev.status == EVAL_STATUS_BLOCKED:
                self.blocked_evals.block(ev)

    # -- raft ----------------------------------------------------------

    def raft_apply(self, msg_type: str, payload) -> int:
        # the trace's terminal hop: broker dequeue → ... → raft apply
        # (trace.span no-ops on an untraced thread)
        with trace.span(trace.current(), "raft.apply", type=msg_type):
            return self.log.apply(msg_type, payload)

    def raft_apply_async(self, msg_type: str, payload):
        """Submit a raft entry and return (index, wait_fn) without
        blocking on the commit."""
        return self.log.apply_async(msg_type, payload)

    # -- FSM side channels --------------------------------------------

    def _on_eval_update(self, evals: list[Evaluation]) -> None:
        if not self._leader:
            return
        for ev in evals:
            if ev.should_enqueue():
                self.eval_broker.enqueue(ev)
            elif ev.should_block():
                self.blocked_evals.block(ev)

    def _on_node_update(self, node) -> None:
        if not self._leader or node is None:
            return
        # capacity may have appeared: unblock evals for this class
        if node.status == NODE_STATUS_READY:
            self.blocked_evals.unblock(
                node.computed_class, self.state.latest_index()
            )

    def _on_alloc_client_update(self, allocs) -> None:
        if not self._leader:
            return
        # terminal allocs free capacity on their node's class
        for alloc in allocs:
            if alloc.client_terminal_status():
                node = self.state.node_by_id(alloc.node_id)
                if node is not None:
                    self.blocked_evals.unblock(
                        node.computed_class, self.state.latest_index()
                    )

    def _requeue_unblocked(self, ev: Evaluation) -> None:
        """Write an unblocked eval back to pending.

        MUST be asynchronous: this fires from FSM side-channels, i.e. from
        inside the raft apply loop — a synchronous raft_apply here would
        block the apply thread on a commit that needs the apply thread
        (the reference's BlockedEvals likewise hands unblocks to the
        broker via a channel, never re-entering Raft from the FSM). A
        single writer thread drains the queue so a mass unblock (drain
        ending, big node joining) costs one thread, not hundreds."""
        self._unblock_q.put(ev)

    def _unblock_writer(self) -> None:
        while True:
            ev = self._unblock_q.get()
            if ev is None:
                return
            try:
                self.raft_apply("eval_update", [ev])
            except Exception:
                # Lost leadership mid-unblock: the new leader rebuilds
                # blocked-eval state from the store (restoreEvals).
                logger.debug("requeue of unblocked eval %s dropped", ev.id)

    def _on_job_upsert(self, job, ns_id) -> None:
        """Keep the periodic dispatcher's tracked set in sync with the FSM
        (reference fsm.go ApplyJobRegister -> periodicDispatcher.Add)."""
        if not self._leader:
            return
        if job is None:
            self.periodic.remove(*ns_id)
        else:
            self.periodic.add(job)

    # -- job endpoint --------------------------------------------------

    def apply_memory_oversubscription_gate(self, job: Job) -> None:
        """Strip memory_max unless the scheduler config enables it
        (reference: Register gates MemoryMaxMB) — register AND plan
        must apply the same gate or plan diffs lie about destructive
        updates."""
        if not self.scheduler_config.memory_oversubscription:
            for tg in job.task_groups:
                for task in tg.tasks:
                    task.resources.memory_max_mb = 0

    def validate_job_submission(self, job: Job) -> Job:
        """The register-time validation front-half on a COPY:
        canonicalize, Connect injection, struct validation,
        oversubscription gate, vault allowlist, scaling bounds."""
        job = job.copy()
        job.canonicalize()
        # Connect admission: inject sidecar tasks/ports/mesh services
        # BEFORE validation so the injected pieces are validated too
        # (reference job_endpoint_hooks.go:60 jobConnectHook).
        from ..connect import inject_connect_sidecars

        inject_connect_sidecars(job)
        job.validate()
        self.apply_memory_oversubscription_gate(job)
        # Fail fast on vault policies outside the operator allowlist
        # (reference job_endpoint.go Register → validateJob vault check);
        # derive_task_token re-checks at mint time.
        for tg in job.task_groups:
            for task in tg.tasks:
                if task.vault:
                    self._check_vault_policies(
                        list(task.vault.get("policies", []))
                    )
            # scaling stanza sanity at SUBMIT time (reference
            # ScalingPolicy.Validate): a min>max or out-of-bounds count
            # would make the group permanently unscalable
            sc = tg.scaling
            if sc is not None and sc.enabled:
                if sc.min < 0 or (sc.max and sc.max < sc.min):
                    raise ValueError(
                        f"group {tg.name!r}: scaling bounds invalid "
                        f"(min {sc.min}, max {sc.max})"
                    )
                if tg.count < sc.min or (sc.max and tg.count > sc.max):
                    raise ValueError(
                        f"group {tg.name!r}: count {tg.count} outside "
                        f"scaling bounds [{sc.min}, {sc.max}]"
                    )
        return job

    def check_eval_admission(self, namespace: str) -> None:
        """Front-door overload guard for the eval-minting write
        endpoints — called directly by job_register (which also covers
        scale and revert, since both re-register), job_force_evaluate
        and job_dispatch: when the broker's admission depth or the
        namespace's fairness cap is exhausted, reject BEFORE raft with a
        retry hint (BrokerSaturatedError). Reads, deregisters and
        internal producers are never guarded here; the broker's own
        per-eval admission covers those."""
        sat = self.eval_broker.saturation(namespace)
        if sat is None:
            return
        reason, retry_after = sat
        metrics.incr("nomad.broker.rejected")
        from ..ratelimit import BrokerSaturatedError

        raise BrokerSaturatedError(
            f"eval broker saturated ({reason}: "
            f"{self.eval_broker.pending_count()} pending)",
            retry_after_s=retry_after,
        )

    def job_register(self, job: Job) -> str:
        """Returns the created eval id (reference job_endpoint.go:80):
        admission, then the job and its registration eval in one raft
        entry."""
        self.check_eval_admission(job.namespace)
        job = self.validate_job_submission(job)
        self._ensure_namespace(job.namespace)
        if job.is_periodic():
            # A malformed cron spec must be rejected at the API, not fire
            # wild from the dispatcher (reference periodic.go Add validates).
            from .periodic import next_launch

            next_launch(job.periodic, time.time())
        ev = None
        if not job.is_periodic() and not job.is_parameterized():
            ev = Evaluation(
                id=generate_uuid(),
                namespace=job.namespace,
                priority=job.priority,
                type=job.type,
                triggered_by=EVAL_TRIGGER_JOB_REGISTER,
                job_id=job.id,
                status=EVAL_STATUS_PENDING,
                create_time=now_ns(),
                modify_time=now_ns(),
            )
        self.raft_apply("job_register", (job, ev))
        return ev.id if ev else ""

    # -- namespace endpoint --------------------------------------------

    def namespace_upsert(self, ns) -> None:
        """Reference: nomad/namespace_endpoint.go UpsertNamespaces."""
        ns.validate()
        self.raft_apply("namespace_upsert", ns)

    def namespace_delete(self, name: str) -> None:
        # pre-validate against current state for a friendly error; the
        # FSM re-checks under the raft serialization point
        if name == DEFAULT_NAMESPACE:
            raise ValueError("the default namespace cannot be deleted")
        if self.state.namespace_by_name(name) is None:
            raise KeyError(f"namespace {name} not found")
        # The replicated apply loop logs-and-continues on FSM errors, so
        # the user-facing in-use refusal must happen here; the store
        # re-checks authoritatively under the raft serialization point.
        # Terminal jobs pending GC don't count (same rule as the store).
        from ..structs.structs import JOB_STATUS_DEAD

        in_use = sum(
            1
            for j in self.state.jobs(name)
            if not (j.stop or j.status == JOB_STATUS_DEAD)
        ) + len(self.state.volumes(name))
        if in_use:
            raise ValueError(f"namespace {name} has {in_use} jobs/volumes")
        self.raft_apply("namespace_delete", name)

    def _ensure_namespace(self, namespace: str) -> None:
        """Writes into a namespace require it to exist (reference
        job_endpoint.go Register's namespace check). 'default' always
        exists — bootstrapped on first use."""
        if namespace == DEFAULT_NAMESPACE:
            if self.state.namespace_by_name(namespace) is None:
                from ..structs.structs import Namespace

                self.raft_apply(
                    "namespace_upsert",
                    Namespace(name=DEFAULT_NAMESPACE,
                              description="Default shared namespace"),
                )
            return
        if self.state.namespace_by_name(namespace) is None:
            raise ValueError(f"namespace {namespace!r} does not exist")

    # -- volume endpoint -----------------------------------------------

    def validate_volume(self, vol) -> None:
        """Shared register/create validation — create must run this
        BEFORE provisioning, or a rejected register would orphan the
        freshly provisioned external storage."""
        if not vol.id or not vol.name:
            raise ValueError("volume requires id and name")
        from ..structs.structs import (
            VOLUME_ACCESS_MULTI_WRITER,
            VOLUME_ACCESS_READ_ONLY,
            VOLUME_ACCESS_SINGLE_WRITER,
        )

        valid_modes = (
            VOLUME_ACCESS_SINGLE_WRITER,
            VOLUME_ACCESS_MULTI_WRITER,
            VOLUME_ACCESS_READ_ONLY,
        )
        if vol.access_mode not in valid_modes:
            # a typo'd mode would silently behave as multi-writer
            raise ValueError(
                f"invalid access_mode {vol.access_mode!r}; "
                f"one of {', '.join(valid_modes)}"
            )

    def volume_register(self, vol) -> None:
        """Register (or update) a volume; claims survive updates
        (reference csi_endpoint.go Register, reshaped for host volumes)."""
        self.validate_volume(vol)
        self._ensure_namespace(vol.namespace)
        self.raft_apply("volume_register", vol)

    def volume_deregister(self, namespace: str, vol_id: str) -> None:
        vol = self.state.volume_by_id(namespace, vol_id)
        if vol is None:
            raise KeyError(f"volume {vol_id} not found")
        if vol.claims:
            raise ValueError(
                f"volume {vol_id} has {len(vol.claims)} active claims"
            )
        self.raft_apply("volume_deregister", (namespace, vol_id))

    # -- secrets (the embedded Vault analog) ---------------------------

    def secret_upsert(self, entry) -> None:
        if not entry.path or not entry.path.strip("/"):
            raise ValueError("secret requires a path")
        self.raft_apply("secret_upsert", entry)

    def secret_delete(self, namespace: str, path: str) -> None:
        if self.state.secret_by_path(namespace, path) is None:
            raise KeyError(f"secret {path} not found")
        self.raft_apply("secret_delete", (namespace, path))

    DERIVED_TOKEN_TTL_S = 3600.0
    # Operator allowlist for task-derivable policies (reference:
    # vault stanza allowed_policies validation in nomad/vault.go — a job
    # may only ask for policies the operator pre-approved; None = no
    # restriction, matching the reference's default). Without this a
    # submit-job token could mint itself any policy via a vault stanza.
    vault_allowed_policies: Optional[list[str]] = None

    def _check_vault_policies(self, policies: list[str]) -> None:
        if self.vault_allowed_policies is None:
            return
        denied = [
            p for p in policies if p not in self.vault_allowed_policies
        ]
        if denied:
            raise PermissionError(
                f"vault policies not in the operator allowlist: {denied}"
            )

    def derive_task_token(self, alloc_id: str, task_name: str) -> dict:
        """Mint a TTL'd ACL token scoped to the task's vault.policies
        (reference nomad/vault.go DeriveVaultToken via the Vault server;
        here the token is a first-class cluster token the client renews).
        Returns {"secret_id", "accessor_id", "ttl_s"}."""
        from ..acl.structs import ACLToken

        alloc = self.state.alloc_by_id(alloc_id)
        if alloc is None:
            raise KeyError(f"alloc {alloc_id} not found")
        if alloc.terminal_status():
            raise ValueError(f"alloc {alloc_id} is terminal")
        job = alloc.job or self.state.job_by_id(alloc.namespace, alloc.job_id)
        tg = job.lookup_task_group(alloc.task_group) if job else None
        task = tg.lookup_task(task_name) if tg else None
        if task is None:
            raise KeyError(f"task {task_name} not in alloc {alloc_id}")
        policies = list((task.vault or {}).get("policies", []))
        self._check_vault_policies(policies)
        token = ACLToken.new(
            name=f"task-{alloc_id[:8]}-{task_name}", policies=policies
        )
        token.expiration_time_ns = now_ns() + int(
            self.DERIVED_TOKEN_TTL_S * 1e9
        )
        self.raft_apply("acl_token_upsert", [token])
        return {
            "secret_id": token.secret_id,
            "accessor_id": token.accessor_id,
            "ttl_s": self.DERIVED_TOKEN_TTL_S,
        }

    def renew_task_token(self, accessor_id: str) -> float:
        """Extend a derived token's TTL (reference vaultclient
        RenewToken → Vault lease renewal)."""
        token = self.state.acl_token_by_accessor(accessor_id)
        if token is None:
            raise KeyError("token not found")
        if not token.expiration_time_ns:
            raise ValueError("token has no TTL")
        if token.expiration_time_ns < now_ns():
            raise ValueError("token already expired")
        renewed = token.copy()
        renewed.expiration_time_ns = now_ns() + int(
            self.DERIVED_TOKEN_TTL_S * 1e9
        )
        self.raft_apply("acl_token_upsert", [renewed])
        return self.DERIVED_TOKEN_TTL_S

    def services_register(self, regs: list) -> None:
        """Upsert service registrations (reference:
        service_registration_endpoint.go Upsert). The owning alloc must
        exist — a late register from a restarting client for a GC'd alloc
        would otherwise resurrect a ghost instance."""
        for reg in regs:
            if not reg.id or not reg.service_name or not reg.alloc_id:
                raise ValueError(
                    "service registration requires id, service_name, alloc_id"
                )
            alloc = self.state.alloc_by_id(reg.alloc_id)
            if alloc is None:
                raise KeyError(f"alloc {reg.alloc_id} not found")
            if alloc.terminal_status():
                # a late check-status upsert must not resurrect rows the
                # service GC just swept
                raise ValueError(f"alloc {reg.alloc_id} is terminal")
        self.raft_apply("service_upsert", regs)

    def services_deregister_alloc(self, alloc_id: str) -> int:
        return self.raft_apply("service_delete_alloc", [alloc_id])

    def services_deregister(self, ids: list[str]) -> int:
        return self.raft_apply("service_delete", ids)

    def alloc_stop(self, alloc_id: str) -> str:
        """Stop one allocation and let the scheduler replace it
        (reference alloc_endpoint.go Stop: DesiredTransition.Migrate +
        an eval). Returns the eval id."""
        from ..structs.structs import DesiredTransition

        alloc = self.state.alloc_by_id(alloc_id)
        if alloc is None:
            raise KeyError(f"alloc {alloc_id} not found")
        job = alloc.job or self.state.job_by_id(alloc.namespace, alloc.job_id)
        ev = Evaluation(
            id=generate_uuid(),
            namespace=alloc.namespace,
            priority=job.priority if job else 50,
            type=job.type if job else JOB_TYPE_SERVICE,
            triggered_by="alloc-stop",
            job_id=alloc.job_id,
            status=EVAL_STATUS_PENDING,
            create_time=now_ns(),
            modify_time=now_ns(),
        )
        self.raft_apply(
            "alloc_update_desired_transition",
            ({alloc_id: DesiredTransition(migrate=True)}, [ev]),
        )
        return ev.id

    def job_scale(self, namespace: str, job_id: str, group: str,
                  count: int, message: str = "") -> str:
        """Scale one task group (reference job_endpoint.go Scale :979:
        count change re-registers the job, bumping its version and
        producing an eval). Returns the eval id."""
        if count < 0:
            raise ValueError("count must be >= 0")
        job = self.state.job_by_id(namespace, job_id)
        if job is None:
            raise KeyError(f"job {job_id} not found")
        job = job.copy()
        tg = job.lookup_task_group(group)
        if tg is None:
            raise ValueError(
                f"task group {group!r} does not exist in job {job_id}"
            )
        if tg.scaling is not None and tg.scaling.enabled:
            lo, hi = tg.scaling.min, tg.scaling.max
            if count < lo or (hi and count > hi):
                raise ValueError(
                    f"count {count} outside scaling bounds [{lo}, {hi}] "
                    f"for group {group!r}"
                )
        prev = tg.count
        tg.count = count
        eval_id = self.job_register(job)
        self.raft_apply(
            "job_scaling_event",
            {
                "namespace": namespace,
                "job_id": job_id,
                "group": group,
                "event": {
                    "Time": now_ns(),
                    "Count": count,
                    "PreviousCount": prev,
                    "Message": message or "submitted via scale API",
                    "EvalID": eval_id,
                },
            },
        )
        return eval_id

    def job_force_evaluate(self, namespace: str, job_id: str) -> str:
        """Create a new eval for the job (reference job_endpoint.go
        Evaluate / `nomad job eval`). Returns the eval id."""
        self.check_eval_admission(namespace)
        job = self.state.job_by_id(namespace, job_id)
        if job is None:
            raise KeyError(f"job {job_id} not found")
        ev = Evaluation(
            id=generate_uuid(),
            namespace=namespace,
            priority=job.priority,
            type=job.type,
            triggered_by="job-eval",
            job_id=job_id,
            status=EVAL_STATUS_PENDING,
            create_time=now_ns(),
            modify_time=now_ns(),
        )
        self.raft_apply("eval_update", [ev])
        return ev.id

    def reconcile_job_summaries(self) -> int:
        """Rebuild every job summary from the alloc table (reference
        system_endpoint.go ReconcileJobSummaries / `system reconcile
        summaries`). Returns how many jobs were recomputed (raft_apply
        returns the LOG INDEX, not the FSM result — count from state)."""
        n = len(self.state.jobs())
        self.raft_apply("summaries_reconcile", None)
        return n

    def job_plan(self, job: Job, diff: bool = True) -> dict:
        """Dry-run the candidate job: run the real scheduler against a
        snapshot without committing; return annotations + diff + failures
        (reference job_endpoint.go:521 + scheduler/annotate.go)."""
        from .job_plan import plan_job

        job = job.copy()
        # same admission mutations register applies — or the plan would
        # diff a memory_max the register is about to strip and show the
        # injected connect sidecars as deletions
        job.canonicalize()
        from ..connect import inject_connect_sidecars

        inject_connect_sidecars(job)
        self.apply_memory_oversubscription_gate(job)
        return plan_job(self.state, job, diff, self.scheduler_config)

    def job_deregister(self, namespace: str, job_id: str, purge: bool = False) -> str:
        job = self.state.job_by_id(namespace, job_id)
        ev = Evaluation(
            id=generate_uuid(),
            namespace=namespace,
            priority=job.priority if job else 50,
            type=job.type if job else JOB_TYPE_SERVICE,
            triggered_by=EVAL_TRIGGER_JOB_DEREGISTER,
            job_id=job_id,
            status=EVAL_STATUS_PENDING,
            create_time=now_ns(),
            modify_time=now_ns(),
        )
        self.raft_apply("job_deregister", (namespace, job_id, purge, ev))
        self.blocked_evals.untrack(namespace, job_id)
        return ev.id

    # -- node endpoint -------------------------------------------------

    def node_register(self, node) -> float:
        """Returns the heartbeat TTL (reference node_endpoint.go Register)."""
        node = node.copy()
        if not node.status:
            node.status = NODE_STATUS_READY
        prev = self.state.node_by_id(node.id)
        was_ready = prev is not None and prev.ready()
        # Registration storms share node_register_batch raft entries;
        # the direct path serves followers applying forwarded writes and
        # anything running before leadership is established.
        if not self.register_batcher.submit(node):
            self.raft_apply("node_register", node)
        # A node that BECAME ready may unblock system jobs / blocked
        # evals (reference node_endpoint.go Register -> createNodeEvals).
        # A re-registration that didn't change readiness mints no evals:
        # a 10k-node reconnect storm must not multiply eval_update raft
        # entries for placements that already exist.
        stored = self.state.node_by_id(node.id)
        if stored is not None and stored.ready() and not was_ready:
            self._create_node_evals(node.id)
        return self.heartbeaters.reset(node.id)

    def node_heartbeat(self, node_id: str) -> float:
        """Node.UpdateStatus(ready) fast-path: rearm the TTL."""
        node = self.state.node_by_id(node_id)
        if node is None:
            raise KeyError(f"unknown node {node_id}")
        if node.status != NODE_STATUS_READY:
            self.node_update_status(node_id, NODE_STATUS_READY)
        return self.heartbeaters.reset(node_id)

    def node_update_status(self, node_id: str, status: str) -> None:
        prev = self.state.node_by_id(node_id)
        prev_status = prev.status if prev is not None else ""
        self.raft_apply("node_update_status", (node_id, status))
        if status == NODE_STATUS_DOWN:
            self.heartbeaters.clear(node_id)
            self._create_node_evals(node_id)
        elif status == NODE_STATUS_READY and prev_status != NODE_STATUS_READY:
            # A recovered node (down -> ready via heartbeat) needs its
            # system jobs re-placed and class-blocked evals re-run —
            # re-registration preserves the stored status, so this
            # transition is where the evals must come from (reference
            # node_endpoint.go UpdateStatus -> createNodeEvals).
            self._create_node_evals(node_id)
            node = self.state.node_by_id(node_id)
            if node is not None:
                self.blocked_evals.unblock(
                    node.computed_class, self.state.latest_index()
                )

    def node_update_drain(
        self, node_id: str, drain: Optional[DrainStrategy], mark_eligible: bool = False
    ) -> None:
        self.raft_apply("node_update_drain", (node_id, drain, mark_eligible))
        if drain is not None:
            self._create_node_evals(node_id, trigger=EVAL_TRIGGER_NODE_DRAIN)

    def node_update_eligibility(self, node_id: str, eligibility: str) -> None:
        self.raft_apply("node_update_eligibility", (node_id, eligibility))

    def _invalidate_heartbeat(self, node_id: str) -> None:
        """TTL expired: node is presumed dead (reference heartbeat.go:128)."""
        logger.warning("node %s missed heartbeat; marking down", node_id)
        # churn observability: spot-node loss rate and the spot-churn
        # scenario's "no alloc stranded past the TTL" evidence
        metrics.incr("nomad.heartbeat.expired")
        try:
            self.node_update_status(node_id, NODE_STATUS_DOWN)
        except KeyError:
            pass
        except Exception:
            # A deposed or quorumless leader cannot commit the down-mark
            # (NotLeaderError / commit timeout during a partition); the
            # next real leader's timers re-derive liveness — don't let
            # the raft error escape into the Timer thread.
            logger.exception("node %s down-mark failed", node_id)

    def _invalidate_heartbeat_batch(self, node_ids: list[str]) -> None:
        """A wheel sweep's whole expiry crop, committed as ONE
        node_batch_update_status raft entry plus ONE eval_update — a
        mass expiry (partition, leader stall) costs a bounded number of
        log entries instead of two per node."""
        known = [
            nid for nid in node_ids if self.state.node_by_id(nid) is not None
        ]
        if not known:
            return
        metrics.incr("nomad.heartbeat.expired", len(known))
        metrics.incr("nomad.heartbeat.expire_batches")
        blackbox.record(
            blackbox.KIND_EXPIRY, "heartbeat_wheel", expired=len(known),
            rel=[f"node:{nid}" for nid in known[:16]],
        )
        logger.warning(
            "%d node(s) missed heartbeats; marking down in one batch",
            len(known),
        )
        try:
            self.raft_apply(
                "node_batch_update_status", (known, NODE_STATUS_DOWN)
            )
        except KeyError:
            return
        except Exception:
            # same discipline as the single-node path: a deposed or
            # quorumless leader drops the down-mark; the next leader's
            # wheel re-derives liveness
            logger.exception(
                "batched down-mark failed for %d node(s)", len(known)
            )
            return
        metrics.incr("nomad.fleet.node_raft_batches")
        metrics.incr("nomad.fleet.node_raft_coalesced", len(known))
        evals: list[Evaluation] = []
        for nid in known:
            self.heartbeaters.clear(nid)
            evals.extend(self._build_node_evals(nid))
        if evals:
            try:
                self.raft_apply("eval_update", evals)
            except Exception:
                logger.exception(
                    "eval_update for batched expiry failed (%d evals)",
                    len(evals),
                )

    def _create_node_evals(
        self, node_id: str, trigger: str = EVAL_TRIGGER_NODE_UPDATE
    ) -> list[str]:
        evals = self._build_node_evals(node_id, trigger)
        if evals:
            self.raft_apply("eval_update", evals)
        return [e.id for e in evals]

    def _build_node_evals(
        self, node_id: str, trigger: str = EVAL_TRIGGER_NODE_UPDATE
    ) -> list[Evaluation]:
        """One eval per job with allocs on the node (reference
        node_endpoint.go:495 createNodeEvals). Build-only so batch
        callers can merge many nodes' evals into one raft entry."""
        node = self.state.node_by_id(node_id)
        evals: list[Evaluation] = []
        seen: set[tuple[str, str]] = set()
        for alloc in self.state.allocs_by_node(node_id):
            key = (alloc.namespace, alloc.job_id)
            if key in seen or alloc.terminal_status():
                continue
            seen.add(key)
            job = alloc.job or self.state.job_by_id(*key)
            if job is None:
                continue
            evals.append(
                Evaluation(
                    id=generate_uuid(),
                    namespace=alloc.namespace,
                    priority=job.priority,
                    type=job.type,
                    triggered_by=trigger,
                    job_id=alloc.job_id,
                    node_id=node_id,
                    node_modify_index=node.modify_index if node else 0,
                    status=EVAL_STATUS_PENDING,
                    create_time=now_ns(),
                    modify_time=now_ns(),
                )
            )
        # system jobs must also react to NEW nodes with no allocs yet
        if trigger == EVAL_TRIGGER_NODE_UPDATE and node is not None and node.ready():
            for job in self.state.jobs():
                if job.type in ("system", "sysbatch") and (job.namespace, job.id) not in seen:
                    evals.append(
                        Evaluation(
                            id=generate_uuid(),
                            namespace=job.namespace,
                            priority=job.priority,
                            type=job.type,
                            triggered_by=trigger,
                            job_id=job.id,
                            node_id=node_id,
                            status=EVAL_STATUS_PENDING,
                            create_time=now_ns(),
                            modify_time=now_ns(),
                        )
                    )
        return evals

    # -- deployment endpoint (reference nomad/deployment_endpoint.go) --

    def deployment_promote(
        self, deployment_id: str, groups: Optional[list[str]] = None
    ) -> None:
        d = self.state.deployment_by_id(deployment_id)
        if d is None:
            raise KeyError(f"unknown deployment {deployment_id}")
        if not d.active():
            raise ValueError(f"deployment {deployment_id} is terminal")
        self.deployment_watcher.promote(d, groups)

    def deployment_pause(self, deployment_id: str, pause: bool) -> None:
        d = self.state.deployment_by_id(deployment_id)
        if d is None:
            raise KeyError(f"unknown deployment {deployment_id}")
        if not d.active():
            raise ValueError(f"deployment {deployment_id} is terminal")
        self.deployment_watcher.pause(d, pause)

    def deployment_fail(self, deployment_id: str) -> None:
        d = self.state.deployment_by_id(deployment_id)
        if d is None:
            raise KeyError(f"unknown deployment {deployment_id}")
        if not d.active():
            raise ValueError(f"deployment {deployment_id} is terminal")
        self.deployment_watcher.fail_deployment(d)

    def alloc_set_health(
        self, deployment_id: str, healthy: list[str], unhealthy: list[str]
    ) -> None:
        """Deployment.SetAllocHealth (manual health override)."""
        d = self.state.deployment_by_id(deployment_id)
        if d is None:
            raise KeyError(f"unknown deployment {deployment_id}")
        self.raft_apply(
            "deployment_alloc_health",
            {
                "deployment_id": deployment_id,
                "healthy_ids": healthy,
                "unhealthy_ids": unhealthy,
            },
        )

    # -- job revert / dispatch (reference nomad/job_endpoint.go) -------

    def job_revert(self, namespace: str, job_id: str, version: int) -> str:
        """Re-register an older job version (reference Job.Revert)."""
        current = self.state.job_by_id(namespace, job_id)
        if current is None:
            raise KeyError(f"unknown job {job_id}")
        if version == current.version:
            raise ValueError(f"job is already at version {version}")
        target = self.state.job_version(namespace, job_id, version)
        if target is None:
            raise KeyError(f"job {job_id} has no version {version}")
        revert = target.copy()
        revert.stable = False
        return self.job_register(revert)

    def job_dispatch(
        self,
        namespace: str,
        job_id: str,
        payload: bytes = b"",
        meta: Optional[dict[str, str]] = None,
    ) -> tuple[str, str]:
        """Dispatch a parameterized job (reference Job.Dispatch). Returns
        (child_job_id, eval_id)."""
        self.check_eval_admission(namespace)
        parent = self.state.job_by_id(namespace, job_id)
        if parent is None:
            raise KeyError(f"unknown job {job_id}")
        if not parent.is_parameterized():
            raise ValueError(f"job {job_id} is not parameterized")
        cfg = parent.parameterized
        meta = dict(meta or {})
        if cfg.payload == "required" and not payload:
            raise ValueError("payload is required by this job")
        if cfg.payload == "forbidden" and payload:
            raise ValueError("payload is forbidden by this job")
        for key in cfg.meta_required:
            if key not in meta:
                raise ValueError(f"missing required dispatch meta {key!r}")
        for key in meta:
            if key not in cfg.meta_required and key not in cfg.meta_optional:
                raise ValueError(f"dispatch meta {key!r} not allowed")
        child = parent.copy()
        child.id = f"{parent.id}/dispatch-{now_ns() // 1_000_000_000}-{generate_uuid()[:8]}"
        child.name = child.id
        child.parent_id = parent.id
        child.dispatched = True
        child.payload = payload
        child.meta.update(meta)
        child.status = ""
        ev = Evaluation(
            id=generate_uuid(),
            namespace=child.namespace,
            priority=child.priority,
            type=child.type,
            triggered_by="job-register",
            job_id=child.id,
            status=EVAL_STATUS_PENDING,
            create_time=now_ns(),
            modify_time=now_ns(),
        )
        self.raft_apply("job_register", (child, ev))
        return child.id, ev.id

    # -- GC (reference nomad/system_endpoint.go + leader.go) -----------

    # -- ACL endpoint (reference nomad/acl_endpoint.go) -----------------

    def acl_bootstrap(self):
        """One-shot initial management token (reference ACL.Bootstrap).
        The lock closes the check-then-act window between two concurrent
        bootstrap requests (the reference uses a bootstrap-index CAS)."""
        from ..acl.structs import ACLToken

        with self._acl_bootstrap_lock:
            if self.state.acl_has_management_token():
                raise ConflictError("ACL bootstrap already done")
            token = ACLToken.new(name="Bootstrap Token", type="management")
            self.raft_apply("acl_token_upsert", [token])
            return self.state.acl_token_by_accessor(token.accessor_id)

    def acl_policy_upsert(self, policies) -> None:
        for pol in policies:
            pol.validate()
        self.raft_apply("acl_policy_upsert", policies)

    def acl_policy_delete(self, names: list[str]) -> None:
        self.raft_apply("acl_policy_delete", names)

    def acl_token_create(self, token):
        from ..acl.structs import ACLToken

        if not token.accessor_id:
            fresh = ACLToken.new(
                name=token.name, type=token.type, policies=token.policies
            )
            fresh.global_ = token.global_
            token = fresh
        token.validate()
        self.raft_apply("acl_token_upsert", [token])
        return self.state.acl_token_by_accessor(token.accessor_id)

    def acl_token_delete(self, accessor_ids: list[str]) -> None:
        self.raft_apply("acl_token_delete", accessor_ids)

    def resolve_token(self, secret_id: str):
        """secret → compiled ACL (reference nomad/acl.go ResolveToken).
        None ⇒ anonymous. Cached per (secret, acl table index)."""
        from ..acl import compile_policies, parse_policy
        from ..acl.acl import MANAGEMENT_ACL
        from ..state.store import TABLE_ACL_POLICIES, TABLE_ACL_TOKENS

        if not secret_id:
            return None
        idx = self.state.table_index(TABLE_ACL_POLICIES, TABLE_ACL_TOKENS)
        cached = self._acl_cache.get(secret_id)
        if cached is not None and cached[0] == idx:
            # Expiry is wall-clock, not table-index: check it from the
            # cached entry so hits stay O(1) (the by-secret lookup scans
            # the token table) without letting a compile outlive its TTL.
            exp = cached[2]
            if exp and exp < now_ns():
                raise PermissionError("token expired")
            return cached[1]
        token = self.state.acl_token_by_secret(secret_id)
        if token is None:
            raise PermissionError("token not found")
        if token.expiration_time_ns and token.expiration_time_ns < now_ns():
            raise PermissionError("token expired")
        if token.is_management():
            acl = MANAGEMENT_ACL
        else:
            policies = []
            for name in token.policies:
                pol = self.state.acl_policy_by_name(name)
                if pol is not None:
                    policies.append(parse_policy(pol.rules))
            acl = compile_policies(policies)
        if len(self._acl_cache) > 512:
            self._acl_cache.clear()
        self._acl_cache[secret_id] = (idx, acl, token.expiration_time_ns)
        return acl

    def force_gc(self) -> None:
        """System.GarbageCollect: enqueue a force-gc core eval."""
        self.eval_broker.enqueue(core_eval("force-gc"))

    def _gc_loop(self, stop: threading.Event) -> None:
        """Periodic threshold GC (reference leader.go schedulePeriodic)."""
        while not stop.wait(self.gc_interval_s):
            for kind in (
                "eval-gc", "job-gc", "node-gc", "deployment-gc",
                "service-gc", "token-gc",
            ):
                self.eval_broker.enqueue(core_eval(kind))

    # -- client alloc updates -----------------------------------------

    def update_allocs_from_client(self, allocs: list[Allocation]) -> None:
        """Node.UpdateAlloc: merge client status; failed allocs trigger
        reschedule evals (reference node_endpoint.go UpdateAlloc)."""
        self.raft_apply("alloc_client_update", allocs)
        evals: list[Evaluation] = []
        seen: set[tuple[str, str]] = set()
        for alloc in allocs:
            if alloc.client_status != ALLOC_CLIENT_STATUS_FAILED:
                continue
            key = (alloc.namespace, alloc.job_id)
            if key in seen:
                continue
            stored = self.state.alloc_by_id(alloc.id)
            job = (stored.job if stored else None) or self.state.job_by_id(*key)
            if job is None or job.stopped():
                continue
            seen.add(key)
            evals.append(
                Evaluation(
                    id=generate_uuid(),
                    namespace=alloc.namespace,
                    priority=job.priority,
                    type=job.type,
                    triggered_by=EVAL_TRIGGER_RETRY_FAILED_ALLOC,
                    job_id=alloc.job_id,
                    status=EVAL_STATUS_PENDING,
                    create_time=now_ns(),
                    modify_time=now_ns(),
                )
            )
        if evals:
            self.raft_apply("eval_update", evals)

    # -- client pull (blocking query) ---------------------------------

    def get_client_allocs(
        self, node_id: str, min_index: int = 0, timeout_s: float = 5.0
    ) -> tuple[list[Allocation], int]:
        """Node.GetClientAllocs: blocking query on the node's allocs.

        The seed implementation parked every watcher on the alloc
        TABLE's condition — each plan apply woke all of them
        (``notify_all``) and each re-scanned its node's allocs. The
        watch hub wakes only the nodes a write actually touched; a
        timeout still falls through to a fetch, so the returned
        (allocs, index) contract is unchanged."""
        from ..state.store import TABLE_ALLOCS

        if min_index > 0:
            self.watch_hub.wait_for_node(node_id, min_index, timeout_s)
        index = self.state.wait_for_index([TABLE_ALLOCS], 0, 0.0)
        return self.state.allocs_by_node(node_id), index

    # -- draining helpers ---------------------------------------------

    def wait_for_evals(self, timeout_s: float = 10.0) -> bool:
        """Test helper: block until no ready/in-flight evals remain."""
        import time

        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if (
                self.eval_broker.ready_count() == 0
                and self.eval_broker.inflight_count() == 0
                and self.plan_queue.depth() == 0
            ):
                return True
            time.sleep(0.01)
        return False
