"""Leader side of the solver-pool tier.

Port of ``nomad_tpu/server/solver_pool.py``. The pool decouples
placement capacity from raft: followers (or dedicated ``solver``-role
servers) keep warm ResidentClusterState replicas on their cards
(scheduler/gpu/remote_solve.py), and the leader's TPUBatchWorker streams
its mega-batch drains out over the RPC fabric (``SolverPool.Solve``)
instead of solving locally. The leader keeps plan-apply/raft authority —
a remote solve returns plan columns that flow through the SAME plan
verification, commit, and eval-update path a local solve would, so a
slightly stale replica costs a trimmed plan (and a retry eval), never a
wrong commit.

Dispatch policy (worker.py _solve_batch):
  * mega-batch drains route to the least-loaded healthy pool member;
  * the interactive lane (host microsolve) always solves locally — a
    network hop would eat the latency the lane exists to save;
  * an empty pool keeps the local path (the leader's own card), and a
    member dying mid-solve rides the existing DeviceFault/retry
    discipline (a member fault IS a retriable device fault to the commit
    stage, whose host fallback re-solves the batch).

Membership hangs off cluster gossip: a member advertises with the serf
tag ``solver=1`` and health follows serf status + a short local fault
cooldown after a failed dispatch. Leadership transfer aborts in-flight
dispatches so their evals NACK (redeliver on the new leader) instead of
dropping.

A dispatch carries the calling thread's trace to the member, so the
member's ``solver.pool.remote`` span and its solve stages land in the
leader's batch trace.

Host code: torch loads only when the endpoint first builds its member
engine (the scheduler/gpu imports live inside methods).
"""

from __future__ import annotations

import copy
import logging
import threading
import time
from concurrent.futures import CancelledError
from typing import Optional

from .. import blackbox, faultplane, metrics, trace

logger = logging.getLogger("nomad_tpu_torch.solver_pool")

# A member that just failed a dispatch sits out this long before pick()
# considers it again — serf suspicion usually confirms within the window.
FAULT_COOLDOWN_S = 5.0


class _Dispatch:
    """One in-flight remote solve: the RPC runs on its own daemon thread
    so the worker's solve stage returns immediately (phase A stays
    async, exactly like the local device dispatch)."""

    __slots__ = ("member_id", "addr", "done", "result", "error", "aborted",
                 "t0")

    def __init__(self, member_id: str, addr: tuple) -> None:
        self.member_id = member_id
        self.addr = addr
        self.done = threading.Event()
        self.result: Optional[dict] = None
        self.error: Optional[BaseException] = None
        self.aborted = False
        self.t0 = time.perf_counter()

    def fail(self, exc: BaseException) -> None:
        if not self.done.is_set():
            self.error = exc
            self.done.set()

    def abort(self) -> None:
        self.aborted = True
        self.done.set()


class RemotePendingBatch:
    """PendingEvalBatch stand-in for a pool-dispatched solve. The commit
    stage consumes it unchanged: finish() blocks on the RPC instead of
    the device; a member fault raises a retriable DeviceFault so the
    existing device-failover path re-solves on the host oracle; the
    chain surface is inert (a remote solve never consumes or produces a
    local used' tensor — the applier's verification is the serializer
    between overlapping remote batches)."""

    chain = None
    chain_accepted = False
    used_micro = False

    def __init__(self, pool: "SolverPool", dispatch: _Dispatch, snapshot,
                 evals: list, planner, config) -> None:
        self._pool = pool
        self._dispatch = dispatch
        self._snapshot = snapshot
        self._evals = evals
        self._planner = planner
        self._config = config
        self._finished = False
        self._plans = None

    def finish(self):
        if self._finished:
            return self._plans
        d = self._dispatch
        d.done.wait(self._pool.solve_timeout_s + 5.0)
        if d.aborted:
            # leadership transfer (or shutdown) mid-solve: the commit
            # stage's outer guard nacks the batch so its evals redeliver
            # on the new leader — aborting must never DROP them
            raise CancelledError("solver pool dispatch aborted")
        if d.error is not None or d.result is None:
            err = d.error or TimeoutError("solver pool solve timed out")
            raise faultplane.DeviceFault(
                f"pool member {d.member_id} failed mid-solve: "
                f"{type(err).__name__}: {err}",
                retriable=True,
            )
        out = d.result
        # Followup evals minted by the member's reconcile pass
        # (CollectingPlanner): applied HERE, on the leader's raft — if
        # leadership was just lost this raises NotLeaderError and the
        # commit stage nacks, same as a local solve's create_eval.
        for fe in out.get("followups") or []:
            self._planner.create_eval(fe)
        dt = time.perf_counter() - d.t0
        metrics.observe("nomad.solver.pool.remote_seconds", dt)
        self._pool.note_completed(d)
        self._plans = out["plans"]
        self._finished = True
        return self._plans

    def solve_host_fallback(self):
        """Member died mid-solve: re-solve the same evals locally on the
        host oracle path (no device, no pool). The failed member's
        followups were never applied, so this is a clean re-solve."""
        from ..scheduler.gpu import solve_eval_batch

        cfg = copy.copy(self._config)
        cfg.small_batch_threshold = 1 << 62
        return solve_eval_batch(
            self._snapshot, self._planner, self._evals, cfg
        )


class SolverPoolEndpoint:
    """RPC surface every server exposes (verbs ``SolverPool.Solve`` /
    ``Sync`` / ``Status``). The warm RemoteSolver engine is built
    lazily on the first Solve/Sync — a server that never advertises and
    never gets dispatched to never loads torch for it. Its config is the
    member's own (``backend="gpu"``) on the device of the hosting
    server's ``scheduler_config``: "cuda" unless that server asked for
    the CPU."""

    def __init__(self, cluster, pool: "SolverPool") -> None:
        self.cs = cluster
        self.pool = pool
        self._lock = threading.Lock()
        self._solver = None

    def local_solver(self, build: bool = True):
        with self._lock:
            if self._solver is None and build:
                from ..scheduler.context import SchedulerConfig
                from ..scheduler.gpu.remote_solve import RemoteSolver

                # the inner Server owns the state store (the cluster
                # node is the raft/gossip shell around it)
                host = getattr(self.cs, "server", self.cs)
                device = getattr(
                    getattr(host, "scheduler_config", None), "device",
                    "cuda",
                )
                self._solver = RemoteSolver(
                    host,
                    config=SchedulerConfig(backend="gpu", device=device),
                    node_id=self.cs.node_id,
                )
            return self._solver

    def solve(self, args):
        args = args or {}
        solver = self.local_solver()
        with trace.span(
            trace.current(), "solver.pool.remote",
            member=self.cs.node_id, evals=len(args.get("evals") or []),
        ):
            return solver.solve(
                args.get("evals") or [],
                int(args.get("min_index") or 0),
                extra_usage=args.get("extra_usage") or None,
                timeout_s=float(args.get("timeout_s") or 5.0),
            )

    def sync(self, args):
        args = args or {}
        solver = self.local_solver()
        return {
            "last_sync": solver.warm(int(args.get("min_index") or 0)),
            "member": self.cs.node_id,
        }

    def status(self, args):
        solver = self.local_solver(build=False)
        if solver is None:
            return {"node_id": self.cs.node_id, "resident": False,
                    "warmups": 0, "solves": 0, "syncs": 0, "in_flight": 0,
                    "last_sync": "cold"}
        return solver.stats()

    # the wire verbs are capitalized (``SolverPool.Solve`` — the
    # reference's Go-style RPC names); keep pythonic methods callable too
    Solve = solve
    Sync = sync
    Status = status


class SolverPool:
    """Pool tracker + dispatcher, one per cluster server.

    Always constructed (cheap); a cluster with no advertised members
    just always falls back local. ``role == "solver"`` additionally
    advertises THIS server as a member (serf tag ``solver=1``) and runs
    the periodic warm loop that keeps its resident replica's delta-sync
    path hot across leadership churn."""

    def __init__(self, cluster, role: str = "", members=(),
                 sync_interval_s: float = 2.0) -> None:
        self.cluster = cluster
        self.role = role or ""
        self.static_members = tuple(members or ())
        self.sync_interval_s = float(sync_interval_s)
        self.solve_timeout_s = 30.0
        self.endpoint = SolverPoolEndpoint(cluster, self)
        self._lock = threading.Lock()
        self._inflight: set[_Dispatch] = set()
        # member id -> leader-side per-member counters
        self._member_stats: dict[str, dict] = {}
        self._fault_until: dict[str, float] = {}
        self.dispatched = 0
        self.completed = 0
        self.faults = 0
        self.aborted = 0
        self.fallback_local = 0
        self._warm_stop: Optional[threading.Event] = None
        self._warm_thread: Optional[threading.Thread] = None
        self._provider = metrics.register_provider(
            "nomad.solver.pool", self._gauges
        )
        if self.role == "solver":
            self._advertise(True)

    # -- config / lifecycle --------------------------------------------

    def _advertise(self, on: bool) -> None:
        serf = self.cluster.serf
        tags = serf.local.tags
        if on:
            if tags.get("solver") == "1":
                return
            tags["solver"] = "1"
        else:
            if "solver" not in tags:
                return
            tags.pop("solver", None)
        # a tag change rides gossip on a higher incarnation (membership
        # merge adopts tags from the fresher record)
        serf.local.incarnation += 1

    def configure(self, role: str, members=(),
                  sync_interval_s: Optional[float] = None) -> bool:
        """SIGHUP-reloadable knobs (Agent.reload). Returns True when
        anything changed."""
        changed = False
        with self._lock:
            role = role or ""
            if role != self.role:
                self.role = role
                self._advertise(role == "solver")
                changed = True
            members = tuple(members or ())
            if members != self.static_members:
                self.static_members = members
                changed = True
            if (
                sync_interval_s is not None
                and float(sync_interval_s) != self.sync_interval_s
            ):
                self.sync_interval_s = float(sync_interval_s)
                changed = True
        if changed:
            self._reconcile_warm_loop()
        return changed

    def start(self) -> None:
        self._reconcile_warm_loop()

    def _reconcile_warm_loop(self) -> None:
        if self.role == "solver" and self._warm_thread is None:
            self._warm_stop = threading.Event()
            self._warm_thread = threading.Thread(
                target=self._warm_loop, args=(self._warm_stop,),
                name=f"solver-pool-warm-{self.cluster.node_id}",
                daemon=True,
            )
            self._warm_thread.start()
        elif self.role != "solver" and self._warm_thread is not None:
            self._warm_stop.set()
            self._warm_thread = None

    def _warm_loop(self, stop: threading.Event) -> None:
        """The member-side sync loop: a periodic delta sync against the
        local raft replica keeps the resident tensors' fingerprint
        current, so the first batch a NEW leader dispatches here hits
        the scatter path — zero warmup on failover."""
        while not stop.wait(self.sync_interval_s):
            try:
                self.endpoint.local_solver().warm()
            except Exception:
                # replica catching up / store mid-restore: next tick
                logger.debug("solver pool warm tick failed", exc_info=True)

    def stop(self) -> None:
        if self._warm_stop is not None:
            self._warm_stop.set()
            self._warm_thread = None
        self.abort_inflight()
        metrics.unregister_provider("nomad.solver.pool", self._provider)

    # -- membership -----------------------------------------------------

    def members(self) -> list[dict]:
        """Current pool membership from gossip: servers advertising
        ``solver=1`` (optionally filtered by the static ``members``
        allowlist), with serf status and leader-side dispatch stats."""
        now = time.monotonic()
        out = []
        for m in self.cluster.serf.members():
            if m.tags.get("solver") != "1":
                continue
            if m.tags.get("role") != "server":
                continue
            if self.static_members and m.id not in self.static_members:
                continue
            st = self._member_stats.get(m.id, {})
            out.append({
                "id": m.id,
                "addr": list(m.addr),
                "status": m.status,
                "self": m.id == self.cluster.node_id,
                "cooling": self._fault_until.get(m.id, 0.0) > now,
                "in_flight": st.get("in_flight", 0),
                "dispatched": st.get("dispatched", 0),
                "faults": st.get("faults", 0),
            })
        return out

    def _pick(self) -> Optional[tuple[str, tuple]]:
        """Least-loaded healthy member, excluding this server (the
        leader solving for itself over a socket would just be the local
        path with extra hops)."""
        best = None
        for m in self.members():
            if m["self"] or m["status"] != "alive" or m["cooling"]:
                continue
            if best is None or m["in_flight"] < best["in_flight"]:
                best = m
        if best is None:
            return None
        return best["id"], tuple(best["addr"])

    def on_member_event(self, kind: str, member) -> None:
        """Fed from the cluster's membership events: a pool member
        confirmed dead by gossip fails its in-flight dispatches NOW
        instead of waiting out the RPC timeout."""
        if member.tags.get("solver") != "1":
            return
        if kind in ("member-failed", "member-leave"):
            with self._lock:
                pending = [
                    d for d in self._inflight if d.member_id == member.id
                ]
            for d in pending:
                d.fail(ConnectionError(f"pool member {member.id} {kind}"))

    # -- dispatch -------------------------------------------------------

    def dispatch_batch(self, evals: list, snapshot, planner,
                       config, extra_usage: Optional[dict] = None,
                       ) -> Optional[RemotePendingBatch]:
        """Route one mega-batch to the pool. Returns None (caller keeps
        the local path) when no healthy member is available."""
        picked = self._pick()
        if picked is None:
            self.fallback_local += 1
            metrics.incr("nomad.solver.pool.fallback_local")
            return None
        member_id, addr = picked
        d = _Dispatch(member_id, addr)
        with self._lock:
            self._inflight.add(d)
            st = self._member_stats.setdefault(
                member_id, {"in_flight": 0, "dispatched": 0, "faults": 0}
            )
            st["in_flight"] += 1
            st["dispatched"] += 1
            self.dispatched += 1
        metrics.incr("nomad.solver.pool.dispatched")
        args = {
            "evals": evals,
            "min_index": snapshot.index,
            "extra_usage": extra_usage,
        }
        # the caller's trace rides the RPC (rpc/wire.py TRACE_KEY): the
        # member's spans come back into the batch's trace
        tctx = trace.current()

        def _call() -> None:
            try:
                with trace.use(tctx):
                    res = self.cluster.pool.call(
                        addr, "SolverPool.Solve", args,
                        timeout_s=self.solve_timeout_s,
                    )
                if not d.done.is_set():
                    d.result = res
                    d.done.set()
            except Exception as e:
                self._record_fault(d, e)
            finally:
                with self._lock:
                    st["in_flight"] = max(0, st["in_flight"] - 1)

        threading.Thread(
            target=_call, name=f"solver-pool-dispatch-{member_id}",
            daemon=True,
        ).start()
        return RemotePendingBatch(self, d, snapshot, evals, planner, config)

    def _record_fault(self, d: _Dispatch, exc: BaseException) -> None:
        with self._lock:
            self.faults += 1
            st = self._member_stats.get(d.member_id)
            if st is not None:
                st["faults"] += 1
            self._fault_until[d.member_id] = (
                time.monotonic() + FAULT_COOLDOWN_S
            )
        metrics.incr("nomad.solver.pool.member_fault")
        blackbox.record(
            blackbox.KIND_POOL_FAULT, d.member_id,
            error=f"{type(exc).__name__}: {exc}",
        )
        logger.warning(
            "solver pool member %s failed: %s: %s",
            d.member_id, type(exc).__name__, exc,
        )
        d.fail(exc)

    def note_completed(self, d: _Dispatch) -> None:
        with self._lock:
            self.completed += 1
            self._inflight.discard(d)

    def abort_inflight(self) -> int:
        """Leadership transfer / shutdown: every in-flight dispatch
        resolves ABORTED so the commit stage nacks its batch (the evals
        redeliver on the new leader's broker). Never drops."""
        with self._lock:
            pending = [d for d in self._inflight if not d.done.is_set()]
            self._inflight.clear()
        for d in pending:
            d.abort()
            self.aborted += 1
            metrics.incr("nomad.solver.pool.aborted")
        return len(pending)

    # -- observability --------------------------------------------------

    def _gauges(self) -> dict:
        members = self.members()
        healthy = sum(
            1 for m in members
            if m["status"] == "alive" and not m["self"] and not m["cooling"]
        )
        return {
            "members": healthy,
            "in_flight": sum(m["in_flight"] for m in members),
        }

    def stats_snapshot(self) -> dict:
        """Live pool state (same idiom as the broker/plan-queue
        stats_snapshot surfaces)."""
        local = self.endpoint.local_solver(build=False)
        with self._lock:
            inflight = len(self._inflight)
        return {
            "role": self.role,
            "sync_interval_s": self.sync_interval_s,
            "static_members": list(self.static_members),
            "dispatched": self.dispatched,
            "completed": self.completed,
            "faults": self.faults,
            "aborted": self.aborted,
            "fallback_local": self.fallback_local,
            "in_flight": inflight,
            "members": self.members(),
            "local": local.stats() if local is not None else None,
        }

    def pool_status(self, per_member_timeout_s: float = 2.0) -> dict:
        """stats_snapshot plus each member's own ``SolverPool.Status``,
        pulled in parallel with a bounded per-member deadline (the
        cluster_health aggregation pattern: a partitioned member slots
        an error row, never a hang)."""
        out = self.stats_snapshot()
        rows: dict[str, dict] = {}

        def _pull(mid: str, addr: tuple) -> None:
            try:
                if mid == self.cluster.node_id:
                    rows[mid] = self.endpoint.status(None)
                else:
                    rows[mid] = self.cluster.pool.call(
                        addr, "SolverPool.Status", {},
                        timeout_s=per_member_timeout_s,
                    )
            except Exception as e:
                rows[mid] = {"node_id": mid, "error": str(e)}

        threads = []
        for m in out["members"]:
            t = threading.Thread(
                target=_pull, args=(m["id"], tuple(m["addr"])),
                name=f"solver-pool-status-{m['id']}", daemon=True,
            )
            t.start()
            threads.append(t)
        for t in threads:
            t.join(per_member_timeout_s + 0.5)
        for m in out["members"]:
            m["remote"] = rows.get(m["id"])
        return out
