"""Deterministic fault injection (testing/chaos.py) and the
churn-hardening it gates, against the port: the cases of
``tests/test_chaos.py`` with their imports pointed at
``nomad_tpu_torch`` and the reference's assertions and timing gates
unchanged. Every server states its scheduler config: the reference's
default (``backend="host"``) on ``device="cpu"``, and for the device
failover cases the batch solver (``backend="gpu"``, the reference's
``"tpu"``) on ``device="cpu"``, whose kernel wrappers run their plain
twins. Covered, as in the reference: RetryPolicy units, FaultPlane
determinism, broker/restore idempotency across leadership churn, device
failover, and scripted kill/partition/heal scenarios against live
in-process clusters with the no-acked-write-lost / no-duplicate-alloc /
convergence invariants asserted.

Fast subset (seeded, single-process, seconds) runs in tier-1; the long
scenario (``test_repeated_churn_with_fsync_faults``) carries the
reference's `slow` marker as well.
"""

import threading
import time

import pytest

from nomad_tpu_torch import metrics, mock
from nomad_tpu_torch.metrics import Registry
from nomad_tpu_torch.retry import RetryPolicy, call_with_retry
from nomad_tpu_torch.rpc import ConnPool, RPCServer
from nomad_tpu_torch.scheduler.context import SchedulerConfig
from nomad_tpu_torch.server import Server
from nomad_tpu_torch.server.raft_replication import NotLeaderError
from nomad_tpu_torch.structs import Evaluation, generate_uuid, now_ns
from nomad_tpu_torch.testing import chaos
from nomad_tpu_torch.testing.chaos import ChaosCluster, FaultPlane
from nomad_tpu_torch.testing.waits import wait_for_state

pytestmark = pytest.mark.chaos


def cpu_config(**kw) -> SchedulerConfig:
    """The reference's default scheduler config, on the CPU."""
    kw.setdefault("backend", "host")
    return SchedulerConfig(device="cpu", **kw)


@pytest.fixture(autouse=True)
def _no_leaked_plane():
    """Every test starts and ends plane-free."""
    chaos.uninstall()
    yield
    chaos.uninstall()


@pytest.fixture()
def fresh_registry():
    old = metrics._install_registry(Registry())
    yield metrics.registry()
    metrics._install_registry(old)


def counters(reg) -> dict:
    return reg.snapshot()["counters"]


def wait_until(fn, timeout_s=30.0, interval=0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


# ---------------------------------------------------------------------------
# RetryPolicy
# ---------------------------------------------------------------------------


class TestRetryPolicy:
    def test_backoff_bounds_and_cap(self):
        import random

        pol = RetryPolicy(base_s=0.1, max_s=0.4, multiplier=2.0, jitter=0.5)
        rng = random.Random(7)
        for attempt, raw in ((1, 0.1), (2, 0.2), (3, 0.4), (9, 0.4)):
            for _ in range(20):
                d = pol.delay_s(attempt, rng)
                assert raw * 0.5 <= d <= raw, (attempt, d)

    def test_seeded_delays_reproduce(self):
        import random

        pol = RetryPolicy(base_s=0.05, jitter=1.0)
        a = [pol.delay_s(i, random.Random(3)) for i in range(1, 6)]
        b = [pol.delay_s(i, random.Random(3)) for i in range(1, 6)]
        assert a == b

    def test_call_with_retry_emits_metric_then_succeeds(self, fresh_registry):
        attempts = []

        def fn():
            attempts.append(1)
            if len(attempts) < 3:
                raise NotLeaderError(None)
            return "ok"

        pol = RetryPolicy(base_s=0.001, max_s=0.002, deadline_s=5.0)
        out = call_with_retry(
            fn, policy=pol,
            retry_if=lambda e: isinstance(e, NotLeaderError),
            label="unit.test",
        )
        assert out == "ok" and len(attempts) == 3
        assert counters(fresh_registry)["nomad.rpc.retry_count.unit.test"] == 2

    def test_deadline_reraises_last_error(self, fresh_registry):
        pol = RetryPolicy(base_s=0.05, max_s=0.05, deadline_s=0.12)

        def fn():
            raise NotLeaderError(None)

        t0 = time.monotonic()
        with pytest.raises(NotLeaderError):
            call_with_retry(
                fn, policy=pol,
                retry_if=lambda e: isinstance(e, NotLeaderError),
                label="unit.deadline",
            )
        assert time.monotonic() - t0 < 2.0

    def test_stop_event_aborts_backoff(self):
        stop = threading.Event()
        stop.set()
        pol = RetryPolicy(base_s=5.0, max_s=5.0, deadline_s=60.0)

        def fn():
            raise NotLeaderError(None)

        t0 = time.monotonic()
        with pytest.raises(NotLeaderError):
            call_with_retry(
                fn, policy=pol,
                retry_if=lambda e: isinstance(e, NotLeaderError),
                label="unit.stop", stop=stop,
            )
        assert time.monotonic() - t0 < 1.0, "set stop event must not sleep"

    def test_non_matching_error_propagates_without_retry(self, fresh_registry):
        def fn():
            raise ValueError("boom")

        with pytest.raises(ValueError):
            call_with_retry(
                fn, policy=RetryPolicy(deadline_s=5.0),
                retry_if=lambda e: isinstance(e, NotLeaderError),
                label="unit.miss",
            )
        assert "nomad.rpc.retry_count.unit.miss" not in counters(fresh_registry)


# ---------------------------------------------------------------------------
# FaultPlane
# ---------------------------------------------------------------------------


class TestFaultPlane:
    def test_seed_fixes_probabilistic_schedule(self):
        def schedule(seed):
            p = FaultPlane(seed=seed)
            p.drop_rpc(prob=0.5)
            out = []
            for _ in range(32):
                try:
                    p.on_rpc_call("a", ("127.0.0.1", 1), "X.y")
                    out.append(0)
                except ConnectionError:
                    out.append(1)
            return out

        assert schedule(11) == schedule(11)
        assert schedule(11) != schedule(12), "different seed, different faults"

    def test_times_bounds_and_heal(self):
        p = FaultPlane()
        p.drop_rpc(method="X.y", times=2)
        for _ in range(2):
            with pytest.raises(ConnectionError):
                p.on_rpc_call("", ("h", 1), "X.y")
        p.on_rpc_call("", ("h", 1), "X.y")  # exhausted: passes
        p.drop_rpc(method="X.y")
        p.heal()
        p.on_rpc_call("", ("h", 1), "X.y")
        assert p.fired["rpc.drop"] == 2

    def test_partition_is_symmetric_and_label_scoped(self):
        p = FaultPlane()
        p.register_addr("s0", ("127.0.0.1", 10))
        p.register_addr("s1", ("127.0.0.1", 11))
        p.partition({"s0"}, {"s1"})
        with pytest.raises(ConnectionError):
            p.on_rpc_call("s0", ("127.0.0.1", 11), "Raft.append_entries")
        with pytest.raises(ConnectionError):
            p.on_rpc_call("s1", ("127.0.0.1", 10), "Raft.request_vote")
        # an unlabeled client pool crosses the cut freely
        p.on_rpc_call("", ("127.0.0.1", 11), "Job.register")

    def test_env_knobs_reported(self, monkeypatch):
        assert chaos.env_knobs_active() == []
        monkeypatch.setenv("NOMAD_TPU_INJECT_DEVICE_LATENCY_S", "0.5")
        assert "NOMAD_TPU_INJECT_DEVICE_LATENCY_S" in chaos.env_knobs_active()
        monkeypatch.setenv("NOMAD_TPU_INJECT_DEVICE_LATENCY_S", "0")
        assert chaos.env_knobs_active() == []
        chaos.install(FaultPlane()).drop_rpc()
        assert "<fault-plane-installed>" in chaos.env_knobs_active()

    def test_rpc_drop_and_delay_through_real_fabric(self):
        class Echo:
            def ping(self, args):
                return args

        server = RPCServer()
        server.register("Echo", Echo())
        server.start()
        pool = ConnPool()
        pool.owner = "client-a"
        plane = chaos.install(FaultPlane())
        plane.register_addr("srv", server.addr)
        try:
            assert pool.call(server.addr, "Echo.ping", 1) == 1
            plane.partition({"client-a"}, {"srv"})
            with pytest.raises(ConnectionError):
                pool.call(server.addr, "Echo.ping", 2)
            plane.heal()
            assert pool.call(server.addr, "Echo.ping", 3) == 3
            plane.delay_rpc(0.2, dst="srv", times=1)
            t0 = time.monotonic()
            assert pool.call(server.addr, "Echo.ping", 4) == 4
            assert time.monotonic() - t0 >= 0.2
        finally:
            pool.shutdown()
            server.shutdown()

    def test_response_drop_times_out_caller(self):
        class Echo:
            def ping(self, args):
                return args

        server = RPCServer()
        server.chaos_label = "srv"
        server.register("Echo", Echo())
        server.start()
        pool = ConnPool()
        plane = chaos.install(FaultPlane())
        try:
            # at-most-once: a DELIVERED request whose response is lost
            # must NOT be blindly re-sent by the pool (request_sent
            # marking) — the caller sees the timeout on the first loss
            plane.drop_response(label="srv", method="Echo.ping", times=1)
            with pytest.raises(TimeoutError):
                pool.call(server.addr, "Echo.ping", 1, timeout_s=0.3)
            assert plane.fired["serve.drop"] == 1, (
                "exactly one delivery: the pool must not re-send"
            )
            # delivered-but-unanswered, then healthy again
            assert pool.call(server.addr, "Echo.ping", 2) == 2
        finally:
            pool.shutdown()
            server.shutdown()

    def test_disk_fault_injection_bounded(self, tmp_path):
        from nomad_tpu_torch import codec
        from nomad_tpu_torch.server.raft_replication import LogEntry
        from nomad_tpu_torch.server.raft_store import RaftLogStore

        store = RaftLogStore(str(tmp_path / "raft.db"))
        store.chaos_label = "s0"
        plane = chaos.install(FaultPlane())
        plane.fail_disk(label="s0", op="append", times=1)
        try:
            with pytest.raises(OSError):
                store.append([LogEntry(1, 1, "noop", codec.pack(None))])
            store.append([LogEntry(1, 1, "noop", codec.pack(None))])
            assert [e.index for e in store.load_log()] == [1]
        finally:
            store.close()


# ---------------------------------------------------------------------------
# Hardened paths: follower durability rollback, broker idempotency,
# worker backoff, device failover
# ---------------------------------------------------------------------------


def test_follower_rolls_back_memory_log_on_disk_failure(tmp_path):
    """An injected fsync failure during AppendEntries must not leave the
    entries in the in-memory log: the leader's retry would find them
    'already appended', skip the store write, and ack entries that never
    hit disk — an acked write lost on the next restart."""
    from nomad_tpu_torch import codec
    from nomad_tpu_torch.server.raft import FSM
    from nomad_tpu_torch.server.raft_replication import RaftNode
    from nomad_tpu_torch.server.raft_store import RaftLogStore
    from nomad_tpu_torch.state import StateStore

    store = RaftLogStore(str(tmp_path / "raft.db"))
    store.chaos_label = "f0"
    node = RaftNode(
        "f0", FSM(StateStore()), ConnPool(), ("127.0.0.1", 0),
        peers={"lead": ("127.0.0.1", 1)}, bootstrap_expect=0, store=store,
    )
    req = {
        "term": 1,
        "leader_id": "lead",
        "prev_log_index": 0,
        "prev_log_term": 0,
        "entries": [(1, 1, "noop", codec.pack(None))],
        "leader_commit": 0,
    }
    plane = chaos.install(FaultPlane())
    plane.fail_disk(label="f0", op="append", times=1)
    try:
        with pytest.raises(OSError):
            node._handle_append_entries(req)
        assert node._last_log_index() == 0, "in-memory suffix must roll back"
        assert store.load_log() == []
        # the leader's retry now re-appends AND persists
        resp = node._handle_append_entries(req)
        assert resp["success"]
        assert node._last_log_index() == 1
        assert [e.index for e in store.load_log()] == [1]
    finally:
        store.close()


def test_transient_injected_drop_absorbed_by_pool_redial():
    """A times=1 drop models one transient network blip: it must ride
    the pool's real rundown+redial path and be absorbed by the built-in
    retry, exactly like a genuine dead-connection error."""

    class Echo:
        def ping(self, args):
            return args

    server = RPCServer()
    server.register("Echo", Echo())
    server.start()
    pool = ConnPool()
    plane = chaos.install(FaultPlane())
    try:
        plane.drop_rpc(method="Echo.ping", times=1)
        assert pool.call(server.addr, "Echo.ping", 7) == 7
        assert plane.fired["rpc.drop"] == 1, "the drop must actually fire"
    finally:
        pool.shutdown()
        server.shutdown()


def test_barrier_persist_failure_abandons_leadership(tmp_path):
    """A leader whose barrier cannot be made durable must step down:
    keeping the barrier only in memory while later appends persist
    would leave a HOLE in the stored log and corrupt the index
    arithmetic on restart. The node re-elects once the disk recovers."""
    from nomad_tpu_torch.server.raft import FSM
    from nomad_tpu_torch.server.raft_replication import LEADER, RaftNode
    from nomad_tpu_torch.server.raft_store import RaftLogStore
    from nomad_tpu_torch.state import StateStore

    store = RaftLogStore(str(tmp_path / "raft.db"))
    store.chaos_label = "b0"
    plane = chaos.install(FaultPlane())
    plane.fail_disk(label="b0", op="append", times=1)
    node = RaftNode(
        "b0", FSM(StateStore()), ConnPool(), ("127.0.0.1", 0),
        peers={}, bootstrap_expect=1, store=store,
    )
    try:
        node.start()  # first election: barrier persist fails → step down
        assert wait_until(lambda: node.state == LEADER, 15), (
            "node must re-elect once the disk recovers"
        )
        # the durable log is contiguous: no hole where the failed
        # barrier's index would have been
        idxs = [e.index for e in store.load_log()]
        assert idxs == list(range(idxs[0], idxs[0] + len(idxs))), idxs
        assert plane.fired.get("disk.fail", 0) == 1
    finally:
        node.stop()
        store.close()


def test_leadership_lost_error_is_not_forwarder_retryable():
    """Outcome-unknown errors (deposed AFTER the entry was replicating)
    must not be auto-retried by the forwarder — locally or as the RPC
    string — while plain NotLeaderError and dead-leader dials are."""
    from nomad_tpu_torch.rpc import RPCError
    from nomad_tpu_torch.server.cluster import _is_leaderless_error
    from nomad_tpu_torch.server.raft_replication import LeadershipLostError

    assert _is_leaderless_error(NotLeaderError(None))
    assert _is_leaderless_error(ConnectionRefusedError())
    assert _is_leaderless_error(RPCError("NotLeaderError: not the leader"))
    assert _is_leaderless_error(RPCError("no cluster leader"))
    assert not _is_leaderless_error(LeadershipLostError(None))
    assert not _is_leaderless_error(
        RPCError("LeadershipLostError: not the leader (leader hint: None)")
    )
    assert not _is_leaderless_error(ConnectionError("connection closed"))
    assert not _is_leaderless_error(ValueError("boom"))


def test_broker_preserves_nack_counts_across_leadership_churn():
    from nomad_tpu_torch.server.eval_broker import EvalBroker

    broker = EvalBroker(nack_delay_s=0.01, delivery_limit=3)
    broker.set_enabled(True)
    ev = Evaluation(
        id=generate_uuid(), namespace="default", priority=50,
        type="service", job_id="j1", status="pending",
        create_time=now_ns(), modify_time=now_ns(),
    )
    broker.enqueue(ev)
    got, token = broker.dequeue(["service"], timeout_s=1)
    assert got is not None
    assert broker._attempts[ev.id] == 1
    # leadership revoked mid-flight, then re-established on this node
    broker.set_enabled(False)
    broker.set_enabled(True)
    broker.enqueue(ev)  # _restore_evals re-enqueues the still-pending eval
    got, token = broker.dequeue(["service"], timeout_s=1)
    assert got is not None
    assert broker._attempts[ev.id] == 2, "delivery count must survive churn"
    broker.set_enabled(False)


def test_broker_tracks_and_restore_idempotency():
    srv = Server(num_workers=0, scheduler_config=cpu_config())
    srv.establish_leadership()
    try:
        ev = Evaluation(
            id=generate_uuid(), namespace="default", priority=50,
            type="service", job_id="idem-j", status="pending",
            create_time=now_ns(), modify_time=now_ns(),
        )
        srv.raft_apply("eval_update", [ev])  # side channel enqueues it
        assert srv.eval_broker.tracks(ev.id)
        before = srv.eval_broker.ready_count()
        srv._restore_evals()  # e.g. a second establishment after churn
        srv._restore_evals()
        assert srv.eval_broker.ready_count() == before, (
            "restore must not double-enqueue a tracked eval"
        )
    finally:
        srv.shutdown()


def test_worker_notleader_backoff_emits_retry_metric(fresh_registry):
    """The hot-loop fix: NotLeaderError on submit nacks AND backs off,
    emitting nomad.rpc.retry_count.worker.invoke."""
    srv = Server(num_workers=1, scheduler_config=cpu_config())
    srv.establish_leadership()
    try:
        srv.eval_broker.nack_delay_s = 0.05
        node = mock.node()
        srv.node_register(node)
        job = mock.job(id="nl-job")
        srv.job_register(job)
        assert srv.wait_for_evals(15)

        # every subsequent write now fails as a deposed leader would
        def deposed(msg_type, payload):
            raise NotLeaderError(None)

        srv.set_raft_applier(deposed)
        ev = Evaluation(
            id=generate_uuid(), namespace="default", priority=50,
            type="service", job_id="nl-job", status="pending",
            triggered_by="job-eval",
            create_time=now_ns(), modify_time=now_ns(),
        )
        srv.eval_broker.enqueue(ev)
        assert wait_until(
            lambda: counters(fresh_registry).get(
                "nomad.rpc.retry_count.worker.invoke", 0
            ) >= 1,
            timeout_s=20,
        ), "worker must emit the retry metric on NotLeaderError"
    finally:
        srv.set_raft_applier(None)
        srv.shutdown()


class TestDeviceFailover:
    def _tpu_server(self):
        cfg = cpu_config(backend="gpu", small_batch_threshold=0)
        srv = Server(use_tpu_batch_worker=True, scheduler_config=cfg)
        srv.eval_broker.nack_delay_s = 0.2
        srv.establish_leadership()
        return srv

    def _place(self, srv, job_id, count=2, timeout_s=30):
        job = mock.job(id=job_id)
        job.task_groups[0].count = count
        srv.job_register(job)
        return wait_for_state(
            [srv],
            lambda: len([
                a for a in srv.state.allocs_by_job("default", job_id)
                if not a.terminal_status()
            ]) == count,
            timeout_s=timeout_s,
        )

    def test_retriable_fault_falls_back_to_host_solve(self, fresh_registry):
        srv = self._tpu_server()
        plane = chaos.install(FaultPlane())
        try:
            for _ in range(4):
                srv.node_register(mock.node())
            plane.fail_device(phase="finish", retriable=True, times=1)
            assert self._place(srv, "dev-fo"), (
                "placement must complete via the host fallback"
            )
            assert counters(fresh_registry).get(
                "nomad.worker.device_failover", 0
            ) >= 1
            chaos.assert_no_duplicate_allocs(srv.state)
        finally:
            srv.shutdown()

    def test_terminal_fault_nacks_and_redelivers(self, fresh_registry):
        srv = self._tpu_server()
        plane = chaos.install(FaultPlane())
        try:
            for _ in range(4):
                srv.node_register(mock.node())
            plane.fail_device(phase="finish", retriable=False, times=1)
            assert self._place(srv, "dev-term"), (
                "eval must redeliver after the terminal fault"
            )
            # terminal ⇒ no failover; the nack/redeliver path served it
            assert counters(fresh_registry).get(
                "nomad.worker.device_failover", 0
            ) == 0
            chaos.assert_no_duplicate_allocs(srv.state)
        finally:
            srv.shutdown()

    def test_dispatch_fault_redelivers(self, fresh_registry):
        srv = self._tpu_server()
        plane = chaos.install(FaultPlane())
        try:
            for _ in range(4):
                srv.node_register(mock.node())
            plane.fail_device(phase="dispatch", retriable=True, times=1)
            assert self._place(srv, "dev-dispatch")
            chaos.assert_no_duplicate_allocs(srv.state)
        finally:
            srv.shutdown()


# ---------------------------------------------------------------------------
# Cluster scenarios (scripted kill / partition / heal)
# ---------------------------------------------------------------------------


class _Heartbeater:
    """Keeps the scenario's mock node alive across churn: a client-side
    heartbeat loop that follows whatever leader exists (the node TTL is
    10-15s and scenarios run longer — a silent node would be marked
    down mid-scenario and its allocs rescheduled)."""

    def __init__(self, cluster, node_id: str, interval_s: float = 2.0):
        self.cluster = cluster
        self.node_id = node_id
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._pool = ConnPool()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while not self._stop.wait(self.interval_s):
            lead = self.cluster.leader()
            if lead is None:
                continue
            try:
                self._pool.call(
                    lead.addr, "Node.heartbeat",
                    {"node_id": self.node_id}, timeout_s=5,
                )
            except Exception:
                pass  # churn window; the next beat follows the new leader

    def stop(self):
        self._stop.set()
        self._t.join(timeout=5)
        self._pool.shutdown()


def _register_through_churn(cluster, pool, job, deadline_s=120.0):
    """Register ``job`` no matter what the leadership weather is doing,
    and record it acked only once an RPC definitively succeeded.

    A raw ``pool.call(lead.addr, "Job.register", ...)`` rides the
    forwarder's 10s FORWARD_POLICY deadline: under suite-tail load plus
    seeded fsync faults a leaderless window can outlast it, and
    LeadershipLostError (deposed mid-replication, outcome unknown) is
    never retried by design. Both made test_repeated_churn_with_
    fsync_faults flip on the RPC *surface* rather than the convergence
    invariants it gates. Registering the same job again is an
    idempotent upsert (worst case an extra eval the broker dedups), so
    the scenario-side answer is to retry through churn with its own,
    scenario-sized deadline — exactly what wait_for_stable_leader's
    docstring prescribes."""
    deadline = time.monotonic() + deadline_s
    last = None
    while time.monotonic() < deadline:
        lead = cluster.wait_for_stable_leader(
            timeout_s=max(1.0, deadline - time.monotonic())
        )
        if lead is None:
            break
        try:
            pool.call(lead.addr, "Job.register", {"job": job},
                      timeout_s=30)
            cluster.acked_jobs.add(job.id)
            return
        except Exception as e:  # leaderless / deposed / injected fault
            last = e
            time.sleep(0.2)
    raise AssertionError(
        f"job {job.id} never registered within {deadline_s}s "
        f"(last error: {last})"
    )


def _register_workload(cluster, pool, n_jobs=3, count=2):
    """Register a node and n_jobs service jobs through the fabric,
    recording each job as acked only after its RPC succeeded; wait for
    every alloc to place."""
    lead = cluster.wait_for_stable_leader()
    assert lead is not None, "no stable leader"
    node = mock.node()
    pool.call(lead.addr, "Node.register", {"node": node})
    hb = _Heartbeater(cluster, node.id)
    jobs = []
    for i in range(n_jobs):
        job = mock.job(id=f"chaos-j{i}")
        job.task_groups[0].count = count
        _register_through_churn(cluster, pool, job)
        jobs.append(job)

    def placed():
        ld = cluster.leader()
        if ld is None:
            return False
        st = ld.server.state
        return all(
            len([
                a for a in st.allocs_by_job("default", j.id)
                if not a.terminal_status()
            ]) == count
            for j in jobs
        )

    assert wait_for_state(
        cluster.servers.values(), placed, timeout_s=60
    ), "workload never placed"
    return jobs, hb


def _assert_alloc_counts(cluster, jobs, count=2):
    for nid, cs in cluster.servers.items():
        st = cs.server.state
        for j in jobs:
            live = [
                a for a in st.allocs_by_job("default", j.id)
                if not a.terminal_status()
            ]
            assert len(live) == count, (
                f"{nid}: job {j.id} has {len(live)} live allocs, "
                f"want {count} (ids {[a.id for a in live]})"
            )


def test_leader_kill_during_log_replay(tmp_path):
    """THE restart-churn regression (the formerly load-flaky
    test_full_cluster_restart_preserves_state failure mode): full
    cluster restart, first elected leader killed WHILE replaying its
    log (commit advancement throttled so the window is real), survivors
    re-elect and converge, the killed node rejoins — with no acked
    write lost and no duplicate alloc minted."""
    cluster = ChaosCluster(
        3, str(tmp_path), seed=29, scheduler_config=cpu_config()
    )
    pool = ConnPool()
    hb = None
    try:
        cluster.start()
        jobs, hb = _register_workload(cluster, pool)
        # full-cluster hard stop
        for nid in list(cluster.servers):
            cluster.kill(nid)

        # restart; commit (and thus replay) trickles while AppendEntries
        # is delayed, holding the mid-replay window open
        cluster.plane.delay_rpc(0.05, method="Raft.append_entries")
        for nid in cluster.ids:
            cluster.restart(nid)
        first = None
        deadline = time.monotonic() + 45
        while first is None and time.monotonic() < deadline:
            lead = cluster.leader()
            if lead is not None:
                first = lead.node_id
            else:
                time.sleep(0.01)
        assert first is not None, "restarted cluster never elected"
        killed = cluster.kill_when(
            first, lambda cs: cs.raft.last_applied >= 1, timeout_s=30
        )
        assert killed, "leader survived the kill window"
        cluster.heal()

        # survivors re-elect and finish the replay
        assert cluster.wait_for_stable_leader(60) is not None
        cluster.restart(first)
        assert cluster.converged(60), "cluster did not converge after churn"
        assert wait_for_state(
            cluster.servers.values(),
            lambda: all(
                cs.server.state.job_by_id("default", j.id) is not None
                for cs in cluster.servers.values() for j in jobs
            ),
            timeout_s=45,
        )
        cluster.check_invariants()
        _assert_alloc_counts(cluster, jobs)
    finally:
        if hb is not None:
            hb.stop()
        pool.shutdown()
        cluster.shutdown()


def test_partition_heal_preserves_acked_writes(tmp_path):
    """Partition the leader away from the majority mid-workload: the
    majority elects, writes acked by the majority survive the heal, the
    minority's stale leader steps down, and the invariants hold."""
    cluster = ChaosCluster(
        3, str(tmp_path), seed=41, scheduler_config=cpu_config()
    )
    pool = ConnPool()
    hb = None
    try:
        cluster.start()
        jobs, hb = _register_workload(cluster, pool, n_jobs=2)
        old = cluster.wait_for_stable_leader()
        assert old is not None
        majority = [nid for nid in cluster.ids if nid != old.node_id]
        cluster.partition({old.node_id}, set(majority))

        # the majority side elects a fresh leader and accepts writes
        def majority_leader():
            for nid in majority:
                cs = cluster.servers[nid]
                if cs.is_leader() and cs.raft.wait_for_replay(0.5):
                    return cs
            return None

        assert wait_until(lambda: majority_leader() is not None, 30), (
            "majority never elected through the partition"
        )
        lead = majority_leader()
        job = mock.job(id="chaos-partition-write")
        job.task_groups[0].count = 1
        pool.call(lead.addr, "Job.register", {"job": job})
        cluster.acked_jobs.add(job.id)
        jobs.append(job)

        cluster.heal()
        assert cluster.converged(60), "no convergence after heal"
        # the deposed minority leader stepped down
        assert sum(
            1 for cs in cluster.servers.values() if cs.is_leader()
        ) == 1
        cluster.check_invariants()
        _assert_alloc_counts(cluster, jobs[:2])
    finally:
        if hb is not None:
            hb.stop()
        pool.shutdown()
        cluster.shutdown()


def test_deaf_node_cannot_depose_healthy_leader(tmp_path):
    """Disruptive-server guard (Ongaro §4.2.3): a node whose listener is
    dead (or behind a one-way partition) election-times-out on a loop
    and solicits votes at ever-climbing terms. Without CheckQuorum each
    solicitation deposes the healthy leader; with it the leader holds,
    writes keep committing, and the deaf node is re-adopted with one
    bounded step-down after it heals."""
    cluster = ChaosCluster(
        3, str(tmp_path), seed=71, heartbeat_ms=50, election_ms=300,
        scheduler_config=cpu_config(),
    )
    pool = ConnPool()
    hb = None
    try:
        cluster.start()
        jobs, hb = _register_workload(cluster, pool, n_jobs=1)
        lead = cluster.wait_for_stable_leader()
        assert lead is not None
        deaf = next(n for n in cluster.ids if n != lead.node_id)
        # one-way deafness: nothing REACHES the deaf node; its own vote
        # solicitations still go out — the disruptive pattern
        cluster.plane.drop_rpc(dst=deaf)

        # across many deaf election cycles the leader must hold and
        # writes must keep committing
        for i in range(3):
            time.sleep(0.6)
            assert cluster.servers[lead.node_id].is_leader(), (
                f"healthy leader deposed by deaf node (cycle {i})"
            )
            job = mock.job(id=f"chaos-deaf-{i}")
            job.task_groups[0].count = 1
            pool.call(lead.addr, "Job.register", {"job": job}, timeout_s=15)
            cluster.acked_jobs.add(job.id)
        assert cluster.servers[deaf].raft.current_term > lead.raft.current_term, (
            "scenario sanity: the deaf node should have climbed terms"
        )

        cluster.heal()
        assert cluster.converged(60), "no convergence after the deaf node heals"
        cluster.check_invariants()
    finally:
        if hb is not None:
            hb.stop()
        pool.shutdown()
        cluster.shutdown()


@pytest.mark.slow
def test_repeated_churn_with_fsync_faults(tmp_path):
    """Long scenario: three rounds of leader kill/restart with
    probabilistic fsync failures and slow disk on the raft stores —
    after the final heal the cluster converges with every acked write
    present and no duplicate allocs."""
    cluster = ChaosCluster(
        3, str(tmp_path), seed=97, scheduler_config=cpu_config()
    )
    pool = ConnPool()
    hb = None
    try:
        cluster.start()
        jobs, hb = _register_workload(cluster, pool, n_jobs=2)
        cluster.plane.fail_disk(prob=0.05)
        cluster.plane.slow_disk(0.02, prob=0.1)
        for round_no in range(3):
            lead = cluster.wait_for_stable_leader(60)
            assert lead is not None, f"round {round_no}: no stable leader"
            nid = lead.node_id
            cluster.kill(nid)
            assert cluster.wait_for_stable_leader(60) is not None, (
                f"round {round_no}: survivors never elected"
            )
            job = mock.job(id=f"chaos-churn-{round_no}")
            job.task_groups[0].count = 1
            _register_through_churn(cluster, pool, job)
            cluster.restart(nid)
        cluster.heal()
        assert cluster.converged(90), "no convergence after churn rounds"
        cluster.check_invariants()
        _assert_alloc_counts(cluster, jobs)
    finally:
        if hb is not None:
            hb.stop()
        pool.shutdown()
        cluster.shutdown()
