"""``tests/test_fleet.py`` against the port (the heartbeat wheel, the
watch hub, the register batcher, the top panel and
nomad_tpu_torch/testing/fleet.py), held against nomad_tpu's.

The reference's cases with the reference's gates: imports pointed at
``nomad_tpu_torch``, the fleet runs on ``device="cpu"``; the mini-fleet
runs the GPU batch worker on the kernels' plain twins (the path the card
runs at 10,000 nodes). Held against nomad_tpu (tolerance: exact): both
packages' heartbeat wheels on one seeded schedule under one fake clock
expire the same nodes in the same batches; both packages' ``SimFleet``
draw the same victims, reconnect order and heartbeat-latency reservoir
from one seed; both top panels render one snapshot alike.

The reference's docstring: fleet-scale survival battery.

Covers the three storm-hardening mechanisms plus the simulated fleet
that exercises them end to end:

  * the sharded heartbeat timer wheel (server/heartbeat.py): TTL re-arm
    across leadership transfer, a live heartbeat racing its own expiry,
    tick drift catch-up after a stall, initialize() arming every
    known-alive node, batch expiry delivery;
  * the alloc-watch fan-out hub (server/watch_hub.py): per-node wakeups,
    waiter eviction at the bound, snapshot-restore priming;
  * the node-register batcher (server/server.py): storm coalescing into
    shared raft entries, error propagation, revoke-leadership drain;
  * the `fleet` mini-scenario (testing/fleet.py run_fleet_scale): a
    seeded ~500-node fleet through registration storm → steady state →
    mass expiry → mass reconnect, with the raft-entry accounting gates.
    The ≥5k-node 10-minute acceptance soak is slow-marked
    (scripts/slow-suite.sh picks it up).
"""

import threading
import time

import pytest

from nomad_tpu_torch import metrics, mock
from nomad_tpu_torch.server.heartbeat import (
    HeartbeatWheel,
    rate_scaled_interval,
)
from nomad_tpu_torch.server.server import NodeRegisterBatcher
from nomad_tpu_torch.server.watch_hub import AllocWatchHub
from nomad_tpu_torch.state import StateStore


def _counter(name: str) -> float:
    return metrics.registry().snapshot()["counters"].get(name, 0)


class _FakeClock:
    def __init__(self, start: float = 1000.0) -> None:
        self.t = start

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _manual_wheel(clock, **kw):
    """A wheel under a fake clock with NO ticker thread: tests drive
    ``_advance`` directly, so every expiry decision is deterministic."""
    expired_batches: list[list[str]] = []
    wheel = HeartbeatWheel(
        on_expire=lambda nid: expired_batches.append([nid]),
        on_expire_batch=expired_batches.append,
        **kw,
    )
    wheel._now = clock
    wheel._enabled = True  # armed, but no ticker — tests sweep by hand
    wheel.min_ttl_s = 1.0
    return wheel, expired_batches


class TestRateScaledInterval:
    def test_floor_and_rate_term(self):
        assert rate_scaled_interval(1) == 10.0
        assert rate_scaled_interval(10_000) == pytest.approx(200.0)
        # the fleet knob: a raised rate cap holds the TTL at the floor
        assert rate_scaled_interval(10_000, 2.0, 5000.0) == pytest.approx(2.0)


class TestHeartbeatWheelEdges:
    def test_expiry_racing_live_heartbeat(self):
        """A heartbeat that lands before the sweep wins: the stale
        bucket entry is re-filed under the new deadline, not expired."""
        clock = _FakeClock()
        wheel, expired = _manual_wheel(clock)
        wheel.reset("n1")
        # past the ORIGINAL deadline (ttl <= 1.5x min_ttl with splay)...
        clock.advance(2.0)
        # ...but the node heartbeats just before the ticker sweeps
        wheel.reset("n1")
        assert wheel._advance(clock()) == []
        assert expired == []
        assert wheel.active_count() == 1
        # with no further heartbeats the re-filed deadline expires
        clock.advance(2.0)
        assert wheel._advance(clock()) == ["n1"]
        assert expired == [["n1"]]
        assert wheel.active_count() == 0

    def test_tick_drift_catch_up(self):
        """A stalled ticker (GC pause, scheduler stall) expires the
        whole backlog in ONE sweep — overdue ticks are never skipped."""
        clock = _FakeClock()
        wheel, expired = _manual_wheel(clock)
        for i in range(20):
            wheel.reset(f"n{i}")
            clock.advance(0.05)  # deadlines spread over many ticks
        clock.advance(60.0)  # the stall
        out = wheel._advance(clock())
        assert sorted(out) == sorted(f"n{i}" for i in range(20))
        assert len(expired) == 1  # one coalesced batch, not 20 calls
        assert wheel.active_count() == 0

    def test_clear_skips_expiry(self):
        clock = _FakeClock()
        wheel, expired = _manual_wheel(clock)
        wheel.reset("n1")
        wheel.clear("n1")
        clock.advance(5.0)
        assert wheel._advance(clock()) == []
        assert expired == []

    def test_ttl_rearm_across_leadership_transfer(self):
        """Revoke clears every leader-local TTL; the next incarnation's
        TTLs come exclusively from initialize() + live heartbeats — a
        deadline armed by the OLD leadership must never fire under the
        new one."""
        clock = _FakeClock()
        wheel, expired = _manual_wheel(clock)
        wheel.reset("old-node")
        # revoke → re-establish (set_enabled manages the ticker thread;
        # exercise the real edges, then detach the ticker again so the
        # sweep stays hand-driven)
        wheel.set_enabled(False)
        assert wheel.active_count() == 0
        wheel.set_enabled(True)
        wheel.set_enabled(False)
        wheel._enabled = True
        wheel._now = clock
        wheel.initialize(["a", "b", "c"])
        assert wheel.active_count() == 3
        clock.advance(5.0)
        out = wheel._advance(clock())
        assert sorted(out) == ["a", "b", "c"]
        assert "old-node" not in out

    def test_initialize_arms_all_known_alive(self):
        clock = _FakeClock()
        wheel, _expired = _manual_wheel(clock)
        ids = [f"n{i}" for i in range(50)]
        wheel.initialize(ids)
        assert wheel.active_count() == 50
        stats = wheel.stats()
        assert stats["armed"] == 50
        assert stats["wheel_buckets"] >= 1

    def test_disabled_wheel_drops_inflight_expiry(self):
        """A sweep that loses the race with revoke-leadership delivers
        nothing — down-marks are leader-only actions."""
        clock = _FakeClock()
        wheel, expired = _manual_wheel(clock)
        wheel.reset("n1")
        clock.advance(5.0)
        wheel._enabled = False
        assert wheel._advance(clock()) == []
        assert expired == []

    def test_live_ticker_expires(self):
        """End to end with the REAL ticker thread and monotonic clock."""
        batches: list[list[str]] = []
        done = threading.Event()

        def on_batch(ids):
            batches.append(ids)
            done.set()

        wheel = HeartbeatWheel(
            on_expire=lambda nid: None,
            on_expire_batch=on_batch,
            tick_s=0.02,
        )
        wheel.min_ttl_s = 0.1
        wheel.rate_hz = 1000.0
        wheel.set_enabled(True)
        try:
            wheel.reset("n1")
            assert done.wait(5.0), "armed TTL never expired"
            assert ["n1"] in batches
        finally:
            wheel.set_enabled(False)


class TestAllocWatchHub:
    def _hub(self):
        state = StateStore()
        hub = AllocWatchHub(state)
        return state, hub

    def test_write_wakes_only_that_node(self):
        state, hub = self._hub()
        try:
            job, n1, n2 = mock.job(), mock.node(), mock.node()
            state.upsert_node(1, n1)
            state.upsert_node(2, n2)
            state.upsert_job(3, job)
            results = {}

            def wait(nid):
                results[nid] = hub.wait_for_node(nid, 4, timeout_s=5.0)

            t1 = threading.Thread(target=wait, args=(n1.id,))
            t2 = threading.Thread(target=wait, args=(n2.id,))
            t1.start(), t2.start()
            time.sleep(0.1)
            state.upsert_allocs(4, [mock.alloc(job, n1)])
            t1.join(5)
            assert results.get(n1.id) is True
            assert hub.index_of(n1.id) == 4
            assert hub.index_of(n2.id) == 0
            # n2's waiter is still parked — wake it via its own write
            state.upsert_allocs(5, [mock.alloc(job, n2)])
            t2.join(5)
            assert results.get(n2.id) is True
        finally:
            hub.stop()

    def test_waiter_bound_evicts_oldest(self):
        state, hub = self._hub()
        threads = []
        try:
            before = _counter("nomad.fleet.watch_evicted")
            results = []

            def wait():
                results.append(hub.wait_for_node("nX", 100, timeout_s=10.0))

            threads = [
                threading.Thread(target=wait, daemon=True)
                for _ in range(hub._max_waiters + 1)
            ]
            for t in threads[:-1]:
                t.start()
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                with hub._lock:
                    if len(hub._waiters.get("nX", [])) == hub._max_waiters:
                        break
                time.sleep(0.01)
            threads[-1].start()  # one past the bound → oldest evicted
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline and not results:
                time.sleep(0.01)
            # the evicted waiter woke promptly (True = go serve current
            # state) instead of stranding until its 10s timeout
            assert results == [True]
            assert _counter("nomad.fleet.watch_evicted") == before + 1
            assert hub.stats()["watch_subscribers"] == hub._max_waiters
        finally:
            hub.prime(1000, {"nX"})  # unblock the parked waiters
            for t in threads:
                if t.is_alive():
                    t.join(5)
            hub.stop()

    def test_prime_overwrites_and_wakes(self):
        """Snapshot restore re-seeds the node index (OVERWRITE — a
        rebase may move indexes downward) and wakes every waiter."""
        state, hub = self._hub()
        try:
            job, node = mock.job(), mock.node()
            state.upsert_node(1, node)
            state.upsert_job(2, job)
            state.upsert_allocs(50, [mock.alloc(job, node)])
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                if hub.index_of(node.id) == 50:
                    break
                time.sleep(0.01)
            assert hub.index_of(node.id) == 50
            woke = threading.Event()
            t = threading.Thread(
                target=lambda: (
                    hub.wait_for_node(node.id, 999, timeout_s=30.0),
                    woke.set(),
                )
            )
            t.start()
            time.sleep(0.1)
            hub.prime(7, {node.id, "other"})
            assert woke.wait(5.0), "prime must wake parked waiters"
            t.join(5)
            assert hub.index_of(node.id) == 7  # overwritten, not maxed
            assert hub.index_of("other") == 7
        finally:
            hub.stop()

    def test_store_restore_primes_hub(self):
        """The real wiring: StateStore.restore_from fires the
        subscribe_restore hook — a hub on a restored store is warm."""
        src = StateStore()
        job, node = mock.job(), mock.node()
        src.upsert_node(1, node)
        src.upsert_job(2, job)
        src.upsert_allocs(3, [mock.alloc(job, node)])
        snap = src.serialize()
        dst = StateStore()
        hub = AllocWatchHub(dst)
        try:
            dst.restore_from(snap)
            assert hub.index_of(node.id) == dst.latest_index()
        finally:
            hub.stop()


class TestNodeRegisterBatcher:
    def test_storm_coalesces_into_shared_entries(self):
        applies = []
        lock = threading.Lock()

        def raft_apply(op, data):
            with lock:
                applies.append((op, list(data)))

        batcher = NodeRegisterBatcher(raft_apply, window_s=0.05)
        batcher.start()
        try:
            nodes = [mock.node() for _ in range(16)]
            threads = [
                threading.Thread(target=batcher.submit, args=(n,))
                for n in nodes
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(10)
            total = sum(len(data) for _op, data in applies)
            assert total == 16
            assert all(op == "node_register_batch" for op, _ in applies)
            # the point of the exercise: far fewer entries than writes
            assert len(applies) < 16
        finally:
            batcher.stop()

    def test_submit_when_stopped_returns_false(self):
        batcher = NodeRegisterBatcher(lambda op, data: None)
        assert batcher.submit(mock.node()) is False

    def test_raft_error_propagates_to_every_submitter(self):
        def raft_apply(op, data):
            raise RuntimeError("not leader")

        batcher = NodeRegisterBatcher(raft_apply, window_s=0.01)
        batcher.start()
        try:
            errs = []

            def submit():
                try:
                    batcher.submit(mock.node())
                except RuntimeError as e:
                    errs.append(str(e))

            threads = [threading.Thread(target=submit) for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(10)
            assert errs == ["not leader"] * 4
        finally:
            batcher.stop()

    def test_stop_drains_queue_to_fallback(self):
        release = threading.Event()

        def raft_apply(op, data):
            release.wait(5)

        batcher = NodeRegisterBatcher(raft_apply, window_s=0.01)
        batcher.start()
        results = []
        t1 = threading.Thread(
            target=lambda: results.append(batcher.submit(mock.node()))
        )
        t1.start()
        time.sleep(0.1)  # t1's batch is now stuck inside raft_apply
        t2 = threading.Thread(
            target=lambda: results.append(batcher.submit(mock.node()))
        )
        t2.start()
        time.sleep(0.05)
        stopper = threading.Thread(target=batcher.stop)
        stopper.start()
        time.sleep(0.05)
        release.set()
        for t in (t1, t2, stopper):
            t.join(10)
        # the queued-but-uncommitted submission fell back (False);
        # the in-flight batch completed normally (True)
        assert sorted(results, key=bool) in ([False, True], [True, True])

    def test_commit_hook_replaces_the_register_entry(self):
        applies, commits = [], []
        batcher = NodeRegisterBatcher(
            lambda op, data: applies.append(op), window_s=0.0,
            commit=commits.append,
        )
        batcher.start()
        try:
            assert batcher.submit("n1") is True
        finally:
            batcher.stop()
        assert commits == [["n1"]] and applies == []


def _recover_down_fleet(batched: bool, n: int = 16) -> dict:
    """n nodes, one alloc of one job on each and a system job, all
    marked down in one batch; then each node's heartbeat from its own
    thread, all at once. batched=False stops the server's ready batcher, so every heartbeat
    takes the single-node path (node_update_status, as nomad_tpu does).
    Returns the raft entries the heartbeats wrote, the statuses and the
    evals they minted."""
    from nomad_tpu_torch.scheduler.context import SchedulerConfig
    from nomad_tpu_torch.server import Server

    srv = Server(num_workers=0, scheduler_config=SchedulerConfig(
        device="cpu"))
    srv.establish_leadership()
    srv.heartbeaters.set_enabled(False)  # no TTLs: nothing expires
    if not batched:
        srv.ready_batcher.stop()
    try:
        nodes = [mock.node() for _ in range(n)]
        srv.raft_apply("node_register_batch", nodes)
        job = mock.job(id="recover-job")
        srv.raft_apply("job_register", (job, None))
        # a system job with no allocs yet: a node that comes back ready
        # owes it an eval too
        srv.raft_apply("job_register",
                       (mock.system_job(id="recover-sys"), None))
        srv.raft_apply("alloc_update", [
            mock.alloc(job, node, index=i) for i, node in enumerate(nodes)])
        ids = [node.id for node in nodes]
        srv.raft_apply("node_batch_update_status", (ids, "down"))
        before = {e.id for e in srv.state.evals()}

        entries: list[str] = []
        first = threading.Event()

        def counting(apply):
            def counted(msg_type, payload):
                if batched and not first.is_set():
                    # hold the first commit until every other heartbeat
                    # has queued behind it
                    first.set()
                    deadline = time.monotonic() + 10
                    while (len(payload[0]) + len(srv.ready_batcher._queue)
                           < n and time.monotonic() < deadline):
                        time.sleep(0.005)
                entries.append(msg_type)
                return apply(msg_type, payload)
            return counted

        srv.raft_apply = counting(srv.raft_apply)
        srv.raft_apply_async = counting(srv.raft_apply_async)
        start = threading.Barrier(n)

        def beat(nid):
            start.wait(10)
            srv.node_heartbeat(nid)

        threads = [threading.Thread(target=beat, args=(nid,)) for nid in ids]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        return {
            "entries": entries,
            "status": {nid: srv.state.node_by_id(nid).status for nid in ids},
            # nodes named by their place: each run mints its own ids
            "evals": sorted(
                (ids.index(e.node_id), e.job_id, e.triggered_by, e.type,
                 e.priority, e.status)
                for e in srv.state.evals() if e.id not in before),
        }
    finally:
        srv.shutdown()


class TestReadyBatcher:
    def test_concurrent_recoveries_share_entries(self):
        """A reconnect storm's recoveries (a down node's heartbeat) share
        node_batch_update_status and eval_update entries, and leave the
        same statuses and evals as the single-node path."""
        batched = _recover_down_fleet(True)
        direct = _recover_down_fleet(False)
        assert set(batched["status"].values()) == {"ready"}
        assert set(direct["status"].values()) == {"ready"}
        assert batched["evals"] == direct["evals"]
        assert len(batched["evals"]) == 32
        assert direct["entries"].count("node_update_status") == 16
        # every heartbeat is in the first batch or queued behind it
        assert batched["entries"] in (
            ["node_batch_update_status", "eval_update"] * k for k in (1, 2))

    def test_heartbeat_of_a_ready_node_writes_nothing(self):
        from nomad_tpu_torch.scheduler.context import SchedulerConfig
        from nomad_tpu_torch.server import Server

        srv = Server(num_workers=0, scheduler_config=SchedulerConfig(
            device="cpu"))
        srv.establish_leadership()
        try:
            node = mock.node()
            srv.node_register(node)
            index = srv.state.latest_index()
            assert srv.node_heartbeat(node.id) > 0
            assert srv.state.latest_index() == index
            with pytest.raises(KeyError):
                srv.node_heartbeat("no-such-node")
        finally:
            srv.shutdown()


class TestOperatorTopFleetPanel:
    def test_fleet_panel_renders_when_fleet_active(self):
        from nomad_tpu_torch.cli.main import _render_top

        snap = {
            "uptime_seconds": 10,
            "counters": {
                "nomad.heartbeat.expired": 12,
                "nomad.rpc.node_throttled": 40,
            },
            "gauges": {
                "nomad.fleet.nodes_ready": 480,
                "nomad.fleet.nodes_down": 20,
                "nomad.heartbeat.armed": 480,
                "nomad.heartbeat.wheel_buckets": 37,
                "nomad.fleet.watch_subscribers": 8,
            },
            "samples": {},
        }
        out = _render_top(snap, None)
        assert "Fleet" in out
        assert "nodes ready 480" in out
        assert "down 20" in out
        assert "ttl armed 480 (37 buckets)" in out
        assert "expired 12" in out
        assert "node throttled(429) 40" in out

    def test_fleet_panel_hidden_on_quiet_cluster(self):
        from nomad_tpu_torch.cli.main import _render_top

        snap = {
            "uptime_seconds": 10,
            "counters": {},
            "gauges": {},
            "samples": {},
        }
        assert "Fleet" not in _render_top(snap, None)


@pytest.mark.fleet
class TestFleetScale:
    def test_mini_fleet_survives_storms(self, tmp_path):
        """The tier-1 fleet gate: a seeded ~500-node simulated fleet
        through all four phases in well under a minute. The ≥5k-node
        10-minute acceptance soak is the slow-marked variant below."""
        from nomad_tpu_torch.testing.fleet import run_fleet_scale

        report = run_fleet_scale(
            str(tmp_path),
            seed=7,
            n_nodes=500,
            steady_s=4.0,
            heartbeat_ttl_s=2.0,
            driver_threads=8,
            real_watchers=4,
            partition_fraction=0.2,
            register_deadline_s=45.0,
            rate=5.0,
            use_tpu_worker=True,
            device="cpu",
        )
        assert report["registered_all"], report
        assert report["admission_engaged"], report
        assert report["expiry_detected"], report
        assert report["expiry_batched"], report
        assert report["reconnect_recovered"], report
        assert report["reconnect_batched"], report
        assert report["p99_bounded"], report
        assert report["converged"], report
        assert report["invariants_ok"], report["invariant_error"]


@pytest.mark.slow
@pytest.mark.fleet
class TestFleetScaleSoak:
    def test_5k_fleet_ten_minute_soak(self, tmp_path):
        """The acceptance soak (the fleet-scale gate): ≥5k nodes
        held ≥10 minutes with bounded heartbeat p99, the cpu-per-node
        gate, batched storm raft writes, and zero invariant
        violations. scripts/slow-suite.sh runs this via `-m slow`."""
        from nomad_tpu_torch.testing.fleet import run_fleet_scale

        report = run_fleet_scale(
            str(tmp_path),
            seed=21,
            n_nodes=5000,
            steady_s=600.0,
            heartbeat_ttl_s=10.0,
            driver_threads=8,
            real_watchers=8,
            partition_fraction=0.2,
            register_deadline_s=120.0,
            rate=10.0,
            p99_bound_s=1.0,
            cpu_per_node_bound=0.002,
            device="cpu",
        )
        for gate in (
            "registered_all", "admission_engaged", "expiry_detected",
            "expiry_batched", "reconnect_recovered", "reconnect_batched",
            "p99_bounded", "cpu_bounded", "converged", "invariants_ok",
        ):
            assert report[gate], (gate, report)


# ---------------------------------------------------------------------------
# Differentials against nomad_tpu (tolerance: exact)
# ---------------------------------------------------------------------------


def _wheel_run(module, seed: int) -> list:
    """One seeded schedule of resets, clears and sweeps on a hand-driven
    wheel of `module` (the TTL splay draws from the global `random`)."""
    import random

    clock = _FakeClock()
    batches: list = []
    wheel = module.HeartbeatWheel(
        on_expire=lambda nid: batches.append([nid]),
        on_expire_batch=batches.append,
    )
    wheel._now = clock
    wheel._enabled = True
    wheel.min_ttl_s = 1.0
    ops = random.Random(seed)
    random.seed(seed)
    out = []
    for step in range(600):
        nid = f"n{ops.randrange(80)}"
        r = ops.random()
        if r < 0.6:
            wheel.reset(nid)
        elif r < 0.7:
            wheel.clear(nid)
        else:
            clock.advance(ops.uniform(0.0, 0.8))
            out.append((step, sorted(wheel._advance(clock()))))
    clock.advance(10.0)
    out.append(("end", sorted(wheel._advance(clock()))))
    stats = wheel.stats()
    return out + [sorted(map(sorted, batches)), wheel.active_count(),
                  stats["armed"]]


@pytest.mark.parametrize("seed", [3, 11])
def test_heartbeat_wheel_schedule_equals_nomad_tpu(seed):
    from nomad_tpu.server import heartbeat as jhb

    from nomad_tpu_torch.server import heartbeat as thb

    got = _wheel_run(thb, seed)
    assert got == _wheel_run(jhb, seed)
    assert any(ids for _s, ids in got[:-3])  # nodes really expired


def _sim_fleet_draws(module, seed: int) -> dict:
    fleet = module.SimFleet(None, 500, seed, driver_threads=1,
                            latency_cap=64)
    ids = [f"node-{i:04d}" for i in range(500)]
    for nid in ids:
        fleet._sims[nid] = module._SimNode(None)
    fleet.registered = set(ids)
    victims = fleet.kill(0.2)
    fleet.reconnect(victims, spread_s=5.0)
    order = [(seq, nid, act) for _due, seq, nid, act in sorted(fleet._heap)]
    for i in range(5000):
        fleet._record_latency((i * 7919 % 1000) / 1e4)
    return {"victims": victims, "reconnect_order": order,
            "hb": fleet.hb_percentiles(), "reservoir": list(fleet._lats)}


@pytest.mark.parametrize("seed", [7, 21])
def test_sim_fleet_draws_equal_nomad_tpu(seed):
    from nomad_tpu.testing import fleet as jfleet

    from nomad_tpu_torch.testing import fleet as tfleet

    got = _sim_fleet_draws(tfleet, seed)
    assert got == _sim_fleet_draws(jfleet, seed)
    assert len(got["victims"]) == 100 and got["hb"]["count"] == 5000


def test_fleet_top_panel_equals_nomad_tpu():
    from nomad_tpu.cli.main import _render_top as jrender

    from nomad_tpu_torch.cli.main import _render_top

    snap = {
        "uptime_seconds": 10,
        "counters": {"nomad.heartbeat.expired": 12,
                     "nomad.rpc.node_throttled": 40},
        "gauges": {"nomad.fleet.nodes_ready": 480,
                   "nomad.fleet.nodes_down": 20,
                   "nomad.heartbeat.armed": 480,
                   "nomad.heartbeat.wheel_buckets": 37,
                   "nomad.fleet.watch_subscribers": 8},
        "samples": {},
    }
    assert _render_top(snap, None) == jrender(snap, None)
