"""A simulated node fleet: thousands of client agents on a few threads.

Port of ``nomad_tpu/testing/fleet.py``. ``run_fleet_scale`` takes its
device explicitly (``scheduler_config`` or ``device``, "cuda" unless the
caller asks for the CPU; ``loadgen.harness_config``).

Robustness work needs a fleet the test host can't afford to run as real
``Client`` instances (each real client is ~6 threads plus driver
machinery; 10k of them is 60k threads). :class:`SimFleet` keeps the
*protocol* surface of a client — real ``Node.register`` RPCs through the
admission door, real heartbeats re-arming real wheel TTLs, real blocking
alloc watches — while multiplexing every node onto a small cooperative
driver pool (the spot-churn scenario's ``_SpotFleet`` pattern,
generalized): a heap of
``(due, node, action)`` entries that a handful of threads drain in
deadline order.

What is real vs simulated:

  * registration, heartbeat, and alloc-watch traffic is REAL RPC into
    the cluster under test (``rpc_self``, with server failover) — the
    server-side wheel, watch hub, register batcher, and node door see
    exactly the call pattern a real fleet produces;
  * the node's workload side (task runners, fingerprinting, alloc
    health) is absent — fleet scenarios gate on control-plane survival,
    not task execution;
  * a handful of ``real_watchers`` hold genuine long-poll
    ``Node.get_client_allocs`` queries on dedicated threads, while every
    other node probes the leader's watch hub in-process (O(1)) — 10k
    parked watcher threads would measure the host's thread scheduler,
    not the server;
  * a node's register and heartbeat RPCs run on a pool of
    ``RPC_WORKERS`` threads, not on the driver that found them due: a
    real client waits on its own calls only, so a registration or a
    recovering heartbeat blocked on a raft commit must not hold back
    other nodes' heartbeats (with the drivers making the calls, a
    reconnect storm kept the whole heap behind the TTL).

``run_fleet_scale`` is the scenario harness: registration storm through
the node door, steady-state heartbeats + job traffic, a mass partition
(wheel expiry storm → batched down-marks), and a mass reconnect
(admission + register batcher), with the raft-entry accounting and
latency/CPU gates a fleet-scale run calls for.
"""

from __future__ import annotations

import heapq
import logging
import math
import queue
import random
import threading
import time
from typing import Optional

from .. import metrics, mock
from ..structs.structs import NODE_STATUS_DOWN, NODE_STATUS_READY

logger = logging.getLogger("nomad_tpu_torch.testing")

ACT_REGISTER = 0
ACT_HEARTBEAT = 1
ACT_WATCH = 2

# register and heartbeat calls in flight at once, across the fleet
RPC_WORKERS = 64


class _SimNode:
    __slots__ = ("node", "ttl", "alive", "watch_index")

    def __init__(self, node) -> None:
        self.node = node
        self.ttl = 10.0
        self.alive = True
        self.watch_index = 0


class _RealWatcher(threading.Thread):
    """One genuine blocking-query loop (the real client's
    ``_watch_allocs`` shape) — the subset of the fleet that exercises
    the server's long-poll path end to end."""

    def __init__(self, fleet: "SimFleet", node_id: str,
                 timeout_s: float = 2.0) -> None:
        super().__init__(name=f"fleet-watch-{node_id[:8]}", daemon=True)
        self.fleet = fleet
        self.node_id = node_id
        self.timeout_s = timeout_s
        self.rounds = 0
        self.alloc_rounds = 0
        self.errors = 0

    def run(self) -> None:
        index = 0
        while not self.fleet._stop.is_set():
            try:
                res = self.fleet._rpc(
                    "Node.get_client_allocs",
                    {
                        "node_id": self.node_id,
                        "min_index": index + 1,
                        "timeout_s": self.timeout_s,
                    },
                )
            except Exception:
                self.errors += 1
                self.fleet._stop.wait(0.5)
                continue
            index = max(index, res["index"])
            self.rounds += 1
            if res["allocs"]:
                self.alloc_rounds += 1


class SimFleet:
    def __init__(
        self,
        cluster,
        size: int,
        seed: int,
        *,
        driver_threads: int = 4,
        hb_frac: float = 0.5,
        watch_period_s: float = 2.0,
        real_watchers: int = 0,
        latency_cap: int = 5000,
    ) -> None:
        self.cluster = cluster
        self.size = size
        self.hb_frac = hb_frac
        self.watch_period_s = watch_period_s
        self._rng = random.Random(seed ^ 0xF1EE7)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._heap: list[tuple[float, int, str, int]] = []
        self._seq = 0
        self._sims: dict[str, _SimNode] = {}
        self.registered: set[str] = set()
        self.dead_at: dict[str, float] = {}
        # counters (under _lock)
        self.throttled = 0
        self.register_errors = 0
        self.hb_errors = 0
        self.watch_advances = 0
        # heartbeat RPC latency reservoir (bounded, seed-deterministic)
        self._lat_cap = latency_cap
        self._lats: list[float] = []
        self._hb_count = 0
        self._stop = threading.Event()
        self._drivers = [
            threading.Thread(
                target=self._drive, name=f"fleet-driver-{i}", daemon=True
            )
            for i in range(max(1, driver_threads))
        ]
        self._calls: queue.SimpleQueue = queue.SimpleQueue()
        self._callers = [
            threading.Thread(
                target=self._call_loop, name=f"fleet-rpc-{i}", daemon=True
            )
            for i in range(RPC_WORKERS)
        ]
        self._n_real_watchers = real_watchers
        self.watchers: list[_RealWatcher] = []

    # -- RPC (failover across live servers, like _SpotFleet) -----------

    def _rpc(self, method: str, args):
        last: Optional[Exception] = None
        for nid in sorted(self.cluster.servers):
            cs = self.cluster.servers.get(nid)
            if cs is None:  # raced a kill
                continue
            try:
                return cs.rpc_self(method, args)
            except Exception as e:
                last = e
                # a throttle verdict is an ANSWER from the door, not a
                # dead server — don't shop it to the next peer
                if _retry_after(e) is not None:
                    raise
        if last is not None:
            raise last
        raise RuntimeError("no live servers")

    # -- lifecycle ------------------------------------------------------

    def populate(self, deadline_s: float = 120.0) -> bool:
        """Create every node and fire the whole registration storm at
        once — the node door paces admission; throttled nodes honor the
        Retry-After hint like real clients. True once ALL registered."""
        now = time.monotonic()
        with self._cv:
            for _ in range(self.size):
                sim = _SimNode(mock.node())
                self._sims[sim.node.id] = sim
                self._push_locked(now, sim.node.id, ACT_REGISTER)
            self._cv.notify_all()
        for t in self._drivers + self._callers:
            if not t.is_alive():
                t.start()
        ok = self._wait(
            lambda: len(self.registered) >= self.size, deadline_s
        )
        if ok and self._n_real_watchers:
            ids = sorted(self._sims)[: self._n_real_watchers]
            self.watchers = [_RealWatcher(self, nid) for nid in ids]
            for w in self.watchers:
                w.start()
        return ok

    def stop(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        for _ in self._callers:
            self._calls.put(None)
        for t in self._drivers + self._callers:
            if t.is_alive():
                t.join(timeout=10)
        for w in self.watchers:
            w.join(timeout=10)

    # -- mass operations ------------------------------------------------

    def kill(self, fraction: float) -> list[str]:
        """Silent mass death (partition / reclaim): heartbeats from the
        victims just STOP — only the leader's wheel can notice."""
        with self._lock:
            candidates = sorted(self.registered)
            n = max(1, math.ceil(len(candidates) * fraction))
            victims = self._rng.sample(candidates, min(n, len(candidates)))
            died = time.monotonic()
            for nid in victims:
                self._sims[nid].alive = False
                self.registered.discard(nid)
                self.dead_at[nid] = died
        return victims

    def reconnect(self, node_ids: list[str], spread_s: float = 0.0) -> None:
        """The partition heals: every victim re-registers at once (or
        within ``spread_s``). This is the storm the register batcher and
        the node door exist for."""
        now = time.monotonic()
        with self._cv:
            for nid in node_ids:
                sim = self._sims.get(nid)
                if sim is None:
                    continue
                sim.alive = True
                self.dead_at.pop(nid, None)
                self._push_locked(
                    now + self._rng.uniform(0, spread_s), nid, ACT_REGISTER
                )
            self._cv.notify_all()

    # -- cooperative driver ---------------------------------------------

    def _push_locked(self, due: float, node_id: str, action: int) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (due, self._seq, node_id, action))

    def _push(self, due: float, node_id: str, action: int) -> None:
        with self._cv:
            self._push_locked(due, node_id, action)
            self._cv.notify()

    def _drive(self) -> None:
        while not self._stop.is_set():
            entry = None
            with self._cv:
                while not self._stop.is_set():
                    now = time.monotonic()
                    if self._heap and self._heap[0][0] <= now:
                        entry = heapq.heappop(self._heap)
                        break
                    wait = 0.2
                    if self._heap:
                        wait = min(wait, max(0.0, self._heap[0][0] - now))
                    self._cv.wait(wait)
            if entry is None:
                return
            _due, _seq, node_id, action = entry
            if action == ACT_WATCH:
                self._run_step(node_id, action)
            else:
                self._calls.put((node_id, action))

    def _call_loop(self) -> None:
        while (call := self._calls.get()) is not None:
            if not self._stop.is_set():
                self._run_step(*call)

    def _run_step(self, node_id: str, action: int) -> None:
        try:
            self._step(node_id, action)
        except Exception:
            logger.exception("fleet action failed")

    def _step(self, node_id: str, action: int) -> None:
        sim = self._sims.get(node_id)
        if sim is None or not sim.alive:
            return
        now = time.monotonic()
        if action == ACT_REGISTER:
            try:
                sim.ttl = float(
                    self._rpc("Node.register", {"node": sim.node})
                )
            except Exception as e:
                hint = _retry_after(e)
                with self._lock:
                    if hint is not None:
                        self.throttled += 1
                    else:
                        self.register_errors += 1
                delay = (
                    hint + self._rng.uniform(0, hint / 2)
                    if hint
                    else 0.2 + self._rng.uniform(0, 0.2)
                )
                self._push(now + delay, node_id, ACT_REGISTER)
                return
            with self._lock:
                self.registered.add(node_id)
            # like the real client: promote to ready immediately with a
            # first heartbeat instead of idling `initializing`/down
            self._push(now + self._rng.uniform(0, 0.05), node_id,
                       ACT_HEARTBEAT)
            self._push(
                now + self._rng.uniform(0, self.watch_period_s),
                node_id, ACT_WATCH,
            )
        elif action == ACT_HEARTBEAT:
            t0 = time.perf_counter()
            try:
                sim.ttl = float(
                    self._rpc("Node.heartbeat", {"node_id": node_id})
                )
            except Exception:
                with self._lock:
                    self.hb_errors += 1
                self._push(
                    now + min(1.0, max(0.1, sim.ttl / 4)),
                    node_id, ACT_HEARTBEAT,
                )
                return
            self._record_latency(time.perf_counter() - t0)
            period = sim.ttl * self.hb_frac
            self._push(
                now + period * self._rng.uniform(0.9, 1.0),
                node_id, ACT_HEARTBEAT,
            )
        elif action == ACT_WATCH:
            # in-process O(1) probe of the hub's per-node cursor: "did
            # my alloc set change?" without parking a thread per node
            lead = self.cluster.leader()
            if lead is not None:
                idx = lead.server.watch_hub.index_of(node_id)
                if idx > sim.watch_index:
                    sim.watch_index = idx
                    with self._lock:
                        self.watch_advances += 1
            self._push(now + self.watch_period_s, node_id, ACT_WATCH)

    # -- measurement -----------------------------------------------------

    def _record_latency(self, lat: float) -> None:
        with self._lock:
            self._hb_count += 1
            if len(self._lats) < self._lat_cap:
                self._lats.append(lat)
            else:
                j = self._rng.randrange(self._hb_count)
                if j < self._lat_cap:
                    self._lats[j] = lat

    def _wait(self, pred, timeout_s: float, poll_s: float = 0.1) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if pred():
                return True
            if self._stop.wait(poll_s):
                return pred()
        return pred()

    def hb_percentiles(self) -> dict[str, float]:
        with self._lock:
            lats = sorted(self._lats)
            count = self._hb_count
        if not lats:
            return {"count": 0, "p50": 0.0, "p99": 0.0, "max": 0.0}
        def q(p: float) -> float:
            return lats[min(len(lats) - 1, int(p * len(lats)))]
        return {
            "count": count,
            "p50": round(q(0.50), 6),
            "p99": round(q(0.99), 6),
            "max": round(lats[-1], 6),
        }

    def report(self) -> dict:
        with self._lock:
            out = {
                "size": self.size,
                "registered": len(self.registered),
                "throttled": self.throttled,
                "register_errors": self.register_errors,
                "hb_errors": self.hb_errors,
                "watch_advances": self.watch_advances,
            }
        out["hb_rpc_seconds"] = self.hb_percentiles()
        out["real_watchers"] = {
            "count": len(self.watchers),
            "rounds": sum(w.rounds for w in self.watchers),
            "alloc_rounds": sum(w.alloc_rounds for w in self.watchers),
            "errors": sum(w.errors for w in self.watchers),
        }
        return out


def _retry_after(e: BaseException) -> Optional[float]:
    from ..ratelimit import retry_after_from_text

    return retry_after_from_text(str(e))


def _counters() -> dict:
    return dict(metrics.registry().snapshot()["counters"])


def _delta(after: dict, before: dict, name: str) -> float:
    return after.get(name, 0) - before.get(name, 0)


def run_fleet_scale(
    data_root: str,
    *,
    seed: int = 0,
    n_servers: int = 1,
    n_nodes: int = 500,
    steady_s: float = 10.0,
    heartbeat_ttl_s: float = 2.0,
    hb_rate_hz: float = 0.0,
    driver_threads: int = 4,
    real_watchers: int = 4,
    partition_fraction: float = 0.2,
    node_register_rate: float = 0.0,
    register_deadline_s: float = 60.0,
    expiry_grace_factor: float = 6.0,
    min_avg_batch: float = 2.0,
    rate: float = 10.0,
    p99_bound_s: float = 0.5,
    cpu_per_node_bound: float = 0.005,
    use_tpu_worker: bool = False,
    scheduler_config=None,
    device: str = "cuda",
) -> dict:
    """Fleet-scale survival: registration storm → steady state → mass
    expiry → mass reconnect, against a live cluster.

    Gates returned in the report:
      * ``registered_all`` — the whole fleet got through the node door;
      * ``expiry_detected`` / ``expiry_batched`` — every silent victim
        is down-marked within ``ttl × expiry_grace_factor``, via
        coalesced wheel sweeps (avg expiry batch ≥ ``min_avg_batch``,
        or raft entries bounded by the wheel ticks the victims'
        deadlines span — per-node down-marks fail either way);
      * ``reconnect_recovered`` / ``reconnect_batched`` — the reconnect
        storm re-admits everyone, with node raft entries bounded by the
        register batcher (avg batch ≥ ``min_avg_batch``);
      * ``p99_bounded`` — heartbeat RPC p99 under ``p99_bound_s``
        THROUGH both storms;
      * ``cpu_bounded`` — server process CPU per node per wall-second
        under ``cpu_per_node_bound`` (cores/node);
      * ``invariants_ok`` / ``converged`` — the standard chaos-cluster
        invariants hold after the dust settles.
    """
    from .chaos import ChaosCluster
    from .loadgen import LoadGen, LoadGenConfig, harness_config
    from .scenarios import _join_loadgen, _loadgen_thread

    if hb_rate_hz <= 0:
        # hold the granted TTL at ~heartbeat_ttl_s regardless of fleet
        # size (the production 50/s cap would stretch a 5k-node TTL to
        # 100s — correct for production, useless in a 10-minute soak)
        hb_rate_hz = max(50.0, n_nodes / heartbeat_ttl_s)
    if node_register_rate <= 0:
        # admit the whole fleet within about half the register deadline
        node_register_rate = max(
            50.0, n_nodes / max(register_deadline_s / 2, 1.0)
        )

    cluster = ChaosCluster(
        n_servers, data_root, seed=seed, num_workers=1,
        use_tpu_batch_worker=use_tpu_worker,
        scheduler_config=harness_config(
            scheduler_config, device, use_tpu_worker
        ),
    )
    fleet: Optional[SimFleet] = None
    victims: list[str] = []
    try:
        cluster.start()
        lead = cluster.wait_for_stable_leader(timeout_s=60)
        if lead is None:
            raise RuntimeError("fleet cluster never elected a leader")
        from ..retry import RetryPolicy

        for cs in cluster.servers.values():
            cs.forward_retry = RetryPolicy(
                base_s=0.05, max_s=0.5, deadline_s=5.0
            )
            cs.server.heartbeaters.min_ttl_s = heartbeat_ttl_s
            cs.server.heartbeaters.rate_hz = hb_rate_hz
            # burst sized to the expected heal-storm: a partition's worth
            # of reconnects rushes the door at full speed (the register
            # batcher coalesces it into shared raft entries) while the
            # sustained rate still paces an unbounded flood — pacing
            # every reconnect to rate would feed the batcher one
            # registration at a time and defeat the coalescing it gates
            cs.set_node_register_limit(
                node_register_rate,
                max(node_register_rate / 2,
                    n_nodes * partition_fraction),
            )

        fleet = SimFleet(
            cluster, n_nodes, seed,
            driver_threads=driver_threads,
            real_watchers=real_watchers,
        )
        c_boot = _counters()
        t_pop = time.monotonic()
        registered_all = fleet.populate(deadline_s=register_deadline_s)
        populate_s = round(time.monotonic() - t_pop, 2)
        c_pop = _counters()

        # job traffic so the fleet's allocs (and the watch path) carry
        # real placements through the storms
        cfg = LoadGenConfig(
            rate_eval_per_s=rate,
            duration_s=3600.0,  # stopped explicitly below
            seed=seed,
            node_count=0,  # jobs land on the sim fleet's nodes
            node_churn_period_s=0.0,
            heartbeat_period_s=3600.0,
            submitters=2,
        )
        gen = LoadGen(cluster, cfg)
        t, box = _loadgen_thread(gen)
        if not gen.setup_done.wait(timeout=60):
            raise RuntimeError("loadgen setup never finished")

        cpu_t0 = time.process_time()
        wall_t0 = time.monotonic()

        # steady state: heartbeats + watches + placements
        hub_peak = 0
        deadline = time.monotonic() + steady_s
        while time.monotonic() < deadline:
            time.sleep(0.25)
            lead = cluster.leader()
            if lead is not None:
                hub_peak = max(
                    hub_peak,
                    int(lead.server.watch_hub.stats()["nodes_tracked"]),
                )

        # mass expiry: a fraction of the fleet goes silent at once
        c0 = _counters()
        victims = fleet.kill(partition_fraction)
        expiry_bound_s = heartbeat_ttl_s * 1.5 + \
            heartbeat_ttl_s * expiry_grace_factor

        def all_down() -> bool:
            lead = cluster.leader()
            if lead is None:
                return False
            state = lead.server.state
            for nid in victims:
                node = state.node_by_id(nid)
                if node is None or node.status != NODE_STATUS_DOWN:
                    return False
            return True

        t_exp = time.monotonic()
        expiry_detected = fleet._wait(all_down, expiry_bound_s + 30.0)
        expiry_detect_s = round(time.monotonic() - t_exp, 2)
        c1 = _counters()

        # mass reconnect: the partition heals, everyone re-registers
        fleet.reconnect(victims)

        def all_ready() -> bool:
            with fleet._lock:
                if len(fleet.registered) < n_nodes:
                    return False
            lead = cluster.leader()
            if lead is None:
                return False
            state = lead.server.state
            return all(
                (node := state.node_by_id(nid)) is not None
                and node.status == NODE_STATUS_READY
                for nid in victims
            )

        t_rec = time.monotonic()
        reconnect_recovered = fleet._wait(
            all_ready, register_deadline_s + heartbeat_ttl_s + 30.0
        )
        reconnect_s = round(time.monotonic() - t_rec, 2)
        c2 = _counters()

        cpu_delta = time.process_time() - cpu_t0
        wall = max(time.monotonic() - wall_t0, 1e-9)

        gen.stop()
        lg_report = _join_loadgen(t, box, timeout_s=120)
        fleet.stop()

        converged = cluster.converged(timeout_s=60)
        cluster.acked_jobs = set(gen.acked_jobs)
        invariants_ok, invariant_error = True, ""
        try:
            cluster.check_invariants()
        except AssertionError as e:
            invariants_ok, invariant_error = False, str(e)

        # raft-entry accounting for the two storms
        expired = _delta(c1, c0, "nomad.heartbeat.expired")
        expire_batches = _delta(c1, c0, "nomad.heartbeat.expire_batches")
        rec_batches = _delta(c2, c1, "nomad.fleet.node_raft_batches")
        rec_coalesced = _delta(c2, c1, "nomad.fleet.node_raft_coalesced")
        avg_expiry_batch = expired / expire_batches if expire_batches else 0.0
        avg_rec_batch = rec_coalesced / rec_batches if rec_batches else 0.0
        # small fleets can't coalesce meaningfully — only gate batching
        # once a storm is big enough to have a shape
        gate_batching = len(victims) >= 20
        # per-sweep coalescing bounds expiry raft entries by the wheel
        # ticks the victims' deadlines span (about one heartbeat period),
        # not by victim count: a small-TTL smoke legitimately spreads its
        # victims across many ticks at ~2 per entry — that's the wheel
        # working, so accept EITHER dense batches or a tick-bounded entry
        # count (per-node down-marks still fail: victims >> span ticks)
        from ..server.heartbeat import DEFAULT_WHEEL_TICK_S

        expiry_entry_bound = int(
            heartbeat_ttl_s * fleet.hb_frac / DEFAULT_WHEEL_TICK_S
        ) + 2
        hb = fleet.hb_percentiles()
        per_node_cpu_fraction = cpu_delta / wall / max(n_nodes, 1)

        return {
            "seed": seed,
            "n_nodes": n_nodes,
            "n_servers": n_servers,
            "heartbeat_ttl_s": heartbeat_ttl_s,
            "node_register_rate": node_register_rate,
            "populate_s": populate_s,
            "registered_all": registered_all,
            "register_throttled": _delta(
                c_pop, c_boot, "nomad.rpc.node_throttled"
            ),
            "admission_engaged": _delta(
                c2, c_boot, "nomad.rpc.node_throttled"
            ) > 0,
            "fleet": fleet.report(),
            "watch_hub_nodes_tracked_peak": hub_peak,
            "victims": len(victims),
            "expiry_detected": expiry_detected,
            "expiry_detect_s": expiry_detect_s,
            "expiry_bound_s": round(expiry_bound_s + 30.0, 2),
            "expired": expired,
            "expire_batches": expire_batches,
            "avg_expiry_batch": round(avg_expiry_batch, 2),
            "expiry_batched": (
                not gate_batching
                or (expire_batches > 0
                    and (avg_expiry_batch >= min_avg_batch
                         or expire_batches <= expiry_entry_bound))
            ),
            "reconnect_recovered": reconnect_recovered,
            "reconnect_s": reconnect_s,
            "reconnect_batches": rec_batches,
            "reconnect_coalesced": rec_coalesced,
            "avg_reconnect_batch": round(avg_rec_batch, 2),
            "reconnect_batched": (
                not gate_batching
                or (rec_batches > 0 and avg_rec_batch >= min_avg_batch)
            ),
            "hb_p99_s": hb["p99"],
            "p99_bound_s": p99_bound_s,
            "p99_bounded": hb["count"] > 0 and hb["p99"] <= p99_bound_s,
            "server_cpu": {
                "cpu_seconds": round(cpu_delta, 3),
                "wall_seconds": round(wall, 2),
                "per_node_cpu_fraction": round(per_node_cpu_fraction, 7),
            },
            "cpu_per_node_bound": cpu_per_node_bound,
            "cpu_bounded": per_node_cpu_fraction <= cpu_per_node_bound,
            "loadgen": lg_report,
            "converged": converged,
            "invariants_ok": invariants_ok,
            "invariant_error": invariant_error,
        }
    finally:
        if fleet is not None:
            fleet.stop()
        cluster.shutdown()
