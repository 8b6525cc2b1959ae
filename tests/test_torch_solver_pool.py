"""The port's solver-pool tier, held to nomad_tpu's on the CPU.

The 18 cases of tests/test_solver_pool.py, each with the same
assertions, run against nomad_tpu_torch.server.solver_pool and
nomad_tpu_torch.scheduler.gpu.remote_solve, with members made with
``device="cpu"`` (the kernels' plain PyTorch twins): gossip-tag
membership, least-loaded dispatch with cooldowns, the three fault
surfaces (member death -> retriable DeviceFault, empty pool -> local
path, leadership transfer -> abort/nack), the warm member engine, config
reload (the HCL and JSON stanzas through the port's CLI config loader)
and the observability surfaces.

Then: the tracker, the fabric and membership import neither torch nor
jax; the launch counters stay exact under concurrent launches; a member
whose card failed answers every later solve with an error. Two
differentials, tolerance none (placements compared exactly by (job,
alloc name, node), 3 seeds): nomad_tpu's RemoteSolver.solve against the
port's on one cluster carried across as wire dicts, and the port's
member solving through a real RPCServer against the port's local
solve_eval_batch on one snapshot. Last, the port's Server whose batch
worker dispatches every batch to a member over real sockets, and a
member fault that the commit stage re-solves on the host.
"""

import subprocess
import sys
import threading
import time
import types

import pytest

import torch

from nomad_tpu_torch import mock
from nomad_tpu_torch.faultplane import DeviceFault
from nomad_tpu_torch.scheduler.context import SchedulerConfig
from nomad_tpu_torch.server.membership import Member
from nomad_tpu_torch.server.solver_pool import (
    FAULT_COOLDOWN_S,
    RemotePendingBatch,
    SolverPool,
    SolverPoolEndpoint,
    _Dispatch,
)
from nomad_tpu_torch.testing import Harness

# six xdist workers share the machine: keep torch's intra-op pool small
torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# Fakes: just enough ClusterServer surface for the pool tracker
# ---------------------------------------------------------------------------


def _member(nid, solver="1", role="server", status="alive", port=None):
    tags = {"role": role}
    if solver:
        tags["solver"] = solver
    return Member(
        nid, ("127.0.0.1", port or (9000 + hash(nid) % 100)),
        status, 0, tags,
    )


class _Serf:
    def __init__(self, members):
        self._m = list(members)
        self.local = self._m[0]

    def members(self):
        return list(self._m)


class _ConnPool:
    """Scriptable fabric: fn(addr, method, args) or raise."""

    def __init__(self, fn=None):
        self.calls = []
        self.fn = fn

    def call(self, addr, method, args, timeout_s=None):
        self.calls.append((tuple(addr), method))
        if self.fn is None:
            raise ConnectionError("fabric down")
        return self.fn(tuple(addr), method, args)


class _Cluster:
    def __init__(self, node_id="s0", members=None, fn=None):
        self.node_id = node_id
        self.serf = _Serf(members or [_member(node_id)])
        self.pool = _ConnPool(fn)


def _make_pool(members=None, fn=None, **kw):
    cluster = _Cluster(members=members, fn=fn)
    return SolverPool(cluster, **kw), cluster


# ---------------------------------------------------------------------------
# Membership + pick
# ---------------------------------------------------------------------------


def test_membership_rides_gossip_tags():
    pool, _ = _make_pool(members=[
        _member("s0"),                      # self
        _member("s1"),                      # eligible
        _member("s2", solver=""),           # server, not advertising
        _member("c1", role="client"),       # solver tag on a client: no
        _member("s3", status="failed"),     # dead
    ])
    try:
        rows = {m["id"]: m for m in pool.members()}
        assert set(rows) == {"s0", "s1", "s3"}
        assert rows["s0"]["self"] is True
        assert rows["s1"]["self"] is False
        # pick: healthy, non-self only
        picked = pool._pick()
        assert picked == ("s1", tuple(rows["s1"]["addr"]))
    finally:
        pool.stop()


def test_static_member_allowlist_filters():
    pool, _ = _make_pool(
        members=[_member("s0"), _member("s1"), _member("s2")],
    )
    try:
        assert {m["id"] for m in pool.members()} == {"s0", "s1", "s2"}
        pool.configure(pool.role, members=("s2",))
        assert {m["id"] for m in pool.members()} == {"s2"}
    finally:
        pool.stop()


def test_pick_least_loaded_skips_cooling():
    pool, _ = _make_pool(members=[
        _member("s0"), _member("s1"), _member("s2"),
    ])
    try:
        pool._member_stats["s1"] = {
            "in_flight": 3, "dispatched": 3, "faults": 0,
        }
        pool._member_stats["s2"] = {
            "in_flight": 1, "dispatched": 1, "faults": 0,
        }
        assert pool._pick()[0] == "s2"
        # a faulted member sits out the cooldown window
        import time

        pool._fault_until["s2"] = time.monotonic() + FAULT_COOLDOWN_S
        assert pool._pick()[0] == "s1"
    finally:
        pool.stop()


# ---------------------------------------------------------------------------
# Dispatch: success, fault, empty pool, abort
# ---------------------------------------------------------------------------


def test_dispatch_roundtrip_applies_followups_on_leader():
    fe = mock.evaluation()

    def serve(addr, method, args):
        assert method == "SolverPool.Solve"
        assert args["min_index"] == 7
        return {"plans": {"e1": "PLAN"}, "followups": [fe]}

    pool, _ = _make_pool(
        members=[_member("s0"), _member("s1")], fn=serve,
    )
    try:
        planner = Harness()
        snap = types.SimpleNamespace(index=7)
        remote = pool.dispatch_batch([mock.evaluation()], snap, planner, None)
        assert isinstance(remote, RemotePendingBatch)
        # the chain surface is inert: remote batches neither consume nor
        # produce a local used' tensor
        assert remote.chain is None and remote.chain_accepted is False
        assert remote.finish() == {"e1": "PLAN"}
        assert [e.id for e in planner.evals] == [fe.id]
        assert pool.dispatched == 1 and pool.completed == 1
        assert pool.stats_snapshot()["in_flight"] == 0
    finally:
        pool.stop()


def test_member_fault_is_retriable_devicefault_and_cools_down():
    pool, _ = _make_pool(members=[_member("s0"), _member("s1")])  # fn=None
    try:
        snap = types.SimpleNamespace(index=1)
        remote = pool.dispatch_batch([mock.evaluation()], snap, Harness(), None)
        with pytest.raises(DeviceFault) as ei:
            remote.finish()
        assert ei.value.retriable, "member death must ride the existing " \
            "device-failover (host re-solve) path"
        assert pool.faults == 1
        # the faulted member is cooling: the next batch falls back local
        assert pool.dispatch_batch([], snap, Harness(), None) is None
        assert pool.fallback_local == 1
    finally:
        pool.stop()


def test_empty_pool_falls_back_local():
    pool, _ = _make_pool()  # only self
    try:
        snap = types.SimpleNamespace(index=1)
        assert pool.dispatch_batch([], snap, Harness(), None) is None
        assert pool.fallback_local == 1
    finally:
        pool.stop()


def test_gossip_death_fails_inflight_immediately():
    hang = threading.Event()

    def serve(addr, method, args):
        hang.wait(10)  # RPC never returns while the member is "dead"
        return {"plans": {}}

    pool, _ = _make_pool(
        members=[_member("s0"), _member("s1")], fn=serve,
    )
    try:
        snap = types.SimpleNamespace(index=1)
        remote = pool.dispatch_batch([mock.evaluation()], snap, Harness(), None)
        pool.on_member_event("member-failed", _member("s1"))
        with pytest.raises(DeviceFault):
            remote.finish()  # resolves NOW, not at the RPC timeout
    finally:
        hang.set()
        pool.stop()


def test_abort_inflight_raises_cancelled_for_nack():
    pool, _ = _make_pool()
    try:
        d = _Dispatch("s1", ("127.0.0.1", 1))
        pool._inflight.add(d)
        pending = RemotePendingBatch(pool, d, None, [], Harness(), None)
        assert pool.abort_inflight() == 1
        # CancelledError, NOT DeviceFault: the commit stage must nack
        # (evals redeliver on the new leader), never host-fallback-solve
        # on a leader that just lost leadership
        from concurrent.futures import CancelledError

        with pytest.raises(CancelledError):
            pending.finish()
        assert pool.aborted == 1
    finally:
        pool.stop()


# ---------------------------------------------------------------------------
# Member engine (RemoteSolver) + endpoint verbs
# ---------------------------------------------------------------------------


def _warm_cluster_state():
    h = Harness()
    for _ in range(4):
        n = mock.node()
        n.resources.cpu = 4000
        n.resources.memory_mb = 8192
        h.state.upsert_node(h.next_index(), n)
    job = mock.job(id="pool-j1")
    job.task_groups[0].count = 3
    h.state.upsert_job(h.next_index(), job)
    return h, job


def test_endpoint_solves_on_warm_replica():
    h, job = _warm_cluster_state()
    cluster = _Cluster()
    cluster.server = types.SimpleNamespace(
        state=h.state, scheduler_config=SchedulerConfig(device="cpu"))
    ep = SolverPoolEndpoint(cluster, None)

    # Status before any solve: cold stub, no torch load
    assert ep.status(None)["resident"] is False

    ev = mock.eval_for_job(job)
    out = ep.solve({"evals": [ev], "min_index": h.state.latest_index()})
    assert ev.id in out["plans"]
    assert out["telemetry"]["member"] == "s0"
    st = ep.status(None)
    assert st["solves"] == 1 and st["warmups"] == 1

    # warm() syncs the replica; a second solve must NOT cold-start
    synced = ep.sync({"min_index": h.state.latest_index()})
    assert synced["last_sync"] != "cold"
    ep.solve({"evals": [mock.eval_for_job(job)],
              "min_index": h.state.latest_index()})
    st = ep.status(None)
    assert st["solves"] == 2
    assert st["warmups"] == 1, "re-solve must reuse the warm replica"


def test_endpoint_wire_verbs_are_capitalized():
    # rpc dispatch resolves the literal method name after the dot:
    # SolverPool.Solve must hit the same handler as .solve
    assert SolverPoolEndpoint.Solve is SolverPoolEndpoint.solve
    assert SolverPoolEndpoint.Sync is SolverPoolEndpoint.sync
    assert SolverPoolEndpoint.Status is SolverPoolEndpoint.status


def test_remote_solver_followups_collected_not_applied():
    """A member must never raft-apply followup evals (it would bounce
    NotLeaderError); they ship back for the leader to apply."""
    from nomad_tpu_torch.scheduler.gpu.remote_solve import CollectingPlanner

    p = CollectingPlanner()
    ev = mock.evaluation()
    p.create_eval(ev)
    p.update_eval(ev)
    assert p.followups == [ev, ev]


# ---------------------------------------------------------------------------
# Config: HCL stanza, SIGHUP reload, advertising
# ---------------------------------------------------------------------------


def test_hcl_solver_pool_stanza(tmp_path):
    from nomad_tpu_torch.cli.main import _load_agent_config

    cfgfile = tmp_path / "agent.hcl"
    cfgfile.write_text(
        'server {\n  enabled = true\n}\n'
        'solver_pool {\n'
        '  role          = "solver"\n'
        '  members       = ["s1", "s2"]\n'
        '  sync_interval = "500ms"\n'
        '}\n'
    )
    cfg = _load_agent_config(str(cfgfile))
    assert cfg.solver_pool_role == "solver"
    assert cfg.solver_pool_members == ("s1", "s2")
    assert cfg.solver_pool_sync_interval_s == pytest.approx(0.5)


def test_json_solver_pool_stanza(tmp_path):
    from nomad_tpu_torch.cli.main import _load_agent_config

    cfgfile = tmp_path / "agent.json"
    cfgfile.write_text(
        '{"solver_pool": {"role": "solver", "members": ["s9"],'
        ' "sync_interval": "2s"}}'
    )
    cfg = _load_agent_config(str(cfgfile))
    assert cfg.solver_pool_role == "solver"
    assert cfg.solver_pool_members == ("s9",)
    assert cfg.solver_pool_sync_interval_s == pytest.approx(2.0)


def test_configure_advertises_and_is_idempotent():
    pool, cluster = _make_pool(members=[_member("s0", solver="")])
    try:
        local = cluster.serf.local
        inc0 = local.incarnation
        assert "solver" not in local.tags

        assert pool.configure("solver") is True
        assert local.tags.get("solver") == "1"
        assert local.incarnation == inc0 + 1

        # idempotent: same config changes nothing, no incarnation churn
        assert pool.configure("solver") is False
        assert local.incarnation == inc0 + 1

        # demotion withdraws the advertisement
        assert pool.configure("") is True
        assert "solver" not in local.tags
        assert local.incarnation == inc0 + 2
    finally:
        pool.stop()


def test_configure_updates_sync_interval_and_members():
    pool, _ = _make_pool()
    try:
        assert pool.configure("", members=("a",), sync_interval_s=9.0)
        assert pool.static_members == ("a",)
        assert pool.sync_interval_s == 9.0
        assert not pool.configure("", members=("a",), sync_interval_s=9.0)
    finally:
        pool.stop()


# ---------------------------------------------------------------------------
# Observability surfaces
# ---------------------------------------------------------------------------


def test_stats_snapshot_shape():
    pool, _ = _make_pool(members=[_member("s0"), _member("s1")])
    try:
        s = pool.stats_snapshot()
        for k in ("role", "dispatched", "completed", "faults", "aborted",
                  "fallback_local", "in_flight", "members", "local"):
            assert k in s, k
        assert s["local"] is None  # no torch load for a cold tracker
        assert {m["id"] for m in s["members"]} == {"s0", "s1"}
    finally:
        pool.stop()


def test_worker_stats_snapshot_live_depths():
    from nomad_tpu_torch.server.worker import TPUBatchWorker

    class _Srv:
        eval_broker = None
        plan_queue = None

    w = TPUBatchWorker(_Srv(), batch_size=8)
    s = w.stats_snapshot()
    for k in ("pipeline", "batch_size", "processed", "commit_queue_depth",
              "chain_in_flight", "held_interactive", "lane_ledger_len",
              "submit_ewma_s", "lane_priority"):
        assert k in s, k
    assert s["batch_size"] == 8
    assert s["commit_queue_depth"] == 0


def test_pool_gauges_registered():
    from nomad_tpu_torch import metrics

    pool, _ = _make_pool(members=[_member("s0"), _member("s1")])
    try:
        gauges = metrics.snapshot().get("gauges", {})
        # provider-backed: healthy non-self members and total in-flight
        assert gauges.get("nomad.solver.pool.members") == 1
        assert gauges.get("nomad.solver.pool.in_flight") == 0
    finally:
        pool.stop()


# ---------------------------------------------------------------------------
# Layering, counters, a member whose card failed
# ---------------------------------------------------------------------------


def test_tracker_fabric_and_membership_load_no_torch_or_jax():
    """The server-side tracker, the RPC fabric and gossip membership are
    host code: a fresh interpreter importing them loads neither torch
    nor jax (the member engine brings torch in at its first solve)."""
    code = (
        "import sys\n"
        "import nomad_tpu_torch.rpc\n"
        "import nomad_tpu_torch.server.membership\n"
        "import nomad_tpu_torch.server.solver_pool\n"
        "print(sorted(m for m in ('torch', 'jax') if m in sys.modules))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        check=True, timeout=120,
    ).stdout.strip()
    assert out == "[]"


def test_launch_counts_exact_under_concurrent_launches():
    """Pool members in one process launch from several threads: every
    wrapper's count goes through one locked increment."""
    from nomad_tpu_torch.scheduler.gpu import kernels as tk

    tk.reset_launch_counts()
    n_threads, per = 16, 5000
    go = threading.Event()

    def launch():
        go.wait()
        for _ in range(per):
            tk._count(tk.solve_placement_compact)
            tk._count(tk.scatter_rows, attr="launches_copy")

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as possible
    try:
        threads = [threading.Thread(target=launch) for _ in range(n_threads)]
        for t in threads:
            t.start()
        go.set()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert tk.solve_placement_compact.launches == n_threads * per
        assert tk.scatter_rows.launches_copy == n_threads * per
    finally:
        sys.setswitchinterval(switch)
        tk.reset_launch_counts()


def test_member_with_lost_device_refuses_every_later_solve(monkeypatch):
    """A CUDA fault in a member's solve (DeviceLost) kills that member's
    context: the member answers that solve and every later one with an
    error and never launches again."""
    from nomad_tpu_torch.faultplane import DeviceLost
    from nomad_tpu_torch.scheduler.gpu import remote_solve

    h, job = _warm_cluster_state()
    host = types.SimpleNamespace(state=h.state)
    rs = remote_solve.RemoteSolver(host, SchedulerConfig(device="cpu"), "m1")
    assert rs.warm(h.state.latest_index()) != "cold"
    real_begin = remote_solve.solve_eval_batch_begin
    calls = []

    def lost(*a, **kw):
        calls.append(1)
        raise DeviceLost("CUDA error: an illegal memory access")

    monkeypatch.setattr(remote_solve, "solve_eval_batch_begin", lost)
    with pytest.raises(DeviceLost):
        rs.solve([mock.eval_for_job(job)], h.state.latest_index())
    monkeypatch.setattr(remote_solve, "solve_eval_batch_begin", real_begin)
    for fn in (lambda: rs.solve([mock.eval_for_job(job)], 0), rs.warm):
        with pytest.raises(RuntimeError, match="lost its device"):
            fn()
    assert calls == [1]
    assert rs.stats()["device_lost"]
    assert rs.solves == 0


# ---------------------------------------------------------------------------
# Differentials (tolerance: none)
# ---------------------------------------------------------------------------


def _pool_fleet(seed):
    """Seeded nodes and jobs built once with nomad_tpu's mocks into a
    nomad_tpu Harness; the port's Harness gets the same objects through
    the wire form, at the same store index. The jobs over-ask the
    fleet."""
    import random

    from nomad_tpu import codec as jcodec
    from nomad_tpu import mock as jmock
    from nomad_tpu.testing import Harness as JHarness
    from nomad_tpu_torch.codec import from_wire

    rng = random.Random(seed)
    jh, th = JHarness(), Harness()
    index = 0
    for i in range(rng.randint(16, 28)):
        n = jmock.node()
        n.datacenter = f"dc{1 + i % 2}"
        index += 1
        jh.state.upsert_node(index, n)
        th.state.upsert_node(index, from_wire(jcodec.to_wire(n)))
    jobs = []
    for j in range(12):
        job = jmock.job(id=f"pool-{seed}-{j}")
        job.datacenters = ["dc1", "dc2"]
        tg = job.task_groups[0]
        tg.count = rng.randint(8, 16)
        tg.tasks[0].resources.cpu = rng.choice([400, 500, 800])
        tg.tasks[0].resources.memory_mb = rng.choice([128, 256, 512])
        tg.tasks[0].resources.networks = []
        index += 1
        jh.state.upsert_job(index, job)
        th.state.upsert_job(index, from_wire(jcodec.to_wire(job)))
        jobs.append(jh.state.job_by_id(job.namespace, job.id))
    jevals = [jmock.eval_for_job(j) for j in jobs]
    tevals = [from_wire(jcodec.to_wire(e)) for e in jevals]
    return jh, th, jobs, jevals, tevals


def _plan_placements(plans: dict) -> list:
    out = []
    for plan in plans.values():
        for allocs in plan.node_allocation.values():
            out += [(a.job_id, a.name, a.node_id) for a in allocs]
        for b in plan.alloc_batches:
            out += [(a.job_id, a.name, a.node_id) for a in b.materialize()]
    return sorted(out)


def _commit_plans(h, plans: dict) -> None:
    for ev_id in sorted(plans):
        if not plans[ev_id].is_no_op():
            h.submit_plan(plans[ev_id])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_remote_solver_matches_nomad_tpu(seed):
    """nomad_tpu's RemoteSolver and the port's, each warmed on its own
    copy of one cluster, solve the same two batches of 6 evals (the
    second after both committed the first: a delta sync). Placements,
    followup counts and sync kinds must be equal."""
    from nomad_tpu.scheduler.context import SchedulerConfig as JConfig
    from nomad_tpu.scheduler.tpu.remote_solve import RemoteSolver as JRemote
    from nomad_tpu_torch.scheduler.gpu.remote_solve import RemoteSolver

    jh, th, jobs, jevals, tevals = _pool_fleet(seed)
    jrs = JRemote(types.SimpleNamespace(state=jh.state), JConfig(
        backend="tpu", small_batch_threshold=0), "m1")
    trs = RemoteSolver(types.SimpleNamespace(state=th.state), SchedulerConfig(
        device="cpu", small_batch_threshold=0), "m1")
    assert trs.warm() == jrs.warm() == "full"
    for lo, hi in ((0, 6), (6, 12)):
        jout = jrs.solve(jevals[lo:hi], jh.state.latest_index())
        tout = trs.solve(tevals[lo:hi], th.state.latest_index())
        assert _plan_placements(tout["plans"]) == _plan_placements(
            jout["plans"])
        assert len(_plan_placements(tout["plans"])) > 0
        assert len(tout["followups"]) == len(jout["followups"])
        assert (tout["telemetry"]["last_sync"]
                == jout["telemetry"]["last_sync"])
        _commit_plans(jh, jout["plans"])
        _commit_plans(th, tout["plans"])
    assert tout["telemetry"]["last_sync"].startswith("delta:")
    assert trs.stats()["warmups"] == jrs.stats()["warmups"] == 1


class _PoolNode:
    """One in-process cluster node the way a cluster server wires it: an
    RPCServer with a shared secret, a ConnPool, a Membership joined by
    gossip and a SolverPool; `host` owns the state store (a member's
    host shares the leader's store: a perfectly synced replica)."""

    SECRET = "pool-secret"

    def __init__(self, node_id, host, role=""):
        from nomad_tpu_torch.rpc import ConnPool, RPCServer
        from nomad_tpu_torch.server.membership import Membership

        self.node_id = node_id
        self.server = host
        self.rpc = RPCServer(secret=self.SECRET)
        self.rpc.chaos_label = node_id
        self.pool = ConnPool(secret=self.SECRET)
        self.pool.owner = node_id
        self.serf = Membership(
            node_id, self.rpc.addr, pool=self.pool,
            tags={"role": "server"}, probe_interval_s=0.1,
            probe_timeout_s=1.0, suspicion_timeout_s=3.0,
            on_event=lambda kind, m: self.solver_pool.on_member_event(
                kind, m),
        )
        self.rpc.register("Serf", self.serf.endpoint)
        self.solver_pool = SolverPool(self, role=role)
        self.rpc.register("SolverPool", self.solver_pool.endpoint)
        self.rpc.start()
        self.serf.start()
        self.solver_pool.start()

    def shutdown(self):
        self.solver_pool.stop()
        self.serf.stop()
        self.rpc.shutdown()
        self.pool.shutdown()


def _join(leader, members):
    for m in members:
        assert m.serf.join([leader.rpc.addr]) == 1
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if len([m for m in leader.solver_pool.members()
                if m["status"] == "alive" and not m["self"]]) == len(members):
            return
        time.sleep(0.02)
    raise AssertionError("pool members never became alive at the leader")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_member_over_rpc_matches_local_solve(seed, monkeypatch):
    """One snapshot: the leader's SolverPool dispatches a batch to a
    member over a real socket (the member's config is its own, on the
    host's device), and the port's local solve_eval_batch solves the
    same evals with a config of the same defaults. The plans' placements
    must be equal; the member's resident tensors are on the CPU."""
    from nomad_tpu_torch.scheduler.gpu import (
        ResidentClusterState, solve_eval_batch,
    )

    # the compact route at these sizes, not the numpy micro kernel
    monkeypatch.setenv("NOMAD_TPU_MICRO_NG", "0")
    _jh, th, _jobs, _jevals, tevals = _pool_fleet(seed)
    cfg = SchedulerConfig(device="cpu")
    leader = _PoolNode("leader", types.SimpleNamespace(
        state=th.state, scheduler_config=cfg))
    member = _PoolNode("m1", types.SimpleNamespace(
        state=th.state, scheduler_config=cfg), role="solver")
    try:
        _join(leader, [member])
        snap = th.state.snapshot()
        local_planner, remote_planner = Harness(th.state), Harness(th.state)
        remote = leader.solver_pool.dispatch_batch(
            tevals[:8], snap, remote_planner, cfg)
        assert remote is not None
        got = remote.finish()
        want = solve_eval_batch(
            snap, local_planner, tevals[:8], SchedulerConfig(device="cpu"),
            resident=ResidentClusterState("cpu"))
        assert _plan_placements(got) == _plan_placements(want)
        assert len(_plan_placements(got)) > 0
        assert len(remote_planner.evals) == len(local_planner.evals)
        solver = member.solver_pool.endpoint.local_solver(build=False)
        assert solver.config is not cfg
        assert solver._resident._used_dev.device.type == "cpu"
        st = leader.solver_pool.stats_snapshot()
        assert (st["dispatched"], st["completed"], st["faults"]) == (1, 1, 0)
    finally:
        member.shutdown()
        leader.shutdown()


# ---------------------------------------------------------------------------
# The Server's batch worker on the pool
# ---------------------------------------------------------------------------


def _pool_server(n_members, pipeline=True):
    from nomad_tpu_torch.server import Server

    srv = Server(use_tpu_batch_worker=True,
                 scheduler_config=SchedulerConfig(device="cpu"))
    srv.tpu_worker.batch_size = 4
    srv.tpu_worker.pipeline = pipeline
    leader = _PoolNode("leader", srv)
    members = [
        _PoolNode(f"m{i}", types.SimpleNamespace(
            state=srv.state, scheduler_config=SchedulerConfig(device="cpu")),
            role="solver")
        for i in range(n_members)
    ]
    _join(leader, members)
    srv.tpu_worker.solver_pool = leader.solver_pool
    srv.establish_leadership()
    for i in range(24):
        n = mock.node()
        n.datacenter = "dc1"
        srv.node_register(n)
    return srv, leader, members


def _pool_jobs(prefix, n, count):
    jobs = []
    for j in range(n):
        job = mock.job(id=f"{prefix}-{j}")
        job.task_groups[0].count = count
        job.task_groups[0].tasks[0].resources.networks = []
        jobs.append(job)
    return jobs


def _register_all(srv, jobs, timeout_s=60.0):
    ids = [srv.job_register(job) for job in jobs]
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        srv.wait_for_evals(1.0)
        if all(srv.state.eval_by_id(i).status == "complete" for i in ids):
            return
        time.sleep(0.05)
    raise AssertionError("evals not complete")


def _live(srv, jobs):
    return sum(
        1 for j in jobs for a in srv.state.allocs_by_job(j.namespace, j.id)
        if not a.terminal_status())


def test_server_batches_ride_the_pool():
    """The port's Server with its batch worker's solver_pool set: every
    batch goes to the two members over real sockets (none falls back
    local), each member warms once, and every alloc is placed."""
    srv, leader, members = _pool_server(2)
    try:
        for m in members:
            leader.pool.call(m.rpc.addr, "SolverPool.Sync",
                             {"min_index": srv.state.latest_index()})
        jobs = _pool_jobs("rp", 16, 6)
        _register_all(srv, jobs)
        assert _live(srv, jobs) == 16 * 6
        st = leader.solver_pool.stats_snapshot()
        assert st["dispatched"] >= 4 and st["completed"] == st["dispatched"]
        assert st["fallback_local"] == 0 and st["faults"] == 0
        assert srv.tpu_worker._resident is None, "the leader solved locally"
        for m in members:
            s = m.solver_pool.endpoint.local_solver(build=False).stats()
            assert s["warmups"] == 1
        assert sum(m.solver_pool.endpoint.local_solver(build=False).solves
                   for m in members) == st["completed"]
    finally:
        srv.shutdown()
        for m in members:
            m.shutdown()
        leader.shutdown()


def test_member_fault_is_resolved_by_host_fallback(monkeypatch):
    """A faultplane drop on one member's SolverPool.Solve (both of the
    pool's attempts): that batch becomes exactly one member fault and
    one device failover, re-solved by solve_host_fallback; the next
    batches go to the surviving member and every alloc is placed. The
    worker runs unpipelined: a pipelined solve stage may dispatch its
    next batch before the failing call's thread has recorded the fault,
    and then picks the failing member again if both members are busy."""
    from nomad_tpu_torch import faultplane, metrics

    srv, leader, members = _pool_server(2, pipeline=False)
    calls = []
    real = RemotePendingBatch.solve_host_fallback

    def counted(self):
        calls.append(len(self._evals))
        return real(self)

    monkeypatch.setattr(RemotePendingBatch, "solve_host_fallback", counted)
    try:
        victim = leader.solver_pool._pick()[0]
        plane = faultplane.install(faultplane.FaultPlane(seed=0))
        for node in [leader] + members:
            plane.register_addr(node.node_id, node.rpc.addr)
        plane.drop_rpc(dst=victim, method="SolverPool.Solve", times=2)
        before = metrics.snapshot()["counters"].get(
            "nomad.worker.device_failover", 0)
        jobs = _pool_jobs("fo", 12, 6)
        _register_all(srv, jobs)
        failovers = metrics.snapshot()["counters"].get(
            "nomad.worker.device_failover", 0) - before
        assert _live(srv, jobs) == 12 * 6
        st = leader.solver_pool.stats_snapshot()
        assert st["faults"] == 1 and failovers == 1 and len(calls) == 1
        rows = {m["id"]: m for m in st["members"]}
        assert rows[victim]["faults"] == 1
        assert rows[victim]["dispatched"] == 1
    finally:
        faultplane.uninstall()
        srv.shutdown()
        for m in members:
            m.shutdown()
        leader.shutdown()
