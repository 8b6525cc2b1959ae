"""The reference's lifecycle cases against the port, on the CPU: the
deployment watcher, node drainer, periodic dispatch and core GC of
nomad_tpu_torch.server, each of the 21 cases of tests/test_lifecycle.py
with the same assertions (the periodic ambiguous-raft case on the port's
own LeadershipLostError / NotLeaderError). Then a lockstep differential:
both packages' Servers run chip_smoke.py's hand-driven lifecycle (register,
plan, a canary rollout promoted to success, an auto-revert, a drain, a
forced periodic launch and a dispatch) at 200 nodes with the batch worker
in batches of 8, on the same seeded nodes; plans, placements by (job,
alloc name, node), deployments, job versions, drain marks and batch
verdicts are compared with no tolerance."""

import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.server import CoreScheduler, CronSpec, core_eval
from nomad_tpu_torch.server.deployment_watcher import DeploymentsWatcher
from nomad_tpu_torch.server.drainer import NodeDrainer
from nomad_tpu_torch.server.periodic import PeriodicDispatch, next_launch
from nomad_tpu_torch.server.raft import FSM, InmemLog
from nomad_tpu_torch.state import StateStore
from nomad_tpu_torch.structs import DrainStrategy, now_ns
from nomad_tpu_torch.structs.structs import (
    DEPLOYMENT_STATUS_FAILED,
    DEPLOYMENT_STATUS_RUNNING,
    DEPLOYMENT_STATUS_SUCCESSFUL,
    AllocDeploymentStatus,
    DeploymentState,
    PeriodicConfig,
    UpdateStrategy,
    new_deployment,
)


class Pipe:
    """StateStore + FSM + single-node log: just enough server for the
    leader subsystems."""

    def __init__(self):
        self.state = StateStore()
        self.fsm = FSM(self.state)
        self.log = InmemLog(self.fsm)
        self.raft_apply = self.log.apply
        self._i = 1

    def idx(self):
        self._i += 1
        return self.log.last_index + 1000 + self._i


# ---------------------------------------------------------------------------
# Deployment watcher
# ---------------------------------------------------------------------------


def _deployed_job(p, auto_revert=False, auto_promote=False, canary=0):
    job = mock.job()
    job.update = UpdateStrategy(
        auto_revert=auto_revert, auto_promote=auto_promote, canary=canary
    )
    job.task_groups[0].update = job.update.copy()
    job.canonicalize()
    p.raft_apply("job_register", (job, None))
    return p.state.job_by_id(job.namespace, job.id)


def _deployment_for(p, job, desired=2, canaries=0):
    d = new_deployment(job)
    d.task_groups[job.task_groups[0].name] = DeploymentState(
        auto_revert=job.update.auto_revert,
        auto_promote=job.update.auto_promote,
        desired_canaries=canaries,
        desired_total=desired,
        placed_allocs=desired,
    )
    p.raft_apply("deployment_upsert", d)
    return p.state.deployment_by_id(d.id)


def _place_allocs(p, job, d, n, healthy=None, canary=False):
    node = mock.node()
    p.raft_apply("node_register", node)
    allocs = []
    for i in range(n):
        a = mock.alloc(job_=job, node_=node, index=i)
        a.deployment_id = d.id
        a.client_status = "running"
        if healthy is not None:
            a.deployment_status = AllocDeploymentStatus(
                healthy=healthy, canary=canary
            )
        allocs.append(a)
    p.raft_apply("alloc_update", allocs)
    return allocs


def test_deployment_success_marks_stable():
    p = Pipe()
    job = _deployed_job(p)
    d = _deployment_for(p, job, desired=2)
    _place_allocs(p, job, d, 2, healthy=True)
    w = DeploymentsWatcher(p.state, p.raft_apply)
    # first pass syncs counters, second judges completion
    w.run_once()
    w.run_once()
    got = p.state.deployment_by_id(d.id)
    assert got.status == DEPLOYMENT_STATUS_SUCCESSFUL
    assert p.state.job_by_id(job.namespace, job.id).stable


def test_deployment_unhealthy_fails_and_autoreverts():
    p = Pipe()
    job = _deployed_job(p, auto_revert=True)
    # v0 must be stable to be a revert target; then push v1
    stable0 = p.state.job_by_id(job.namespace, job.id).copy()
    stable0.stable = True
    p.raft_apply("job_register", (stable0, None))
    v1 = stable0.copy()
    v1.task_groups[0].tasks[0].env["V"] = "2"
    v1.stable = False
    p.raft_apply("job_register", (v1, None))
    v1 = p.state.job_by_id(job.namespace, job.id)
    assert v1.version == 1

    d = _deployment_for(p, v1, desired=2)
    _place_allocs(p, v1, d, 2, healthy=False)
    w = DeploymentsWatcher(p.state, p.raft_apply)
    w.run_once()
    got = p.state.deployment_by_id(d.id)
    assert got.status == DEPLOYMENT_STATUS_FAILED
    assert "rolling back" in got.status_description
    # job reverted: new version with v0's spec
    reverted = p.state.job_by_id(job.namespace, job.id)
    assert reverted.version == 2
    assert "V" not in reverted.task_groups[0].tasks[0].env
    # a deployment-watcher eval was created for the scheduler to roll back
    evs = p.state.evals_by_job(job.namespace, job.id)
    assert any(e.triggered_by == "deployment-watcher" for e in evs)


def test_deployment_healthy_deadline_marks_unhealthy():
    p = Pipe()
    job = _deployed_job(p)
    job_stored = p.state.job_by_id(job.namespace, job.id)
    tg = job_stored.task_groups[0]
    tg.update.healthy_deadline_s = 0.000001  # immediately past deadline
    d = _deployment_for(p, job_stored, desired=1)
    allocs = _place_allocs(p, job_stored, d, 1, healthy=None)
    # make the alloc old enough
    time.sleep(0.01)
    w = DeploymentsWatcher(p.state, p.raft_apply)
    w.run_once()
    got = p.state.deployment_by_id(d.id)
    assert got.status == DEPLOYMENT_STATUS_FAILED
    a = p.state.alloc_by_id(allocs[0].id)
    assert a.deployment_status.is_unhealthy()


def test_deployment_auto_promote():
    p = Pipe()
    job = _deployed_job(p, auto_promote=True, canary=1)
    d = _deployment_for(p, job, desired=2, canaries=1)
    allocs = _place_allocs(p, job, d, 1, healthy=True, canary=True)
    dd = p.state.deployment_by_id(d.id).copy()
    dd.task_groups[job.task_groups[0].name].placed_canaries = [allocs[0].id]
    p.raft_apply("deployment_upsert", dd)

    w = DeploymentsWatcher(p.state, p.raft_apply)
    w.run_once()
    got = p.state.deployment_by_id(d.id)
    assert got.task_groups[job.task_groups[0].name].promoted
    # canary flag cleared on promotion
    assert not p.state.alloc_by_id(allocs[0].id).deployment_status.canary


def test_deployment_manual_promote_requires_healthy_canaries():
    p = Pipe()
    job = _deployed_job(p, canary=1)
    d = _deployment_for(p, job, desired=2, canaries=1)
    allocs = _place_allocs(p, job, d, 1, healthy=False, canary=True)
    dd = p.state.deployment_by_id(d.id).copy()
    dd.task_groups[job.task_groups[0].name].placed_canaries = [allocs[0].id]
    p.raft_apply("deployment_upsert", dd)
    # validation happens endpoint-side, before the raft commit
    w = DeploymentsWatcher(p.state, p.raft_apply)
    with pytest.raises(ValueError, match="healthy canaries"):
        w.promote(p.state.deployment_by_id(d.id))


# ---------------------------------------------------------------------------
# Node drainer
# ---------------------------------------------------------------------------


def _drain_setup(p, n_allocs=3, max_parallel=1):
    node = mock.node()
    p.raft_apply("node_register", node)
    job = mock.job()
    job.task_groups[0].count = n_allocs
    from nomad_tpu_torch.structs.structs import MigrateStrategy

    job.task_groups[0].migrate = MigrateStrategy(max_parallel=max_parallel)
    p.raft_apply("job_register", (job, None))
    job = p.state.job_by_id(job.namespace, job.id)
    allocs = []
    for i in range(n_allocs):
        a = mock.alloc(job_=job, node_=node, index=i)
        a.client_status = "running"
        allocs.append(a)
    p.raft_apply("alloc_update", allocs)
    return node, job, allocs


def test_drainer_rate_limits_by_migrate_stanza():
    p = Pipe()
    node, job, allocs = _drain_setup(p, n_allocs=3, max_parallel=1)
    p.raft_apply("node_update_drain", (node.id, DrainStrategy(deadline_s=600), False))
    d = NodeDrainer(p.state, p.raft_apply)
    assert d.run_once() == 1  # only max_parallel=1 marked
    marked = [
        a
        for a in p.state.allocs_by_node(node.id)
        if a.desired_transition.should_migrate()
    ]
    assert len(marked) == 1
    # second pass: slot still held (migration not finished) -> no new marks
    assert d.run_once() == 0
    # the migrating alloc stops, but its replacement hasn't reported
    # health yet -> the slot is STILL held (reference watch_jobs.go:
    # healthy - (count - max_parallel) gate)
    stopped = marked[0].copy()
    stopped.desired_status = "stop"
    stopped.client_status = "complete"
    p.raft_apply("alloc_update", [stopped])
    assert d.run_once() == 0
    # a running replacement on a non-draining node opens the next slot
    other = mock.node()
    p.raft_apply("node_register", other)
    repl = mock.alloc(job_=job, node_=other, index=0)
    repl.client_status = "running"
    p.raft_apply("alloc_update", [repl])
    assert d.run_once() == 1


def test_drainer_deadline_forces_all():
    p = Pipe()
    node, job, allocs = _drain_setup(p, n_allocs=3, max_parallel=1)
    p.raft_apply("node_update_drain", (node.id, DrainStrategy(deadline_s=-1), False))
    d = NodeDrainer(p.state, p.raft_apply)
    assert d.run_once() == 3
    # drain eval created for the job
    evs = p.state.evals_by_job(job.namespace, job.id)
    assert any(e.triggered_by == "node-drain" for e in evs)


def test_drainer_completes_when_empty():
    p = Pipe()
    node = mock.node()
    p.raft_apply("node_register", node)
    p.raft_apply("node_update_drain", (node.id, DrainStrategy(deadline_s=600), False))
    assert p.state.node_by_id(node.id).drain
    d = NodeDrainer(p.state, p.raft_apply)
    d.run_once()
    got = p.state.node_by_id(node.id)
    assert not got.drain
    assert got.scheduling_eligibility == "ineligible"  # stays out of service


def test_drainer_ignores_system_jobs_when_asked():
    p = Pipe()
    node = mock.node()
    p.raft_apply("node_register", node)
    sysjob = mock.system_job()
    p.raft_apply("job_register", (sysjob, None))
    sysjob = p.state.job_by_id(sysjob.namespace, sysjob.id)
    a = mock.alloc(job_=sysjob, node_=node)
    a.client_status = "running"
    p.raft_apply("alloc_update", [a])
    p.raft_apply(
        "node_update_drain",
        (node.id, DrainStrategy(deadline_s=600, ignore_system_jobs=True), False),
    )
    d = NodeDrainer(p.state, p.raft_apply)
    assert d.run_once() == 0
    # node counts as done: only ignored system allocs remain
    assert not p.state.node_by_id(node.id).drain


# ---------------------------------------------------------------------------
# Periodic dispatch
# ---------------------------------------------------------------------------


def test_cron_next_after():
    spec = CronSpec("*/15 * * * *")
    # 2021-01-01 00:07:00 UTC -> next quarter hour
    import calendar

    t0 = calendar.timegm((2021, 1, 1, 0, 7, 0, 0, 0, 0))
    nxt = spec.next_after(t0)
    assert time.gmtime(nxt)[:5] == (2021, 1, 1, 0, 15)
    # exact boundary is exclusive
    t1 = calendar.timegm((2021, 1, 1, 0, 15, 0, 0, 0, 0))
    assert time.gmtime(spec.next_after(t1))[:5] == (2021, 1, 1, 0, 30)


def test_cron_fields():
    spec = CronSpec("30 4 1,15 * 5")  # 04:30 on the 1st, 15th and Fridays
    import calendar

    t0 = calendar.timegm((2021, 3, 2, 0, 0, 0, 0, 0, 0))  # Tue Mar 2
    nxt = time.gmtime(spec.next_after(t0))
    assert nxt[:5] == (2021, 3, 5, 4, 30)  # Friday Mar 5 (dow OR dom)


def test_periodic_launches_child():
    p = Pipe()
    job = mock.job()
    job.type = "batch"
    job.periodic = PeriodicConfig(enabled=True, spec="*/5 * * * *")
    p.raft_apply("job_register", (job, None))
    pd = PeriodicDispatch(p.state, p.raft_apply)
    pd.restore()
    assert len(pd.tracked()) == 1
    # force the clock past the next launch
    key = (job.namespace, job.id)
    when = pd._next[key]
    assert pd.run_once(when + 1) == 1
    children = p.state.jobs_by_parent(job.namespace, job.id)
    assert len(children) == 1
    assert children[0].id.startswith(job.id + "/periodic-")
    assert children[0].parent_id == job.id
    evs = p.state.evals_by_job(job.namespace, children[0].id)
    assert len(evs) == 1 and evs[0].triggered_by == "periodic-job"


def test_periodic_prohibit_overlap():
    p = Pipe()
    job = mock.job()
    job.type = "batch"
    job.periodic = PeriodicConfig(
        enabled=True, spec="*/5 * * * *", prohibit_overlap=True
    )
    p.raft_apply("job_register", (job, None))
    pd = PeriodicDispatch(p.state, p.raft_apply)
    pd.restore()
    when = pd._next[(job.namespace, job.id)]
    assert pd.run_once(when + 1) == 1
    # child still pending -> second due launch is skipped
    when2 = pd._next[(job.namespace, job.id)]
    assert pd.run_once(when2 + 1) == 0


def test_periodic_every_spec():
    cfg = PeriodicConfig(enabled=True, spec="@every 30s")
    assert next_launch(cfg, 1000.0) == 1030.0


def test_periodic_ambiguous_raft_failure_keeps_reservation():
    """An outcome-unknown raft failure (LeadershipLostError, timeout)
    must keep the child-id reservation — the entry can still commit
    after the raise, and releasing the id would let a racer probe
    (not reserved, not yet in state) and silently upsert over the
    late-committing child. A pre-submit NotLeaderError is known not to
    have reached the log and releases the id."""
    from nomad_tpu_torch.server.raft import (LeadershipLostError,
                                             NotLeaderError)

    p = Pipe()
    job = mock.job()
    job.type = "batch"
    job.periodic = PeriodicConfig(enabled=True, spec="*/5 * * * *")
    p.raft_apply("job_register", (job, None))
    pd = PeriodicDispatch(p.state, p.raft_apply)

    def raising(exc):
        def apply(op, args):
            raise exc
        return apply

    # ambiguous: deposed mid-replication — id stays reserved, and the
    # next launch at the same second steers to ts+1
    pd.raft_apply = raising(LeadershipLostError("deposed"))
    with pytest.raises(LeadershipLostError):
        pd.create_child(job, 1000)
    assert (job.namespace, f"{job.id}/periodic-1000") in pd._launch_reserved
    pd.raft_apply = p.raft_apply
    assert pd.create_child(job, 1000) == f"{job.id}/periodic-1001"

    # ambiguous: commit-stall timeout — same containment
    pd.raft_apply = raising(TimeoutError("raft apply timed out"))
    with pytest.raises(TimeoutError):
        pd.create_child(job, 2000)
    assert (job.namespace, f"{job.id}/periodic-2000") in pd._launch_reserved

    # definite: pre-submit not-leader refusal never reached the log —
    # the id is free for the retry that lands on the new leader
    pd.raft_apply = raising(NotLeaderError("not leader"))
    with pytest.raises(NotLeaderError):
        pd.create_child(job, 3000)
    assert (job.namespace, f"{job.id}/periodic-3000") not in pd._launch_reserved
    pd.raft_apply = p.raft_apply
    assert pd.create_child(job, 3000) == f"{job.id}/periodic-3000"


# ---------------------------------------------------------------------------
# Core GC
# ---------------------------------------------------------------------------


class FakeServer:
    def __init__(self, p):
        self.p = p
        self.raft_apply = p.raft_apply


def test_core_eval_gc():
    p = Pipe()
    job = mock.job()
    p.raft_apply("job_register", (job, None))
    job = p.state.job_by_id(job.namespace, job.id)
    ev = mock.eval_for_job(job, status="complete")
    p.raft_apply("eval_update", [ev])
    node = mock.node()
    p.raft_apply("node_register", node)
    a = mock.alloc(job_=job, node_=node, eval_id=ev.id, client_status="complete")
    a.desired_status = "stop"
    p.raft_apply("alloc_update", [a])

    core = CoreScheduler(FakeServer(p), p.state.snapshot())
    n_evals, n_allocs = core.eval_gc(force=True)
    assert (n_evals, n_allocs) == (1, 1)
    assert p.state.eval_by_id(ev.id) is None
    assert p.state.alloc_by_id(a.id) is None


def test_core_eval_gc_spares_live():
    p = Pipe()
    job = mock.job()
    p.raft_apply("job_register", (job, None))
    job = p.state.job_by_id(job.namespace, job.id)
    ev = mock.eval_for_job(job, status="complete")
    p.raft_apply("eval_update", [ev])
    node = mock.node()
    p.raft_apply("node_register", node)
    a = mock.alloc(job_=job, node_=node, eval_id=ev.id, client_status="running")
    p.raft_apply("alloc_update", [a])
    core = CoreScheduler(FakeServer(p), p.state.snapshot())
    assert core.eval_gc(force=True) == (0, 0)
    assert p.state.eval_by_id(ev.id) is not None


def test_core_job_gc():
    p = Pipe()
    job = mock.job()
    job.stop = True
    p.raft_apply("job_register", (job, None))
    core = CoreScheduler(FakeServer(p), p.state.snapshot())
    assert core.job_gc(force=True) == 1
    assert p.state.job_by_id(job.namespace, job.id) is None


def test_core_node_gc():
    p = Pipe()
    node = mock.node()
    p.raft_apply("node_register", node)
    p.raft_apply("node_update_status", (node.id, "down"))
    core = CoreScheduler(FakeServer(p), p.state.snapshot())
    assert core.node_gc(force=True) == 1
    assert p.state.node_by_id(node.id) is None


def test_core_deployment_gc():
    p = Pipe()
    job = mock.job()
    p.raft_apply("job_register", (job, None))
    job = p.state.job_by_id(job.namespace, job.id)
    d = new_deployment(job)
    d.status = "failed"
    p.raft_apply("deployment_upsert", d)
    core = CoreScheduler(FakeServer(p), p.state.snapshot())
    assert core.deployment_gc(force=True) == 1
    assert p.state.deployment_by_id(d.id) is None


def test_force_gc_via_core_eval():
    p = Pipe()
    node = mock.node()
    p.raft_apply("node_register", node)
    p.raft_apply("node_update_status", (node.id, "down"))
    core = CoreScheduler(FakeServer(p), p.state.snapshot())
    core.process(core_eval("force-gc"))
    assert p.state.node_by_id(node.id) is None


# ---------------------------------------------------------------------------
# Lockstep differential: both packages' Servers through chip_smoke.py's
# hand-driven lifecycle
# ---------------------------------------------------------------------------


def _chip_smoke():
    """chip_smoke.py (at the repo root) as a module: the lifecycle
    routine the card's `small` phase runs is the one held here."""
    import importlib.util
    import pathlib
    import sys

    if "chip_smoke" in sys.modules:
        return sys.modules["chip_smoke"]
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def _ref_fleet(n_nodes):
    """chip_smoke.c2m_nodes' fleet, built with nomad_tpu's mocks."""
    from nomad_tpu import mock as jmock
    from nomad_tpu.structs.node_class import compute_node_class

    nodes = []
    for i in range(n_nodes):
        n = jmock.node()
        n.datacenter = ["dc1", "dc2", "dc3", "dc4"][i % 4]
        n.resources.cpu = 4000
        n.resources.memory_mb = 8192
        n.computed_class = compute_node_class(n)
        nodes.append(n)
    return nodes


def _ref_make(job_id, count):
    """chip_smoke.make_job's c2m job, built with nomad_tpu's mocks."""
    from nomad_tpu import mock as jmock
    from nomad_tpu.structs import Constraint, Spread

    job = jmock.job(id=job_id)
    job.datacenters = ["dc1", "dc2", "dc3", "dc4"]
    tg = job.task_groups[0]
    tg.count = count
    tg.tasks[0].resources.cpu = 250
    tg.tasks[0].resources.memory_mb = 128
    tg.tasks[0].resources.networks = []
    job.constraints.append(Constraint("${attr.kernel.name}", "linux", "="))
    job.spreads = [Spread(attribute="${node.datacenter}", weight=50)]
    return job


@pytest.mark.parametrize("seed", [0, 1])
def test_lifecycle_lockstep_matches_nomad_tpu(seed):
    """LIFE_SMALL (200 nodes, 20 jobs of 50 with canary 2 and
    max_parallel 10, migrate max_parallel 5): nomad_tpu's Server
    (backend "tpu") and the port's (device "cpu"), each with its batch
    worker in batches of 8 driven by hand, on the same nodes, jobs and
    seeded drained nodes. Everything lifecycle_lockstep returns must be
    equal, and the run must roll, revert, drain and chain."""
    import random

    from nomad_tpu import codec as jcodec
    from nomad_tpu.scheduler.context import SchedulerConfig as JConfig
    from nomad_tpu.server import Server as JServer
    from nomad_tpu.structs import structs as jstructs
    from nomad_tpu_torch.codec import from_wire
    from nomad_tpu_torch.scheduler.context import SchedulerConfig
    from nomad_tpu_torch.server import Server as TServer
    from nomad_tpu_torch.structs import structs as tstructs

    def wire(obj):
        return from_wire(jcodec.to_wire(obj))

    cs = _chip_smoke()
    cfg = cs.LIFE_SMALL
    nodes = _ref_fleet(200)
    drained = random.Random(seed).sample(
        sorted(n.id for n in nodes), int(200 * cfg["drain_ratio"]))
    jsrv = JServer(use_tpu_batch_worker=True, scheduler_config=JConfig(
        backend="tpu", small_batch_threshold=0))
    tsrv = TServer(use_tpu_batch_worker=True, scheduler_config=SchedulerConfig(
        device="cpu", small_batch_threshold=0))
    for srv in (jsrv, tsrv):
        srv.tpu_worker.batch_size = cs.SERVER_BATCH
        srv.tpu_worker.lane_priority = 0
    try:
        jout = cs.lifecycle_lockstep(jsrv, jstructs, _ref_make, nodes,
                                     drained, cfg)
        tout = cs.lifecycle_lockstep(
            tsrv, tstructs, lambda jid, c: wire(_ref_make(jid, c)),
            [wire(n) for n in nodes], drained, cfg)
    finally:
        jsrv.shutdown()
        tsrv.shutdown()
    assert sorted(tout) == sorted(jout)
    for key in jout:
        assert tout[key] == jout[key], key
    assert tout["deploy_rounds"] >= 2
    statuses = {d[2] for d in tout["deployments"]}
    assert {"successful", "failed"} <= statuses
    assert any(p for p in tout["drain_passes"][:2])
    assert any(chained and accepted
               for _, chained, accepted, _ in tout["verdicts"])
    assert len(tout["placed"]) == (cfg["jobs"] * cfg["count"]
                                   + 2 * cfg["child"])


def test_lifecycle_modules_load_no_torch_jax_or_nomad_tpu():
    """The job lifecycle's modules are host code: a fresh interpreter
    importing the plan, the three watchers, the diff and the Connect
    hook loads neither torch nor jax nor anything of nomad_tpu (job_plan
    reaches the card's schedulers only when a plan runs)."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import nomad_tpu_torch.server.job_plan\n"
        "import nomad_tpu_torch.server.deployment_watcher\n"
        "import nomad_tpu_torch.server.drainer\n"
        "import nomad_tpu_torch.server.periodic\n"
        "import nomad_tpu_torch.structs.diff\n"
        "import nomad_tpu_torch.connect\n"
        "import nomad_tpu_torch.connect.sidecar\n"
        "bad = sorted(m for m in sys.modules if m in ('torch', 'jax')"
        " or m.startswith(('torch.', 'jax.', 'nomad_tpu.')) or m == "
        "'nomad_tpu')\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        check=True, timeout=120,
    ).stdout.strip()
    assert out == "[]"
