"""The port's batch solve path against nomad_tpu's, end to end, on the CPU.

A cluster is built once in a nomad_tpu Harness, carried into a
nomad_tpu_torch Harness through the wire form (nomad_tpu.codec.to_wire
-> nomad_tpu_torch.codec.from_wire), and both packages then solve the
same evals: reconcile, lower, the compact kernel (JAX jitted on the CPU
vs the port's plain PyTorch twins on CPU tensors), materialize, one Plan
per eval. Placements are held exact: the same (job id, alloc name) ->
node id map, wave by wave, including the resident delta sync, the
adjusted view for stops, and a chained in-flight wave.
"""

import subprocess
import sys

import pytest
import torch

from nomad_tpu import codec as jcodec
from nomad_tpu import mock as jmock
from nomad_tpu.scheduler.context import SchedulerConfig as JConfig
from nomad_tpu.scheduler.tpu import (
    ResidentClusterState as JResident,
    solve_eval_batch as j_solve,
    solve_eval_batch_begin as j_begin,
)
from nomad_tpu.structs import Constraint, Spread
from nomad_tpu.structs.node_class import compute_node_class
from nomad_tpu.testing import Harness as JHarness

from nomad_tpu_torch import mock as tmock
from nomad_tpu_torch.codec import from_wire
from nomad_tpu_torch.scheduler import SchedulerConfig as TConfig
from nomad_tpu_torch.scheduler.gpu import (
    ResidentClusterState as TResident,
    kernels as tkernels,
    solve_eval_batch as t_solve,
    solve_eval_batch_begin as t_begin,
)
from nomad_tpu_torch.testing import Harness as THarness

# six xdist workers share the machine: keep torch's intra-op pool small
torch.set_num_threads(2)

DCS = ["dc1", "dc2", "dc3", "dc4"]


def _c2m_cluster(n_nodes: int) -> JHarness:
    """bench.py build_cluster's node shape: 4000 MHz / 8192 MB, dc1..dc4."""
    h = JHarness()
    for i in range(n_nodes):
        n = jmock.node()
        n.datacenter = DCS[i % len(DCS)]
        n.resources.cpu = 4000
        n.resources.memory_mb = 8192
        n.computed_class = compute_node_class(n)
        h.state.upsert_node(h.next_index(), n)
    return h


def _add_jobs(h: JHarness, prefix: str, n_jobs: int, count: int) -> list:
    """bench.py add_jobs(constrained=True): 250 MHz / 128 MB, the
    kernel.name constraint and a datacenter spread (weight 50)."""
    jobs = []
    for j in range(n_jobs):
        job = jmock.job(id=f"{prefix}-{j}")
        job.datacenters = list(DCS)
        tg = job.task_groups[0]
        tg.count = count
        tg.tasks[0].resources.cpu = 250
        tg.tasks[0].resources.memory_mb = 128
        tg.tasks[0].resources.networks = []
        job.constraints.append(Constraint("${attr.kernel.name}", "linux", "="))
        job.spreads = [Spread(attribute="${node.datacenter}", weight=50)]
        h.state.upsert_job(h.next_index(), job)
        jobs.append(h.state.job_by_id(job.namespace, job.id))
    return jobs


def _scale(h: JHarness, job, count: int):
    """Scale a job down and roll out a new version of its task in the
    same update. The eval then stops allocs AND places (the rolling
    update's max_parallel replacements): only an eval with placement
    asks brings its plan's stops into the batch's usage deltas — a pure
    scale-down eval has no ask, and its stops reach the solver only
    once committed."""
    job = job.copy()
    job.task_groups[0].count = count
    job.task_groups[0].tasks[0].env = {"FOO": "bar", "VERSION": "2"}
    h.state.upsert_job(h.next_index(), job)
    return h.state.job_by_id(job.namespace, job.id)


def _carry_jobs(th: THarness, jobs) -> None:
    th.load_wire([], [jcodec.to_wire(j) for j in jobs])


def _evals(jobs):
    ref = [jmock.eval_for_job(j) for j in jobs]
    return ref, [from_wire(jcodec.to_wire(e)) for e in ref]


def _placements(plans, evals) -> dict:
    out = {}
    for ev in evals:
        plan = plans[ev.id]
        for allocs in plan.node_allocation.values():
            for a in allocs:
                out[(a.job_id, a.name)] = a.node_id
        for b in plan.alloc_batches:
            for a in b.materialize():
                out[(a.job_id, a.name)] = a.node_id
    return out


def _stops(plans, evals) -> set:
    return {
        (a.job_id, a.name)
        for ev in evals
        for allocs in plans[ev.id].node_update.values()
        for a in allocs
    }


def _commit(h, plans, evals) -> None:
    for ev in evals:
        h.submit_plan(plans[ev.id])


def _twin_cluster(n_nodes: int, n_jobs: int, count: int):
    jh = _c2m_cluster(n_nodes)
    jobs = _add_jobs(jh, "w1", n_jobs, count)
    th = THarness()
    th.load_wire(
        [jcodec.to_wire(n) for n in jh.state.nodes()],
        [jcodec.to_wire(j) for j in jobs],
    )
    return jh, th, jobs


def test_wire_carry_rebuilds_the_same_cluster():
    jh, th, jobs = _twin_cluster(40, 3, 20)
    assert [n.id for n in th.state.nodes()] == [n.id for n in jh.state.nodes()]
    for jn, tn in zip(jh.state.nodes(), th.state.nodes()):
        assert tn.modify_index == jn.modify_index
        assert tn.datacenter == jn.datacenter
        assert tn.available_resources().cpu == jn.available_resources().cpu
        assert tn.computed_class == jn.computed_class
    for job in jobs:
        tj = th.state.job_by_id(job.namespace, job.id)
        assert tj.modify_index == job.modify_index
        assert tj.version == job.version
        assert tj.task_groups[0].count == job.task_groups[0].count
        assert [c.ltarget for c in tj.constraints] == [
            c.ltarget for c in job.constraints
        ]
        assert tj.spreads[0].attribute == "${node.datacenter}"
    assert th.next_index() == jh.next_index()


def test_three_waves_match_reference(monkeypatch):
    """The slice as a whole, at 200 nodes: wave 1 fills from a full
    resident upload; wave 2 adds jobs and scales a wave-1 job down (a
    delta sync of wave 1's usage, then the non-donated adjusted view
    for the stops) and stays uncommitted; wave 3 chains on wave 2's
    used' with another scale-down (the clamped scatter-add onto the
    chain). Both packages must place every alloc on the same node."""
    jh, th, w1 = _twin_cluster(200, 8, 200)
    jres, tres = JResident(), TResident(device="cpu")
    jcfg = JConfig(small_batch_threshold=0)
    tcfg = TConfig(small_batch_threshold=0, device="cpu")
    tkernels.reset_launch_counts()
    syncs = []
    # which row-scatter flavors each wave ran (the CPU twins)
    calls = []
    set_plain, add_plain = tkernels.scatter_rows_plain, tkernels.scatter_add_rows_plain
    monkeypatch.setattr(
        tkernels, "scatter_rows_plain",
        lambda u, i, r, donate=True: calls.append(("set", donate))
        or set_plain(u, i, r, donate),
    )
    monkeypatch.setattr(
        tkernels, "scatter_add_rows_plain",
        lambda u, i, r: calls.append(("add", None)) or add_plain(u, i, r),
    )

    # wave 1
    jev, tev = _evals(w1)
    jp = j_solve(jh.snapshot(), jh, jev, jcfg, resident=jres)
    tp = t_solve(th.snapshot(), th, tev, tcfg, resident=tres)
    got, want = _placements(tp, tev), _placements(jp, jev)
    assert len(want) == 8 * 200
    assert got == want
    syncs.append((jres.last_sync, tres.last_sync))
    _commit(jh, jp, jev)
    _commit(th, tp, tev)

    # wave 2: new jobs + one wave-1 job scaled 200 -> 100, not committed
    w2 = _add_jobs(jh, "w2", 2, 200) + [_scale(jh, w1[0], 100)]
    _carry_jobs(th, w2)
    jev2, tev2 = _evals(w2)
    jpend2 = j_begin(jh.snapshot(), jh, jev2, jcfg, resident=jres)
    tpend2 = t_begin(th.snapshot(), th, tev2, tcfg, resident=tres)
    syncs.append((jres.last_sync, tres.last_sync))
    # the delta sync (donated), then the adjusted view for the stops
    assert calls == [("set", True), ("set", False)]
    calls.clear()

    # wave 3: chained on wave 2's in-flight used'
    w3 = _add_jobs(jh, "w3", 2, 200) + [_scale(jh, w1[1], 100)]
    _carry_jobs(th, w3)
    jev3, tev3 = _evals(w3)
    jpend3 = j_begin(
        jh.snapshot(), jh, jev3, jcfg, resident=jres, used_chain=jpend2.chain
    )
    tpend3 = t_begin(
        th.snapshot(), th, tev3, tcfg, resident=tres, used_chain=tpend2.chain
    )
    syncs.append((jres.last_sync, tres.last_sync))
    assert jpend3.chain_accepted and tpend3.chain_accepted
    assert calls == [("add", None)]  # the stops' deltas onto the chain

    jp2, tp2 = jpend2.finish(), tpend2.finish()
    jp3, tp3 = jpend3.finish(), tpend3.finish()
    for jplans, tplans, je, te in ((jp2, tp2, jev2, tev2),
                                   (jp3, tp3, jev3, tev3)):
        assert _stops(tplans, te) == _stops(jplans, je)
        # 100 scaled away + the rolling update's 5 replacements
        assert len(_stops(jplans, je)) == 105
        got, want = _placements(tplans, te), _placements(jplans, je)
        assert sum(1 for k in want if not k[0].startswith("w1-")) == 400
        assert got == want
        _commit(jh, jplans, je)
        _commit(th, tplans, te)

    assert [s[1] for s in syncs] == [s[0] for s in syncs]
    assert syncs[0][1] == "full" and syncs[1][1].startswith("delta:")
    # committed end state: the same live alloc -> node map, within cap
    live_j = {
        (a.job_id, a.name): a.node_id
        for a in jh.state.allocs() if not a.terminal_status()
    }
    live_t = {
        (a.job_id, a.name): a.node_id
        for a in th.state.allocs() if not a.terminal_status()
    }
    assert live_t == live_j and len(live_t) == 8 * 200 - 200 + 2 * 400
    for node in th.state.nodes():
        assert th.state.node_usage(node.id)[0] <= node.available_resources().cpu
    # on the CPU every wrapper ran its plain twin: no kernel launched
    assert [fn.launches for fn in tkernels.KERNELS] == [0] * 7


def test_spread_relaxation_retry_matches_reference(monkeypatch):
    """dc4's nodes hold 4 allocs each, too few for its spread quota: the
    restricted dc4 sub-group leaves requests over, and the solver retries
    them against the unrestricted feasibility (the spread-relaxation
    retry, with its own synchronous kernel call and chain refresh)."""
    from nomad_tpu_torch.scheduler.gpu import solver as tsolver

    jh = JHarness()
    for i in range(40):
        n = jmock.node()
        n.datacenter = DCS[i % 4]
        n.resources.cpu = 1000 if n.datacenter == "dc4" else 4000
        n.resources.memory_mb = 8192
        n.computed_class = compute_node_class(n)
        jh.state.upsert_node(jh.next_index(), n)
    jobs = _add_jobs(jh, "spread", 2, 120)
    th = THarness()
    th.load_wire(
        [jcodec.to_wire(n) for n in jh.state.nodes()],
        [jcodec.to_wire(j) for j in jobs],
    )
    retries = []
    run_compact = tsolver.BatchSolver._run_compact
    monkeypatch.setattr(
        tsolver.BatchSolver, "_run_compact",
        lambda self, *a, **k: retries.append(1) or run_compact(self, *a, **k),
    )
    jev, tev = _evals(jobs)
    jp = j_solve(jh.snapshot(), jh, jev, JConfig(small_batch_threshold=0),
                 resident=JResident())
    tres = TResident(device="cpu")
    pend = t_begin(th.snapshot(), th, tev,
                   TConfig(small_batch_threshold=0, device="cpu"),
                   resident=tres)
    tp = pend.finish()
    got, want = _placements(tp, tev), _placements(jp, jev)
    assert got == want and len(got) == 240
    assert retries, "the spread-relaxation retry did not run"
    assert not any(ev.failed_tg_allocs for ev in tev)
    # the chain now carries both passes' placements
    placed = sum(a.comparable_resources().cpu
                 for ev in tev for b in tp[ev.id].alloc_batches
                 for a in b.materialize())
    assert int(pend.chain[1][:, 0].sum()) == placed


def test_resident_state_matches_upload_path():
    """Port twin of test_resident_state_matches_upload_path_across_
    incremental_solves (tests/test_tpu_solver.py:1148): resident sync
    full -> delta/clean places exactly as a per-solve upload does."""

    def build():
        h = THarness()
        for i in range(50):
            n = tmock.node()
            n.id = f"res-node-{i:03d}"
            n.name = n.id
            h.state.upsert_node(h.next_index(), n)
        return h

    def run(h, resident, jobs_round):
        evals = []
        for i in jobs_round:
            job = tmock.job(id=f"res-job-{i}")
            job.task_groups[0].count = 6
            h.state.upsert_job(h.next_index(), job)
            evals.append(tmock.eval_for_job(job))
        plans = t_solve(
            h.snapshot(), h, evals,
            TConfig(small_batch_threshold=0, device="cpu"), resident=resident,
        )
        for ev in evals:
            h.submit_plan(plans[ev.id])
        return {
            (a.job_id, a.name): a.node_id
            for ev in evals
            for allocs in plans[ev.id].node_allocation.values()
            for a in allocs
        }

    h_res, h_up = build(), build()
    resident = TResident(device="cpu")
    syncs = []
    for rnd in ([0, 1], [2], [3, 4]):
        got = run(h_res, resident, rnd)
        want = run(h_up, None, rnd)
        assert got == want and len(got) == 6 * len(rnd)
        syncs.append(resident.last_sync)
    assert syncs[0] == "full"
    assert all(s.startswith("delta:") or s == "clean" for s in syncs[1:])


def test_microsolve_route_matches_reference():
    """A small batch takes the numpy microsolve in both packages."""
    jh, th, jobs = _twin_cluster(12, 2, 5)
    jev, tev = _evals(jobs)
    jp = j_solve(jh.snapshot(), jh, jev, JConfig(preemption_service=False))
    tp = t_solve(
        th.snapshot(), th, tev, TConfig(preemption_service=False, device="cpu")
    )
    got = _placements(tp, tev)
    assert got == _placements(jp, jev) and len(got) == 10


def test_chain_survives_the_retry_and_never_aliases_resident():
    jh, th, jobs = _twin_cluster(40, 2, 30)
    tres = TResident(device="cpu")
    _, tev = _evals(jobs)
    pend = t_begin(
        th.snapshot(), th, tev, TConfig(small_batch_threshold=0, device="cpu"),
        resident=tres,
    )
    node_ids, used_out = pend.chain
    assert used_out.data_ptr() != tres._used_dev.data_ptr()
    assert len(node_ids) == 40 and tuple(used_out.shape) == (256, 3)
    # the resident tensor still holds committed (empty) usage
    assert int(tres._used_dev.sum()) == 0
    pend.finish()


# ---------------------------------------------------------------------------
# device rule and the routes not ported yet
# ---------------------------------------------------------------------------


def _one_eval_harness(count=5):
    th = THarness()
    for _ in range(4):
        th.state.upsert_node(th.next_index(), tmock.node())
    job = tmock.job(id="route-job")
    job.task_groups[0].count = count
    job.task_groups[0].tasks[0].resources.networks = []
    th.state.upsert_job(th.next_index(), job)
    return th, tmock.eval_for_job(job)


def test_cuda_device_raises_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    th, ev = _one_eval_harness()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_solve(th.snapshot(), th, [ev], TConfig(small_batch_threshold=0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TResident()
    # nothing was reconciled for the refused solve
    assert th.evals == [] and th.plans == []


def test_resolve_device():
    import torch

    from nomad_tpu_torch.scheduler.gpu import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported"):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda:0")


@pytest.mark.parametrize("route", ["host", "solve_fn", "mesh", "fallback"])
def test_unported_routes_raise(route):
    if route == "host":
        # This case expected NotImplementedError ("ROADMAP.md A3") until
        # the host iterator stack was ported; it now holds that route
        # instead: a small batch with the microsolve off runs the host
        # stack (_solve_host) and places the same allocs through both
        # packages, each drawing its shuffles from one seed.
        import random

        jh, th2, jobs = _twin_cluster(40, 3, 12)
        jev, tev = _evals(jobs)
        random.seed(5)
        jp = j_solve(jh.snapshot(), jh, jev,
                     JConfig(micro_solve_threshold=0))
        tp = t_solve(th2.snapshot(), th2, tev,
                     TConfig(micro_solve_threshold=0, device="cpu"),
                     rng=random.Random(5))
        got = _placements(tp, tev)
        assert got == _placements(jp, jev) and len(got) == 36
    elif route == "solve_fn":
        # This case expected NotImplementedError ("ROADMAP.md A6") until
        # the dense route was ported; it now holds that route instead: a
        # custom solve_fn (a wrapper, so not the default kernel) places
        # the same allocs through both packages.
        from nomad_tpu.scheduler.tpu import kernels as jkernels

        jh, th2, jobs = _twin_cluster(40, 2, 30)
        jev, tev = _evals(jobs)
        jp = j_solve(jh.snapshot(), jh, jev, JConfig(small_batch_threshold=0),
                     solve_fn=lambda *a: jkernels.solve_placement(*a))
        tp = t_solve(th2.snapshot(), th2, tev,
                     TConfig(small_batch_threshold=0, device="cpu"),
                     solve_fn=lambda *a: tkernels.solve_placement(*a))
        got = _placements(tp, tev)
        assert got == _placements(jp, jev) and len(got) == 60
    elif route == "mesh":
        # This case expected NotImplementedError ("ROADMAP.md A7") until
        # the mesh route was ported; it now holds that route instead: one
        # eval on a two-shard mesh places the same allocs through both
        # packages (the node-sharded compact kernels).
        jh, th2, jobs = _twin_cluster(40, 1, 60)
        jev, tev = _evals(jobs)
        jp = j_solve(jh.snapshot(), jh, jev,
                     JConfig(small_batch_threshold=0, mesh_devices=2))
        tp = t_solve(th2.snapshot(), th2, tev,
                     TConfig(small_batch_threshold=0, mesh_devices=2,
                             device="cpu"))
        got = _placements(tp, tev)
        assert got == _placements(jp, jev) and len(got) == 60
    else:
        # This case expected NotImplementedError ("ROADMAP.md A4") until
        # the host iterator stack was ported; it now holds the fallback
        # instead: a dispatched batch re-solved on the host oracle places
        # the same allocs through both packages.
        import random

        jh, th2, jobs = _twin_cluster(40, 2, 30)
        jev, tev = _evals(jobs)
        random.seed(9)
        jp = j_begin(jh.snapshot(), jh, jev,
                     JConfig(small_batch_threshold=0)).solve_host_fallback()
        pend = t_begin(th2.snapshot(), th2, tev,
                       TConfig(small_batch_threshold=0, device="cpu"),
                       rng=random.Random(9))
        tp = pend.solve_host_fallback()
        got = _placements(tp, tev)
        assert got == _placements(jp, jev) and len(got) == 60
        assert pend.chain is None and not pend.chain_accepted
        assert pend.solve_host_fallback() is tp


def test_port_never_imports_jax_or_nomad_tpu():
    """Every module of the port — the server pipeline, the native
    loader and the leaf modules included, each named so a module the
    walk missed fails — imports neither jax nor nomad_tpu."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import nomad_tpu_torch\n"
        "seen = set()\n"
        "for m in pkgutil.walk_packages(nomad_tpu_torch.__path__, "
        "'nomad_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "    seen.add(m.name)\n"
        "need = {'nomad_tpu_torch.' + m for m in ('native', 'server',"
        " 'retry', 'faultplane', 'hostobs', 'blackbox', 'ratelimit',"
        " 'tcprelay', 'connect', 'connect.hook', 'connect.sidecar',"
        " 'structs.diff')}\n"
        "need |= {'nomad_tpu_torch.server.' + m for m in ('plan_queue',"
        " 'eval_broker', 'blocked_evals', 'raft', 'plan_apply', 'heartbeat',"
        " 'core_sched', 'worker', 'server', 'job_plan',"
        " 'deployment_watcher', 'drainer', 'periodic')}\n"
        "assert need <= seen, sorted(need - seen)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'nomad_tpu' or m.startswith('nomad_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
