"""The port's dense and preemption route against nomad_tpu's, on the CPU.

Kernels: the same seeded numpy inputs go through nomad_tpu's jitted
solve_placement / solve_placement_preempt (JAX on the CPU) and through
the port's wrappers on CPU tensors, which run their plain PyTorch twins.
Every output is held array-equal.

Solver: a cluster is built in a nomad_tpu Harness and carried into a
nomad_tpu_torch Harness through the wire form; both packages fill it and
then solve the same high-priority wave. Placements ((job id, alloc name)
-> node id), the victims of each plan, each placement's
preempted_allocations and the failure counts are held exact.
"""

import zlib

import numpy as np
import pytest
import torch

from nomad_tpu import codec as jcodec
from nomad_tpu import mock as jmock
from nomad_tpu.scheduler.context import SchedulerConfig as JConfig
from nomad_tpu.scheduler.tpu import kernels as jkernels
from nomad_tpu.scheduler.tpu import solve_eval_batch as j_solve
from nomad_tpu.structs import Constraint, Spread
from nomad_tpu.structs.node_class import compute_node_class
from nomad_tpu.testing import Harness as JHarness

from nomad_tpu_torch import mock as tmock
from nomad_tpu_torch.codec import from_wire
from nomad_tpu_torch.scheduler import SchedulerConfig as TConfig
from nomad_tpu_torch.scheduler.gpu import kernels as tkernels
from nomad_tpu_torch.scheduler.gpu import solve_eval_batch as t_solve
from nomad_tpu_torch.structs import PlanResult
from nomad_tpu_torch.testing import Harness as THarness

# six xdist workers share the machine: keep torch's intra-op pool small
torch.set_num_threads(2)

DCS = ["dc1", "dc2", "dc3", "dc4"]


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _problem(rng, n=1024, g=48, tiers=0):
    """tests/test_tpu_solver.py _c1k_problem, copied: a random padded
    problem at c1k scale; with tiers > 0 nearly-full nodes whose usage is
    mostly low-tier, the cumulative tier prefix and per-group limits."""
    cap = rng.integers(2000, 8000, size=(n, 3)).astype(np.int32)
    used = (cap * rng.uniform(0.0, 0.5, size=(n, 3))).astype(np.int32)
    asks = rng.integers(100, 600, size=(g, 3)).astype(np.int32)
    counts = rng.integers(1, 120, size=g).astype(np.int32)
    feas = rng.random((g, n)) > 0.15
    bias = (rng.random((g, n)) * 0.2).astype(np.float32)
    ucap = np.full((g, n), 1 << 30, dtype=np.int32)
    if not tiers:
        return cap, used, asks, counts, feas, bias, ucap
    used = (cap * rng.uniform(0.75, 0.95, size=(n, 3))).astype(np.int32)
    counts = rng.integers(40, 200, size=g).astype(np.int32)
    shares = rng.dirichlet(np.ones(tiers), size=n)[:, :, None]  # [n,T,1]
    tier_usage = (
        used[:, None, :] * 0.9 * shares
    ).astype(np.int32).transpose(1, 0, 2)  # [T, n, 3]
    prefix = np.zeros((tiers + 1, n, 3), dtype=np.int32)
    prefix[1:] = np.cumsum(tier_usage, axis=0)
    tier_limit = rng.integers(0, tiers + 1, size=g).astype(np.int32)
    return cap, used, asks, counts, feas, bias, ucap, prefix, tier_limit


def _both(jfn, tfn, arrays):
    want = jfn(*arrays)
    got = tfn(*[torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])
    assert len(got) == len(want)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return [np.asarray(w) for w in want]


def _dense(arrays):
    return _both(jkernels.solve_placement, tkernels.solve_placement, arrays)


def _preempt(cap, used, asks, counts, feas, bias, ucap, prefix, tier_limit):
    return _both(
        jkernels.solve_placement_preempt, tkernels.solve_placement_preempt,
        (cap, used, prefix, asks, counts, feas, bias, ucap, tier_limit),
    )


# seeded random problems, then the cases K4's kernel routes on: every
# group's units fit its count (the select's round-0 shortcut), Np not a
# multiple of 128 (the kernel's global-memory slices), a batch padded with
# count-0 groups, and counts well below the units on spread scores (radix
# passes)
DENSE_CASES = [0, 5, 19, "all_fit", "np_not_128", "padded_groups",
               "radix_passes"]


def _dense_case(case):
    if isinstance(case, int):
        rng = np.random.default_rng(case)
        n, g = 1024, 48
    else:
        rng = np.random.default_rng(zlib.crc32(case.encode()))
        n = 1000 if case == "np_not_128" else 1024
        g = 16 if case == "radix_passes" else 48
    cap, used, asks, counts, feas, bias, ucap = _problem(rng, n=n, g=g)
    # finite unit caps too, so the clip to ucap binds somewhere
    ucap = rng.integers(0, 6, size=ucap.shape).astype(np.int32)
    if case == "all_fit":
        counts = np.full(g, 1 << 20, dtype=np.int32)
    elif case == "padded_groups":
        counts[1::3] = 0
        counts[-8:] = 0
    elif case == "radix_passes":
        counts = rng.integers(150, 400, size=g).astype(np.int32)
    return cap, used, asks, counts, feas, bias, ucap


def _check_dense_case(case, arrays, assign):
    counts, ucap = arrays[3], arrays[6]
    placed = assign.sum(axis=1)
    assert placed.sum() > 0 and (assign <= ucap).all()
    if case == "all_fit":
        assert (placed < counts).all()
    elif case == "padded_groups":
        assert (assign[counts == 0] == 0).all() and placed.sum() > 0
    elif case == "radix_passes":
        assert (placed == counts).all()


@pytest.mark.parametrize("seed", DENSE_CASES)
def test_dense_matches_reference_random(seed):
    arrays = _dense_case(seed)
    assign, used_out = _dense(arrays)
    _check_dense_case(seed, arrays, assign)


@pytest.mark.parametrize("case", DENSE_CASES)
def test_dense_with_radix_select_matches_reference(monkeypatch, case):
    """The dense solve with each group's waterfill computed as K4's kernel
    computes it (the radix select's plain model) equals nomad_tpu's
    solve_placement on every case above."""
    arrays = _dense_case(case)
    monkeypatch.setattr(tkernels, "_waterfill", _select_waterfill)
    assign, _ = _dense(arrays)
    _check_dense_case(case, arrays, assign)


def test_dense_matches_reference_all_tied():
    """Identical nodes and zero bias: every score ties, so the fill order
    is the node index alone (the stable sort's order)."""
    n, g = 512, 16
    cap = np.full((n, 3), 4000, dtype=np.int32)
    used = np.zeros((n, 3), dtype=np.int32)
    asks = np.tile(np.array([[250, 128, 150]], np.int32), (g, 1))
    counts = np.random.default_rng(2).integers(0, 300, g).astype(np.int32)
    feas = np.ones((g, n), dtype=bool)
    bias = np.zeros((g, n), dtype=np.float32)
    ucap = np.full((g, n), 7, dtype=np.int32)
    assign, _ = _dense((cap, used, asks, counts, feas, bias, ucap))
    assert assign.sum() == counts.sum()


def test_dense_negative_free_capacity_floors():
    """Overcommitted nodes: cap - used < 0 floors (jnp '//') to a
    negative unit count, which clips to zero."""
    rng = np.random.default_rng(4)
    cap, used, asks, counts, feas, bias, ucap = _problem(rng, n=256, g=16)
    over = rng.random(256) < 0.4
    used[over] = cap[over] + rng.integers(1, 700, (int(over.sum()), 3))
    assign, _ = _dense((cap, used, asks, counts, feas, bias, ucap))
    assert assign.sum() > 0 and assign[:, over].sum() == 0


@pytest.mark.parametrize("tiers", [1, 3])
@pytest.mark.parametrize("seed", [0, 7])
def test_preempt_matches_reference(tiers, seed):
    arrays = _problem(np.random.default_rng(seed), tiers=tiers)
    assign, evict, _ = _preempt(*arrays)
    assert evict.sum() > 0 and (evict <= assign).all()


@pytest.mark.parametrize("klim", [0, 1, 2, 3])
def test_preempt_every_tier_limit(klim):
    """One tier limit for every group, from none to all three tiers."""
    arrays = list(_problem(np.random.default_rng(11), n=512, g=24, tiers=3))
    arrays[-1] = np.full(24, klim, dtype=np.int32)
    assign, evict, _ = _preempt(*arrays)
    assert (evict.sum() > 0) == (klim > 0)


def test_preempt_padded_tier_axis_and_limit_at_the_pad():
    """The solver pads the tier axis to a multiple of 4 with the full
    sum repeated. A limit at the pad, past it (the JAX kernel clamps the
    index) or negative (it counts from the end) reads that last row, so
    the result is the unpadded prefix's with every tier preemptible."""
    cap, used, asks, counts, feas, bias, ucap, prefix, _ = _problem(
        np.random.default_rng(13), n=512, g=24, tiers=2
    )
    padded = np.concatenate([prefix, prefix[-1:]], axis=0)  # Tp = 4
    at_pad = _preempt(cap, used, asks, counts, feas, bias, ucap, padded,
                      np.array([3, 9, -1] * 8, dtype=np.int32))
    every_tier = _preempt(cap, used, asks, counts, feas, bias, ucap, prefix,
                          np.full(24, 2, dtype=np.int32))
    for a, b in zip(at_pad, every_tier):
        np.testing.assert_array_equal(a, b)
    assert at_pad[1].sum() > 0


def _select_waterfill(score, units, count, k=None):
    assert k is None
    return tkernels.waterfill_select_plain(score, units, int(count))


@pytest.mark.parametrize("variant", ["random", "tied", "one_unit"])
def test_preempt_with_radix_select_matches_reference(monkeypatch, variant):
    """The preemption solve with each phase's waterfill computed as K5's
    kernel computes it (the radix select's plain model) equals nomad_tpu's
    solve_placement_preempt: random scores, all-tied nodes, and one-unit
    caps that put the boundary inside a run of one-unit nodes."""
    arrays = list(_problem(np.random.default_rng(29), n=512, g=24, tiers=3))
    if variant != "random":
        arrays[0] = np.full_like(arrays[0], 4000)
        arrays[1] = np.full_like(arrays[1], 3200)
        arrays[5] = np.zeros_like(arrays[5])
    if variant == "one_unit":
        arrays[6] = np.ones_like(arrays[6])
    monkeypatch.setattr(tkernels, "_waterfill", _select_waterfill)
    assign, evict, _ = _preempt(*arrays)
    assert assign.sum() > 0


def test_preempt_phase_one_places_everything():
    """Small counts on roomy nodes: phase 1 places every instance, so
    phase 2 has nothing left and evicts nothing."""
    cap, used, asks, counts, feas, bias, ucap, prefix, tier_limit = _problem(
        np.random.default_rng(17), n=512, g=16, tiers=3
    )
    used = (used // 4).astype(np.int32)
    counts = np.full(16, 5, dtype=np.int32)
    tier_limit = np.full(16, 3, dtype=np.int32)
    assign, evict, _ = _preempt(cap, used, asks, counts, feas, bias, ucap,
                                prefix, tier_limit)
    assert (assign.sum(axis=1) == 5).all() and evict.sum() == 0


def test_dense_wrappers_refuse_other_devices():
    arrays = [torch.from_numpy(a) for a in _problem(np.random.default_rng(0),
                                                    n=256, g=8)]
    with pytest.raises(ValueError, match="unsupported device"):
        tkernels.solve_placement(*[a.to("meta") for a in arrays])


# ---------------------------------------------------------------------------
# the solver route
# ---------------------------------------------------------------------------


def _cluster(n_nodes: int) -> JHarness:
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


def _jobs(h, prefix, n_jobs, count, priority, dcs=DCS, spread=False):
    """bench.py add_jobs at 400 MHz / 800 MB; with spread, the
    kernel.name constraint and a datacenter spread (weight 50)."""
    jobs = []
    for j in range(n_jobs):
        job = jmock.job(id=f"{prefix}-{j}")
        job.datacenters = list(dcs)
        job.priority = priority
        tg = job.task_groups[0]
        tg.count = count
        tg.tasks[0].resources.cpu = 400
        tg.tasks[0].resources.memory_mb = 800
        tg.tasks[0].resources.networks = []
        if spread:
            job.constraints.append(
                Constraint("${attr.kernel.name}", "linux", "=")
            )
            job.spreads = [Spread(attribute="${node.datacenter}", weight=50)]
        h.state.upsert_job(h.next_index(), job)
        jobs.append(h.state.job_by_id(job.namespace, job.id))
    return jobs


def _twin(jh: JHarness) -> THarness:
    th = THarness()
    th.load_wire([jcodec.to_wire(n) for n in jh.state.nodes()], [])
    return th


def _carry(th: THarness, jobs) -> None:
    th.load_wire([], [jcodec.to_wire(j) for j in jobs])


def _evals(jobs):
    ref = [jmock.eval_for_job(j) for j in jobs]
    return ref, [from_wire(jcodec.to_wire(e)) for e in ref]


def _outcome(h, plans, evals) -> dict:
    """What a wave decided, in ids that both packages share: placements,
    each plan's victims and each placement's preempted allocs by (job
    id, alloc name), and the failed allocs per eval."""
    def key(alloc_id):
        a = h.state.alloc_by_id(alloc_id)
        return (a.job_id, a.name)

    placed, preempted_by, victims, failed = {}, {}, {}, {}
    for ev in evals:
        plan = plans[ev.id]
        for allocs in plan.node_allocation.values():
            for a in allocs:
                placed[(a.job_id, a.name)] = a.node_id
                if a.preempted_allocations:
                    preempted_by[(a.job_id, a.name)] = sorted(
                        key(v) for v in a.preempted_allocations
                    )
        for b in plan.alloc_batches:
            for a in b.materialize():
                placed[(a.job_id, a.name)] = a.node_id
        victims[ev.job_id] = sorted(
            (v.job_id, v.name, v.node_id)
            for allocs in plan.node_preemptions.values()
            for v in allocs
        )
        failed[ev.job_id] = {
            tg: m.coalesced_failures + 1
            for tg, m in ev.failed_tg_allocs.items()
        }
    return {"placed": placed, "preempted_by": preempted_by,
            "victims": victims, "failed": failed}


def _wave(jh, th, jobs, jcfg, tcfg, commit=True, **kw):
    _carry(th, jobs)
    jev, tev = _evals(jobs)
    jp = j_solve(jh.snapshot(), jh, jev, jcfg, **kw.get("j", {}))
    tp = t_solve(th.snapshot(), th, tev, tcfg, **kw.get("t", {}))
    want, got = _outcome(jh, jp, jev), _outcome(th, tp, tev)
    assert got == want
    if commit:
        for h, plans, evs in ((jh, jp, jev), (th, tp, tev)):
            for ev in evs:
                h.submit_plan(plans[ev.id])
    return got


def _fill(jh, th, tiers) -> None:
    """Fill through the compact route, highest tier first, so that no
    fill batch can preempt."""
    for prefix, n_jobs, count, prio, dcs in tiers:
        jobs = _jobs(jh, prefix, n_jobs, count, prio, dcs)
        got = _wave(jh, th, jobs, JConfig(), TConfig(device="cpu"))
        assert len(got["placed"]) == n_jobs * count
        assert not any(got["victims"].values())


def _count_twins(monkeypatch) -> dict:
    """On CPU tensors a wrapper runs its plain twin and launches nothing
    (its launch counter stays 0), so count the twins' calls instead."""
    calls: dict = {}
    for name in ("solve_placement", "solve_placement_preempt",
                 "solve_placement_compact"):
        plain = getattr(tkernels, name + "_plain")

        def counted(*a, _name=name, _plain=plain, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _plain(*a, **kw)

        monkeypatch.setattr(tkernels, name + "_plain", counted)
    return calls


def _live_fit(th) -> None:
    for node in th.state.nodes():
        u = th.state.node_usage(node.id)
        cap = node.available_resources()
        assert u[0] <= cap.cpu and u[1] <= cap.memory_mb


def test_bench_preempt_config_matches_reference(monkeypatch):
    """bench.py run_preempt_config (BASELINE config 4): 500 nodes filled
    to 90% by 25 x 180 allocs at priority 20, then 20 x 50 at priority 70
    in one batch. Half the wave lands on free slots, the other half
    evicts priority-20 allocs, one victim per placement."""
    jh = _cluster(500)
    th = _twin(jh)
    _fill(jh, th, [("fill", 25, 180, 20, DCS)])
    his = _jobs(jh, "hi", 20, 50, 70)
    calls = _count_twins(monkeypatch)
    got = _wave(jh, th, his, JConfig(preemption_service=True),
                TConfig(preemption_service=True, device="cpu"))
    assert len(got["placed"]) == 1000
    n_victims = sum(len(v) for v in got["victims"].values())
    assert n_victims == 500 == len(got["preempted_by"])
    assert all(len(v) == 1 for v in got["preempted_by"].values())
    assert calls == {"solve_placement_preempt": 1}
    _live_fit(th)
    assert len([a for a in th.state.allocs() if not a.terminal_status()]) \
        == 5000


def test_three_tier_spread_wave_runs_the_dense_retry(monkeypatch):
    """Three tiers at 200 nodes: dc4 is full of priority-65 allocs (not
    preemptible by priority 70), dc1 of priority-20 allocs, dc2/dc3 hold
    priority 40 with room to spare. The wave's dc4 sub-groups run out of
    capacity, and their remainder retries on the unrestricted base
    through the dense kernel (K4), which places it on dc2/dc3."""
    jh = _cluster(200)
    th = _twin(jh)
    _fill(jh, th, [
        ("p65", 5, 90, 65, ["dc4"]),
        ("p40", 6, 100, 40, ["dc2", "dc3"]),
        ("p20", 5, 100, 20, ["dc1"]),
    ])
    wave = _jobs(jh, "hi", 4, 100, 70, spread=True)
    calls = _count_twins(monkeypatch)
    got = _wave(jh, th, wave, JConfig(preemption_service=True,
                                      small_batch_threshold=0),
                TConfig(preemption_service=True, small_batch_threshold=0,
                        device="cpu"))
    assert calls == {"solve_placement_preempt": 1, "solve_placement": 1}
    assert len(got["placed"]) == 400
    victims = [v for vs in got["victims"].values() for v in vs]
    assert len(victims) == 100 and {v[0][:3] for v in victims} == {"p20"}
    _live_fit(th)


def test_custom_solve_fn_takes_the_dense_route():
    """A solve_fn that is not the default kernel selects the dense
    route. With no preempt variant beside it, preemption is off: a
    priority-70 wave on a fleet full of priority-20 allocs places and
    evicts nothing. Given a solve_preempt_fn too, the same wave evicts.
    Both packages decide alike each time."""
    jh = _cluster(40)
    th = _twin(jh)
    _fill(jh, th, [("low", 4, 100, 20, DCS)])  # 10 slots on each of 40 nodes
    jobs = _jobs(jh, "hi", 2, 30, 70, spread=True)
    calls: list = []

    def counted(tag, fn):
        def call(*a):
            calls.append(tag)
            return fn(*a)
        return call

    jcfg = JConfig(small_batch_threshold=0)
    tcfg = TConfig(small_batch_threshold=0, device="cpu")
    got = _wave(jh, th, jobs, jcfg, tcfg, commit=False,
                j={"solve_fn": counted("jax", jkernels.solve_placement)},
                t={"solve_fn": counted("torch", tkernels.solve_placement)})
    assert not got["placed"] and not any(got["victims"].values())
    assert sum(n for f in got["failed"].values() for n in f.values()) == 60
    assert calls.count("jax") == calls.count("torch") >= 1

    calls.clear()
    got = _wave(
        jh, th, jobs, jcfg, tcfg,
        j={"solve_fn": jkernels.solve_placement,
           "solve_preempt_fn": counted(
               "jax", jkernels.solve_placement_preempt)},
        t={"solve_fn": tkernels.solve_placement,
           "solve_preempt_fn": counted(
               "torch", tkernels.solve_placement_preempt)},
    )
    assert len(got["placed"]) == 60
    assert sum(len(v) for v in got["victims"].values()) == 60
    assert calls.count("jax") == calls.count("torch") >= 1
    _live_fit(th)


# ---------------------------------------------------------------------------
# nomad_tpu's preemption scenarios (tests/test_tpu_solver.py), through the port
# ---------------------------------------------------------------------------


def _low_alloc_on(th, node, priority=10, cpu=3600, memory_mb=7000):
    low_job = tmock.job(priority=priority)
    t = low_job.task_groups[0].tasks[0]
    t.resources.cpu = cpu
    t.resources.memory_mb = memory_mb
    low_job.task_groups[0].count = 1
    th.state.upsert_job(th.next_index(), low_job)
    la = tmock.alloc(job_=low_job, node_=node)
    la.resources.tasks["web"].cpu = cpu
    la.resources.tasks["web"].memory_mb = memory_mb
    la.client_status = "running"
    # the port's store takes allocs through the plan applier's entry point
    th.state.upsert_plan_results(
        th.next_index(), PlanResult(node_allocation={node.id: [la]})
    )
    return la


def _full_nodes(th, count):
    nodes = []
    for _ in range(count):
        n = tmock.node()
        n.reserved.cpu = 0
        n.reserved.memory_mb = 0
        th.state.upsert_node(th.next_index(), n)
        nodes.append(n)
    return nodes


def _high_job(th, count, cpu, memory_mb):
    job = tmock.job(priority=70)
    job.task_groups[0].count = count
    t = job.task_groups[0].tasks[0]
    t.resources.cpu = cpu
    t.resources.memory_mb = memory_mb
    th.state.upsert_job(th.next_index(), job)
    return job


def _port_solve(th, job):
    ev = tmock.eval_for_job(job)
    plans = t_solve(th.snapshot(), th, [ev],
                    TConfig(small_batch_threshold=0, device="cpu"))
    th.submit_plan(plans[ev.id])
    return plans[ev.id]


def _live(th, job):
    return [a for a in th.state.allocs_by_job(job.namespace, job.id)
            if not a.terminal_status()]


def test_port_preemption_evicts_lower_priority():
    """test_diff_preemption_evicts_lower_priority: a full node and a
    priority-70 job; the port places it by preempting the priority-10
    alloc and emits plan.node_preemptions."""
    th = THarness()
    (node,) = _full_nodes(th, 1)
    low = _low_alloc_on(th, node)
    job = _high_job(th, 1, 2000, 4000)
    plan = _port_solve(th, job)
    allocs = _live(th, job)
    assert len(allocs) == 1
    preempted = [a for v in plan.node_preemptions.values() for a in v]
    assert [a.id for a in preempted] == [low.id]
    assert preempted[0].desired_status == "evict"
    assert allocs[0].preempted_allocations == [low.id]


def test_port_preemption_respects_priority_delta():
    """test_diff_preemption_respects_priority_delta: an alloc within 10
    priority of the new job is not preemptible; the placement fails."""
    th = THarness()
    (node,) = _full_nodes(th, 1)
    _low_alloc_on(th, node, priority=65)
    job = _high_job(th, 1, 2000, 4000)
    plan = _port_solve(th, job)
    assert _live(th, job) == []
    assert not plan.node_preemptions


def test_port_batch_preemption_many_nodes():
    """test_tpu_batch_preemption_many_nodes: a fleet of full nodes and a
    high-priority job that needs them — one victim per node, capacity
    never exceeded."""
    th = THarness()
    nodes = _full_nodes(th, 8)
    lows = [_low_alloc_on(th, n, cpu=3000, memory_mb=6000) for n in nodes]
    job = _high_job(th, 8, 3000, 5000)
    ev = tmock.eval_for_job(job)
    plans = t_solve(th.snapshot(), th, [ev],
                    TConfig(small_batch_threshold=0, device="cpu"))
    plan = plans[ev.id]
    placed = [a for allocs in plan.node_allocation.values() for a in allocs]
    assert len(placed) == 8
    preempted = [a for allocs in plan.node_preemptions.values()
                 for a in allocs]
    assert {a.id for a in preempted} == {la.id for la in lows}
    gone = {p.id for p in preempted}
    for node in nodes:
        keep = [a for a in th.state.allocs_by_node_terminal(node.id, False)
                if a.id not in gone]
        new = plan.node_allocation.get(node.id, [])
        assert sum(a.comparable_resources().cpu for a in keep + new) \
            <= node.resources.cpu
