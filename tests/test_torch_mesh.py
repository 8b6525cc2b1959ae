"""The port's mesh route against nomad_tpu's, on the CPU.

The node-sharded kernels (K6 make_sharded_solver in its full, top-k and
compact modes, K7 make_sharded_solver_preempt) and the solver's mesh
wiring. Inputs are seeded numpy arrays, fed to nomad_tpu on the 8
virtual CPU devices conftest.py sets up, and to the port with every
shard on the CPU (SolverMesh(device="cpu")), where the wrappers run
their plain twins. Every comparison is exact
(np.testing.assert_array_equal). The CUDA kernels run only on the card
and are held against these same twins by chip_smoke.py.

The twins' f32 scores round as XLA's do (kernels.xla_exp and the fused
score tail), so a near-tie falls the same way in both packages:
_c1k_problem seed 35, whose group 45 a one-ulp exp gap once flipped, is
held against nomad_tpu's dense and sharded solvers in every mode, and
against the port's own single-card twins.
"""

import logging

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from nomad_tpu import codec as jcodec
from nomad_tpu import mock as jmock
from nomad_tpu import solverobs as jobs_obs
from nomad_tpu.scheduler.context import SchedulerConfig as JConfig
from nomad_tpu.scheduler.tpu import (
    ResidentClusterState as JResident,
    solve_eval_batch as j_solve,
    solve_eval_batch_begin as j_begin,
)
from nomad_tpu.scheduler.tpu import kernels as jk
from nomad_tpu.scheduler.tpu import sharding as jsharding
from nomad_tpu.testing import Harness as JHarness

from nomad_tpu_torch import solverobs as tobs
from nomad_tpu_torch.codec import from_wire
from nomad_tpu_torch.scheduler import SchedulerConfig as TConfig
from nomad_tpu_torch.scheduler.gpu import (
    ResidentClusterState as TResident,
    SolverMesh,
    kernels as tk,
    sharding as tsharding,
    solve_eval_batch as t_solve,
    solve_eval_batch_begin as t_begin,
)
from nomad_tpu_torch.scheduler.gpu import scheduler as tscheduler
from nomad_tpu_torch.testing import Harness as THarness

# six xdist workers share the machine: keep torch's intra-op pool small
torch.set_num_threads(2)


def _mesh_n(n_dev: int) -> Mesh:
    devs = np.array(jax.devices()[:n_dev])
    if len(devs) < n_dev:
        pytest.skip(f"needs {n_dev} virtual devices (conftest sets them up)")
    return Mesh(devs, axis_names=("nodes",))


def _c1k_problem(rng, n=1024, g=48, tiers=0, tied=False, negative=False):
    """tests/test_tpu_solver.py _c1k_problem, with an all-tied and a
    negative-free-capacity variant."""
    cap = rng.integers(2000, 8000, size=(n, 3)).astype(np.int32)
    used = (cap * rng.uniform(0.0, 0.5, size=(n, 3))).astype(np.int32)
    asks = rng.integers(100, 600, size=(g, 3)).astype(np.int32)
    counts = rng.integers(1, 120, size=g).astype(np.int32)
    feas = rng.random((g, n)) > 0.15
    bias = (rng.random((g, n)) * 0.2).astype(np.float32)
    ucap = np.full((g, n), 1 << 30, dtype=np.int32)
    if tied:
        cap = np.full((n, 3), 4000, dtype=np.int32)
        used = np.zeros((n, 3), dtype=np.int32)
        asks = np.tile(np.array([[250, 128, 150]], np.int32), (g, 1))
        feas = np.ones((g, n), dtype=bool)
        bias = np.zeros((g, n), dtype=np.float32)
    if negative:
        rows = rng.random(n) < 0.3
        used[rows] = cap[rows] + rng.integers(1, 700, (int(rows.sum()), 3))
    if not tiers:
        return cap, used, asks, counts, feas, bias, ucap
    used = (cap * rng.uniform(0.75, 0.95, size=(n, 3))).astype(np.int32)
    counts = rng.integers(40, 200, size=g).astype(np.int32)
    shares = rng.dirichlet(np.ones(tiers), size=n)[:, :, None]
    tier_usage = (
        used[:, None, :] * 0.9 * shares
    ).astype(np.int32).transpose(1, 0, 2)
    prefix = np.zeros((tiers + 1, n, 3), dtype=np.int32)
    prefix[1:] = np.cumsum(tier_usage, axis=0)
    tier_limit = rng.integers(0, tiers + 1, size=g).astype(np.int32)
    return cap, used, asks, counts, feas, bias, ucap, prefix, tier_limit


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _assert_same(ref, got, names):
    for name, r, t in zip(names, ref, got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(r), err_msg=name)


MODES = {
    "full": dict(max_count=None, compact=False),
    "topk": dict(max_count=True, compact=False),
    "compact": dict(max_count=True, compact=True),
}


def _k6_both(a, n_dev, mode):
    kw = dict(MODES[mode])
    if kw["max_count"]:
        kw["max_count"] = jk.pad_c(int(a[3].max()))
    ref = jk.make_sharded_solver(_mesh_n(n_dev), "nodes", **kw)(*a)
    got = tk.sharded_solver(*_t(a), n_shards=n_dev, **kw)
    return ref, got, kw


def _names(mode):
    return ("inst", "over", "used'") if mode == "compact" else (
        "assign", "used'")


# ---------------------------------------------------------------------------
# K6: the node-sharded solve's twin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", ["full", "topk", "compact"])
def test_sharded_twin_matches_reference(mode, n_dev):
    """Seeds of tests/test_tpu_solver.py's sharded compact test (57 + D)."""
    a = _c1k_problem(np.random.default_rng(57 + n_dev))
    ref, got, _ = _k6_both(a, n_dev, mode)
    _assert_same(ref, got, _names(mode))
    assert int(np.asarray(ref[-1]).sum()) > int(a[1].sum())  # it placed


def test_sharded_full_twin_matches_reference_seed_7():
    """tests/test_tpu_solver.py's full-gather test: seed 7 on 8 shards."""
    a = _c1k_problem(np.random.default_rng(7))
    ref, got, _ = _k6_both(a, 8, "full")
    _assert_same(ref, got, _names("full"))


@pytest.mark.parametrize("variant", ["tied", "negative"])
@pytest.mark.parametrize("mode", ["full", "topk", "compact"])
def test_sharded_twin_ties_and_negative_free(mode, variant):
    """All-tied inputs (ties go to the lower global index, across shard
    boundaries) and 30% of the nodes over capacity (floor division of
    negative free capacity)."""
    a = _c1k_problem(np.random.default_rng(3), **{variant: True})
    if variant == "tied":
        # enough instances to fill across several shards
        a[3][:] = np.random.default_rng(4).integers(0, 120, a[3].shape)
    ref, got, _ = _k6_both(a, 8, mode)
    _assert_same(ref, got, _names(mode))


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_sharded_twin_matches_port_single_card_twins(n_dev):
    """The sharded algorithm against the port's own single-card kernels
    (K4 for the full and top-k modes, K1 for compact) on the same
    inputs, at the seeds of the reference's top-k test (31 + D), seed 35
    included: the scores are the same torch arithmetic on both sides."""
    a = _c1k_problem(np.random.default_rng(31 + n_dev))
    ta = _t(a)
    maxc = jk.pad_c(int(a[3].max()))
    dense = tk.solve_placement_plain(*ta)
    for kw in (dict(), dict(max_count=maxc)):
        got = tk.sharded_solver(*ta, n_shards=n_dev, **kw)
        for w, g in zip(dense, got):
            assert torch.equal(w, g)
    idx = torch.arange(a[2].shape[0], dtype=torch.int32)
    compact = tk.solve_placement_compact_plain(
        ta[0], ta[1], ta[2], ta[3],
        torch.from_numpy(np.packbits(a[4], axis=1)), idx, ta[5], idx,
        ta[6], idx, max_count=maxc,
    )
    got = tk.sharded_solver(*ta, n_shards=n_dev, max_count=maxc,
                            compact=True)
    for w, g in zip(compact, got):
        assert torch.equal(w, g)


def test_seed_35_dense_twin_matches_reference():
    """_c1k_problem seed 35 through K4's twin and nomad_tpu's
    solve_placement: group 45 holds a near-tie that an ulp of exp flips."""
    a = _c1k_problem(np.random.default_rng(35))
    ref = jk.solve_placement(*a)
    got = tk.solve_placement(*_t(a))
    _assert_same(ref, got, ("assign", "used'"))
    assert int(np.asarray(ref[0])[45].sum()) > 0


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", ["full", "topk", "compact"])
def test_seed_35_sharded_twin_matches_reference(mode, n_dev):
    """The same near-tie through the K6 twins and nomad_tpu's
    make_sharded_solver, in every mode and mesh size."""
    a = _c1k_problem(np.random.default_rng(35))
    ref, got, _ = _k6_both(a, n_dev, mode)
    _assert_same(ref, got, _names(mode))


@pytest.mark.parametrize("n_dev", [3, 5, 8])
def test_pad_nodes_non_multiple_mesh(n_dev):
    """A node count that does not divide the mesh is absorbed by
    pad_nodes (zero-capacity pad rows that never place), and the padded
    solve through the mesh's solver matches nomad_tpu's."""
    jmesh = jsharding.SolverMesh(n_dev)
    tmesh = SolverMesh(n_dev, device="cpu")
    for n in (1, 255, 1000, 2049, 10000, 100000):
        assert tmesh.pad_nodes(n) == jmesh.pad_nodes(n)
    n_real, g = 1000, 16
    np_ = tmesh.pad_nodes(n_real)
    rng = np.random.default_rng(77)
    cap = np.zeros((np_, 3), dtype=np.int32)
    used = np.zeros((np_, 3), dtype=np.int32)
    cap[:n_real] = rng.integers(2000, 8000, size=(n_real, 3))
    used[:n_real] = (
        cap[:n_real] * rng.uniform(0.0, 0.5, size=(n_real, 3))
    ).astype(np.int32)
    asks = rng.integers(100, 600, size=(g, 3)).astype(np.int32)
    counts = rng.integers(1, 60, size=g).astype(np.int32)
    feas = np.zeros((g, np_), dtype=bool)
    feas[:, :n_real] = rng.random((g, n_real)) > 0.15
    bias = np.zeros((g, np_), dtype=np.float32)
    bias[:, :n_real] = (rng.random((g, n_real)) * 0.2).astype(np.float32)
    ucap = np.full((g, np_), 1 << 30, dtype=np.int32)
    a = (cap, used, asks, counts, feas, bias, ucap)
    jfn, jkb = jmesh.solver(jk.pad_c(int(counts.max())))
    tfn, tkb = tmesh.solver(jk.pad_c(int(counts.max())))
    assert tkb == jkb and tfn.__name__ == f"sharded_solver_d{n_dev}"
    ref, got = jfn(*a), tfn(*a)
    _assert_same(ref, got, ("assign", "used'"))
    assert got[0][:, n_real:].sum() == 0


# ---------------------------------------------------------------------------
# K7: the node-sharded preemption solve's twin
# ---------------------------------------------------------------------------


def _preempt_args(a):
    """_c1k_problem's preempt tuple in the kernels' argument order."""
    cap, used, asks, counts, feas, bias, ucap, prefix, tier_limit = a
    return [cap, used, prefix, asks, counts, feas, bias, ucap, tier_limit]


@pytest.mark.parametrize("limit", ["-1", "0", "T", "T+1"])
def test_sharded_preempt_twin_matches_reference(limit):
    """_c1k_problem(tiers=3) on 8 shards: every group's tier limit set
    to -1 (wraps to the last prefix row), 0 (no preemption), T (every
    tier) or T+1 (past the last row, clamped)."""
    a = _preempt_args(_c1k_problem(np.random.default_rng(11), tiers=3))
    t = 3
    a[8][:] = {"-1": -1, "0": 0, "T": t, "T+1": t + 1}[limit]
    ref = jk.make_sharded_solver_preempt(_mesh_n(8), "nodes")(*a)
    got = tk.sharded_solver_preempt(*_t(a), n_shards=8)
    _assert_same(ref, got, ("assign", "evict", "used'"))
    single = tk.solve_placement_preempt_plain(*_t(a))
    for w, g in zip(single, got):
        assert torch.equal(w, g)
    if limit != "0":
        assert int(np.asarray(ref[1]).sum()) > 0, "phase 2 must run"


def test_sharded_preempt_twin_random_limits():
    """The reference's own sharded preempt test: seed 11, random limits."""
    a = _preempt_args(_c1k_problem(np.random.default_rng(11), tiers=3))
    ref = jk.make_sharded_solver_preempt(_mesh_n(8), "nodes")(*a)
    got = tk.sharded_solver_preempt(*_t(a), n_shards=8)
    _assert_same(ref, got, ("assign", "evict", "used'"))


@pytest.mark.parametrize("variant", ["random", "tied"])
def test_sharded_preempt_with_radix_select_matches_reference(monkeypatch,
                                                           variant):
    """K7's twin with each phase's gathered waterfill computed as its
    kernel computes it (the radix select's plain model) on 8 shards
    equals nomad_tpu's make_sharded_solver_preempt, on random scores and
    with every node tied."""
    a = _preempt_args(_c1k_problem(np.random.default_rng(11), tiers=3,
                                   tied=variant == "tied"))
    if variant == "tied":
        a[1] = np.full_like(a[1], 3400)  # phase 1 scores every node alike
    ref = jk.make_sharded_solver_preempt(_mesh_n(8), "nodes")(*a)

    def select(score, units, count, k=None):
        assert k is None
        return tk.waterfill_select_plain(score, units, int(count))

    monkeypatch.setattr(tk, "_waterfill", select)
    got = tk.sharded_solver_preempt(*_t(a), n_shards=8)
    _assert_same(ref, got, ("assign", "evict", "used'"))
    assert int(np.asarray(ref[0]).sum()) > 0


def test_launch_ledger_records_the_route():
    """solverobs.timed_call records the route an entry point reports in
    `last_route` (K7's graph capture, replay or step-by-step launches),
    counted per route in the kernel's ledger row; entry points without
    one record none."""
    obs = tobs.SolverObservatory()
    old = tobs._install(obs)
    try:
        def solve():
            return None

        for route in ("graph_capture", "graph_replay", "graph_replay"):
            solve.last_route = route
            tobs.timed_call("sharded_solver_preempt_d8", ("s", 1), solve)
        tobs.timed_call("solve_placement", ("d", 1), lambda: None)
        rows = obs.snapshot()["ledger"]["kernels"]
    finally:
        tobs._install(old)
    assert rows["sharded_solver_preempt_d8"]["routes"] == {
        "graph_capture": 1, "graph_replay": 2}
    assert rows["solve_placement"]["routes"] == {}


# ---------------------------------------------------------------------------
# the mesh's bookkeeping
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_dev", [1, 3, 8])
def test_shard_accounting_matches_reference(n_dev):
    jmesh = jsharding.SolverMesh(n_dev)
    tmesh = SolverMesh(n_dev, device="cpu")
    for n, np_ in ((1000, jmesh.pad_nodes(1000)),
                   (100000, jmesh.pad_nodes(100000)), (5, 256 * n_dev)):
        assert tmesh.shard_occupancy(n, np_) == jmesh.shard_occupancy(n, np_)
        for g in (8, 16, 80):
            for k in (None, 16, 512):
                assert tmesh.allgather_bytes(g, np_, k) == \
                    jmesh.allgather_bytes(g, np_, k)


def test_mesh_devices_and_names():
    mesh = SolverMesh(8, device="cpu")
    assert mesh.cards == [(torch.device("cpu"), 0, 8)]
    assert [s["device"] for s in mesh.shard_map()] == ["cpu"] * 8
    assert mesh.preempt_solver().__name__ == "sharded_solver_preempt_d8"
    assert mesh.solver(300, compact=True)[0].__name__ == \
        "sharded_solver_compact_d8"
    assert mesh.solver(300)[1] == 512
    assert tsharding.solver_mesh(8, "cpu") is tsharding.solver_mesh(8, "cpu")
    with pytest.raises(ValueError, match="shards"):
        SolverMesh(0, device="cpu")
    with pytest.raises(ValueError, match="shards"):
        SolverMesh(2000, device="cpu")
    # a per-card list passes through place(); a whole tensor stays whole
    x = torch.zeros(16, 3, dtype=torch.int32)
    assert mesh.place(x) is x


def test_mesh_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SolverMesh(8)
    # the scheduler never quietly degrades a cuda mesh to the CPU
    th = THarness()
    th.state.upsert_node(th.next_index(), _tnode())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_solve(th.snapshot(), th, [], TConfig(mesh_devices=8))


def test_unbuildable_mesh_logs_and_clears(caplog):
    cfg = TConfig(mesh_devices=5000, device="cpu")
    with caplog.at_level(logging.ERROR):
        assert tscheduler._mesh_for(cfg, None) is None
    assert cfg.mesh_devices == 0
    assert "mesh_devices=5000 unusable" in caplog.text
    # an explicit solve_fn brings its own topology
    assert tscheduler._mesh_for(TConfig(mesh_devices=8, device="cpu"),
                                lambda *a: a) is None


def test_sharded_wrappers_refuse_other_devices():
    a = _t(_c1k_problem(np.random.default_rng(0), n=256, g=8))
    with pytest.raises(ValueError, match="unsupported device"):
        tk.sharded_solver([a[0].to("meta")], [a[1]], *a[2:], n_shards=2)
    with pytest.raises(ValueError, match="equal shards"):
        tk.sharded_solver_plain(*a, n_shards=3)


# ---------------------------------------------------------------------------
# the mesh route through both packages' solve_eval_batch
# ---------------------------------------------------------------------------


def _tnode():
    from nomad_tpu_torch import mock as tmock

    return tmock.node()


def _twin_nodes(n_nodes: int, prefix: str):
    jh = JHarness()
    for i in range(n_nodes):
        n = jmock.node()
        n.id = f"{prefix}-{i:03d}"
        n.name = n.id
        jh.state.upsert_node(jh.next_index(), n)
    th = THarness()
    th.load_wire([jcodec.to_wire(n) for n in jh.state.nodes()], [])
    return jh, th


def _job(jh, th, job_id, count, cpu=None, mem=None, priority=None):
    job = jmock.job(id=job_id)
    job.task_groups[0].count = count
    if priority is not None:
        job.priority = priority
    res = job.task_groups[0].tasks[0].resources
    if cpu is not None:
        res.cpu, res.memory_mb, res.networks = cpu, mem, []
    jh.state.upsert_job(jh.next_index(), job)
    job = jh.state.job_by_id(job.namespace, job.id)
    th.load_wire([], [jcodec.to_wire(job)])
    return job


def _evals(jobs):
    ref = [jmock.eval_for_job(j) for j in jobs]
    return ref, [from_wire(jcodec.to_wire(e)) for e in ref]


def _outcome(h, plans, evals) -> dict:
    def key(alloc_id):
        a = h.state.alloc_by_id(alloc_id)
        return (a.job_id, a.name)

    placed, by, victims, failed = {}, {}, [], {}
    for ev in evals:
        plan = plans[ev.id]
        for allocs in plan.node_allocation.values():
            for a in allocs:
                placed[(a.job_id, a.name)] = a.node_id
                if a.preempted_allocations:
                    by[(a.job_id, a.name)] = sorted(
                        key(v) for v in a.preempted_allocations)
        for b in plan.alloc_batches:
            for a in b.materialize():
                placed[(a.job_id, a.name)] = a.node_id
        victims += [(v.job_id, v.name, v.node_id)
                    for allocs in plan.node_preemptions.values()
                    for v in allocs]
        failed[ev.job_id] = {tg: m.coalesced_failures + 1
                             for tg, m in ev.failed_tg_allocs.items()}
    return {"placed": placed, "preempted_by": by,
            "victims": sorted(victims), "failed": failed}


def _commit(h, plans, evals):
    for ev in evals:
        h.submit_plan(plans[ev.id])


@pytest.fixture
def observatories():
    jold = jobs_obs._install(jobs_obs.SolverObservatory())
    told = tobs._install(tobs.SolverObservatory())
    try:
        yield
    finally:
        jobs_obs._install(jold)
        tobs._install(told)


def test_resident_sharded_delta_sync_matches_reference(observatories):
    """test_tpu_solver.py's sharded resident round trip through both
    packages: the full upload, then delta syncs scattered into the
    owning shards, on an 8-shard mesh; every round places the same
    allocs on the same nodes as nomad_tpu."""
    jh, th = _twin_nodes(50, "shard-node")
    jres = JResident(mesh=jsharding.solver_mesh(8))
    tres = TResident(mesh=tsharding.solver_mesh(8, "cpu"))
    jcfg = JConfig(small_batch_threshold=0, mesh_devices=8)
    tcfg = TConfig(small_batch_threshold=0, mesh_devices=8, device="cpu")
    syncs = []
    for rnd in ([0, 1], [2], [3, 4]):
        jobs = [_job(jh, th, f"shard-job-{i}", 6) for i in rnd]
        jev, tev = _evals(jobs)
        jp = j_solve(jh.snapshot(), jh, jev, jcfg, resident=jres)
        tp = t_solve(th.snapshot(), th, tev, tcfg, resident=tres)
        want, got = _outcome(jh, jp, jev), _outcome(th, tp, tev)
        assert got["placed"] and got == want, f"round {rnd} diverged"
        syncs.append((jres.last_sync, tres.last_sync))
        _commit(jh, jp, jev)
        _commit(th, tp, tev)
    assert [s[1] for s in syncs] == [s[0] for s in syncs]
    assert syncs[0][1] == "full"
    assert all(s[1].startswith("delta:") or s[1] == "clean"
               for s in syncs[1:])
    # every shard on the one (CPU) device: one [Np, 3] tensor
    assert tuple(tres._used_dev.shape) == (256, 3)
    snap = tobs.snapshot(sample=False)
    assert snap["transfers"]["scatter_bytes"] > 0
    assert snap["transfers"]["allgather_bytes"] == \
        jobs_obs.snapshot(sample=False)["transfers"]["allgather_bytes"]
    assert snap["sharding"]["devices"] == 8
    assert len(snap["sharding"]["last_shards"]) == 8
    assert "sharded_solver_compact_d8" in snap["ledger"]["kernels"]


def test_mesh_pipelined_chain_composes_with_resident(observatories):
    """Two in-flight batches on the mesh: batch B begins while A is
    uncommitted, chaining on A's used' composed with the sharded
    resident state; both packages place identically and B sees A's
    placements (every node carries exactly 2)."""
    jh, th = _twin_nodes(4, "chain-node")
    jcfg = JConfig(small_batch_threshold=0, mesh_devices=8)
    tcfg = TConfig(small_batch_threshold=0, mesh_devices=8, device="cpu")
    jres = JResident(mesh=jsharding.solver_mesh(8))
    tres = TResident(mesh=tsharding.solver_mesh(8, "cpu"))
    a = _job(jh, th, "chain-a", 4, cpu=2000, mem=256)
    b = _job(jh, th, "chain-b", 4, cpu=2000, mem=256)
    (jea,), (tea,) = _evals([a])
    (jeb,), (teb,) = _evals([b])
    jpa = j_begin(jh.snapshot(), jh, [jea], jcfg, resident=jres)
    tpa = t_begin(th.snapshot(), th, [tea], tcfg, resident=tres)
    jpb = j_begin(jh.snapshot(), jh, [jeb], jcfg, resident=jres,
                  used_chain=jpa.chain)
    tpb = t_begin(th.snapshot(), th, [teb], tcfg, resident=tres,
                  used_chain=tpa.chain)
    assert tpb.chain_accepted and jpb.chain_accepted
    got, want = {}, {}
    for jp, tp, jev, tev in ((jpa, tpa, jea, tea), (jpb, tpb, jeb, teb)):
        jplans, tplans = jp.finish(), tp.finish()
        want.update(_outcome(jh, jplans, [jev])["placed"])
        got.update(_outcome(th, tplans, [tev])["placed"])
        _commit(jh, jplans, [jev])
        _commit(th, tplans, [tev])
    assert got == want and len(got) == 8
    per_node: dict = {}
    for node in got.values():
        per_node[node] = per_node.get(node, 0) + 1
    assert len(per_node) == 4 and set(per_node.values()) == {2}


def test_sharded_preempt_end_to_end_matches_reference(observatories):
    """test_tpu_solver.py's sharded preempt scenario through the mesh
    route of both packages: 16 nodes filled by a priority-10 job, then a
    priority-80 wave that must evict; placements, victims,
    preempted_allocations and failures identical."""
    jh, th = _twin_nodes(16, "pre-node")
    jcfg = JConfig(small_batch_threshold=0, mesh_devices=8)
    tcfg = TConfig(small_batch_threshold=0, mesh_devices=8, device="cpu")
    calls = {"compact": 0, "preempt": 0}
    plain_c, plain_p = tk.sharded_solver_plain, tk.sharded_solver_preempt_plain

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    lo = _job(jh, th, "lo", 64, cpu=1000, mem=256, priority=10)
    hi = _job(jh, th, "hi", 8, cpu=1000, mem=256, priority=80)
    outcomes = []
    for job in (lo, hi):
        jev, tev = _evals([job])
        jp = j_solve(jh.snapshot(), jh, jev, jcfg)
        tk.sharded_solver_plain = counted("compact", plain_c)
        tk.sharded_solver_preempt_plain = counted("preempt", plain_p)
        try:
            tp = t_solve(th.snapshot(), th, tev, tcfg)
        finally:
            tk.sharded_solver_plain = plain_c
            tk.sharded_solver_preempt_plain = plain_p
        want, got = _outcome(jh, jp, jev), _outcome(th, tp, tev)
        assert got == want
        outcomes.append(got)
        _commit(jh, jp, jev)
        _commit(th, tp, tev)
    assert len(outcomes[0]["placed"]) == 64
    assert len(outcomes[1]["placed"]) == 8
    assert len(outcomes[1]["victims"]) == 8
    assert calls == {"compact": 1, "preempt": 1}
    snap = tobs.snapshot(sample=False)
    assert snap["sharding"]["devices"] == 8
    assert "sharded_solver_preempt_d8" in snap["ledger"]["kernels"]
