"""Faults planted in the program under test, for the readings that a
limit of `correct` sits below: each breaks the timed path underneath a
whole run, which has to come out not correct.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 \
        --faults over_evict wrong_tier --seconds 25

A fault is fault(system) -> None or an undo(), called once set-up is
done: it patches the running Server, or a class of the program for as
long as the run lasts. The benchmark's own runs never plant one.
"""

from __future__ import annotations


def unchanged(system):
    """The store takes no plan result: a commit leaves the state as it
    was, and the evals still complete."""
    system.srv.state.upsert_plan_results_batch = lambda index, results: None


def half_left_out(system):
    """Each batch commits plans for its first half of evals only; the
    rest complete with nothing placed."""
    w = system.srv.tpu_worker
    orig = w._commit_batch

    def commit(evals, plans, snapshot, **kw):
        for ev in evals[len(evals) // 2:]:
            p = plans[ev.id]
            p.node_allocation, p.alloc_batches = {}, []
            p.node_update, p.node_preemptions = {}, {}
        return orig(evals, plans, snapshot, **kw)

    w._commit_batch = commit


def altered(system):
    """Every committed placement of a plan lands on its first node."""
    st = system.srv.state
    orig = st.upsert_plan_results_batch

    def upsert(index, results):
        for r in results:
            for b in r.alloc_batches:
                b.node_idx[:] = b.node_idx[0]
            if r.node_allocation:
                first = next(iter(r.node_allocation))
                moved = [a for al in r.node_allocation.values() for a in al]
                for a in moved:
                    a.node_id = first
                r.node_allocation = {first: moved}
        return orig(index, results)

    st.upsert_plan_results_batch = upsert


def stalled(system):
    """The batch worker stops: registrations are taken and never
    answered (evals_incomplete)."""
    system.srv.tpu_worker.stop()


def _eligible(solver, table, ni, grp, taken) -> list:
    """The node's allocs the placement may evict, as pick_victims reads
    them, less those already taken."""
    from nomad_tpu_torch.scheduler.preemption import PRIORITY_DELTA

    out = []
    for a in table._allocs_by_node(table.nodes[ni].id):
        prio = a.job.priority if a.job is not None else 50
        if (a.id in solver._victimized or a.id in taken
                or (a.job_id == grp.job.id
                    and a.namespace == grp.job.namespace)
                or grp.priority - prio < PRIORITY_DELTA):
            continue
        out.append(a)
    return out


def _patch_victims(choose):
    from nomad_tpu_torch.scheduler.gpu.solver import BatchSolver

    orig = BatchSolver._pick_victims

    def pick(self, table, ni, grp):
        got = orig(self, table, ni, grp)
        return choose(self, table, ni, grp, got) if got else got

    BatchSolver._pick_victims = pick

    def undo():
        BatchSolver._pick_victims = orig

    return undo


def over_evict(system):
    """Each placement that preempts evicts one eligible alloc more than
    it needs (victims_extra)."""

    def choose(solver, table, ni, grp, got):
        ids = {a.id for a in got}
        return got + _eligible(solver, table, ni, grp, ids)[:1]

    return _patch_victims(choose)


def wrong_tier(system):
    """Each placement that preempts evicts as many allocs as it needs,
    taken from the highest eligible tier first (victims_tier)."""

    def choose(solver, table, ni, grp, got):
        cands = _eligible(solver, table, ni, grp, set())
        cands.sort(key=lambda a: -(a.job.priority if a.job else 50))
        return cands[:len(got)]

    return _patch_victims(choose)


FAULTS = {f.__name__: f for f in (unchanged, half_left_out, altered,
                                  stalled, over_evict, wrong_tier)}
