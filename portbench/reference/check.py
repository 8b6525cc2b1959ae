"""The plain reference: what a committed end state must be, worked out
again from the benchmark's own inputs.

It reads the generated fleet and job specs and what the harness asked
of the system (which jobs it left registered and which it stopped), and
judges the allocations the program committed, given as plain columns.
It imports nothing of the program: capacities, asks, datacenters and
priorities come from the specs, never from the program's rows, and
every sum is recomputed here.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

# the least priority gap at which a placement may evict (Nomad's
# scheduler/preemption.go; the configuration's preemption guarantee)
PRIORITY_DELTA = 10

LIVE_DESIRED = "run"
LIVE_CLIENT = ("pending", "running")

# what each job must hold once the system has settled
FULL = "full"  # exactly `count` live allocs, one of each name
STOPPED = "stopped"  # none live
# placed in full while it ran (one alloc of each name, live or not),
# none live now: a job stopped after its registration was answered
SERVED = "served"
AT_MOST = "at_most"  # at most one live alloc of each name


@dataclasses.dataclass
class Allocs:
    """The committed allocations as plain columns, one entry a row."""

    id: list
    job_id: list
    name: list
    node_id: list
    desired_status: list
    client_status: list
    preempted_by: list  # the evicting alloc's id, "" if none
    # raft indexes: at which the alloc was committed, at which the eval
    # that placed it was created, and at which a committed plan stopped
    # or evicted it (0 where unknown, or never)
    create_index: list = dataclasses.field(default_factory=list)
    eval_index: list = dataclasses.field(default_factory=list)
    stop_index: list = dataclasses.field(default_factory=list)

    def __len__(self) -> int:
        return len(self.id)


def _index(name: str, job_id: str) -> int:
    """The instance index of `<job>.<group>[i]`, -1 if malformed."""
    m = re.fullmatch(re.escape(job_id) + r"\.[^\[\]]+\[(\d+)\]", name)
    return int(m.group(1)) if m else -1


def judge(fleet, jobs: dict, want: dict, allocs: Allocs) -> dict:
    """The numbers `correct` compares, each 0 in a sound end state.

    fleet: inputs.Fleet; jobs: {job id: inputs.JobSpec}; want: {job id:
    FULL | STOPPED | AT_MOST}; allocs: Allocs.

    - allocs_missing: allocs a FULL job lacks live, and names a SERVED
      job never held.
    - allocs_extra: live allocs beyond what a job may hold: a second
      live alloc of one name, a name outside the job's count, any live
      alloc of a STOPPED or SERVED job or of a job the harness never
      sent.
    - nodes_over: nodes whose live allocs ask more CPU or memory than
      the node has (asks from the specs).
    - allocs_infeasible: live allocs on a node outside the job's
      datacenters or kernel, or on no node of the fleet.
    - victims_wrong: evictions that no placement of a job at least
      PRIORITY_DELTA higher, on the same node, accounts for.
    - victims_extra: evictions a placement did not need: its victims
      less this one still free its whole ask.
    - victims_tier: evictions from a higher tier than needed: on the
      victim's node an alloc of a lower priority, as large or larger,
      that the placing eval saw (committed before the eval was made,
      not stopped until after the placement was committed) stayed.
    """
    node_pos = {nid: i for i, nid in enumerate(fleet.ids)}
    n = len(fleet)
    cpu = np.zeros(n, dtype=np.int64)
    mem = np.zeros(n, dtype=np.int64)
    live_names: dict = {}
    held: dict = {}  # SERVED job -> every name it ever held
    infeasible = extra = 0
    by_id = {}
    for k in range(len(allocs)):
        by_id[allocs.id[k]] = k
        job_id = allocs.job_id[k]
        if want.get(job_id) == SERVED:
            held.setdefault(job_id, set()).add(
                _index(allocs.name[k], job_id))
    for k in range(len(allocs)):
        if (allocs.desired_status[k] != LIVE_DESIRED
                or allocs.client_status[k] not in LIVE_CLIENT):
            continue
        job_id = allocs.job_id[k]
        spec = jobs.get(job_id)
        if spec is None or want.get(job_id) in (STOPPED, SERVED):
            extra += 1
            continue
        i = _index(allocs.name[k], job_id)
        names = live_names.setdefault(job_id, set())
        if i < 0 or i >= spec.count or i in names:
            extra += 1
        else:
            names.add(i)
        pos = node_pos.get(allocs.node_id[k])
        if pos is None:
            infeasible += 1
            continue
        if (fleet.datacenter[pos] not in spec.datacenters
                or (spec.kernel and spec.kernel != fleet.kernel)):
            infeasible += 1
        cpu[pos] += spec.cpu_mhz
        mem[pos] += spec.memory_mb
    over = int(((cpu > fleet.cpu_mhz) | (mem > fleet.memory_mb)).sum())
    missing = sum(
        max(0, jobs[j].count - len(live_names.get(j, ())))
        for j, w in want.items() if w == FULL
    ) + sum(
        jobs[j].count - len(held.get(j, set()) & set(range(jobs[j].count)))
        for j, w in want.items() if w == SERVED
    )
    return {
        "allocs_missing": int(missing),
        "allocs_extra": int(extra),
        "nodes_over": over,
        "allocs_infeasible": int(infeasible),
        "victims_wrong": _victims_wrong(jobs, allocs, by_id),
        **_victims_chosen(jobs, allocs, by_id),
    }


def _victims_wrong(jobs: dict, allocs: Allocs, by_id: dict) -> int:
    bad = 0
    for k in range(len(allocs)):
        if allocs.desired_status[k] != "evict":
            continue
        victim = jobs.get(allocs.job_id[k])
        p = by_id.get(allocs.preempted_by[k])
        if victim is None or p is None:
            bad += 1
            continue
        evictor = jobs.get(allocs.job_id[p])
        if (evictor is None or allocs.node_id[p] != allocs.node_id[k]
                or evictor.priority - victim.priority < PRIORITY_DELTA):
            bad += 1
    return bad


def _victims_chosen(jobs: dict, allocs: Allocs, by_id: dict) -> dict:
    """victims_extra and victims_tier (see judge). Both read only what
    holds whatever the placing eval's view of the node was: an ask is
    at most the placement's whole ask, and an alloc committed before
    the eval was made and stopped only after the placement was
    committed was on the node in every view the eval could have had."""
    n = len(allocs)
    made_at = allocs.eval_index or [0] * n
    committed_at = allocs.create_index or [0] * n
    stopped_at = allocs.stop_index or [0] * n
    victims: dict = {}  # evicting alloc's row -> its victims' rows
    on_node: dict = {}  # node id -> rows of the jobs the harness sent
    for k in range(n):
        if allocs.job_id[k] not in jobs:
            continue
        on_node.setdefault(allocs.node_id[k], []).append(k)
        if allocs.desired_status[k] == "evict":
            p = by_id.get(allocs.preempted_by[k])
            if p is not None:
                victims.setdefault(p, []).append(k)

    def ask(k):
        s = jobs[allocs.job_id[k]]
        return (s.cpu_mhz, s.memory_mb)

    def covers(a, b):
        return a[0] >= b[0] and a[1] >= b[1]

    extra = tier = 0
    for p, vs in victims.items():
        evictor = jobs.get(allocs.job_id[p])
        if evictor is None:
            continue
        need = ask(p)
        asks = [ask(v) for v in vs]
        freed = (sum(a[0] for a in asks), sum(a[1] for a in asks))
        seen, placed = made_at[p], committed_at[p]
        for v, av in zip(vs, asks):
            if covers((freed[0] - av[0], freed[1] - av[1]), need):
                extra += 1
            pv = jobs[allocs.job_id[v]].priority
            for u in on_node.get(allocs.node_id[v], ()):
                spec = jobs[allocs.job_id[u]]
                if (spec.priority < pv and spec.id != evictor.id
                        and evictor.priority - spec.priority
                        >= PRIORITY_DELTA
                        and 0 < committed_at[u] <= seen
                        and (stopped_at[u] == 0 or stopped_at[u] > placed)
                        and covers(ask(u), av)):
                    tier += 1
                    break
    return {"victims_extra": int(extra), "victims_tier": int(tier)}
