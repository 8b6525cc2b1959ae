"""The reference against hand-worked end states on a tiny fleet."""

import numpy as np
import pytest

from portbench.inputs import Fleet, JobSpec
from portbench.reference.check import (AT_MOST, FULL, SERVED, STOPPED,
                                       Allocs, judge)
from portbench.reference.placer import place

# four nodes: two in dc1, one in dc2, one in dc3; 1,000 MHz / 1,000 MB
FLEET = Fleet(ids=["n0", "n1", "n2", "n3"],
              datacenter=["dc1", "dc1", "dc2", "dc3"],
              cpu_mhz=np.full(4, 1000), memory_mb=np.full(4, 1000),
              disk_mb=np.zeros(4), kernel="linux")
WEB = JobSpec("web", 4, 400, 100, 50, ("dc1", "dc2"), "linux", 50)
LOW = JobSpec("low", 2, 500, 100, 20, ("dc1", "dc2", "dc3"))
HI = JobSpec("hi", 1, 500, 100, 70, ("dc3",))


def allocs(*rows):
    """rows: (id, job, index, node, desired, preempted_by)."""
    a = Allocs([], [], [], [], [], [], [])
    for aid, job, i, node, desired, by in rows:
        a.id.append(aid)
        a.job_id.append(job)
        a.name.append(f"{job}.web[{i}]")
        a.node_id.append(node)
        a.desired_status.append(desired)
        a.client_status.append("pending")
        a.preempted_by.append(by)
    return a


# web spread 2 / 2 over dc1 and dc2... dc2 has one node of 1,000 MHz:
# two 400s fit there, two on n0
SOUND = [("a0", "web", 0, "n0", "run", ""), ("a1", "web", 1, "n0", "run", ""),
         ("a2", "web", 2, "n2", "run", ""), ("a3", "web", 3, "n2", "run", ""),
         ("l0", "low", 0, "n3", "evict", "h0"),
         ("l1", "low", 1, "n1", "run", ""),
         ("h0", "hi", 0, "n3", "run", "")]
JOBS = {"web": WEB, "low": LOW, "hi": HI}
WANT = {"web": FULL, "low": AT_MOST, "hi": FULL}
ZERO = {"allocs_missing": 0, "allocs_extra": 0, "nodes_over": 0,
        "allocs_infeasible": 0, "victims_wrong": 0, "victims_extra": 0,
        "victims_tier": 0}


def edit(rows, k, **kw):
    rows = [list(r) for r in rows]
    keys = ("id", "job", "i", "node", "desired", "by")
    for name, v in kw.items():
        rows[k][keys.index(name)] = v
    return [tuple(r) for r in rows]


def test_sound_end_state():
    assert judge(FLEET, JOBS, WANT, allocs(*SOUND)) == ZERO


def test_served_job_stopped_in_full():
    """A job placed in full and then stopped holds nothing live."""
    rows = [edit(SOUND, k, desired="stop")[k] for k in range(4)] + SOUND[4:]
    assert judge(FLEET, JOBS, {**WANT, "web": SERVED}, allocs(*rows)) == ZERO


# an eviction off the evictor's node is also one its placement did not
# need (it frees nothing there), and makes the evictor's other victim
# one too many
OFF_NODE = {"victims_extra": 2}


@pytest.mark.parametrize("rows,want,number,value", [
    (SOUND[1:], WANT, "allocs_missing", 1),
    (SOUND + [("a4", "web", 1, "n1", "run", "")], WANT, "allocs_extra", 1),
    (SOUND + [("a5", "web", 9, "n1", "run", "")], WANT, "allocs_extra", 1),
    (SOUND, {**WANT, "web": STOPPED}, "allocs_extra", 4),
    (SOUND, {**WANT, "web": SERVED}, "allocs_extra", 4),
    ([edit(SOUND, k, desired="stop")[k] for k in range(3)] + SOUND[4:],
     {**WANT, "web": SERVED}, "allocs_missing", 1),
    (edit(SOUND, 1, node="n2"), WANT, "nodes_over", 1),
    (edit(SOUND, 0, node="n3"), WANT, "allocs_infeasible", 1),
    (edit(SOUND, 0, node="n9"), WANT, "allocs_infeasible", 1),
    (edit(SOUND, 4, by="a0"), WANT, "victims_wrong", 1),
    (edit(SOUND, 4, by="nobody"), WANT, "victims_wrong", 1),
    (edit(SOUND, 5, desired="evict", by="h0"), WANT, "victims_wrong", 1),
])
def test_one_fault_one_number(rows, want, number, value):
    got = judge(FLEET, JOBS, want, allocs(*rows))
    assert got[number] == value
    others = {k: v for k, v in got.items() if k != number and v}
    assert others in ({}, OFF_NODE) and (
        not others or rows == edit(SOUND, 5, desired="evict", by="h0")), got


# victim choice on one node of 1,000 MHz: TOP (p70, 400) placed at raft
# index 10 by an eval made at index 8; before it the node held MID
# (p40, 400), LOW2 (p20, 400) and LOW1 (p20, 200), all committed at
# index 5: 1,000 MHz in use, 400 short
T_FLEET = Fleet(ids=["n0"], datacenter=["dc1"], cpu_mhz=np.full(1, 1000),
                memory_mb=np.full(1, 1000), disk_mb=np.zeros(1),
                kernel="linux")
T_JOBS = {"top": JobSpec("top", 1, 400, 100, 70, ("dc1",)),
          "mid": JobSpec("mid", 1, 400, 100, 40, ("dc1",)),
          "low2": JobSpec("low2", 1, 400, 100, 20, ("dc1",)),
          "low1": JobSpec("low1", 1, 200, 100, 20, ("dc1",))}
T_WANT = {"top": FULL, "mid": AT_MOST, "low2": AT_MOST, "low1": AT_MOST}


def tier_allocs(evicted: dict, stops: dict = None):
    """evicted: {job: evicting alloc id}; stops: {job: stop index}."""
    stops = stops or {}
    a = Allocs([], [], [], [], [], [], [], [], [], [])
    for job in ("top", "mid", "low2", "low1"):
        a.id.append(f"{job}-a")
        a.job_id.append(job)
        a.name.append(f"{job}.web[0]")
        a.node_id.append("n0")
        gone = job in evicted
        a.desired_status.append("evict" if gone else "run")
        a.client_status.append("complete" if gone else "pending")
        a.preempted_by.append(evicted.get(job, ""))
        a.create_index.append(10 if job == "top" else 5)
        a.eval_index.append(8 if job == "top" else 3)
        a.stop_index.append(10 if gone else stops.get(job, 0))
    return a


def test_victim_choice():
    got = judge(T_FLEET, T_JOBS, T_WANT, tier_allocs({"low2": "top-a"}))
    assert got == ZERO
    # the p20 of the same size stays: evicting the p40 took a tier too high
    got = judge(T_FLEET, T_JOBS, T_WANT, tier_allocs({"mid": "top-a"}))
    assert got == {**ZERO, "victims_tier": 1}
    # one victim too many: low2 alone freed the whole ask
    got = judge(T_FLEET, T_JOBS, T_WANT,
                tier_allocs({"low2": "top-a", "low1": "top-a"}))
    assert got == {**ZERO, "victims_extra": 1}
    # low1 alone is too small: low1 and low2 together, neither extra
    jobs = {**T_JOBS, "top": JobSpec("top", 1, 600, 100, 70, ("dc1",))}
    got = judge(T_FLEET, jobs, T_WANT,
                tier_allocs({"low2": "top-a", "low1": "top-a"}))
    assert got == ZERO


def test_victim_tier_reads_the_view():
    """A lower alloc the placing eval could not see is no fault: one
    committed after the eval was made, or stopped before the
    placement."""
    a = tier_allocs({"mid": "top-a"})
    a.create_index[2] = 9  # low2 came after the eval was made
    assert judge(T_FLEET, T_JOBS, T_WANT, a)["victims_tier"] == 0
    a = tier_allocs({"mid": "top-a"}, stops={"low2": 10})
    a.desired_status[2] = "stop"
    assert judge(T_FLEET, T_JOBS, T_WANT, a)["victims_tier"] == 0
    a = tier_allocs({"mid": "top-a"}, stops={"low2": 12})
    a.desired_status[2] = "stop"
    assert judge(T_FLEET, T_JOBS, T_WANT, a)["victims_tier"] == 1


def test_placer_by_hand():
    """The plain placer on the tiny fleet: web spreads 2 / 2 and packs."""
    jobs, want, out = place(FLEET, [("register", WEB)])
    assert sorted(out.node_id) == ["n0", "n0", "n2", "n2"]
    assert judge(FLEET, jobs, want, out) == ZERO


def test_placer_stale_view_overcommits():
    a = JobSpec("a", 2, 500, 100, 50, ("dc1",))
    b = JobSpec("b", 2, 500, 100, 50, ("dc1",))
    jobs, want, out = place(FLEET, [("register", a), ("register", b)],
                            ("stale",), stale_batch=2)
    assert judge(FLEET, jobs, want, out)["nodes_over"] == 1
    jobs, want, out = place(FLEET, [("register", a), ("register", b)])
    assert judge(FLEET, jobs, want, out)["nodes_over"] == 0


@pytest.mark.parametrize("brk,number", [
    ("drop", "allocs_missing"), ("dup", "allocs_extra"),
    ("keep", "allocs_extra"), ("off_fleet", "allocs_infeasible"),
    ("stray_evict", "victims_wrong")])
def test_placer_breaks_one_number(brk, number):
    a = JobSpec("a", 2, 100, 100, 50, ("dc1", "dc2"))
    b = JobSpec("b", 2, 100, 100, 50, ("dc1", "dc2"))
    ops = [("register", a), ("register", b), ("deregister", "a"),
           ("register", JobSpec("c", 1, 100, 100, 50, ("dc3",)))]
    assert judge(FLEET, *place(FLEET, ops))[number] == 0
    assert judge(FLEET, *place(FLEET, ops, (brk,)))[number] >= 1


def test_placer_refuses_unknown_break():
    with pytest.raises(ValueError):
        place(FLEET, [], ("teleport",))
