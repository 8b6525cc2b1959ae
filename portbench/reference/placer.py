"""A plain placer, put in the program's place for the control of
`correct`.

It places each job's allocs on the fullest node that still fits them
(bin packing), lowest position first among equals; a job that spreads
deals its allocs round-robin over its datacenters first. It never
preempts, so a job that outranks a full fleet's allocs is placed only
where room is free: the placement guarantee breaks there.

`breaks` names further guarantees to break, one number of the judge's
each, for the readings a limit sits between:

- "stale": `stale_batch` registrations in a row are placed against the
  usage the fleet had before the first of them (a batch solved on one
  snapshot, not chained): capacity (nodes_over).
- "drop": every job places one alloc fewer than it asks (allocs_missing).
- "dup": every job's last alloc takes its first one's name
  (allocs_extra).
- "keep": a deregistration leaves the job's allocs running: the step
  leaves the state unchanged (allocs_extra).
- "off_fleet": every job's last alloc names no node of the fleet
  (allocs_infeasible).
- "stray_evict": every registration marks one live alloc of another
  job evicted, with no placement to account for it (victims_wrong).

With no break, on a fleet with room, it keeps every guarantee the judge
checks; the tests hold it to that.
"""

from __future__ import annotations

import numpy as np

from .check import AT_MOST, FULL, STOPPED, Allocs


def _fill(fleet, cpu, mem, mask, spec, n: int) -> list:
    """Up to n allocs on the nodes in mask, each on the fullest node
    that still fits it: a node takes allocs until it is full."""
    got: list = []
    while n > 0:
        room = np.minimum((fleet.cpu_mhz - cpu) // max(1, spec.cpu_mhz),
                          (fleet.memory_mb - mem) // max(1, spec.memory_mb))
        ok = mask & (room > 0)
        if not ok.any():
            break
        pos = int(np.argmax(np.where(ok, cpu, -1)))
        k = int(min(n, room[pos]))
        got += [pos] * k
        cpu[pos] += k * spec.cpu_mhz
        mem[pos] += k * spec.memory_mb
        n -= k
    return got


def _place_job(fleet, dc_arr, cpu, mem, spec, n: int) -> list:
    """A job's allocs: with a spread, dealt round-robin over its
    datacenters in their listed order (each takes its share, bin
    packed; a share that does not fit goes, one alloc at a time, to the
    datacenter with the fewest that still has room); without, bin
    packed over all of them."""
    if not spec.spread_weight:
        return _fill(fleet, cpu, mem, np.isin(dc_arr, spec.datacenters),
                     spec, n)
    dcs = list(spec.datacenters)
    got: list = []
    placed = {}
    left = 0
    for i, dc in enumerate(dcs):
        share = n // len(dcs) + (i < n % len(dcs))
        part = _fill(fleet, cpu, mem, dc_arr == dc, spec, share)
        placed[dc] = len(part)
        left += share - len(part)
        got += part
    while left > 0:
        for dc in sorted(dcs, key=lambda d: placed[d]):
            part = _fill(fleet, cpu, mem, dc_arr == dc, spec, 1)
            if part:
                placed[dc] += 1
                got += part
                left -= 1
                break
        else:
            break
    return got


BREAKS = ("stale", "drop", "dup", "keep", "off_fleet", "stray_evict")


def place(fleet, ops: list, breaks=(), stale_batch: int = 64,
          fill: list = ()):
    """Run `ops` ([("register", JobSpec) | ("deregister", job id)]) on
    `fleet`, which starts with `fill` running ([(JobSpec, node
    positions)], as the harness commits it). The fill's jobs are held to
    AT_MOST, the rest to FULL or STOPPED. Returns (jobs, want,
    Allocs)."""
    unknown = set(breaks) - set(BREAKS)
    if unknown:
        raise ValueError(f"unknown breaks {sorted(unknown)}")
    if "stale" not in breaks:
        stale_batch = 1
    n = len(fleet)
    used_cpu = np.zeros(n, dtype=np.int64)
    used_mem = np.zeros(n, dtype=np.int64)
    dc_arr = np.array(fleet.datacenter)
    rows: dict = {}  # job id -> list of node positions
    jobs, want = {}, {}
    for spec, positions in fill:
        jobs[spec.id] = spec
        want[spec.id] = AT_MOST
        rows[spec.id] = [int(p) for p in positions]
        np.add.at(used_cpu, rows[spec.id], spec.cpu_mhz)
        np.add.at(used_mem, rows[spec.id], spec.memory_mb)
    frozen = None
    evicted: dict = {}  # job id -> the row marked evicted ("stray_evict")
    streak = 0  # registrations so far: the view refreshes every B
    for kind, x in ops:
        if kind == "deregister":
            spec = jobs[x]
            want[x] = STOPPED
            if "keep" in breaks:
                continue
            for pos in rows.pop(x, []):
                used_cpu[pos] -= spec.cpu_mhz
                used_mem[pos] -= spec.memory_mb
            continue
        spec = x
        jobs[spec.id] = spec
        want[spec.id] = FULL
        if streak % stale_batch == 0:
            frozen = (used_cpu.copy(), used_mem.copy())
        streak += 1
        base_cpu, base_mem = (frozen if stale_batch > 1
                              else (used_cpu, used_mem))
        cpu = base_cpu.copy()
        mem = base_mem.copy()
        want_n = spec.count - ("drop" in breaks)
        got = _place_job(fleet, dc_arr, cpu, mem, spec, want_n)
        if "stray_evict" in breaks:
            for other, positions in rows.items():
                if positions and other not in evicted:
                    evicted[other] = len(positions) - 1
                    break
        rows[spec.id] = got
        for pos in got:
            used_cpu[pos] += spec.cpu_mhz
            used_mem[pos] += spec.memory_mb
    out = Allocs([], [], [], [], [], [], [])
    for job_id, positions in rows.items():
        last = len(positions) - 1
        for i, pos in enumerate(positions):
            out.id.append(f"{job_id}/{i}")
            out.job_id.append(job_id)
            name_i = 0 if "dup" in breaks and i == last else i
            out.name.append(f"{job_id}.web[{name_i}]")
            out.node_id.append("off-fleet" if "off_fleet" in breaks
                               and i == last else fleet.ids[pos])
            out.desired_status.append(
                "evict" if evicted.get(job_id) == i else "run")
            out.client_status.append("pending")
            out.preempted_by.append("")
    return jobs, want, out
