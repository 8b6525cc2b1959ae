"""The benchmark's inputs as plain data, made from the seed.

Nothing here imports the program: the reference reads these same
specs, and `port.py` turns them into the program's structs.
"""

from __future__ import annotations

import dataclasses
import uuid

import numpy as np


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One service job of one task group, as a user submits it."""

    id: str
    count: int
    cpu_mhz: int
    memory_mb: int
    priority: int
    datacenters: tuple
    kernel: str = ""  # "" = no kernel constraint
    spread_weight: int = 0  # 0 = no datacenter spread


@dataclasses.dataclass
class Fleet:
    """The nodes in registration order: ids, datacenter names and
    capacities (the node's whole resources; the fleet reserves none)."""

    ids: list
    datacenter: list
    cpu_mhz: np.ndarray
    memory_mb: np.ndarray
    disk_mb: np.ndarray
    kernel: str

    def __len__(self) -> int:
        return len(self.ids)


def seeded_uuid(rng: np.random.Generator) -> str:
    return str(uuid.UUID(bytes=rng.bytes(16), version=4))


def make_fleet(cfg: dict, rng: np.random.Generator) -> Fleet:
    """`cfg["nodes"]` identical nodes spread evenly over the
    datacenters; the seed orders them and names them, so every seed has
    the same fleet in another order."""
    n = int(cfg["nodes"])
    dcs = list(cfg["datacenters"])
    dc_of = [dcs[i % len(dcs)] for i in range(n)]
    order = rng.permutation(n)
    return Fleet(
        ids=[seeded_uuid(rng) for _ in range(n)],
        datacenter=[dc_of[i] for i in order],
        cpu_mhz=np.full(n, int(cfg["cpu_mhz"]), dtype=np.int64),
        memory_mb=np.full(n, int(cfg["memory_mb"]), dtype=np.int64),
        disk_mb=np.full(n, int(cfg["disk_mb"]), dtype=np.int64),
        kernel=str(cfg["kernel"]),
    )


def job_spec(template: dict, job_id: str) -> JobSpec:
    return JobSpec(
        id=job_id,
        count=int(template["count"]),
        cpu_mhz=int(template["cpu_mhz"]),
        memory_mb=int(template["memory_mb"]),
        priority=int(template["priority"]),
        datacenters=tuple(template["datacenters"]),
        kernel=str(template.get("kernel", "")),
        spread_weight=int(template.get("spread_weight", 0)),
    )


def fill_specs(fill: list) -> list:
    """The jobs that fill the fleet before the window, tier by tier."""
    return [job_spec(tier, f"{tier['prefix']}-{j}")
            for tier in fill for j in range(int(tier["jobs"]))]


def fill_layout(fleet: Fleet, specs: list) -> list:
    """Where the fill's allocs run: [(spec, node positions, one an
    alloc)]. The allocs of the jobs that share a set of datacenters are
    dealt round-robin over those datacenters' nodes, job after job, so
    tiers that share datacenters share every node, as the tiers of a
    cluster whose jobs came and went over time do. Refuses a fill that
    would not fit."""
    dc_arr = np.array(fleet.datacenter)
    nxt: dict = {}  # datacenter set -> next deal position
    cpu = np.zeros(len(fleet), dtype=np.int64)
    mem = np.zeros(len(fleet), dtype=np.int64)
    out = []
    for spec in specs:
        key = tuple(sorted(spec.datacenters))
        nodes = np.nonzero(np.isin(dc_arr, key))[0]
        start = nxt.get(key, 0)
        pos = nodes[(start + np.arange(spec.count)) % len(nodes)]
        nxt[key] = start + spec.count
        np.add.at(cpu, pos, spec.cpu_mhz)
        np.add.at(mem, pos, spec.memory_mb)
        out.append((spec, pos))
    if (cpu > fleet.cpu_mhz).any() or (mem > fleet.memory_mb).any():
        raise ValueError("the fill does not fit the fleet")
    return out
