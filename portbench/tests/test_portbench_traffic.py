"""The generators and the inputs: the same seed gives the same inputs,
and every seed the same amount of work in another order; a mix names
its generator, found by name."""

import numpy as np
import pytest

from portbench import inputs, manifest

FLEET = {"nodes": 400, "cpu_mhz": 4000, "memory_mb": 8192, "disk_mb": 102400,
         "kernel": "linux", "datacenters": ["dc1", "dc2", "dc3", "dc4"]}
BIG = 2 ** 31 + 11
USERS = {"loop": "users", "users": 3, "keep": 2, "warm_rounds": 1}


def test_fleet_from_seed():
    a = inputs.make_fleet(FLEET, np.random.default_rng(BIG))
    b = inputs.make_fleet(FLEET, np.random.default_rng(BIG))
    c = inputs.make_fleet(FLEET, np.random.default_rng(BIG + 1))
    assert a.ids == b.ids and a.datacenter == b.datacenter
    assert a.ids != c.ids and a.datacenter != c.datacenter
    for dc in FLEET["datacenters"]:
        assert a.datacenter.count(dc) == c.datacenter.count(dc) == 100
    assert len(set(a.ids)) == 400


def _fresh():
    import itertools

    counter = itertools.count()
    job = {"count": 2, "cpu_mhz": 1, "memory_mb": 1, "priority": 70,
           "datacenters": ["dc1"]}
    return lambda: inputs.job_spec(job, f"j-{next(counter)}")


def test_users_loop_ops():
    """The users' calls for a placer: each user's `keep` jobs, then per
    registration the user's oldest job stopped; no job is stopped
    before it was registered, and `keep` a user stay live."""
    loop = manifest.loop(USERS)
    p = loop.parse(USERS)
    ops = loop.ops(p, _fresh(), 5)
    regs = [o[1].id for o in ops if o[0] == "register"]
    stops = [o[1] for o in ops if o[0] == "deregister"]
    assert len(regs) == 3 * 2 + 3 + 5 and len(stops) == 3 + 5
    assert len(set(regs) - set(stops)) == 3 * 2
    seen = set()
    for kind, x in ops:
        if kind == "register":
            seen.add(x.id)
        else:
            assert x in seen
    assert ops == loop.ops(p, _fresh(), 5)


@pytest.mark.parametrize("doc", [
    {"loop": "users", "users": 0, "keep": 1},
    {"loop": "users", "users": 1, "keep": 0},
    {"loop": "users", "users": 1, "keep": 1, "warm_rounds": -1},
    {"loop": "users", "users": 1, "keep": 1, "drain_s": 0},
])
def test_parse_refuses(doc):
    with pytest.raises(ValueError):
        manifest.loop(doc).parse(doc)


@pytest.mark.parametrize("doc", [{"loop": "sideways"}, {"loop": "../run"},
                                 {}])
def test_unknown_loop_refused(doc):
    with pytest.raises(KeyError):
        manifest.loop(doc)


def test_mix_files_parse():
    bench = manifest.load()
    for w in bench["workloads"]:
        mix = manifest.cell(bench, w["name"])["traffic"]
        manifest.loop(mix).parse(mix)


def test_fill_specs():
    fill = [{"prefix": "p1", "jobs": 2, "count": 3, "cpu_mhz": 1,
             "memory_mb": 2, "priority": 10, "datacenters": ["dc4"]}]
    specs = inputs.fill_specs(fill)
    assert [s.id for s in specs] == ["p1-0", "p1-1"]
    assert specs[0].datacenters == ("dc4",) and not specs[0].spread_weight


def test_fill_layout_deals_tiers_onto_shared_nodes():
    fleet = inputs.make_fleet(FLEET, np.random.default_rng(BIG))
    fill = [{"prefix": "a", "jobs": 2, "count": 150, "cpu_mhz": 400,
             "memory_mb": 800, "priority": 40, "datacenters": ["dc1", "dc2"]},
            {"prefix": "b", "jobs": 3, "count": 150, "cpu_mhz": 400,
             "memory_mb": 800, "priority": 20, "datacenters": ["dc2", "dc1"]},
            {"prefix": "c", "jobs": 1, "count": 100, "cpu_mhz": 400,
             "memory_mb": 800, "priority": 65, "datacenters": ["dc4"]}]
    layout = inputs.fill_layout(fleet, inputs.fill_specs(fill))
    per_node = {}
    for spec, pos in layout:
        assert len(pos) == spec.count
        for i in pos:
            assert fleet.datacenter[i] in spec.datacenters
            per_node.setdefault(int(i), []).append(spec.priority)
    shared = [v for i, v in per_node.items()
              if fleet.datacenter[i] in ("dc1", "dc2")]
    assert len(shared) == 200
    assert all(len(v) in (3, 4) and {40, 20} <= set(v) for v in shared)
    fill[2]["count"] = 1001
    with pytest.raises(ValueError):
        inputs.fill_layout(fleet, inputs.fill_specs(fill))
