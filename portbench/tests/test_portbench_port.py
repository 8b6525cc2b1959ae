"""The harness's side of the program on the CPU: the store's publish
timestamps eval ends, the stops a client would report are reported,
and a fill is committed where its layout deals it."""

import time

import numpy as np

from portbench import inputs

FLEET = {"nodes": 40, "cpu_mhz": 4000, "memory_mb": 8192, "disk_mb": 102400,
         "kernel": "linux", "datacenters": ["dc1", "dc2", "dc3", "dc4"]}
JOB = {"count": 30, "cpu_mhz": 250, "memory_mb": 128, "priority": 50,
       "datacenters": ["dc1", "dc2", "dc3", "dc4"], "kernel": "linux",
       "spread_weight": 50}


def _wait(system, eval_id, timeout_s=60.0):
    deadline = time.perf_counter() + timeout_s
    while eval_id not in system.watch.done:
        assert time.perf_counter() < deadline, "eval never ended"
        time.sleep(0.01)
    return system.watch.done[eval_id]


def test_watch_and_ack_stops():
    from portbench.port import System, to_job

    system = System("cpu")
    try:
        system.register_fleet(
            inputs.make_fleet(FLEET, np.random.default_rng(5)))
        spec = inputs.job_spec(JOB, "j-0")
        t0 = time.perf_counter()
        end, status = _wait(system, system.register(to_job(spec)))
        assert status == "complete" and end > t0
        live = [a for a in system.allocs().desired_status if a == "run"]
        assert len(live) == spec.count
        _wait(system, system.deregister(spec.id))
        assert system.wait_quiet(30)
        assert system.clients.report() == spec.count
        assert system.wait_quiet(30)
        got = system.allocs()
        assert set(got.client_status) == {"complete"}
        assert all(i > 0 for i in got.stop_index)
        assert all(i > 0 for i in got.eval_index)
        assert system.clients.report() == 0
    finally:
        system.shutdown()


def test_fill_committed_as_dealt():
    from portbench.port import System

    fleet = inputs.make_fleet(FLEET, np.random.default_rng(6))
    fill = [{"prefix": "p40", "jobs": 2, "count": 20, "cpu_mhz": 400,
             "memory_mb": 800, "priority": 40, "datacenters": ["dc1"]},
            {"prefix": "p20", "jobs": 2, "count": 20, "cpu_mhz": 400,
             "memory_mb": 800, "priority": 20, "datacenters": ["dc1"]}]
    layout = inputs.fill_layout(fleet, inputs.fill_specs(fill))
    system = System("cpu")
    try:
        system.register_fleet(fleet)
        system.commit_fill(fleet, layout)
        got = system.allocs()
        want = sorted((s.id, fleet.ids[int(p)]) for s, pos in layout
                      for p in pos)
        assert sorted(zip(got.job_id, got.node_id)) == want
        assert set(got.desired_status) == {"run"}
        assert all(i > 0 for i in got.create_index)
    finally:
        system.shutdown()
