"""The control at a size a test can hold: the plain placer with one
guarantee broken comes out not correct, the sound placer correct. On
the card machine, control.py runs it at each cell's own size."""

import pytest

from portbench import manifest
from portbench.control import readings

BENCH = manifest.load()
SMALL = {
    "preempt.burst": {
        "config": {"fleet": {"nodes": 400}, "job": {"count": 100},
                   "fill": [
                       {"prefix": "p65", "jobs": 10, "count": 90,
                        "cpu_mhz": 400, "memory_mb": 800, "priority": 65,
                        "datacenters": ["dc4"]},
                       {"prefix": "p40", "jobs": 12, "count": 90,
                        "cpu_mhz": 400, "memory_mb": 800, "priority": 40,
                        "datacenters": ["dc1", "dc2", "dc3"]},
                       {"prefix": "p20", "jobs": 18, "count": 90,
                        "cpu_mhz": 400, "memory_mb": 800, "priority": 20,
                        "datacenters": ["dc1", "dc2", "dc3"]}]},
        "traffic": {"users": 2, "keep": 3}, "control": {"jobs": 8}},
}


@pytest.mark.parametrize("workload", sorted(SMALL))
@pytest.mark.parametrize("seed", [1, 2, 2 ** 31 + 3])
def test_control_fails_sound_passes(workload, seed):
    r = readings(BENCH, workload, seed, shrink=SMALL[workload])
    assert r["sound"]["correct"], r["sound"]
    assert not r["control"]["correct"], r["control"]
    target = {"stale": "nodes_over", "drop": "allocs_missing", "dup": "allocs_extra",
              "keep": "allocs_extra", "off_fleet": "allocs_infeasible",
              "stray_evict": "victims_wrong"}
    for fault, number in target.items():
        if fault in r:
            assert r[fault]["numbers"][number] >= 1, (fault, r[fault])


@pytest.mark.card
def test_cells_correct_on_card(card):
    """Each cell as committed, a short window, on the card."""
    import json
    import subprocess
    import sys

    for w in manifest.load()["workloads"]:
        out = subprocess.run(
            [sys.executable, str(manifest.HERE / "run.py"), "--workload",
             w["name"], "--seed", "2147483649", "--seconds", "5",
             "--trace", "0"],
            capture_output=True, text=True, timeout=1200,
            cwd=manifest.ROOT)
        assert out.returncode == 0, out.stderr[-3000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
