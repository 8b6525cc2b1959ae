"""A whole run on the CPU (the kernels' plain twins, a small fleet),
past the harness's look for a card: sound, it comes out correct; with
the timed path broken underneath (portbench/faults.py), not. One case
for each fault the cell can have on one card: a step that leaves the
state unchanged, half of each batch left out, an answer altered where
it is produced, a worker that stops, and a preemption that evicts more
than it needs or from a higher tier than it needs."""

import pytest

from portbench import manifest
from portbench.faults import FAULTS
from portbench.run import run_cell

BENCH = manifest.load()
# 800 nodes filled to 90% in the cell's three tiers (45-alloc jobs), and
# urgent jobs of 100 allocs: above the server's small-batch threshold,
# so they take the dense preemption solve (K5's twin, pick_victims)
FILL = [
    {"prefix": "p65", "jobs": 40, "count": 45, "cpu_mhz": 400,
     "memory_mb": 800, "priority": 65, "datacenters": ["dc4"]},
    {"prefix": "p40", "jobs": 48, "count": 45, "cpu_mhz": 400,
     "memory_mb": 800, "priority": 40, "datacenters": ["dc1", "dc2", "dc3"]},
    {"prefix": "p20", "jobs": 72, "count": 45, "cpu_mhz": 400,
     "memory_mb": 800, "priority": 20, "datacenters": ["dc1", "dc2", "dc3"]},
]
SHRINK = {
    "config": {"fleet": {"nodes": 800}, "job": {"count": 100},
               "fill": FILL},
    "traffic": {"users": 2, "keep": 5, "drain_s": 15},
}
SECONDS = 6.0
SEED = 2 ** 31 + 5
# the number of the judge's each fault has to move
MOVES = {"unchanged": "allocs_missing", "half_left_out": "allocs_missing",
         "altered": "nodes_over", "stalled": "evals_incomplete",
         "over_evict": "victims_extra", "wrong_tier": "victims_tier"}


def test_sound_run_is_correct():
    out = run_cell(BENCH, "preempt.burst", SEED, SECONDS, False,
                   device="cpu", shrink=SHRINK)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault):
    out = run_cell(BENCH, "preempt.burst", SEED, SECONDS, False,
                   device="cpu", shrink=SHRINK, fault=FAULTS[fault])
    assert not out["correct"], out["checks"]
    assert out["checks"][MOVES[fault]]["value"] > 0, out["checks"]


def test_traced_run_on_cpu():
    """--trace 1's path: per-layer metrics read from the registry and
    the spans; the device's own numbers need the card and stay out."""
    out = run_cell(BENCH, "preempt.burst", 3, SECONDS, True, device="cpu",
                   shrink=SHRINK)
    assert out["correct"]
    got = set(out["metrics"])
    assert {"eval_p95_ms.burst", "eval_mean_ms.burst",
            "broker_wait_ms.burst", "dispatch_ms_per_batch.burst",
            "evals_per_batch.burst", "commit_ms_per_batch.burst",
            "plan_submit_ms.burst", "gen_late_ms.burst"} <= got
    assert not {"k5_roofline_pct.burst", "device_idle_pct.burst"} & got
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
