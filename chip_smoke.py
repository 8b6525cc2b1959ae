#!/usr/bin/env python3
"""Smoke run of nomad_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases (one JSON line each, with its seconds):

  1. build    — compile the CUDA kernels (nomad_tpu_torch/csrc) with nvcc
                for sm_90a and load them;
  2. kernels  — every kernel against its plain PyTorch twin on the card,
                array-equal: the compact solve at the c2m bucket (10240
                nodes, 128 groups, 1024-wide readback) on seeded random
                and all-tied inputs and with negative free capacity, and
                where its cluster selection can go wrong (compact_cases:
                several selection rounds, groups cut by k, Np 100352 with
                its slices in shared and in global memory, Np 256 and
                1024 leaving blocks empty); the
                dense and the preemption solves at the preempt wave's
                bucket (10240 nodes, 80 groups, 4 tier rows) on seeded
                random, all-tied and negative-free inputs and with tier
                limits at, past and before the padded tier row, and the
                preemption solve's select edges (preempt_edge_cases:
                counts past every unit, no phase-2 remainder, negative
                tier limits, one-unit tied nodes; Np 100352 with K5's
                slices in global memory), each also through the 8-shard
                solve, whose cached CUDA graph replays other inputs than
                it was captured on; the dense solve's select edges
                (dense_edge_cases: units that all fit, all-tied scores,
                radix passes, count-0 groups; Np 10000 and 100352 with
                K4's slices in global memory); the row set-scatter
                (donated and not) and the clamped row scatter-add, with
                pad indices and negative deltas, and the one-launch add's
                edges (scatter_add_cases: repeated and negative indices,
                4096 rows, rows only the clamp zeroes, a partial last
                block);
  3. main     — the batch solve path at c2m scale through the entry
                points a user calls: 10,000 nodes (4000 MHz / 8192 MB,
                dc1-dc4) and 100 jobs x 1,000 allocs with the kernel.name
                constraint and a datacenter spread; three waves — a full
                resident upload, a delta sync plus an adjusted view for
                stops (uncommitted), and a wave chained on the in-flight
                one. Launch counters are zeroed just before and read just
                after; every kernel must have run;
  4. preempt  — the preemption route at c2m scale (BASELINE config 4,
                bench.py run_preempt_config's shapes): the 10,000 nodes
                filled to 90% with 400 MHz / 800 MB allocs in three
                priority tiers (65 on dc4; 40 and 20 on dc1-dc3), then a
                wave of 20 jobs x 1,000 allocs at priority 70 with the
                constraint and the datacenter spread, in one batch, then
                committed. It runs the preemption kernel on 80 spread
                sub-groups and the dense kernel on the dc4 sub-groups'
                leftovers. Launch counters are zeroed just before the
                wave and read just after; both kernels must have run;
  5. mesh     — the node-sharded route (kernels also checks the sharded
                solves against their twins and the single-card kernels at
                c2m_sharded's bucket, Np 100352 on 1 and 8 shards, with
                unit caps of 1 for several selection rounds and with lists
                cut by k, and at the preempt wave's, on 8 shards): bench.py
                run_c2m_sharded_config's shapes at full width, 100,000
                nodes and rounds of 16 jobs x 500 allocs, round 1 solved
                on one snapshot without a mesh, on 1 shard and on 8 (the
                plans must be identical), then five pipelined rounds on
                8 shards (a full upload, chained in-flight batches, delta
                syncs) with the counters zeroed; then the preempt phase's
                fleet and wave solved on one snapshot on one card and on
                8 shards (identical placements and victims), the mesh's
                plans committed. It prints the shard -> card map;
  6. replay   — each kernel's first call on its path replayed against its
                twin, and timed beside its bound and the twin's time: a
                kernel's `ms` is its device time (CUDA events around
                back-to-back launches queued behind a spin kernel) and
                `enqueue_ms` the host's time to queue one call; K5's and
                K7's device time split by kernel must show the radix
                select's kernels and no pick loop, and K7's timed calls
                must replay its CUDA graph (`launch_route`,
                `graph_replays`, `capture_s`); K4's and K5's must show
                their cluster kernel alone, with its launch shape;
  7. small    — the same three waves at 200 nodes, and at 500 nodes on
                an 8-shard mesh, and bench.py's 500-node preempt config,
                on the card and on the CPU twins: identical placements
                and victims.

Then the card's name and power limit (nvidia-smi), one {"kernels": [...]}
line, and last {"ok": true, "device": {...}}. Any failure raises: the
exit code is nonzero and no result line is printed. Without a CUDA
device it exits 2 before doing anything.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from nomad_tpu_torch import mock, trace
from nomad_tpu_torch.scheduler import SchedulerConfig
from nomad_tpu_torch.scheduler import gpu
from nomad_tpu_torch.scheduler.gpu import kernels as tk
from nomad_tpu_torch.scheduler.gpu import libkernels
from nomad_tpu_torch.scheduler.gpu import solver as solver_mod
from nomad_tpu_torch.structs import Constraint, Spread
from nomad_tpu_torch.structs.node_class import compute_node_class
from nomad_tpu_torch.testing import Harness

DCS = ["dc1", "dc2", "dc3", "dc4"]

# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# f32 operations per (group, node) of the compact solve's scoring pass:
# 2 int->float adds, 2 max, 2 div, 2 sub, 2 mul, 2 exp, add, sub, 2 clamp,
# div, bias add
SCORE_FLOPS = 19

SOURCES = {
    "solve_placement_compact": (
        "nomad_tpu_torch/csrc/solve_compact.cu",
        "nomad_tpu/scheduler/tpu/kernels.py:212",
    ),
    "solve_placement": (
        "nomad_tpu_torch/csrc/solve_dense.cu",
        "nomad_tpu/scheduler/tpu/kernels.py:191",
    ),
    "solve_placement_preempt": (
        "nomad_tpu_torch/csrc/solve_dense.cu",
        "nomad_tpu/scheduler/tpu/kernels.py:359",
    ),
    "scatter_rows": (
        "nomad_tpu_torch/csrc/scatter_rows.cu",
        "nomad_tpu/scheduler/tpu/solver.py:427",
    ),
    "scatter_add_rows": (
        "nomad_tpu_torch/csrc/scatter_rows.cu",
        "nomad_tpu/scheduler/tpu/solver.py:459",
    ),
    "sharded_solver": (
        "nomad_tpu_torch/csrc/solve_sharded.cu",
        "nomad_tpu/scheduler/tpu/kernels.py:583",
    ),
    "sharded_solver_preempt": (
        "nomad_tpu_torch/csrc/solve_sharded.cu",
        "nomad_tpu/scheduler/tpu/kernels.py:475",
    ),
}


def phase(name: str, t0: float, **extra) -> None:
    print(json.dumps({"phase": name, "seconds": time.perf_counter() - t0,
                      **extra}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds per call, each call between two CUDA events:
    the host's dispatch between the events is counted too. For the plain
    twins, whose index masks wait on the card inside the call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps: int) -> tuple:
    """(device ms per call, host enqueue ms per call) for a function that
    only queues work. A spin kernel holds the card while the host queues
    `reps` calls, so the events around the calls see them back to back
    on the card, with none of the host's time between them. Fails if the
    spin ended before the host had queued every call."""
    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000  # ~10 ms at the H100's boost clock
    for _ in range(4):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_s = time.perf_counter() - t0
        b.record()
        covered = not a.query()
        b.synchronize()
        if covered:
            return a.elapsed_time(b) / reps, 1e3 * host_s / reps
        cycles *= 4
    raise AssertionError("the spin kernel never outlasted the enqueue")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def compact_problem(rng, n=10240, g=128, tied=False, negative=False):
    """Seeded inputs in the shape of tests/test_tpu_solver.py _c1k_problem
    at the c2m bucket, as the solver ships them (bit-packed feasibility,
    i16 unit caps)."""
    if tied:
        cap = np.full((n, 3), 4000, dtype=np.int32)
        used = np.zeros((n, 3), dtype=np.int32)
        asks = np.tile(np.array([[250, 128, 150]], np.int32), (g, 1))
        counts = rng.integers(0, 1000, g).astype(np.int32)
        feas = np.ones((g, n), dtype=bool)
        bias = np.zeros((g, n), dtype=np.float32)
    else:
        cap = rng.integers(2000, 8000, size=(n, 3)).astype(np.int32)
        used = (cap * rng.uniform(0.0, 0.5, size=(n, 3))).astype(np.int32)
        asks = rng.integers(100, 600, size=(g, 3)).astype(np.int32)
        counts = rng.integers(1, 1000, size=g).astype(np.int32)
        feas = rng.random((g, n)) > 0.15
        bias = (rng.random((g, n)) * 0.2).astype(np.float32)
    if negative:
        rows = rng.random(n) < 0.3
        used[rows] = cap[rows] + rng.integers(1, 700, (int(rows.sum()), 3))
    ucap = rng.integers(0, 40, (g, n)).astype(np.int16)
    idx = np.arange(g, dtype=np.int32)
    return [cap, used, asks, counts, np.packbits(feas, axis=1), idx, bias,
            idx, ucap, idx]


def dense_problem(rng, n=10240, g=80, tiers=3, tied=False, negative=False):
    """Seeded inputs in the shape of tests/test_tpu_solver.py _c1k_problem's
    preempt variant at the preempt wave's bucket: nearly-full nodes whose
    usage is mostly low-tier, the cumulative tier prefix padded to 4 rows
    (the padded rows repeat the full sum, as the solver pads it), and tier
    limits from -1 to past the pad. Returns (K4 args, K5 args)."""
    tp = 4
    if tied:
        cap = np.full((n, 3), 4000, dtype=np.int32)
        used = np.full((n, 3), 3600, dtype=np.int32)
        asks = np.tile(np.array([[400, 400, 100]], np.int32), (g, 1))
        counts = rng.integers(0, 300, g).astype(np.int32)
        feas = np.ones((g, n), dtype=bool)
        bias = np.zeros((g, n), dtype=np.float32)
        tier_usage = np.full((tiers, n, 3), 3600 // tiers, dtype=np.int32)
    else:
        cap = rng.integers(2000, 8000, size=(n, 3)).astype(np.int32)
        used = (cap * rng.uniform(0.75, 0.95, size=(n, 3))).astype(np.int32)
        asks = rng.integers(100, 600, size=(g, 3)).astype(np.int32)
        # _c1k_problem's counts per 1024 nodes, scaled to n
        counts = (rng.integers(40, 200, size=g) * (n // 1024)).astype(np.int32)
        feas = rng.random((g, n)) > 0.15
        bias = (rng.random((g, n)) * 0.2).astype(np.float32)
        shares = rng.dirichlet(np.ones(tiers), size=n)[:, :, None]
        tier_usage = (
            used[:, None, :] * 0.9 * shares
        ).astype(np.int32).transpose(1, 0, 2)
    if negative:
        rows = rng.random(n) < 0.3
        used[rows] = cap[rows] + rng.integers(1, 700, (int(rows.sum()), 3))
    ucap = rng.integers(0, 40, (g, n)).astype(np.int32)
    prefix = np.zeros((tp, n, 3), dtype=np.int32)
    prefix[1:tiers + 1] = np.cumsum(tier_usage, axis=0)
    prefix[tiers + 1:] = prefix[tiers]
    tier_limit = rng.integers(-1, tp + 2, size=g).astype(np.int32)
    return ([cap, used, asks, counts, feas, bias, ucap],
            [cap, used, prefix, asks, counts, feas, bias, ucap, tier_limit])


def mesh_problem(rng, n=100352, g=16, tied=False, negative=False):
    """Dense inputs at c2m_sharded's bucket (100,000 nodes padded to
    100352, 16 groups of up to 500 instances), in the shape of
    compact_problem: random, all-tied, or 30% of the nodes over
    capacity."""
    if tied:
        cap = np.full((n, 3), 4000, dtype=np.int32)
        used = np.zeros((n, 3), dtype=np.int32)
        asks = np.tile(np.array([[250, 128, 150]], np.int32), (g, 1))
        feas = np.ones((g, n), dtype=bool)
        bias = np.zeros((g, n), dtype=np.float32)
    else:
        cap = rng.integers(2000, 8000, size=(n, 3)).astype(np.int32)
        used = (cap * rng.uniform(0.0, 0.5, size=(n, 3))).astype(np.int32)
        asks = rng.integers(100, 600, size=(g, 3)).astype(np.int32)
        feas = rng.random((g, n)) > 0.15
        bias = (rng.random((g, n)) * 0.2).astype(np.float32)
    counts = rng.integers(0, 501, g).astype(np.int32)
    if negative:
        rows = rng.random(n) < 0.3
        used[rows] = cap[rows] + rng.integers(1, 700, (int(rows.sum()), 3))
    ucap = rng.integers(0, 40, (g, n)).astype(np.int32)
    return [cap, used, asks, counts, feas, bias, ucap]


def scatter_problem(rng, n=10240, b=700):
    used = rng.integers(0, 9000, (n, 3)).astype(np.int32)
    idx = np.full(1024, 1 << 30, dtype=np.int32)  # pad indices past b
    idx[:b] = rng.choice(n, size=b, replace=False)
    rows = np.zeros((1024, 3), dtype=np.int32)
    rows[:b] = rng.integers(-6000, 6000, (b, 3))
    return used, idx, rows


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def unit_caps_of_one(arrays, counts_from: int, counts_to: int, rng):
    """A compact_problem whose every node takes at most one instance of a
    group, with counts in [counts_from, counts_to): a group then needs one
    pick per instance, more than one selection round's 16 x 32."""
    arrays = list(arrays)
    arrays[8] = np.ones_like(arrays[8])
    arrays[3] = rng.integers(counts_from, counts_to,
                             arrays[3].shape).astype(np.int32)
    return arrays


def compact_cases(rng) -> list:
    """(name, arrays, max_count) for K1: the c2m bucket's random, all-tied
    (ties straddle every block slice) and negative-free problems; groups
    needing several selection rounds (unit caps of 1, counts past 512);
    groups cut by k; Np 100352 (c2m_sharded's bucket) with i16 unit caps,
    whose slices fit in shared memory, and with i32 caps, whose slices do
    not (the global-memory variant); and Np 256 and 1024, which leave
    blocks of the cluster with part of a slice or none."""
    def caps32(arrays):
        arrays = list(arrays)
        arrays[8] = arrays[8].astype(np.int32)
        return arrays

    return [
        ("random", compact_problem(rng), 1024),
        ("tied", compact_problem(rng, tied=True), 1024),
        ("negative_free", compact_problem(rng, negative=True), 1024),
        ("multi_round", unit_caps_of_one(compact_problem(rng, g=32),
                                         600, 1000, rng), 1024),
        ("tied_multi_round", unit_caps_of_one(
            compact_problem(rng, g=16, tied=True), 600, 1000, rng), 1024),
        ("cut_by_k", unit_caps_of_one(compact_problem(rng, g=32),
                                      100, 1000, rng), 64),
        ("np100352", compact_problem(rng, n=100352, g=16), 1024),
        ("np100352_global_slices",
         caps32(compact_problem(rng, n=100352, g=16)), 1024),
        ("np1024", compact_problem(rng, n=1024, g=24), 256),
        ("np256_tied", compact_problem(rng, n=256, g=24, tied=True), 256),
    ]


def preempt_edge_cases(rng) -> list:
    """(name, K5 arguments) where the preemption solve's radix select can
    go wrong, at the preempt wave's bucket with 16 groups: counts past
    every unit a group can take (the shortcut, in both phases); low usage
    and small counts (phase 1 places everything, no phase 2); tier limits
    from -8 to -1 (wrapped from the end, then clamped); all scores tied
    with unit caps of 1 (the boundary inside a run of one-unit nodes); and
    Np 100352 (c2m_sharded's bucket), where K5's slices do not fit in
    shared memory."""
    cases = []
    _, k5 = dense_problem(rng, g=16)
    k5[4] = np.full_like(k5[4], 1_000_000)
    cases.append(("count_past_units", k5))
    _, k5 = dense_problem(rng, g=16)
    k5[1] = (k5[0] * 0.3).astype(np.int32)
    k5[4] = rng.integers(1, 200, k5[4].shape).astype(np.int32)
    cases.append(("no_phase2", k5))
    _, k5 = dense_problem(rng, g=16)
    k5[8] = rng.integers(-8, 0, k5[8].shape).astype(np.int32)
    cases.append(("negative_tier", k5))
    _, k5 = dense_problem(rng, g=16, tied=True)
    k5[7] = np.ones_like(k5[7])
    cases.append(("tied_one_unit", k5))
    _, k5 = dense_problem(rng, n=100352, g=8)
    cases.append(("np100352", k5))
    return cases


def preempt_edge_checks(dev, rng) -> None:
    """K5 and K7 (8 shards, one card) against their twins on
    preempt_edge_cases, with what each case is for checked on the twin's
    outputs; then the first case again through K7's cached graph, which
    has replayed the other cases' inputs since (stale static buffers
    would show)."""
    variants, routes, first = set(), [], None
    for name, arrays in preempt_edge_cases(rng):
        t = [torch.from_numpy(a).to(dev) for a in arrays]
        want = tk.solve_placement_preempt_plain(*t)
        got = tk.solve_placement_preempt(*t)
        torch.cuda.synchronize()
        launch = tk.solve_placement_preempt.last_launch
        check(max_abs_err(got, want) == 0,
              f"preempt {name}: K5 differs from its twin (launch {launch})")
        variants.add(launch["smem_slices"])
        got = tk.sharded_solver_preempt(*t, n_shards=8)
        torch.cuda.synchronize()
        routes.append((t[0].shape[0], tk.sharded_solver_preempt.last_route))
        check(max_abs_err(got, tk.sharded_solver_preempt_plain(
            *t, n_shards=8)) == 0, f"sharded preempt {name}: K7 differs "
            "from its twin")
        assign, evict = want[0], want[1]
        counts = t[4]
        if name == "count_past_units":
            check(bool((assign.sum(dim=1) < counts).all()),
                  "count_past_units: a group placed its whole count")
        if name == "no_phase2":
            check(int(evict.sum()) == 0
                  and bool((assign.sum(dim=1) == counts).all()),
                  "no_phase2: phase 1 left a remainder")
        check(int(assign.sum()) > 0, f"preempt {name}: placed nothing")
        first = first or (t, want)
    check(variants == {True, False},
          "K5's shared- and global-memory slice variants were not both run")
    t, want = first
    got = tk.sharded_solver_preempt(*t, n_shards=8)
    torch.cuda.synchronize()
    check(tk.sharded_solver_preempt.last_route == "graph_replay"
          and max_abs_err(got, want) == 0,
          "K7's graph replayed on its first inputs again differs")
    at_bucket = [r for n, r in routes if n == t[0].shape[0]]
    check(at_bucket[0] in ("graph_capture", "graph_replay")
          and all(r == "graph_replay" for r in at_bucket[1:]),
          f"K7 routes {routes}: the cases did not share one graph")


def dense_edge_cases(rng) -> list:
    """(name, K4 arguments) where the dense solve's cluster kernel can go
    wrong, 16 groups each: counts past every unit (the select's round-0
    shortcut), all scores tied (an index-ordered share), spread scores
    with counts well below the units (radix passes), a batch padded with
    count-0 groups, Np 10000 (not a multiple of 128: the global-memory
    slices) and Np 100352 (c2m_sharded's bucket: global-memory slices)."""
    k4, _ = dense_problem(rng, g=16)
    k4[3] = np.full_like(k4[3], 1_000_000)
    cases = [("all_fit", k4)]
    k4, _ = dense_problem(rng, g=16, tied=True)
    k4[6] = np.ones_like(k4[6])
    cases.append(("all_tied", k4))
    k4 = mesh_problem(rng, n=10240)
    k4[3] = rng.integers(100, 501, k4[3].shape).astype(np.int32)
    cases.append(("radix_passes", k4))
    k4, _ = dense_problem(rng, g=16)
    k4[3][1::3] = 0
    k4[3][8:] = 0
    cases.append(("padded_groups", k4))
    cases.append(("np10000", dense_problem(rng, n=10000, g=16)[0]))
    cases.append(("np100352", mesh_problem(rng)))
    return cases


def dense_edge_checks(dev, rng) -> None:
    """K4 against its twin on dense_edge_cases, array-equal, with what
    each case is for checked on the twin's outputs and both slice
    variants (shared and global memory) run."""
    variants = set()
    for name, arrays in dense_edge_cases(rng):
        t = [torch.from_numpy(a).to(dev) for a in arrays]
        got = tk.solve_placement(*t)
        torch.cuda.synchronize()
        launch = dict(tk.solve_placement.last_launch)
        want = tk.solve_placement_plain(*t)
        check(max_abs_err(got, want) == 0,
              f"dense {name}: K4 differs from its twin (launch {launch})")
        variants.add(launch["smem_slices"])
        placed, counts = want[0].sum(dim=1), t[3]
        check(int(placed.sum()) > 0, f"dense {name}: placed nothing")
        if name == "all_fit":
            check(bool((placed < counts).all()),
                  "all_fit: a group's units covered its count")
        if name in ("radix_passes", "all_tied"):
            check(bool((placed == counts).all()),
                  f"{name}: a group was not placed in full")
        if name == "padded_groups":
            check(int(want[0][counts == 0].abs().sum()) == 0,
                  "padded_groups: a count-0 group placed")
        if name.startswith("np"):
            check(not launch["smem_slices"],
                  f"dense {name}: the slices went to shared memory")
    check(variants == {True, False},
          "K4's shared- and global-memory slice variants were not both run")


def scatter_add_cases(rng) -> list:
    """(name, used, idx, rows) where K3's one-launch kernel can go wrong:
    repeated indices (shared atomics on one row), negative indices down
    to -Np and past it, the 1 << 30 pad with nonzero pad rows, 4096 rows
    (more than a block's threads), untouched negative rows that only the
    clamp zeroes, and Np 10000, whose last block owns part of a range."""
    n = 10240

    def base(n_, lo=0):
        return rng.integers(lo, 9000, (n_, 3)).astype(np.int32)

    def deltas(b):
        return rng.integers(-6000, 6000, (b, 3)).astype(np.int32)

    cases = [("repeated", base(n),
              rng.choice(50, size=1024).astype(np.int32), deltas(1024))]
    idx = rng.integers(-n - 40, 0, 1024).astype(np.int32)
    idx[:4] = [-n, -1, -n - 1, -n]
    cases.append(("negative", base(n), idx, deltas(1024)))
    idx = np.full(1024, 1 << 30, dtype=np.int32)
    idx[:300] = rng.choice(n, 300, replace=False)
    cases.append(("pad", base(n), idx, deltas(1024)))
    cases.append(("b4096", base(n), rng.integers(0, n, 4096).astype(np.int32),
                  deltas(4096)))
    idx = np.full(1024, 1 << 30, dtype=np.int32)
    idx[:100] = rng.choice(n // 2, 100, replace=False)
    cases.append(("untouched_negative", base(n, lo=-3000), idx, deltas(1024)))
    n2 = 10000
    idx = rng.integers(n2 - 300, n2, 1024).astype(np.int32)
    cases.append(("np10000", base(n2), idx, deltas(1024)))
    return cases


def scatter_add_checks(dev, rng) -> None:
    """K3 against its twin on scatter_add_cases, array-equal; the input
    must stay as it was (the output is a fresh tensor)."""
    for name, used, idx, rows in scatter_add_cases(rng):
        u, i, r = (torch.from_numpy(a).to(dev) for a in (used, idx, rows))
        got = tk.scatter_add_rows(u, i, r)
        want = tk.scatter_add_rows_plain(u, i, r)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"scatter_add_rows {name} differs")
        check(torch.equal(u.cpu(), torch.from_numpy(used)),
              f"scatter_add_rows {name} wrote its input")
        check(bool((got == 0).any()), f"scatter_add_rows {name}: no clamp")
        if name == "untouched_negative":
            kept = torch.zeros(used.shape[0], dtype=torch.bool)
            kept[torch.from_numpy(idx[:100]).long()] = True
            neg = (torch.from_numpy(used) < 0).any(dim=1) & ~kept
            check(bool(neg.any()) and int(got.cpu()[neg].min()) == 0,
                  "untouched_negative: no untouched row was clamped")


def kernel_checks(dev, seed: int) -> list:
    """Each kernel against its twin on seeded inputs at the c2m bucket.
    Returns K4's arguments from the random dense case, a call that
    places, for replay_dense to time beside the path's own call."""
    rng = np.random.default_rng(seed)
    variants = set()
    for name, arrays, maxc in compact_cases(rng):
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        got = tk.solve_placement_compact(*args, max_count=maxc)
        launch = tk.solve_placement_compact.last_launch
        want = tk.solve_placement_compact_plain(*args, max_count=maxc)
        torch.cuda.synchronize()
        for label, g_, w_ in zip(("inst", "over", "used'"), got, want):
            check(torch.equal(g_, w_), f"compact {name}: {label} differs "
                  f"(launch {launch})")
        check(int((got[0] >= 0).sum()) > 0, f"compact {name}: placed nothing")
        variants.add(launch["smem_slices"])
        if name == "np100352_global_slices":
            check(not launch["smem_slices"],
                  "Np 100352 with i32 caps kept its slices in shared memory")
    check(variants == {True, False},
          "K1's shared- and global-memory slice variants were not both run")
    dense_cases = [
        ("random, limit at the pad", dense_problem(rng, tiers=2)),
        ("tied", dense_problem(rng, tied=True)),
        ("negative_free", dense_problem(rng, negative=True)),
    ]
    placing = None
    for name, (k4, k5) in dense_cases:
        args = [torch.from_numpy(a).to(dev) for a in k4]
        placing = placing or args
        got = tk.solve_placement(*args)
        want = tk.solve_placement_plain(*args)
        torch.cuda.synchronize()
        for label, g_, w_ in zip(("assign", "used'"), got, want):
            check(torch.equal(g_, w_), f"dense {name}: {label} differs")
        check(int(got[0].sum()) > 0, f"dense {name}: placed nothing")
        args = [torch.from_numpy(a).to(dev) for a in k5]
        got = tk.solve_placement_preempt(*args)
        want = tk.solve_placement_preempt_plain(*args)
        torch.cuda.synchronize()
        for label, g_, w_ in zip(("assign", "evict", "used'"), got, want):
            check(torch.equal(g_, w_), f"preempt {name}: {label} differs")
        check(int(got[1].sum()) > 0, f"preempt {name}: evicted nothing")
    used, idx, rows = (torch.from_numpy(a).to(dev)
                       for a in scatter_problem(rng))
    for donate in (True, False):
        base = used.clone()
        got = tk.scatter_rows(base, idx, rows.abs(), donate)
        want = tk.scatter_rows_plain(used.clone(), idx, rows.abs(), donate)
        check(torch.equal(got, want), f"scatter_rows donate={donate} differs")
        check((got is base) == donate, "scatter_rows donation")
    got = tk.scatter_add_rows(used, idx, rows)
    want = tk.scatter_add_rows_plain(used, idx, rows)
    check(torch.equal(got, want), "scatter_add_rows differs")
    check(bool((got == 0).any()), "scatter_add_rows: clamp not exercised")
    torch.cuda.synchronize()
    mesh_kernel_checks(dev, rng)
    preempt_edge_checks(dev, rng)
    dense_edge_checks(dev, rng)
    scatter_add_checks(dev, rng)
    return placing


def mesh_kernel_checks(dev, rng) -> None:
    """K6 in its three modes at c2m_sharded's bucket (Np 100352, Gp 16)
    on 1 and 8 shards (and 32 on the random problem), and K7 at the preempt wave's bucket (Np 10240,
    Gp 80, Tp 4) on 8 shards: each against its twin, and against the
    single-card kernel (K4 for K6's full and top-k modes, K1 for
    compact, K5 for K7) on the same inputs, array-equal."""
    for name in ("random", "tied", "negative_free"):
        arrays = mesh_problem(rng, tied=name == "tied",
                              negative=name == "negative_free")
        t = [torch.from_numpy(a).to(dev) for a in arrays]
        maxc = tk.pad_c(int(arrays[3].max()))
        idx = torch.arange(t[2].shape[0], dtype=torch.int32, device=dev)
        packed = torch.from_numpy(np.packbits(arrays[4], axis=1)).to(dev)
        single = {
            "full": tk.solve_placement(*t),
            "compact": tk.solve_placement_compact(
                t[0], t[1], t[2], t[3], packed, idx, t[5], idx, t[6], idx,
                max_count=maxc,
            ),
        }
        single["topk"] = single["full"]
        # 32 shards: more lists than the candidate fill merges at once
        for d in ((1, 8, 32) if name == "random" else (1, 8)):
            for mode, kw in (("full", {}), ("topk", {"max_count": maxc}),
                             ("compact", {"max_count": maxc,
                                          "compact": True})):
                got = tk.sharded_solver(*t, n_shards=d, **kw)
                want = tk.sharded_solver_plain(*t, n_shards=d, **kw)
                torch.cuda.synchronize()
                for i, (g_, w_, s_) in enumerate(
                        zip(got, want, single[mode])):
                    check(torch.equal(g_, w_),
                          f"sharded {mode} d{d} {name}: output {i} differs "
                          "from its twin")
                    check(torch.equal(g_, s_),
                          f"sharded {mode} d{d} {name}: output {i} differs "
                          "from the single-card kernel")
        check(int((single["compact"][0] >= 0).sum()) > 0,
              f"sharded {name}: placed nothing")
    # the selection's own edges: unit caps of 1, so a shard's list needs
    # several rounds (counts past 16 x 32), and lists cut by k = 64
    for name, maxc in (("multi_round", 512), ("cut_by_k", 64)):
        arrays = mesh_problem(rng)
        arrays[6] = np.ones_like(arrays[6])
        arrays[3] = rng.integers(300, 501, arrays[3].shape).astype(np.int32)
        t = [torch.from_numpy(a).to(dev) for a in arrays]
        idx = torch.arange(t[2].shape[0], dtype=torch.int32, device=dev)
        packed = torch.from_numpy(np.packbits(arrays[4], axis=1)).to(dev)
        single = {"topk": tk.solve_placement(*t),
                  "compact": tk.solve_placement_compact(
                      t[0], t[1], t[2], t[3], packed, idx, t[5], idx, t[6],
                      idx, max_count=maxc)}
        for d in (1, 8):
            for mode, kw in (("topk", {"max_count": maxc}),
                             ("compact", {"max_count": maxc,
                                          "compact": True})):
                got = tk.sharded_solver(*t, n_shards=d, **kw)
                want = tk.sharded_solver_plain(*t, n_shards=d, **kw)
                torch.cuda.synchronize()
                for i, (g_, w_, s_) in enumerate(
                        zip(got, want, single[mode])):
                    check(torch.equal(g_, w_),
                          f"sharded {mode} d{d} {name}: output {i} differs "
                          "from its twin")
                    # k bounds every group's receivers only uncut
                    if name == "multi_round":
                        check(torch.equal(g_, s_),
                              f"sharded {mode} d{d} {name}: output {i} "
                              "differs from the single-card kernel")
    for name, kwargs in (("random", {}), ("tied", {"tied": True}),
                         ("negative_free", {"negative": True})):
        _, k5 = dense_problem(rng, **kwargs)
        t = [torch.from_numpy(a).to(dev) for a in k5]
        got = tk.sharded_solver_preempt(*t, n_shards=8)
        want = tk.sharded_solver_preempt_plain(*t, n_shards=8)
        single = tk.solve_placement_preempt(*t)
        torch.cuda.synchronize()
        for i, (g_, w_, s_) in enumerate(zip(got, want, single)):
            check(torch.equal(g_, w_),
                  f"sharded preempt {name}: output {i} differs from its twin")
            check(torch.equal(g_, s_),
                  f"sharded preempt {name}: output {i} differs from K5")
        check(int(got[1].sum()) > 0, f"sharded preempt {name}: evicted nothing")


def build_c2m(n_nodes: int):
    h = Harness()
    for i in range(n_nodes):
        n = mock.node()
        n.datacenter = DCS[i % 4]
        n.resources.cpu = 4000
        n.resources.memory_mb = 8192
        n.computed_class = compute_node_class(n)
        h.state.upsert_node(h.next_index(), n)
    return h


def add_jobs(h, prefix: str, n_jobs: int, count: int, *, cpu: int = 250,
             mem: int = 128, priority: int = 50, dcs=DCS,
             constrained: bool = True) -> list:
    """bench.py add_jobs: 250 MHz / 128 MB per alloc unless told
    otherwise; constrained adds the kernel.name constraint and the
    datacenter spread (weight 50)."""
    jobs = []
    for j in range(n_jobs):
        job = mock.job(id=f"{prefix}-{j}")
        job.datacenters = list(dcs)
        job.priority = priority
        tg = job.task_groups[0]
        tg.count = count
        tg.tasks[0].resources.cpu = cpu
        tg.tasks[0].resources.memory_mb = mem
        tg.tasks[0].resources.networks = []
        if constrained:
            job.constraints.append(
                Constraint("${attr.kernel.name}", "linux", "=")
            )
            job.spreads = [Spread(attribute="${node.datacenter}", weight=50)]
        h.state.upsert_job(h.next_index(), job)
        jobs.append(h.state.job_by_id(job.namespace, job.id))
    return jobs


def scale_down(h, job, count: int):
    """Scale down while rolling out a new task version, so the eval both
    stops allocs and places: its stops become the batch's usage deltas."""
    job = job.copy()
    job.task_groups[0].count = count
    job.task_groups[0].tasks[0].env = {"FOO": "bar", "VERSION": "2"}
    h.state.upsert_job(h.next_index(), job)
    return h.state.job_by_id(job.namespace, job.id)


def placements(plans, evals) -> dict:
    out = {}
    for ev in evals:
        plan = plans[ev.id]
        for allocs in plan.node_allocation.values():
            for a in allocs:
                out[(a.job_id, a.name)] = a.node_id
        for b in plan.alloc_batches:
            for a in b.materialize():
                out[(a.job_id, a.name)] = a.node_id
    return out


def commit(h, plans, evals) -> None:
    t0 = time.monotonic_ns()
    for ev in evals:
        h.submit_plan(plans[ev.id])
    trace.stage("commit", time.monotonic_ns() - t0)


def stage_ms(ctx) -> dict:
    """Milliseconds per stage name over one trace (summed)."""
    out: dict = {}
    for span in ctx.spans[1:]:
        out[span.name] = out.get(span.name, 0.0) + span.duration_ns / 1e6
    return out


def three_waves(device: str, n_nodes: int, n_jobs: int, count: int,
                new_jobs: int, on_wave=None, mesh: int = 0) -> dict:
    """The slice's main path: wave 1 (full upload), wave 2 (delta sync +
    adjusted view, left uncommitted), wave 3 (chained on wave 2). Each
    wave runs under a trace, so the solver's own stage timers (reconcile,
    host_prep, device.wait, readback, materialize, plan.assemble) and the
    commit add up to where its time went. mesh > 0 runs the waves on a
    mesh of that many shards."""
    h = build_c2m(n_nodes)
    w1 = add_jobs(h, "w1", n_jobs, count)
    cfg = SchedulerConfig(small_batch_threshold=0, device=device,
                          mesh_devices=mesh)
    resident = gpu.ResidentClusterState(
        mesh=gpu.solver_mesh(mesh, device) if mesh else None, device=device,
    )
    out = {"h": h, "resident": resident, "syncs": [], "evals": [],
           "chains": []}

    t0 = time.perf_counter()
    ctx = trace.TraceContext("wave1")
    with trace.use(ctx):
        ev1 = [mock.eval_for_job(j) for j in w1]
        p1 = gpu.solve_eval_batch(h.snapshot(), h, ev1, cfg,
                                  resident=resident)
        out["syncs"].append(resident.last_sync)
        commit(h, p1, ev1)
    out["evals"].append((ev1, p1))
    if on_wave:
        on_wave("wave1", t0, stages_ms=stage_ms(ctx))

    t0 = time.perf_counter()
    ctx = trace.TraceContext("waves2_3")
    with trace.use(ctx):
        w2 = add_jobs(h, "w2", new_jobs, count)
        w2.append(scale_down(h, w1[0], count // 2))
        ev2 = [mock.eval_for_job(j) for j in w2]
        pend2 = gpu.solve_eval_batch_begin(h.snapshot(), h, ev2, cfg,
                                           resident=resident)
        out["syncs"].append(resident.last_sync)
        out["chains"].append(pend2.chain)

        w3 = add_jobs(h, "w3", new_jobs, count)
        w3.append(scale_down(h, w1[1], count // 2))
        ev3 = [mock.eval_for_job(j) for j in w3]
        pend3 = gpu.solve_eval_batch_begin(h.snapshot(), h, ev3, cfg,
                                           resident=resident,
                                           used_chain=pend2.chain)
        out["syncs"].append(resident.last_sync)
        out["chain_accepted"] = pend3.chain_accepted
        out["chains"].append(pend3.chain)
        for evs, pend in ((ev2, pend2), (ev3, pend3)):
            plans = pend.finish()
            commit(h, plans, evs)
            out["evals"].append((evs, plans))
    if on_wave:
        on_wave("waves2_3", t0, stages_ms=stage_ms(ctx))
    out["placed"] = {}
    for evs, plans in out["evals"]:
        out["placed"].update(placements(plans, evs))
    # node ids are fresh uuids per cluster: compare runs by node position
    pos = {node.id: i for i, node in enumerate(h.state.nodes())}
    out["placed_pos"] = {k: pos[v] for k, v in out["placed"].items()}
    return out


def check_main(res, n_jobs: int, count: int, new_jobs: int) -> None:
    h = res["h"]
    for evs, plans in res["evals"]:
        for ev in evs:
            check(ev.id in plans, "a plan did not come back")
            check(not ev.failed_tg_allocs,
                  f"eval {ev.job_id} failed to place: {ev.failed_tg_allocs}")
    want_live = n_jobs * count - 2 * (count - count // 2) + 2 * new_jobs * count
    live = [a for a in h.state.allocs() if not a.terminal_status()]
    check(len(live) == want_live, f"{len(live)} live allocs, want {want_live}")
    for node in h.state.nodes():
        u = h.state.node_usage(node.id)
        cap = node.available_resources()
        check(u[0] <= cap.cpu and u[1] <= cap.memory_mb,
              f"node {node.id} over capacity: {u} > {cap}")
    syncs = res["syncs"]
    check(syncs[0] == "full", f"wave 1 sync {syncs[0]}")
    check(syncs[1].startswith("delta:"), f"wave 2 sync {syncs[1]}")
    check(res["chain_accepted"], "wave 3 did not accept the chain")


# ---------------------------------------------------------------------------
# the preemption route (BASELINE config 4 at c2m scale)
# ---------------------------------------------------------------------------

DC123 = DCS[:3]
# (job prefix, jobs, allocs per job, priority, datacenters), highest tier
# first so that no fill batch can preempt: 90,000 allocs, 90% of the
# 100,000 slots of 10,000 nodes at 400 MHz / 800 MB
C2M_FILLS = [
    ("p65", 25, 900, 65, ["dc4"]),
    ("p40", 30, 900, 40, DC123),
    ("p20", 45, 900, 20, DC123),
]
# bench.py run_preempt_config: 500 nodes, 25 x 180 at priority 20
BENCH_FILLS = [("fill", 25, 180, 20, DCS)]


def preempt_outcome(h, plans, evals) -> dict:
    """What a wave decided, by node position and (job id, alloc name),
    read from its plans after the commit (the store keeps the evicted
    allocs it names)."""
    pos = {node.id: i for i, node in enumerate(h.state.nodes())}

    def key(alloc_id):
        a = h.state.alloc_by_id(alloc_id)
        return (a.job_id, a.name)

    placed, by, victims, prios, unplaced = {}, {}, [], set(), 0
    for ev in evals:
        plan = plans[ev.id]
        for allocs in plan.node_allocation.values():
            for a in allocs:
                placed[(a.job_id, a.name)] = pos[a.node_id]
                if a.preempted_allocations:
                    by[(a.job_id, a.name)] = sorted(
                        key(v) for v in a.preempted_allocations
                    )
        for b in plan.alloc_batches:
            for a in b.materialize():
                placed[(a.job_id, a.name)] = pos[a.node_id]
        for allocs in plan.node_preemptions.values():
            for v in allocs:
                victims.append((v.job_id, v.name, pos[v.node_id]))
                prios.add(h.state.job_by_id(v.namespace, v.job_id).priority)
        unplaced += sum(m.coalesced_failures + 1
                        for m in ev.failed_tg_allocs.values())
    return {"placed": placed, "preempted_by": by, "victims": sorted(victims),
            "unplaced": unplaced, "victim_prios": sorted(prios)}


def preempt_fleet(device: str, n_nodes: int, fills: list, wave: tuple):
    """The fleet filled through the compact route, and the priority-70
    wave's jobs (jobs, allocs per job, constrained) at 400 MHz / 800 MB,
    added but not yet solved."""
    h = build_c2m(n_nodes)
    fill_cfg = SchedulerConfig(small_batch_threshold=0, device=device)
    for prefix, n_jobs, count, prio, dcs in fills:
        jobs = add_jobs(h, prefix, n_jobs, count, cpu=400, mem=800,
                        priority=prio, dcs=dcs, constrained=False)
        evs = [mock.eval_for_job(j) for j in jobs]
        plans = gpu.solve_eval_batch(h.snapshot(), h, evs, fill_cfg)
        commit(h, plans, evs)
    n_jobs, count, constrained = wave
    jobs = add_jobs(h, "hi", n_jobs, count, cpu=400, mem=800, priority=70,
                    constrained=constrained)
    return h, jobs


def preempt_scenario(device: str, n_nodes: int, fills: list, wave: tuple,
                     before_wave=None, on_wave=None, mesh: int = 0) -> dict:
    """Fill the fleet, then solve one priority-70 wave in one batch with
    preemption on (on a mesh of `mesh` shards when mesh > 0), and commit
    it. The wave runs under a trace, so its stage spans and the commit
    add up to where its time went; reading its outcome comes after its
    timer stops."""
    h, jobs = preempt_fleet(device, n_nodes, fills, wave)
    evs = [mock.eval_for_job(j) for j in jobs]
    cfg = SchedulerConfig(preemption_service=True, small_batch_threshold=0,
                          device=device, mesh_devices=mesh)
    if before_wave:
        before_wave()
    t0 = time.perf_counter()
    ctx = trace.TraceContext("preempt")
    with trace.use(ctx):
        plans = gpu.solve_eval_batch(h.snapshot(), h, evs, cfg)
        commit(h, plans, evs)
    if on_wave:
        on_wave("preempt.wave", t0, stages_ms=stage_ms(ctx))
    out = preempt_outcome(h, plans, evs)
    out["h"] = h
    return out


def check_preempt(res, wave_allocs: int, kept: dict) -> None:
    """After the commit: every node's live allocs fit its capacity,
    every victim sat at least PRIORITY_DELTA below the wave, the tiers
    in `kept` ({priority: live allocs}) lost nothing, each victim is
    charged to exactly one placement, and every alloc of the wave was
    either placed or reported unplaced."""
    h = res["h"]
    for node in h.state.nodes():
        u = h.state.node_usage(node.id)
        cap = node.available_resources()
        check(u[0] <= cap.cpu and u[1] <= cap.memory_mb,
              f"node {node.id} over capacity: {u} > {cap}")
    check(all(p <= 60 for p in res["victim_prios"]),
          f"victims at priorities {res['victim_prios']}")
    live: dict = {}
    for a in h.state.allocs():
        if not a.terminal_status():
            p = h.state.job_by_id(a.namespace, a.job_id).priority
            live[p] = live.get(p, 0) + 1
    for prio, n in kept.items():
        check(live.get(prio, 0) == n,
              f"priority {prio}: {live.get(prio, 0)} live, want {n}")
    charged = sum(len(v) for v in res["preempted_by"].values())
    check(charged == len(res["victims"]),
          f"{charged} victims charged to placements, "
          f"{len(res['victims'])} in the plans")
    total = len(res["placed"]) + res["unplaced"]
    check(total == wave_allocs,
          f"placed {len(res['placed'])} + unplaced {res['unplaced']} "
          f"!= {wave_allocs}")
    check(live.get(70, 0) == len(res["placed"]),
          "a placement of the wave was not committed")


# ---------------------------------------------------------------------------
# the mesh route: c2m_sharded at full width, the preempt wave on 8 shards
# ---------------------------------------------------------------------------

# bench.py run_c2m_sharded_config's defaults (BENCH_SHARDED_NODES / JOBS /
# COUNT); its device phase was an injected sleep, so only its shapes are
# taken
SHARDED_NODES, SHARDED_JOBS, SHARDED_COUNT = 100_000, 16, 500
SHARDED_ROUNDS = 5


def c2m_sharded(on_phase) -> dict:
    """100,000 nodes at 4000 MHz / 8192 MB and rounds of 16 jobs x 500
    allocs of 250 MHz / 128 MB with no constraint or spread. Round 1 is
    solved on one snapshot three ways, uncommitted: the single-card
    route (K1), a 1-shard and an 8-shard mesh (K6); the plans must be
    identical. Then bench.py's pipelined sequence on the 8-shard mesh,
    with the launch counters zeroed: begin(N+1) chains on batch N's
    in-flight used' before finish(N) and its commit; the resident shards
    take a full upload, then delta syncs."""
    t0 = time.perf_counter()
    h = build_c2m(SHARDED_NODES)
    rounds = [add_jobs(h, f"s{r}", SHARDED_JOBS, SHARDED_COUNT,
                       constrained=False) for r in range(SHARDED_ROUNDS)]
    on_phase("mesh.build", t0, nodes=SHARDED_NODES)

    t0 = time.perf_counter()
    snap = h.snapshot()
    placed, solve_s = {}, {}
    for label, shards in (("single_card", 0), ("d1", 1), ("d8", 8)):
        cfg = SchedulerConfig(small_batch_threshold=0, device="cuda",
                              mesh_devices=shards)
        evs = [mock.eval_for_job(j) for j in rounds[0]]
        t = time.perf_counter()
        plans = gpu.solve_eval_batch(snap, h, evs, cfg)
        solve_s[label] = time.perf_counter() - t
        check(not any(ev.failed_tg_allocs for ev in evs),
              f"round 1 ({label}) failed to place")
        placed[label] = placements(plans, evs)
    check(len(placed["single_card"]) == SHARDED_JOBS * SHARDED_COUNT,
          "round 1 placed too few allocs")
    for label in ("d1", "d8"):
        check(placed[label] == placed["single_card"],
              f"round 1 on the {label} mesh differs from the single card")
    on_phase("mesh.round1_three_ways", t0, solve_s=solve_s,
             allocs_compared=len(placed["single_card"]))

    mesh = gpu.solver_mesh(8, "cuda")
    resident = gpu.ResidentClusterState(mesh=mesh)
    cfg = SchedulerConfig(small_batch_threshold=0, device="cuda",
                          mesh_devices=8)
    rec = Recorder(gpu.sharding, "sharded_solver")
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    syncs, walls, stages, prev = [], [], [], None
    t_last = t0
    for i, jobs in enumerate(rounds + [None]):
        # one trace per step: begin(N+1), then finish(N) and its commit
        ctx = trace.TraceContext(f"step{i}")
        trace_cm = trace.use(ctx)
        trace_cm.__enter__()
        pend = None
        if jobs is not None:
            evs = [mock.eval_for_job(j) for j in jobs]
            pend = gpu.solve_eval_batch_begin(
                h.snapshot(), h, evs, cfg, resident=resident,
                used_chain=prev[0].chain if prev else None,
            )
            syncs.append(resident.last_sync
                         + ("+chain" if pend.chain_accepted else ""))
        if prev is not None:
            p_pend, p_evs = prev
            plans = p_pend.finish()
            commit(h, plans, p_evs)
            for ev in p_evs:
                check(not ev.failed_tg_allocs,
                      f"eval {ev.job_id} failed: {ev.failed_tg_allocs}")
            now = time.perf_counter()
            walls.append(now - t_last)
            t_last = now
        trace_cm.__exit__(None, None, None)
        stages.append(stage_ms(ctx))
        prev = (pend, evs) if pend is not None else None
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in tk.KERNELS}
    rec.restore()
    on_phase("mesh.pipelined", t0, round_walls_s=walls, syncs=syncs,
             shard_map=mesh.shard_map(), launches=launches,
             step_stages_ms=stages)
    check(launches["sharded_solver"] > 0, "K6 did not launch on the mesh")
    check(launches["solve_placement_compact"] == 0,
          "K1 launched on the mesh path")
    check(syncs[0] == "full" and all("+chain" in x for x in syncs[1:])
          and any(x.startswith("delta:") for x in syncs),
          f"sync sequence {syncs}")
    on_card = [resident._cap_dev, resident._used_dev] + rec.tensors
    check(all(t.is_cuda for t in on_card),
          "a resident shard or a K6 operand is on the host")
    live = sum(1 for a in h.state.allocs() if not a.terminal_status())
    want = SHARDED_ROUNDS * SHARDED_JOBS * SHARDED_COUNT
    check(live == want, f"{live} live allocs, want {want}")
    for node in h.state.nodes():
        u = h.state.node_usage(node.id)
        cap = node.available_resources()
        check(u[0] <= cap.cpu and u[1] <= cap.memory_mb,
              f"node {node.id} over capacity: {u} > {cap}")
    return {"launches": launches["sharded_solver"], "rec": rec,
            "solves": SHARDED_ROUNDS}


def preempt_on_mesh(on_phase) -> dict:
    """The preempt phase's fleet and wave (10,000 nodes 90% full, 20 x
    1,000 at priority 70), solved on one snapshot through the single-card
    route and on an 8-shard mesh, with the launch counters zeroed around
    the mesh solve: placements, victims and preempted allocations must
    be identical. The mesh's plans are committed."""
    t0 = time.perf_counter()
    h, jobs = preempt_fleet("cuda", 10000, C2M_FILLS, (20, 1000, True))
    on_phase("mesh.preempt_fleet", t0)
    snap = h.snapshot()
    out, solve_s = {}, {}
    rec = None
    for label, shards in (("single_card", 0), ("d8", 8)):
        cfg = SchedulerConfig(preemption_service=True,
                              small_batch_threshold=0, device="cuda",
                              mesh_devices=shards)
        evs = [mock.eval_for_job(j) for j in jobs]
        if shards:
            rec = Recorder(gpu.sharding, "sharded_solver_preempt")
            tk.reset_launch_counts()
        t = time.perf_counter()
        plans = gpu.solve_eval_batch(snap, h, evs, cfg)
        torch.cuda.synchronize()
        solve_s[label] = time.perf_counter() - t
        out[label] = (plans, evs, preempt_outcome(h, plans, evs))
    launches = {fn.__name__: fn.launches for fn in tk.KERNELS}
    route = tk.sharded_solver_preempt.last_route
    replays = tk.sharded_solver_preempt.graph_replays
    rec.restore()
    check(route in ("graph_capture", "graph_replay") and replays == 1,
          f"K7 on one card took the {route} route ({replays} replays)")
    ref, got = out["single_card"][2], out["d8"][2]
    for k in ("placed", "preempted_by", "victims", "unplaced"):
        check(got[k] == ref[k], f"preempt wave on the mesh differs in {k}")
    check(launches["sharded_solver_preempt"] > 0,
          "K7 did not launch on the mesh's preempt wave")
    check(all(t.is_cuda for t in rec.tensors), "a K7 operand is on the host")
    plans, evs, res = out["d8"]
    commit(h, plans, evs)
    res["h"] = h
    check_preempt(res, 20 * 1000, {65: 25 * 900})
    # the wave's graph, captured by its first solve of this shape
    a = rec.first[0]
    capture_s = tk.sharded_solver_preempt.graphs[
        (a[0].shape[0], a[3].shape[0], a[2].shape[0], 8,
         a[0].device.index)]["capture_s"]
    on_phase("mesh.preempt_wave", t0, solve_s=solve_s, launches=launches,
             placed=len(got["placed"]), evicted=len(got["victims"]),
             route=route, capture_s=capture_s)
    return {"launches": launches["sharded_solver_preempt"], "rec": rec,
            "solves": 1, "graph_replays": replays, "capture_s": capture_s}


class Recorder:
    """Wraps a kernel wrapper where the solver calls it, keeping a copy
    of the first call's inputs (before a donated call writes them)."""

    def __init__(self, mod, name: str) -> None:
        self.mod, self.name = mod, name
        self.real = getattr(mod, name)
        self.first = None
        self.tensors = []
        setattr(mod, name, self)

    def __call__(self, *args, **kwargs):
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        if self.first is None:
            self.first = ([a.clone() if isinstance(a, torch.Tensor)
                           else a for a in args], dict(kwargs))
        out = self.real(*args, **kwargs)
        outs = out if isinstance(out, tuple) else (out,)
        self.tensors.extend(tensors + list(outs))
        return out

    def __getattr__(self, attr):
        # the wrapper's own state (launch counts, route), read through
        if attr == "real":
            raise AttributeError(attr)
        return getattr(self.real, attr)

    def restore(self) -> None:
        setattr(self.mod, self.name, self.real)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def max_abs_err(got, want) -> float:
    """Largest elementwise |kernel - twin| over all outputs (the
    tolerance is exact: every output is integer or boolean)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return max(
        float((g.long() - w.long()).abs().max()) for g, w in zip(got, want)
    )


def replay(rec: dict, launches: dict) -> list:
    """Each kernel's first main-path call against its twin, then timed."""
    out = []
    # K1
    args, kw = rec["solve_placement_compact"].first
    got = tk.solve_placement_compact(*args, **kw)
    want = tk.solve_placement_compact_plain(*args, **kw)
    torch.cuda.synchronize()
    k1_err = max_abs_err(got, want)
    check(k1_err == 0, "main-path compact call differs")
    cap, used, asks, counts, fp, fi, br, bi, ur, ui = args
    inst, over, used_out = got
    live_groups = int((counts > 0).sum())
    k1_bytes = nbytes(cap, used, asks, counts, fp, fi, br, bi, ur, ui,
                      inst, over, used_out)
    k1_ops = live_groups * cap.shape[0] * SCORE_FLOPS
    ms, enq = device_ms(lambda: tk.solve_placement_compact(*args, **kw), 10)
    plain_ms = time_ms(
        lambda: tk.solve_placement_compact_plain(*args, **kw), 3
    )
    out.append(entry("solve_placement_compact", launches, k1_err, ms, plain_ms,
                     k1_bytes, k1_ops, None, enqueue_ms=enq,
                     launch=tk.solve_placement_compact.last_launch,
                     shape={"np": cap.shape[0], "gp": asks.shape[0],
                            "live_groups": live_groups,
                            "max_count": kw["max_count"]}))
    # K2: the delta sync (donated) and the adjusted view (not donated)
    args2, _ = rec["scatter_rows"].first
    used2, idx2, rows2 = args2[:3]
    k2_err = 0.0
    for donate in (True, False):
        got = tk.scatter_rows(used2.clone(), idx2, rows2, donate)
        want = tk.scatter_rows_plain(used2.clone(), idx2, rows2, donate)
        torch.cuda.synchronize()
        k2_err = max(k2_err, max_abs_err(got, want))
    check(k2_err == 0, "main-path scatter_rows differs")
    kept = (idx2 >= 0) & (idx2 < used2.shape[0])
    b_kept = int(kept.sum())
    k2_bytes = nbytes(idx2, rows2) + b_kept * 12
    work = used2.clone()
    ms, enq = device_ms(lambda: tk.scatter_rows(work, idx2, rows2, True), 50)
    ms_copy, enq_copy = device_ms(
        lambda: tk.scatter_rows(used2, idx2, rows2, False), 50
    )
    plain_ms = time_ms(
        lambda: tk.scatter_rows_plain(work, idx2, rows2, True), 20
    )
    ik, rk = idx2[kept].long(), rows2[kept]
    lib_ms, _ = device_ms(lambda: work.index_copy_(0, ik, rk), 50)
    out.append(entry("scatter_rows", launches, k2_err, ms, plain_ms, k2_bytes,
                     0, lib_ms, enqueue_ms=enq, ms_copy=ms_copy,
                     enqueue_ms_copy=enq_copy,
                     bound_ms_copy=1e3 * (nbytes(idx2, rows2)
                                          + 2 * nbytes(used2))
                     / HBM_BYTES_PER_S,
                     shape={"np": used2.shape[0], "rows": idx2.shape[0],
                            "kept": b_kept}))
    # K3: the stops' deltas onto the chained used'
    args3, _ = rec["scatter_add_rows"].first
    used3, idx3, rows3 = args3[:3]
    got = tk.scatter_add_rows(used3, idx3, rows3)
    want = tk.scatter_add_rows_plain(used3, idx3, rows3)
    torch.cuda.synchronize()
    k3_err = max_abs_err(got, want)
    check(k3_err == 0, "main-path scatter_add_rows differs")
    k3_bytes = nbytes(used3, idx3, rows3) + nbytes(used3)
    ms, enq = device_ms(lambda: tk.scatter_add_rows(used3, idx3, rows3), 50)
    plain_ms = time_ms(
        lambda: tk.scatter_add_rows_plain(used3, idx3, rows3), 20
    )
    out.append(entry("scatter_add_rows", launches, k3_err, ms, plain_ms,
                     k3_bytes, 0, None, enqueue_ms=enq,
                     shape={"np": used3.shape[0], "rows": idx3.shape[0],
                            "kept": int(((idx3 >= 0)
                                         & (idx3 < used3.shape[0])).sum())}))
    return out


def replay_dense(rec: dict, launches: dict, k4_placing: list) -> list:
    """K5's and K4's first preempt-path calls against their twins, then
    timed. The operation count is what this run's data needs: one
    scoring pass per live group, and a second for each group whose
    phase 1 left a remainder. K4's call on the path places nothing (K5
    left no free slot), so K4 is also timed on kernel_checks' random
    case, which places, under `placing_case`."""
    out = []
    args, _ = rec["solve_placement_preempt"].first
    got = tk.solve_placement_preempt(*args)
    want = tk.solve_placement_preempt_plain(*args)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    check(err == 0, "preempt-path solve_placement_preempt call differs")
    cap, _, prefix, asks, counts = args[:5]
    assign, evict, _ = got
    live = counts > 0
    phase2 = live & ((assign - evict).sum(dim=1) < counts)
    np_ = cap.shape[0]
    ops = (int(live.sum()) + int(phase2.sum())) * np_ * SCORE_FLOPS
    ms, enq = device_ms(lambda: tk.solve_placement_preempt(*args), 10)
    plain_ms = time_ms(lambda: tk.solve_placement_preempt_plain(*args), 3)
    split = device_split_ms(lambda: tk.solve_placement_preempt(*args))
    check(list(split) == ["solve_placement_kernel"],
          f"K5 did not run the radix-select kernel alone: {split}")
    out.append(entry("solve_placement_preempt", launches, err, ms, plain_ms,
                     nbytes(*args, *got), ops, None, enqueue_ms=enq,
                     launch=tk.solve_placement_preempt.last_launch,
                     kernel_split_ms=split,
                     shape={"np": np_, "gp": asks.shape[0],
                            "tp": prefix.shape[0],
                            "live_groups": int(live.sum()),
                            "phase2_groups": int(phase2.sum()),
                            "placed": int(assign.sum()),
                            "evicting": int(evict.sum())}))
    k4 = []
    for args in (rec["solve_placement"].first[0], k4_placing):
        got = tk.solve_placement(*args)
        launch = dict(tk.solve_placement.last_launch)
        want = tk.solve_placement_plain(*args)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        check(err == 0, "solve_placement call differs from its twin")
        cap, _, asks, counts = args[:4]
        live = int((counts > 0).sum())
        ms, enq = device_ms(lambda: tk.solve_placement(*args), 10)
        plain_ms = time_ms(lambda: tk.solve_placement_plain(*args), 3)
        split = device_split_ms(lambda: tk.solve_placement(*args))
        check(list(split) == ["solve_placement_kernel"],
              f"K4 did not run the radix-select kernel alone: {split}")
        k4.append(entry("solve_placement", launches, err, ms, plain_ms,
                        nbytes(*args, *got),
                        live * cap.shape[0] * SCORE_FLOPS, None,
                        enqueue_ms=enq, launch=launch, kernel_split_ms=split,
                        shape={"np": cap.shape[0], "gp": asks.shape[0],
                               "live_groups": live,
                               "placed": int(got[0].sum())}))
    path, placing = k4
    check(placing["shape"]["placed"] > 0, "K4's timed case placed nothing")
    path["placing_case"] = {k: placing[k] for k in (
        "max_abs_err", "ms", "enqueue_ms", "plain_ms", "bound_ms",
        "bound_by", "launch", "shape")}
    out.append(path)
    return out


def device_split_ms(fn) -> dict:
    """Device milliseconds by kernel over one call, from torch.profiler's
    CUDA activity (kernel names cut to their __global__ function)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        m = re.search(r"(\w+_kernel)", ev.key)
        if us and m:
            out[m.group(1)] = out.get(m.group(1), 0.0) + us / 1e3
    return out


def replay_mesh(paths: dict, launches: dict) -> list:
    """K6's and K7's first calls on the mesh's paths against their twins,
    then timed: `ms` is the device time of one whole call (every launch
    it makes, back to back), `launches_per_solve` the launches one call
    makes. The operation count is what this run's data needs, as for
    K1 and K5."""
    out = []
    for name in ("sharded_solver", "sharded_solver_preempt"):
        args, kw = paths[name]["rec"].first
        fn, plain = getattr(tk, name), getattr(tk, name + "_plain")
        before = fn.launches
        got = fn(*args, **kw)
        per_solve = fn.launches - before
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        check(err == 0, f"mesh-path {name} call differs from its twin")
        if name == "sharded_solver":
            cap, _, asks, counts = args[:4]
            live = counts > 0
            passes = int(live.sum())
            shape = {"np": cap.shape[0], "gp": asks.shape[0],
                     "live_groups": passes, "shards": kw["n_shards"],
                     "max_count": kw["max_count"],
                     "compact": kw["compact"],
                     "placed": int((got[0] >= 0).sum())}
        else:
            cap, _, prefix, asks, counts = args[:5]
            assign, evict, _ = got
            live = counts > 0
            phase2 = live & ((assign - evict).sum(dim=1) < counts)
            passes = int(live.sum()) + int(phase2.sum())
            shape = {"np": cap.shape[0], "gp": asks.shape[0],
                     "tp": prefix.shape[0], "shards": kw["n_shards"],
                     "live_groups": int(live.sum()),
                     "phase2_groups": int(phase2.sum()),
                     "placed": int(assign.sum()),
                     "evicting": int(evict.sum())}
        # the calls queued behind the spin kernel must fit the card's
        # queue of pending launches (about a thousand), or the host blocks
        # until the spin ends: K6 makes 33 launches a call; a replay of
        # K7's graph queues one graph and its copies
        graph = name == "sharded_solver_preempt"
        reps = 5 if graph else max(1, min(5, 512 // per_solve))
        replays = tk.sharded_solver_preempt.graph_replays
        ms, enq = device_ms(lambda: fn(*args, **kw), reps)
        plain_ms = time_ms(lambda: plain(*args, **kw), 3)
        extra = {"kernel_split_ms": device_split_ms(lambda: fn(*args, **kw)),
                 "shard_cluster": libkernels.library().nomad_shard_cluster(
                     kw["n_shards"], cap.shape[0] // kw["n_shards"])}
        if graph:
            route = tk.sharded_solver_preempt.last_route
            check(route == "graph_replay",
                  f"K7's timed calls took the {route} route")
            split = extra["kernel_split_ms"]
            check("gathered_select_kernel" in split
                  and "gathered_waterfill_kernel" not in split,
                  f"K7 did not run the radix select alone: {split}")
            entry_ = tk.sharded_solver_preempt.graphs[
                (cap.shape[0], asks.shape[0], prefix.shape[0],
                 kw["n_shards"], cap.device.index)]
            replay_ms, replay_enq = device_ms(entry_["graph"].replay, reps)
            extra.update(
                launch_route=route,
                graph_replays=tk.sharded_solver_preempt.graph_replays
                - replays,
                graph_replays_on_path=paths[name]["graph_replays"],
                capture_s=paths[name]["capture_s"],
                graph_only_ms=replay_ms, graph_only_enqueue_ms=replay_enq,
                water_cluster=libkernels.library().nomad_water_cluster(
                    cap.shape[0]))
        if name == "sharded_solver":
            # the same call with every row in one shard
            one = dict(kw, n_shards=1)
            d1 = fn(*args, **one)
            torch.cuda.synchronize()
            check(max_abs_err(d1, got) == 0, "K6 on 1 shard differs from 8")
            d1_ms, d1_enq = device_ms(lambda: fn(*args, **one), reps)
            extra["one_shard"] = {
                "ms": d1_ms, "enqueue_ms": d1_enq,
                "shard_cluster": libkernels.library().nomad_shard_cluster(
                    1, cap.shape[0]),
                "kernel_split_ms": device_split_ms(lambda: fn(*args, **one)),
            }
        out.append(entry(name, launches, err, ms, plain_ms,
                         nbytes(*args, *got),
                         passes * cap.shape[0] * SCORE_FLOPS, None,
                         enqueue_ms=enq, launches_per_solve=per_solve,
                         solves_on_path=paths[name]["solves"],
                         timed_calls=reps, shape=shape, **extra))
    return out


def entry(name, launches, err, ms, plain_ms, nbytes_, ops, lib_ms, **extra):
    t_bytes = 1e3 * nbytes_ / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / FP32_FLOP_PER_S
    src, replaces = SOURCES[name]
    return {
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": launches[name], "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms, **extra,
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)

    # 1. build
    t0 = time.perf_counter()
    libkernels.library()
    phase("build", t0, nvcc_seconds=libkernels.build_seconds)
    ptxas = [ln.strip() for ln in libkernels.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(json.dumps({"ptxas": ptxas}), flush=True)

    # 2. each kernel against its twin at the c2m bucket
    t0 = time.perf_counter()
    k4_placing = kernel_checks(dev, args.seed)
    phase("kernels", t0)

    # 3. the main path at c2m, launch counters zeroed just before
    rec = {name: Recorder(solver_mod, name)
           for name in ("solve_placement_compact", "scatter_rows",
                        "scatter_add_rows")}
    t_main = time.perf_counter()
    tk.reset_launch_counts()
    trace.set_enabled(True)
    res = three_waves("cuda", 10000, 100, 1000, 20,
                      on_wave=lambda name, t, **kw: phase(f"main.{name}", t,
                                                          **kw))
    trace.set_enabled(False)
    torch.cuda.synchronize()
    launches = {name: getattr(tk, name).launches for name in rec}
    for r in rec.values():
        r.restore()
    phase("main", t_main, launches=launches, syncs=res["syncs"],
          allocs_placed=len(res["placed"]))
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    check_main(res, 100, 1000, 20)
    resident = res["resident"]
    on_card = [resident._cap_dev, resident._used_dev]
    on_card += [c[1] for c in res["chains"]]
    for r in rec.values():
        on_card += r.tensors
    check(all(t.is_cuda for t in on_card), "a tensor of the path is on the host")

    # 4. the preemption route at c2m, launch counters zeroed just before
    #    the wave
    prec = {name: Recorder(solver_mod, name)
            for name in ("solve_placement", "solve_placement_preempt")}
    t_pre = time.perf_counter()
    trace.set_enabled(True)
    pres = preempt_scenario(
        "cuda", 10000, C2M_FILLS, (20, 1000, True),
        before_wave=tk.reset_launch_counts,
        on_wave=lambda name, t, **kw: phase(name, t, **kw),
    )
    trace.set_enabled(False)
    torch.cuda.synchronize()
    pre_launches = {name: getattr(tk, name).launches for name in prec}
    for r in prec.values():
        r.restore()
    phase("preempt", t_pre, launches=pre_launches,
          placed=len(pres["placed"]), evicted=len(pres["victims"]),
          unplaced=pres["unplaced"], victim_prios=pres["victim_prios"])
    for name, n in pre_launches.items():
        check(n > 0, f"kernel {name} was not launched on the preempt path")
    check_preempt(pres, 20 * 1000, {65: 25 * 900})
    on_card = []
    for r in prec.values():
        on_card += r.tensors
    check(all(t.is_cuda for t in on_card),
          "a tensor of the preempt path is on the host")
    del pres
    launches.update(pre_launches)

    # 5. the mesh route: c2m_sharded at full width, then the preempt wave
    #    on 8 shards, each with the launch counters zeroed around it
    t_mesh = time.perf_counter()
    trace.set_enabled(True)
    mesh_paths = {
        "sharded_solver": c2m_sharded(phase),
        "sharded_solver_preempt": preempt_on_mesh(phase),
    }
    trace.set_enabled(False)
    for name, res in mesh_paths.items():
        launches[name] = res["launches"]
    phase("mesh", t_mesh, launches={n: launches[n] for n in mesh_paths})

    # 6. replay each path's calls against the twins, and time them
    t0 = time.perf_counter()
    kernels = replay(rec, launches)
    kernels[1:1] = replay_dense(prec, launches, k4_placing)
    kernels += replay_mesh(mesh_paths, launches)
    phase("replay", t0)

    # 7. the same waves at 200 nodes, at 500 nodes on an 8-shard mesh,
    #    and bench.py's preempt config: card == CPU twins
    t0 = time.perf_counter()
    small_gpu = three_waves("cuda", 200, 8, 200, 2)
    small_cpu = three_waves("cpu", 200, 8, 200, 2)
    check(small_gpu["placed_pos"] == small_cpu["placed_pos"],
          "card and CPU twins placed differently")
    check(small_gpu["syncs"] == small_cpu["syncs"], "sync sequence differs")
    mesh_gpu = three_waves("cuda", 500, 8, 200, 2, mesh=8)
    mesh_cpu = three_waves("cpu", 500, 8, 200, 2, mesh=8)
    check(mesh_gpu["placed_pos"] == mesh_cpu["placed_pos"],
          "mesh: card and CPU twins placed differently")
    check(mesh_gpu["syncs"] == mesh_cpu["syncs"], "mesh sync sequence differs")
    check_main(mesh_gpu, 8, 200, 2)
    pre_gpu = preempt_scenario("cuda", 500, BENCH_FILLS, (20, 50, False))
    pre_cpu = preempt_scenario("cpu", 500, BENCH_FILLS, (20, 50, False))
    for k in ("placed", "preempted_by", "victims", "unplaced"):
        check(pre_gpu[k] == pre_cpu[k],
              f"bench preempt config: card and CPU twins differ in {k}")
    check(len(pre_gpu["victims"]) > 0, "bench preempt config evicted nothing")
    check_preempt(pre_gpu, 20 * 50, {})
    phase("small", t0, allocs_compared=len(small_gpu["placed"]),
          mesh_allocs_compared=len(mesh_gpu["placed"]),
          preempt_placed=len(pre_gpu["placed"]),
          preempt_evicted=len(pre_gpu["victims"]))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
