#!/usr/bin/env python3
"""Where the preemption solves (K5, and K7 on 8 shards) and the dense solve
(K4) spend their time on the card, from clock64() counters in an
instrumented copy of their sources.

    python3 scripts/chip_preempt_split.py [--tree DIR] [--case wave|random]

DIR is an unpacked checkout (default: this one); its package is the one
imported, built and measured. With --case wave (the default) the script
builds the preempt wave's fleet on the card (10,000 nodes filled to 90% in
priority tiers 65/40/20, then 20 jobs x 1,000 allocs at priority 70 with
the kernel.name constraint and the datacenter spread; chip_smoke.py's
preempt phase) and records K5's arguments from the wave's solve; with
--case random it takes chip_smoke.py's seeded random dense problem at the
same bucket (Np 10240, 80 groups, 4 tier rows), whose spread scores run
the select's radix passes. K7 runs on the same arguments on 8 shards, as
the mesh route solves that wave. K4 is split on chip_smoke.py's placing
case (kernel_checks' first dense problem: Np 10240, 80 groups, spread
scores), where its tree runs K4 on K5's kernel template (solve_dense.cu
solve_placement_kernel): the row prefetch wait, the scoring, the select
and the row writes (the apply of each node's take into the assignment
row and the slice's usage).

Two designs are recognised from the sources:
  * the pick loop (solve_dense.cu's waterfill, solve_sharded.cu's
    gathered_waterfill_kernel before the radix select): per group, phase
    1's scoring, its picks, phase 2's scoring, its picks and phase 2's
    victim accounting, with the picks counted;
  * the unit-weighted radix select (solve_common.cuh cluster_waterfill):
    the row prefetch wait, phase 1's scoring, its select passes, its
    apply, the same for phase 2, with the passes and the waterfills that
    took the shortcut counted.
Thread 0 of block 0 (the cluster's leader) reads the clock after the
block's barriers, so a phase ends when its slowest thread does. For K7
the counters cover the waterfill kernel (per launch, summed), and
torch.profiler splits the device time by kernel.

It prints one JSON line: cycles and share per phase, the counts, each
solve's device time with and without the counters (CUDA events over
back-to-back calls), and the card's name and power limit. Needs one card
and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

# thread 0 of blocks 0 and 1 (the cluster's leader and one other block),
# each into its own 32 slots
PRELUDE = """
static __device__ unsigned long long g_prof[64];
static __device__ long long g_tmark[2];
#define PROF_ON (threadIdx.x == 0 && blockIdx.x < 2)
#define PROF_MARK() do { if (PROF_ON) g_tmark[blockIdx.x] = clock64(); } \\
    while (0)
#define PROF(slot) do { if (PROF_ON) { const long long n_ = clock64(); \\
    g_prof[blockIdx.x * 32 + (slot)] += n_ - g_tmark[blockIdx.x]; \\
    g_tmark[blockIdx.x] = n_; } } while (0)
#define PROF_COUNT(slot, n) do { if (PROF_ON) \\
    g_prof[blockIdx.x * 32 + (slot)] += (n); } while (0)
"""
READER = """
extern "C" int nomad_prof_read_{tu}(unsigned long long* out, int reset) {{
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  if (reset) {{
    unsigned long long z[64] = {{0}};
    cudaMemcpyToSymbol(g_prof, z, sizeof(z));
  }}
  return (int)e;
}}
"""

# K5's slots (solve_dense.cu) and K7's waterfill slots (solve_sharded.cu)
K5_PHASES = {0: "prefetch_wait", 1: "score1", 2: "waterfill1", 3: "apply1",
             4: "score2", 5: "waterfill2", 6: "apply2"}
K7_PHASES = {16: "load", 17: "waterfill", 18: "apply"}
# K4 runs K5's kernel template without phase 2, so phase 1's slots
K4_PHASES = {0: "prefetch_wait", 1: "score", 2: "select", 3: "row_writes"}
K5_COUNTS = {10: "picks_or_rounds", 11: "waterfills", 12: "shortcuts"}
PASS_PARTS = {28: "round0", 24: "bins", 25: "push", 26: "barrier1",
              27: "leader_scan", 29: "barrier2"}
K7_COUNTS = {19: "picks_or_rounds", 20: "launches", 21: "shortcuts"}

# (anchor, text inserted before it, text inserted after it), per file
PICK_LOOP = {
    "solve_common.cuh": [("#include <stdint.h>\n", "", PRELUDE)],
    "solve_dense.cu": [
        ("  if (tid == 0) sh.remaining = count;\n", "",
         "  PROF_COUNT(11, 1);\n"),
        ("    if (bi == kNoNode) break;\n", "", "    PROF_COUNT(10, 1);\n"),
        ("  for (int g = 0; g < a.gp; ++g) {\n", "  PROF_MARK();\n", ""),
        ("    const int rem = waterfill(a, sh, my_s, my_i, count, a.take1, "
         "ask, true);\n", "    __syncthreads();\n    PROF(1);\n",
         "    PROF(2);\n"),
        ("      waterfill(a, sh, my_s, my_i, rem, erow, ask, false);\n",
         "      __syncthreads();\n      PROF(4);\n", "      PROF(5);\n"),
        ("        arow[n] = wrap_add(a.take1[n], t2);\n      }\n", "",
         "      __syncthreads();\n      PROF(6);\n"),
        ("      for (int n = tid; n < np; n += kThreads) arow[n] = "
         "a.take1[n];\n", "", "      __syncthreads();\n      PROF(3);\n"),
    ],
    "solve_sharded.cu": [
        ("gathered_waterfill_kernel(WaterArgs a) {\n", "",
         "  PROF_MARK();\n  PROF_COUNT(20, 1);\n"),
        ("  if (tid == 0) remaining = count;\n  __syncthreads();\n"
         "  int rem = count;\n", "", "  PROF(16);\n"),
        ("    if (bi == kNoNode) break;\n", "", "    PROF_COUNT(19, 1);\n"),
        ("  // phase 1's remainder: count minus the whole mesh's takes",
         "  PROF(17);\n", ""),
    ],
}

# the select's phase slot and count slot, set by the caller before a call
SELECT_PRELUDE = PRELUDE + """
static __device__ int g_sel[2];
#define PROF_SET(sel, cnt) do { if (PROF_ON) { g_sel[0] = (sel); \\
    g_sel[1] = (cnt); } } while (0)
"""
RADIX_SELECT = {
    "solve_common.cuh": [
        ("#include <stdint.h>\n", "", SELECT_PRELUDE),
        ("  __syncthreads();  // the block's sc/un are written\n", "",
         "  PROF_COUNT(g_sel[1] + 1, 1);\n"),
        # rounds, shortcuts and all-tied selects (slot 30); inside a
        # radix pass: the block's bins, its push, the first cluster
        # barrier, the leader's scan, the second barrier
        ("  share_part(ws, parity, block_total, lo_b, hi_b);\n", "",
         "  PROF(28);\n"),
        ("  for (int p = start; p < 4 && mode == kSelRun; ++p) {\n",
         "  PROF_COUNT(g_sel[1], 1);\n"
         "  if (mode == kSelCut) PROF_COUNT(g_sel[1] + 2, 1);\n"
         "  if (mode == kSelTie) PROF_COUNT(30, 1);\n", ""),
        ("      warp_bin_add(ws.local, d, w);\n    }\n    __syncthreads();\n", "",
         "    PROF(24);\n"),
        ("    cluster.sync();  // every block's bins are in the leader's\n",
         "    PROF(25);\n", "    PROF(26);\n"),
        ("    cluster.sync();  // the outcome is in every block\n",
         "    PROF(27);\n", "    PROF(29);\n    PROF_COUNT(g_sel[1], 1);\n"),
        ("    share_part(ws, parity, tied_total, 0, 0);\n", "",
         "    PROF_COUNT(g_sel[1], 1);\n"),
        ("  for (int l = l0; l < l1; ++l) {\n    const int u = un[l];\n",
         "  PROF(g_sel[0]);\n", ""),
    ],
    "solve_dense.cu": [
        ("  if (kSmem) prefetch(0, 0);\n", "", "  PROF_MARK();\n"),
        ("      __syncthreads();  // group g's rows are in; group g-1's buffer "
         "is free\n", "", "      PROF(0);\n"),
        ("    const long long placed1 = cluster_waterfill(",
         "    __syncthreads();\n    PROF(1);\n    PROF_SET(2, 10);\n", ""),
        ("    const int rem = count - (int)placed1;\n", "    PROF(3);\n", ""),
        ("      cluster_waterfill(ws, rounds, sc, un, n_loc, rem, [&](int l, "
         "int t2) {\n", "      __syncthreads();\n      PROF(4);\n"
         "      PROF_SET(5, 10);\n", ""),
        ("        erow[l] = t2;\n        arow[l] = wrap_add(take1[l], t2);\n"
         "      });\n", "", "      PROF(6);\n"),
        ("        erow[l] = 0;\n        arow[l] = take1[l];\n      }\n", "",
         "      PROF(3);\n"),
    ],
    "solve_sharded.cu": [
        ("  waterfill_init(ws);\n  const int g = a.g;\n", "  PROF_MARK();\n",
         ""),
        ("  int rounds = 0;\n  const long long placed = cluster_waterfill(",
         "  PROF(16);\n  PROF_SET(17, 19);\n", ""),
        ("  // phase 1's remainder: count minus the whole mesh's takes (the\n",
         "  PROF(18);\n", ""),
    ],
}

DESIGNS = {"pick_loop": PICK_LOOP, "radix_select": RADIX_SELECT}


def design_of(csrc: Path) -> str:
    common = (csrc / "solve_common.cuh").read_text()
    return "radix_select" if "cluster_waterfill(" in common else "pick_loop"


def instrument(src_dir: Path, dst_dir: Path, marks: dict) -> None:
    shutil.copytree(src_dir, dst_dir)
    for name, edits in marks.items():
        path = dst_dir / name
        text = path.read_text()
        for anchor, before, after in edits:
            if text.count(anchor) != 1:
                raise SystemExit(f"{name}: anchor not found once: {anchor!r}")
            text = text.replace(anchor, before + anchor + after)
        tu = {"solve_dense.cu": "dense", "solve_sharded.cu": "sharded"}.get(name)
        if tu:
            text += READER.format(tu=tu)
        path.write_text(text)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", type=Path, default=ROOT,
                        help="an unpacked checkout holding the kernels to split")
    parser.add_argument("--case", choices=("wave", "random"), default="wave")
    opts = parser.parse_args()
    tree = opts.tree.resolve()
    # the tree's package, and this checkout's chip_smoke for its fleet
    sys.path[:0] = [str(tree), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("chip_preempt_split: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke
    from nomad_tpu_torch.scheduler.gpu import kernels as tk
    from nomad_tpu_torch.scheduler.gpu import libkernels as lk
    from nomad_tpu_torch.scheduler.gpu import solver as solver_mod

    csrc = tree / "nomad_tpu_torch" / "csrc"
    design = design_of(csrc)

    if opts.case == "wave":
        # the preempt wave's K5 call, recorded on the card
        rec = chip_smoke.Recorder(solver_mod, "solve_placement_preempt")
        try:
            chip_smoke.preempt_scenario("cuda", 10000, chip_smoke.C2M_FILLS,
                                        (20, 1000, True))
        finally:
            rec.restore()
        args = rec.first[0]
    else:
        _, arrays = chip_smoke.dense_problem(np.random.default_rng(0))
        args = [torch.from_numpy(a).to("cuda") for a in arrays]
    want = tk.solve_placement_preempt_plain(*args)
    # K4 on K5's template: chip_smoke.kernel_checks' placing case, its first
    # dense problem, drawn after the compact cases
    dense_src = (csrc / "solve_dense.cu").read_text()
    k4_split = "solve_placement_kernel" in dense_src
    rng = np.random.default_rng(0)
    chip_smoke.compact_cases(rng)
    k4_args = [torch.from_numpy(a).to("cuda")
               for a in chip_smoke.dense_problem(rng, tiers=2)[0]]
    k4_want = tk.solve_placement_plain(*k4_args)

    def k4():
        return tk.solve_placement(*k4_args)

    def k5():
        return tk.solve_placement_preempt(*args)

    def k7():
        return tk.sharded_solver_preempt(*args, n_shards=8)

    graphs = getattr(tk.sharded_solver_preempt, "graphs", None)

    def use(lib_csrc: Path, build: Path):
        lk.CSRC, lk.BUILD_DIR, lk._lib = lib_csrc, build, None
        if graphs is not None:
            graphs.clear()  # a cached graph holds the other library's kernels
        return lk.library()

    out = {"tree": str(tree), "design": design, "case": opts.case}
    with tempfile.TemporaryDirectory() as tmp:
        clocked_src = Path(tmp) / "csrc"
        instrument(csrc, clocked_src, DESIGNS[design])
        dll = use(clocked_src, Path(tmp) / "build")
        p, i = ctypes.c_void_p, ctypes.c_int
        readers = {}
        for tu in ("dense", "sharded"):
            fn = getattr(dll, f"nomad_prof_read_{tu}")
            fn.argtypes, fn.restype = [p, i], i
            readers[tu] = fn
        prof = (ctypes.c_ulonglong * 64)()

        def counters(tu: str, fn, ref=want) -> list:
            readers[tu](prof, 1)
            got = fn()
            torch.cuda.synchronize()
            same = all(torch.equal(g, w) for g, w in zip(got, ref))
            if not same:
                raise SystemExit(f"instrumented {tu} solve differs from "
                                 "its twin")
            readers[tu](prof, 1)
            return list(prof)

        fn_k7 = k7  # its first call may capture a graph: run it once first
        fn_k7()
        torch.cuda.synchronize()
        c5 = counters("dense", k5)
        c7 = counters("sharded", fn_k7)
        c4 = counters("dense", k4, k4_want) if k4_split else None
        times = {"k5_clocked": chip_smoke.device_ms(k5, 10)[0],
                 "k7_clocked": chip_smoke.device_ms(k7, 1)[0],
                 "k4_clocked": chip_smoke.device_ms(k4, 10)[0]}
        use(csrc, tree / "nomad_tpu_torch" / "_build")
        k7()
        torch.cuda.synchronize()
        times["k5"], times["k5_enqueue"] = chip_smoke.device_ms(k5, 10)
        times["k7"], times["k7_enqueue"] = chip_smoke.device_ms(k7, 1)
        times["k4"], times["k4_enqueue"] = chip_smoke.device_ms(k4, 10)
        out["k7_kernel_split_ms"] = chip_smoke.device_split_ms(k7)

    counts = args[4]
    live = int((counts > 0).sum())
    for name, c, phases, cnt in (("k5", c5, K5_PHASES, K5_COUNTS),
                                 ("k7", c7, K7_PHASES, K7_COUNTS)):
        # a select's pass parts are cut out of its phase's cycles
        parts = {v: c[k] for k, v in PASS_PARTS.items()}
        cycles = {v: c[k] for k, v in phases.items()}
        total = sum(cycles.values()) + sum(parts.values())
        n = c[10 if name == "k5" else 19]
        sel = (cycles.get("waterfill1", 0) + cycles.get("waterfill2", 0)
               + cycles.get("waterfill", 0) + sum(parts.values()))
        out[name] = {
            "cycles": cycles, "pass_parts": parts, "cycles_total": total,
            "share": {k: v / max(total, 1) for k, v in cycles.items()},
            **{v: c[k] for k, v in cnt.items()}, "all_tied": c[30],
            "cycles_per_live_group": total / max(live, 1),
            "cycles_per_pick_or_round": sel / max(n, 1),
            "pass_parts_per_round": {k: v / max(n, 1)
                                    for k, v in parts.items()},
            # thread 0 of block 1 (the radix select's kernels only)
            "block1": {**{v: c[32 + k] for k, v in phases.items()},
                       **{v: c[32 + k] for k, v in PASS_PARTS.items()}},
        }
    out["k4"] = None
    if c4 is not None:
        parts = {v: c4[k] for k, v in PASS_PARTS.items()}
        cycles = {v: c4[k] for k, v in K4_PHASES.items()}
        total = sum(cycles.values()) + sum(parts.values())
        k4_live = int((k4_args[3] > 0).sum())
        out["k4"] = {
            "cycles": cycles, "pass_parts": parts, "cycles_total": total,
            "share": {k: v / max(total, 1)
                      for k, v in {**cycles, **parts}.items()},
            **{v: c4[k] for k, v in K5_COUNTS.items()}, "all_tied": c4[30],
            "live_groups": k4_live,
            "cycles_per_live_group": total / max(k4_live, 1),
            "cycles_per_round": (cycles["select"] + sum(parts.values()))
            / max(c4[10], 1),
            "pass_parts_per_round": {k: v / max(c4[10], 1)
                                    for k, v in parts.items()},
            "placed": int(k4_want[0].sum()),
            "launch": tk.solve_placement.last_launch,
        }
    out["device_ms"] = times
    out["k5_launch"] = getattr(tk.solve_placement_preempt, "last_launch", None)
    out["k7_route"] = getattr(tk.sharded_solver_preempt, "last_route", None)
    out["live_groups"] = live
    out["shape"] = {"np": args[0].shape[0], "gp": args[3].shape[0],
                    "tp": args[2].shape[0]}
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
