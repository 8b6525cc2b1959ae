#!/usr/bin/env python3
"""Where the compact solve (K1) spends its time on the card, from
clock64() counters in an instrumented copy of its source.

    python3 scripts/chip_k1_split.py [--tree DIR]

DIR is an unpacked checkout (default: this one). For the single-block
K1 of commit 8e0d569 (`git archive 8e0d569 | tar -x -C DIR`) it splits
each group into the scoring pass, the pick loop and the node-order
emission; for the cluster K1 (csrc/solve_compact.cu with
cluster_select) into the prefetch wait, scoring, the warps' selection,
the block merge, the two cluster barriers, the leader's merge, the
consumption between rounds and the emission. Thread 0 of the leader
block (the one block of the single-block kernel) reads the clock after the
block's barriers, so each phase ends when its slowest thread does.

The copy is built with the port's nvcc flags into its own library and
run on c2m's wave-1 call: 10,000 nodes, 100 jobs x 1,000 allocs with the
kernel.name constraint and the datacenter spread, its K1 arguments
recorded from the port's solver on the CPU. It prints one JSON line: the
cycles and share of each phase, the selection rounds or picks made, and
the kernel's device time with and without the counters (CUDA events
over 10 launches). Needs one card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from nomad_tpu_torch import mock  # noqa: E402
from nomad_tpu_torch.scheduler import SchedulerConfig  # noqa: E402
from nomad_tpu_torch.scheduler import gpu  # noqa: E402
from nomad_tpu_torch.scheduler.gpu import kernels as tk  # noqa: E402
from nomad_tpu_torch.scheduler.gpu import libkernels  # noqa: E402
from nomad_tpu_torch.scheduler.gpu import solver as solver_mod  # noqa: E402

# the single-block kernel (commit 8e0d569): (anchor, text inserted after it)
MARKS = [
    ("solve_compact_kernel(Args a) {\n",
     "  const long long t_kernel = clock64();\n"),
    ("  for (int g = 0; g < a.gp; ++g) {\n",
     "    long long t_mark = clock64();\n"),
    ("      if (tid == 0) remaining = count;\n      __syncthreads();\n",
     "      if (tid == 0) { const long long t = clock64();"
     " g_prof[0] += t - t_mark; t_mark = t; }\n"),
    ("        if (bs == -INFINITY) break;\n",
     "        if (tid == 0) g_prof[3] += 1;\n"),
    ("    __syncthreads();\n    // 4. instances",
     "\n    if (tid == 0) { const long long t = clock64();"
     " g_prof[1] += t - t_mark; t_mark = t; }\n    // 4. instances"),
    ("      row[p] = -1;\n    __syncthreads();\n",
     "    if (tid == 0) g_prof[2] += clock64() - t_mark;\n"),
]
TAIL = """
extern "C" int nomad_prof_read(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  if (reset) {
    unsigned long long z[6] = {0, 0, 0, 0, 0, 0};
    cudaMemcpyToSymbol(g_prof, z, sizeof(z));
  }
  return (int)e;
}
"""


# the cluster kernel: file -> [(anchor, text inserted before, after)];
# PROF(slot) adds the cycles since the previous mark to g_prof[slot]
PHASES = ["prefetch_wait", "score", "warp_select", "block_merge",
          "push_and_cluster_sync1", "leader_merge", "cluster_sync2",
          "own_takes", "record", "sync_and_emission"]
PRELUDE = """
__device__ unsigned long long g_prof[16 * 16];
__device__ long long g_tmark[16];
#define PROF_ON (threadIdx.x == 0)
#define PROF_RANK (cooperative_groups::this_cluster().block_rank())
#define PROF(slot) do { if (PROF_ON) { const long long n_ = clock64(); \\
    g_prof[PROF_RANK * 16 + (slot)] += n_ - g_tmark[PROF_RANK]; \\
    g_tmark[PROF_RANK] = n_; } } while (0)
"""
CLUSTER_MARKS = {
    "solve_common.cuh": [
        ("#include <stdint.h>\n", "", PRELUDE),
        ("  warp_select(sc, un, n_loc, idx0, need, kleft, sh.warp_list[warp]);\n"
         "  __syncthreads();\n", "", "  PROF(2);\n"),
        ("      sh.list_trunc = (cov >= need || n >= kleft || exhausted) ? 0 : 1;"
         "\n    }\n  }\n  __syncthreads();\n", "", "  PROF(3);\n"),
        ("    cluster.sync();  // every block's list is in the leader\n", "",
         "    PROF(4);\n"),
        ("    cluster.sync();  // the round's outcome is in every block\n",
         "    PROF(5);\n", "    PROF(6);\n    if (PROF_ON && PROF_RANK == 0) g_prof[10] += 1;\n"),
        ("      if (again) un[c.i - idx0] = 0;\n    }\n    __syncthreads();\n",
         "", "    PROF(7);\n"),
    ],
    "solve_compact.cu": [
        ("  if (kSmem) prefetch(0, 0);\n",
         "  if (PROF_ON) g_tmark[PROF_RANK] = clock64();\n",
         ""),
        ("      __syncthreads();  // group g's rows are in; group g-1's buffer"
         " is free\n", "", "      PROF(0);\n"),
        ("      placed = cluster_select(", "      PROF(1);\n", ""),
        ("      a.total[g] = (int)min(covered, (long long)count);\n    }\n",
         "", "    PROF(8);\n"),
        ("  // used' and the overflow flags", "  PROF(9);\n", ""),
    ],
}


def instrument_cluster(text: str, marks) -> str:
    for anchor, before, after in marks:
        if text.count(anchor) != 1:
            raise SystemExit(f"anchor not found once: {anchor!r}")
        text = text.replace(anchor, before + anchor + after)
    return text


def instrument(src: str) -> str:
    for anchor, add in MARKS:
        if src.count(anchor) != 1:
            raise SystemExit(f"anchor not found once: {anchor!r}")
        if anchor.endswith("// 4. instances"):
            src = src.replace(anchor, anchor[:-len("// 4. instances")]
                              + add.lstrip("\n"))
        else:
            src = src.replace(anchor, anchor + add)
    end = "  // overflow flags"
    src = src.replace(end, "  if (threadIdx.x == 0) g_prof[4] += clock64()"
                      " - t_kernel;\n" + end, 1)
    src = src.replace("namespace {\n",
                      "__device__ unsigned long long g_prof[6];\n"
                      "namespace {\n", 1)
    return src + TAIL


def build(tree: Path, out_dir: Path, clocked: bool, cluster: bool):
    csrc = tree / "nomad_tpu_torch" / "csrc"
    name = "clocked" if clocked else "plain"
    work = out_dir / name
    work.mkdir()
    for f in ("solve_compact.cu", "solve_common.cuh"):
        text = (csrc / f).read_text()
        if clocked and cluster:
            text = instrument_cluster(text, CLUSTER_MARKS[f])
        elif clocked and f == "solve_compact.cu":
            text = instrument(text)
        if clocked and cluster and f == "solve_compact.cu":
            text += TAIL.replace("unsigned long long z[6] = {0, 0, 0, 0, 0, 0};",
                                 "unsigned long long z[256] = {0};")
        (work / f).write_text(text)
    lib = work / "lib.so"
    flags = [f for f in libkernels.NVCC_FLAGS if f != "-Xptxas=-v"]
    subprocess.run([libkernels._nvcc(), *flags, "-shared", "-I", str(work),
                    str(work / "solve_compact.cu"), "-o", str(lib)],
                   check=True)
    dll = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.nomad_solve_compact.argtypes = (
        [p, p, p, p, p, p, p, p, p, i, p, i, i, i, i, p, p, p, p, p, p]
        + ([p] if cluster else []) + [p])
    dll.nomad_solve_compact.restype = i
    if clocked:
        dll.nomad_prof_read.argtypes = [p, i]
        dll.nomad_prof_read.restype = i
    return dll


def wave1_call():
    """K1's arguments on c2m's wave 1, recorded from the CPU solver."""
    rec = chip_smoke.Recorder(solver_mod, "solve_placement_compact")
    try:
        h = chip_smoke.build_c2m(10000)
        jobs = chip_smoke.add_jobs(h, "w1", 100, 1000)
        cfg = SchedulerConfig(small_batch_threshold=0, device="cpu")
        evals = [mock.eval_for_job(j) for j in jobs]
        gpu.solve_eval_batch(h.snapshot(), h, evals, cfg)
    finally:
        rec.restore()
    return rec.first


def launch(dll, args, kw, dev, cluster: bool):
    cap, used, asks, counts, fp, fi, br, bi, ur, ui = args
    np_, gp, maxc = cap.shape[0], asks.shape[0], kw["max_count"]
    k = min(maxc, np_)
    inst = torch.empty((gp, maxc), dtype=torch.int32, device=dev)
    over = torch.empty((np_,), dtype=torch.bool, device=dev)
    used_out = torch.empty((np_, 3), dtype=torch.int32, device=dev)
    score = torch.empty((np_,), dtype=torch.float32, device=dev)
    units = torch.empty((np_,), dtype=torch.int32, device=dev)
    # the single-block kernel's take scratch [np], the cluster kernel's picks
    third = torch.empty((2 * gp * k + 2 * gp if cluster else np_,),
                        dtype=torch.int32, device=dev)
    info = [(ctypes.c_int * 4)()] if cluster else []
    code = dll.nomad_solve_compact(
        cap.data_ptr(), used.data_ptr(), asks.data_ptr(), counts.data_ptr(),
        fp.data_ptr(), fi.data_ptr(), br.data_ptr(), bi.data_ptr(),
        ur.data_ptr(), int(ur.dtype == torch.int16), ui.data_ptr(),
        np_, gp, maxc, k, score.data_ptr(), units.data_ptr(),
        third.data_ptr(), inst.data_ptr(), over.data_ptr(),
        used_out.data_ptr(), *info,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if code:
        raise RuntimeError(f"launch failed: cudaError {code}")
    return inst, over, used_out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", type=Path, default=ROOT,
                        help="an unpacked checkout holding the K1 to split")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_k1_split: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    src = (opts.tree / "nomad_tpu_torch" / "csrc" / "solve_compact.cu")
    cluster = "cluster_select(" in src.read_text()
    args, kw = wave1_call()
    args = [a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]
    with tempfile.TemporaryDirectory() as tmp:
        clocked = build(opts.tree, Path(tmp), True, cluster)
        plain = build(opts.tree, Path(tmp), False, cluster)
        want = tk.solve_placement_compact_plain(*args, **kw)
        same = True
        for dll in (plain, clocked):
            got = launch(dll, args, kw, dev, cluster)
            torch.cuda.synchronize()
            same &= all(torch.equal(g, w) for g, w in zip(got, want))
        prof = (ctypes.c_ulonglong * 256)()
        clocked.nomad_prof_read(prof, 1)
        launch(clocked, args, kw, dev, cluster)
        torch.cuda.synchronize()
        clocked.nomad_prof_read(prof, 1)
        one = list(prof)
        times = {}
        for name, dll in (("plain", plain), ("clocked", clocked),
                          ("plain_again", plain)):
            times[name] = chip_smoke.device_ms(
                lambda: launch(dll, args, kw, dev, cluster), 10)[0]
    live = int((args[3] > 0).sum())
    if cluster:
        cycles = dict(zip(PHASES, one[:len(PHASES)]))
        # the other blocks' own phases (thread 0 of each), per block
        others = [dict(zip(PHASES, one[16 * b:16 * b + len(PHASES)]))
                  for b in range(1, 16) if any(one[16 * b:16 * b + 16])]
        counts = {"rounds": one[10], "rounds_per_live_group":
                  one[10] / max(live, 1),
                  "other_blocks_max": {k: max(o[k] for o in others)
                                       for k in PHASES} if others else {},
                  "other_blocks_min": {k: min(o[k] for o in others)
                                       for k in PHASES} if others else {}}
    else:
        cycles = {"score": one[0], "picks": one[1], "emission": one[2],
                  "other": one[4] - one[0] - one[1] - one[2]}
        counts = {"picks_made": one[3],
                  "picks_per_live_group": one[3] / max(live, 1),
                  "cycles_per_pick": one[1] / max(one[3], 1)}
    total = sum(cycles.values())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(json.dumps({
        "card": smi, "design": "cluster" if cluster else "single_block",
        "np": args[0].shape[0], "gp": args[2].shape[0],
        "live_groups": live, "max_count": kw["max_count"],
        "equal_to_twin": same, "cycles": cycles, "cycles_total": total,
        "share": {k: v / total for k, v in cycles.items()},
        "cycles_per_live_group": total / max(live, 1), **counts,
        "device_ms": times,
    }), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
