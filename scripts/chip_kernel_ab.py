#!/usr/bin/env python3
"""Device time of K3 and K4 in one checkout, for comparing two commits on
one card.

    python3 scripts/chip_kernel_ab.py [--tree DIR]

DIR is an unpacked checkout (default: this one); its package is the one
imported, built and timed. The inputs are chip_smoke.py's, made from seed
0: K4 (solve_placement) on the placing case (kernel_checks' first dense
problem: Np 10240, 80 groups, spread scores) and on the preempt path's
shape (Np 10240, 16 groups, 10 live, every node full: nothing placed),
and K3 (scatter_add_rows) at the chained c2m wave's shape (Np 10240, 1024
rows, 35 kept, the rest the 1 << 30 pad). Each call is first held equal
to its twin, then timed with chip_smoke.device_ms (device time of calls
queued back to back behind a spin kernel, and the host's enqueue time).
It prints one JSON line with the card's name and power limit. To compare
two commits, run it in turns in one chip call: parent, change, change,
parent. Needs one card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", type=Path, default=ROOT,
                        help="an unpacked checkout holding the kernels")
    opts = parser.parse_args()
    tree = opts.tree.resolve()
    sys.path[:0] = [str(tree), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("chip_kernel_ab: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke
    from nomad_tpu_torch.scheduler.gpu import kernels as tk

    dev = "cuda"
    rng = np.random.default_rng(0)
    chip_smoke.compact_cases(rng)
    placing, _ = chip_smoke.dense_problem(rng, tiers=2)
    full = [a.copy() for a in placing]
    full[1] = full[0].copy()  # every node full: no units anywhere
    for i in (2, 3, 4, 5, 6):
        full[i] = full[i][:16].copy()
    full[3][10:] = 0  # 10 live groups of 16
    n = 10240
    used = rng.integers(0, 9000, (n, 3)).astype(np.int32)
    idx = np.full(1024, 1 << 30, dtype=np.int32)
    idx[:35] = rng.choice(n, 35, replace=False)
    rows = np.zeros((1024, 3), dtype=np.int32)
    rows[:35] = rng.integers(-6000, 6000, (35, 3))

    out = {"tree": str(tree)}
    for name, arrays in (("k4_placing", placing), ("k4_path", full)):
        t = [torch.from_numpy(a).to(dev) for a in arrays]
        got = tk.solve_placement(*t)
        want = tk.solve_placement_plain(*t)
        torch.cuda.synchronize()
        if chip_smoke.max_abs_err(got, want) != 0:
            raise SystemExit(f"{name}: K4 differs from its twin")
        ms, enq = chip_smoke.device_ms(lambda: tk.solve_placement(*t), 10)
        out[name] = {"ms": ms, "enqueue_ms": enq,
                     "placed": int(want[0].sum()),
                     "launch": getattr(tk.solve_placement, "last_launch",
                                       None)}
    u, i, r = (torch.from_numpy(a).to(dev) for a in (used, idx, rows))
    got = tk.scatter_add_rows(u, i, r)
    if not torch.equal(got, tk.scatter_add_rows_plain(u, i, r)):
        raise SystemExit("K3 differs from its twin")
    ms, enq = chip_smoke.device_ms(lambda: tk.scatter_add_rows(u, i, r), 50)
    out["k3"] = {"ms": ms, "enqueue_ms": enq}
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
