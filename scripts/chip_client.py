#!/usr/bin/env python3
"""The client phase of chip_smoke.py alone, on one card.

    python3 scripts/chip_client.py [--per-node N]

Builds the kernel library, then runs chip_smoke.py's `client` phase
(client_scenario at CLIENT: a server agent with a co-located client and
three client agents joined over the fabric, c2m's fleet beside their four
real nodes, c2m's job at C2M's density on the real nodes through the
CLI, process tasks given the card, a drain, a client agent's restart
with its tasks left running, a stop) with the launch counters zeroed
around it and every check of the phase, replays its K1 and K2 calls
against their twins, then client_lockstep at CLIENT_SMALL on the card and
on the CPU twins. --per-node asks for fewer allocs a real node than
C2M's 330 (a quick first run). Prints the card's name and power limit,
one JSON line per step and phase, the K1 shapes, and {"ok": true} last.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--per-node", type=int, default=None)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_client: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from nomad_tpu_torch import trace
    from nomad_tpu_torch.scheduler.gpu import libkernels

    def on_step(name, seconds, **kw):
        print(json.dumps({"phase": name, "seconds": seconds, **kw},
                         default=str), flush=True)

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    libkernels.library()
    cs.phase("build", t0)
    cfg = dict(cs.CLIENT)
    if args.per_node:
        cfg["per_node"] = args.per_node
    t0 = time.perf_counter()
    rec = cs.client_recorders()
    trace.set_enabled(True)
    try:
        res = cs.client_scenario("cuda", cfg, on_step)
    finally:
        trace.set_enabled(False)
        for r in reversed(list(rec.values())):
            r.restore()
    cs.check(all(t.is_cuda for r in rec.values() for t in r.tensors),
             "a tensor of the client path is on the host")
    cs.check_client_run(res)
    cs.phase("client", t0, launches=res["launches"], syncs=res["syncs"],
             k1_shapes=sorted(set(rec["solve_placement_compact"].shapes)),
             peak_threads=res["peak_threads"],
             peak_rss_mb=res["peak_rss_mb"], shutdown_s=res["shutdown_s"])
    held = cs.replay_server({k: r for k, r in rec.items()
                             if res["launches"][k] > 0}, res["launches"])
    print(json.dumps({"held": held}, default=str), flush=True)
    t0 = time.perf_counter()
    nodes = cs.c2m_nodes(cs.CLIENT_SMALL["nodes"])
    gpu = cs.client_small("cuda", nodes)
    cpu = cs.client_small("cpu", nodes)
    for key in gpu:
        cs.check(gpu[key] == cpu[key],
                 f"client: card and CPU twins differ in {key}")
    cs.check(res["restart_outcome"] == gpu["restart_outcome"],
             "client: the restarted agent's mock allocs differ from "
             "client_lockstep's")
    cs.phase("small.client", t0, allocs_compared=len(gpu["steps"]["stop"]),
             reads_compared=len(gpu["reads"]))
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
