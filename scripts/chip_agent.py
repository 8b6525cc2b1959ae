#!/usr/bin/env python3
"""The agent phase of chip_smoke.py alone, on one card.

    python3 scripts/chip_agent.py

Builds the kernel library, then runs chip_smoke.py's `agent` phase
(agent_scenario at AGENT: one server agent, c2m's fleet over its fabric,
c2m's 100 jobs as HCL through the CLI's `job plan` and `job run`, an
operator's reads over HTTP) with the launch counters zeroed around it
and every check of the phase, replays its first K1 and K2 calls against
their twins, then agent_lockstep at AGENT_SMALL on the card and on the
CPU twins. Prints the card's name and power limit, one JSON line per
phase, the `operator solver status` text, and {"ok": true} last.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_agent: no CUDA device available", file=sys.stderr)
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
    t0 = time.perf_counter()
    arec = cs.server_recorders()
    trace.set_enabled(True)
    try:
        res = cs.agent_scenario("cuda", cs.AGENT, on_step)
    finally:
        trace.set_enabled(False)
        for r in reversed(list(arec.values())):
            r.restore()
    cs.check(all(t.is_cuda for r in arec.values() for t in r.tensors),
             "a tensor of the agent path is on the host")
    cs.check_agent_run(res)
    cs.phase("agent", t0, launches=res["launches"],
             shutdown_s=res["shutdown_s"])
    print(res["solver_text"], flush=True)
    held = cs.replay_server({k: r for k, r in arec.items()
                             if res["launches"][k] > 0}, res["launches"])
    print(json.dumps({"held": held}, default=str), flush=True)
    t0 = time.perf_counter()
    nodes = cs.c2m_nodes(cs.AGENT_SMALL["nodes"])
    gpu = cs.agent_small("cuda", nodes)
    cpu = cs.agent_small("cpu", nodes)
    for key in gpu:
        cs.check(gpu[key] == cpu[key],
                 f"agent: card and CPU twins differ in {key}")
    cs.phase("small.agent", t0, allocs_compared=len(gpu["allocs"]),
             reads_compared=len(gpu["reads"]))
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
