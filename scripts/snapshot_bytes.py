#!/usr/bin/env python3
"""StateStore.serialize() bytes and seconds in both packages, beside
the RPC fabric's MAX_FRAME, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/snapshot_bytes.py [--nodes N] [--jobs J]

The port's Server (batch worker on the CPU twins) places J of c2m's jobs
(1,000 allocs of 250 MHz / 128 MB, chip_smoke.make_job) on N of c2m's
nodes; its nodes, jobs and allocs are then written into a fresh
StateStore of each package (nomad_tpu's built from the wire form) and
each store is serialized once: the snapshot a follower would receive in
Raft.install_snapshot. Prints one JSON line per package. This is a CPU
measurement of bytes; its seconds are this host's, not the card's.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def fill(store, nodes, jobs, allocs) -> None:
    index = 1
    for n in nodes:
        store.upsert_node(index, n)
        index += 1
    for j in jobs:
        store.upsert_job(index, j)
        index += 1
    for i in range(0, len(allocs), 1000):
        store.upsert_allocs(index, allocs[i:i + 1000])
        index += 1


def measure(name, store, max_frame) -> dict:
    t0 = time.perf_counter()
    raw = store.serialize()
    return {"package": name, "bytes": len(raw),
            "seconds": time.perf_counter() - t0, "max_frame": max_frame,
            "over_max_frame": len(raw) > max_frame}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=4000)
    ap.add_argument("--jobs", type=int, default=40)
    args = ap.parse_args()
    cs = _chip_smoke()

    from nomad_tpu_torch import codec
    from nomad_tpu_torch.rpc.wire import MAX_FRAME as TFRAME
    from nomad_tpu_torch.state import StateStore as TStore

    srv, _ = cs.start_server("cpu", cs.c2m_nodes(args.nodes),
                             small_batch_threshold=0)
    try:
        cs.register_and_wait(srv, [cs.make_job(f"snap-{j}", 1000)
                                   for j in range(args.jobs)])
        nodes = srv.state.nodes()
        jobs = srv.state.jobs()
        allocs = srv.state.allocs()
    finally:
        srv.shutdown()
    shape = {"nodes": len(nodes), "jobs": len(jobs), "allocs": len(allocs)}
    store = TStore()
    fill(store, [n.copy() for n in nodes], [j.copy() for j in jobs],
         [a.copy() for a in allocs])
    print(json.dumps({**shape, **measure("nomad_tpu_torch", store, TFRAME)}),
          flush=True)
    del store

    from nomad_tpu import codec as jcodec
    from nomad_tpu.rpc.wire import MAX_FRAME as JFRAME
    from nomad_tpu.state import StateStore as JStore

    def ref(objs):
        return [jcodec.from_wire(codec.to_wire(o)) for o in objs]

    store = JStore()
    fill(store, ref(nodes), ref(jobs), ref(allocs))
    print(json.dumps({**shape, **measure("nomad_tpu", store, JFRAME)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
