#!/usr/bin/env python3
"""Raft entry and AppendEntries frame bytes, and the codec's seconds, at
c2m's width, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/raft_frame_bytes.py [--nodes N] [--jobs J] [--backlog K]

The port's Server (batch worker on the CPU twins, batches of 8) places J
of c2m's jobs on N of c2m's nodes; every raft entry it writes is packed
as RaftNode.apply_submit packs it (codec.pack). Then the AppendEntries
request a follower receives is built as RaftNode._replicate_loop builds
it, inside the fabric's envelope, for one plan entry and for a backlog of
K plan entries (what a restarted follower gets in one frame), and is
encoded and decoded as the fabric's frame (codec.pack / unpack: msgpack,
the packed entries as bins). Prints one JSON line. Sizes are exact; seconds are this
host's CPU, not the card machine's.
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


def frame(entries) -> dict:
    return {"id": 1, "method": "Raft.append_entries", "args": {
        "term": 2, "leader_id": "s0", "prev_log_index": 1,
        "prev_log_term": 1, "entries": entries, "leader_commit": 1}}


def codec_times(env) -> dict:
    from nomad_tpu_torch import codec

    t0 = time.perf_counter()
    raw = codec.pack(env)
    t1 = time.perf_counter()
    back = codec.unpack(raw)
    t2 = time.perf_counter()
    t3 = time.perf_counter()
    for e in back["args"]["entries"]:
        codec.unpack(e[3])
    return {"frame_bytes": len(raw), "encode_s": t1 - t0,
            "decode_s": t2 - t1, "entries_unpack_s": time.perf_counter() - t3}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=10000)
    ap.add_argument("--jobs", type=int, default=16)
    ap.add_argument("--backlog", type=int, default=13)
    args = ap.parse_args()
    cs = _chip_smoke()
    from nomad_tpu_torch import codec
    from nomad_tpu_torch.rpc.wire import MAX_FRAME

    srv, _ = cs.start_server("cpu", cs.c2m_nodes(args.nodes))
    packed = []
    real_apply, real_async = srv.log.apply, srv.log.apply_async

    def pack(msg_type, payload):
        t0 = time.perf_counter()
        raw = codec.pack(payload)
        packed.append((msg_type, raw, time.perf_counter() - t0))

    def apply(msg_type, payload):
        pack(msg_type, payload)
        return real_apply(msg_type, payload)

    def apply_async(msg_type, payload):
        pack(msg_type, payload)
        return real_async(msg_type, payload)

    srv.log.apply, srv.log.apply_async = apply, apply_async
    try:
        cs.register_and_wait(srv, [cs.make_job(f"frame-{j}", 1000)
                                   for j in range(args.jobs)])
    finally:
        srv.shutdown()
    plans = [(m, r, s) for m, r, s in packed if m.startswith("apply_plan")]
    raws = [r for _, r, _ in plans]
    backlog = [raws[i % len(raws)] for i in range(args.backlog)]

    def entries(rs):
        return [(2 + i, 2, "apply_plan_results_batch", r)
                for i, r in enumerate(rs)]

    out = {
        "nodes": args.nodes, "jobs": args.jobs,
        "plan_entries": len(plans),
        "plan_entry_bytes": [len(r) for r in raws],
        "plan_pack_s": [s for _, _, s in plans],
        "one_entry": codec_times(frame(entries(raws[:1]))),
        "backlog": dict(codec_times(frame(entries(backlog))),
                        entries=len(backlog),
                        payload_bytes=sum(map(len, backlog))),
        "max_frame": MAX_FRAME,
        "append_entries_timeout_s": 2.0,
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
