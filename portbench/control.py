"""The control of `correct`: the plain placer put in the program's
place, at the cell's own size, with one guarantee broken; and beside
it the same placer with none broken. The control has to come out not
correct under the cell's limits, the sound placer correct.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3

The cell's file (`cells/<cell>.json`) says under "control" how many
registrations to run (`jobs`), which guarantees the control breaks
(`control`, reference/placer.py's breaks), and which single breaks to
read besides (`faults`): each gives the reading above which a number's
limit must sit.

With --faults, whole runs of the cell on the card instead, each with one
fault of faults.py planted in the program, for --seconds:

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 \
        --faults over_evict wrong_tier --seconds 25

The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def ops_for(cfg: dict, mix_doc: dict, jobs: int) -> list:
    """The registrations and deregistrations the placer runs on the
    filled fleet: the cell's loop (loops/<kind>.py's ops) with `jobs`
    registrations in its window."""
    import itertools

    from portbench import inputs, manifest

    job = cfg["job"]
    loop = manifest.loop(mix_doc)
    counter = itertools.count()

    def fresh():
        return inputs.job_spec(job, f"{job['prefix']}-{next(counter)}")

    return loop.ops(loop.parse(mix_doc), fresh, jobs)


def readings(bench: dict, workload: str, seed: int, shrink=None) -> dict:
    """{run name: {"numbers", "correct", "seconds"}} for the sound
    placer, the control (the placer with the cell's `control` breaks)
    and each of the cell's `faults` (one break each)."""
    import numpy as np

    from portbench import inputs, manifest
    from portbench.reference.check import judge
    from portbench.reference.placer import place
    from portbench.run import _merge

    c = manifest.cell(bench, workload)
    cfg, mix_doc = c["config"], c["traffic"]
    control = c["control"]
    if shrink:
        cfg = _merge(cfg, shrink.get("config", {}))
        mix_doc = _merge(mix_doc, shrink.get("traffic", {}))
        control = _merge(control, shrink.get("control", {}))
    fleet = inputs.make_fleet(cfg["fleet"], np.random.default_rng(seed))
    ops = ops_for(cfg, mix_doc, int(control["jobs"]))
    fill = inputs.fill_layout(fleet,
                              inputs.fill_specs(cfg.get("fill", [])))
    # the plain placer never preempts: on a filled fleet the sound run
    # is the fill alone
    sound_ops = [] if fill else ops
    runs = [("sound", sound_ops, ()), ("control", ops, control["control"])]
    runs += [(f, ops, (f,)) for f in control["faults"]]
    out = {}
    for name, run_ops, breaks in runs:
        t0 = time.perf_counter()
        numbers = judge(fleet, *place(fleet, run_ops, breaks,
                                      int(control.get("stale_batch", 64)),
                                      fill))
        out[name] = {
            "numbers": numbers,
            "correct": all(numbers[k] <= v for k, v in c["limits"].items()
                           if k in numbers),
            "seconds": time.perf_counter() - t0,
        }
    return out


def planted(bench: dict, workload: str, seed: int, fault: str,
            seconds: float, device: str = "cuda", shrink=None) -> dict:
    """A whole run of the cell with one fault of faults.py planted."""
    from portbench.faults import FAULTS
    from portbench.run import run_cell

    t0 = time.perf_counter()
    out = run_cell(bench, workload, seed, seconds, False, device=device,
                   shrink=shrink, fault=FAULTS[fault])
    return {"numbers": {k: v["value"] for k, v in out["checks"].items()},
            "correct": out["correct"], "attempted": out["attempted"],
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", default=None)
    ap.add_argument("--seconds", type=float, default=25.0)
    args = ap.parse_args(argv)
    from portbench import manifest

    bench = manifest.load()
    for seed in args.seeds:
        if args.faults:
            r = {f: planted(bench, args.workload, seed, f, args.seconds)
                 for f in args.faults}
        else:
            r = readings(bench, args.workload, seed)
        print(json.dumps({"workload": args.workload, "seed": seed, **r}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
