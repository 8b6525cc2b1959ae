"""Run one cell of BENCHMARK.json once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the card, the kernel library, the fleet, the fill, a
warm-up of the cell's own traffic) is timed as setup_s; then the cell's
traffic runs for --seconds through the port's Server; the evals due in
the window are followed to their end; the committed end state is held
against the plain reference (portbench/reference/); and the last line
of standard output is one JSON object. With --trace 1 the window runs
under torch.profiler and the program's tracing, and the line carries
the per-layer metrics instead of the end-to-end ones.

Exits non-zero, printing no result, without a CUDA card, with fewer
cards than the cell asks for, or when the JAX package or JAX was
loaded.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# compared by whole top-level module name: nomad_tpu_torch is the
# program; nomad_tpu is the JAX package it was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "nomad_tpu")
# the server's knobs that its environment can move; the benchmark runs
# the server on its defaults
SERVER_ENV = ("NOMAD_TPU_LANE_PRIORITY", "NOMAD_TPU_MICRO_NG",
              "NOMAD_TPU_MESH_DEVICES", "NOMAD_TPU_NO_FASTPACK")
# build and kernel caches: fixed directories inside the checkout
CACHE = ROOT / ".portbench_cache"
# the batch worker's traces: one a mega-batch, one an interactive solve
BATCH_TRACES = ("tpu.batch", "tpu.interactive")


def forbidden_modules() -> list:
    loaded = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN))


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _wait_ended(system, eval_ids, timeout_s: float) -> None:
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        if all(e in system.watch.done for e in eval_ids if e):
            return
        time.sleep(0.02)
    raise RuntimeError(f"set-up evals still running after {timeout_s} s")


def short_jobs(jobs: dict, want: dict, allocs) -> set:
    """Jobs held to FULL that hold fewer live allocs than they ask."""
    from portbench.reference.check import FULL

    live: dict = {}
    for k in range(len(allocs)):
        if allocs.desired_status[k] == "run":
            live[allocs.job_id[k]] = live.get(allocs.job_id[k], 0) + 1
    return {j for j, w in want.items()
            if w == FULL and live.get(j, 0) < jobs[j].count}


class Context:
    """What a traffic loop (loops/<kind>.py) drives: the system, the
    driver that sends and records its calls, fresh(), which names and
    shapes each new job from the configuration, and wait(), which waits
    out set-up's evals."""

    def __init__(self, system, driver, job: dict) -> None:
        import itertools

        from portbench import inputs

        self.system = system
        self.driver = driver
        counter = itertools.count()
        self.fresh = lambda: inputs.job_spec(
            job, f"{job['prefix']}-{next(counter)}")

    def wait(self, eval_ids, timeout_s: float = 600) -> None:
        _wait_ended(self.system, eval_ids, timeout_s)


def setup(system, cfg: dict, fleet) -> dict:
    """The fleet and the fill; returns {job id: spec} for the fill."""
    from portbench import inputs

    system.register_fleet(fleet)
    fill = inputs.fill_specs(cfg.get("fill", []))
    system.commit_fill(fleet, inputs.fill_layout(fleet, fill))
    return {s.id: s for s in fill}


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             traced: bool, device: str = "cuda", shrink: dict = None,
             fault=None) -> dict:
    """One run of one cell: returns the result line's object.

    shrink ({"config": {...}, "traffic": {...}}) overrides parts of the
    cell's files, and fault(system) is called once set-up is done: both
    for tests and for the control's planted faults."""
    import numpy as np
    import torch

    from portbench import inputs, manifest
    from portbench.driver import Driver
    from portbench.reference.check import AT_MOST, FULL, SERVED, STOPPED
    from portbench.reference.check import judge

    c = manifest.cell(bench, workload)
    cfg, mix_doc = c["config"], c["traffic"]
    if shrink:
        cfg = _merge(cfg, shrink.get("config", {}))
        mix_doc = _merge(mix_doc, shrink.get("traffic", {}))
    loop = manifest.loop(mix_doc)
    params = loop.parse(mix_doc)
    rng = np.random.default_rng(seed)
    fleet = inputs.make_fleet(cfg["fleet"], rng)

    from nomad_tpu_torch import trace as ptrace
    from nomad_tpu_torch.scheduler.gpu import solver as solver_mod
    from portbench.port import System, metrics_snapshot, to_job

    system = System(device, float(cfg.get("clients", {}).get(
        "report_s", 1.0)))
    fill = setup(system, cfg, fleet)
    system.clients.start()
    drv = Driver(system, to_job)
    ctx = Context(system, drv, cfg["job"])
    live = loop.warm(ctx, params)
    system.wait_quiet(600)
    system.freeze()
    undo = fault(system) if fault is not None else None
    while not system.watch.ends.empty():
        system.watch.ends.get()
    if device.startswith("cuda"):
        torch.cuda.synchronize()

    rec = {}
    prof = recorder = None
    if traced:
        from portbench.devtrace import DeviceTrace
        from portbench.roofline import LaunchRecorder

        ptrace.clear_finished()
        ptrace.set_enabled(True)
        recorder = LaunchRecorder(solver_mod)
        if device.startswith("cuda"):
            prof = DeviceTrace().__enter__()
            prof.mark()
    n_warm = len(drv.calls)
    m0 = metrics_snapshot()
    mono0 = time.monotonic_ns()
    t0 = time.perf_counter()
    rec["setup_s"] = t0 - _T0
    loop.window(ctx, params, live, t0 + seconds)
    left = t0 + seconds - time.perf_counter()
    if left > 0:
        time.sleep(left)
    t1 = time.perf_counter()
    mono1 = time.monotonic_ns()
    rec["m1"] = metrics_snapshot()
    rec["m0"] = m0
    window_calls = drv.calls[n_warm:]
    if traced:
        if prof is not None:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
        recorder.restore()
        ptrace.set_enabled(False)

    drv.drain(window_calls, params.drain_s)
    rec["drain_end"] = time.perf_counter()
    system.clients.stop()
    system.wait_quiet(max(1.0, t1 + params.drain_s - time.perf_counter()))
    peak = (torch.cuda.max_memory_allocated(torch.device(device))
            if device.startswith("cuda") else 0)

    rec.update(t0=t0, window_s=t1 - t0, calls=window_calls,
               ended=dict(system.watch.done))
    allocs = system.allocs()
    jobs = dict(fill)
    want = {j: AT_MOST for j in fill}
    for j, s in drv.specs.items():
        jobs[j] = s
        want[j] = (SERVED if j in drv.served
                   else STOPPED if j in drv.stopped else FULL)
    numbers = judge(fleet, jobs, want, allocs)
    numbers["evals_incomplete"] = sum(
        1 for call in window_calls
        if call.eval_id and call.eval_id not in rec["ended"])
    if any(numbers[k] > v for k, v in c["limits"].items()):
        short = sorted(short_jobs(jobs, want, allocs))
        print("portbench: diagnosis " + json.dumps(system.diagnose(short)),
              file=sys.stderr)
    print(f"portbench: window {len(window_calls)} calls, "
          f"{system.clients.reported} stops reported by the clients, "
          f"{sum(1 for d in allocs.desired_status if d == 'evict')} "
          f"evictions in the store", file=sys.stderr)
    if traced:
        from portbench import devtrace

        ops = devtrace.clip(prof.ops if prof else [], mono0, mono1)
        busy = devtrace.busy_intervals(ops)
        spans = [(sp.name, sp.start_ns, sp.end_ns)
                 for t in ptrace.finished_traces() if t.name in BATCH_TRACES
                 for sp in t.spans[1:]
                 if sp.end_ns and sp.start_ns < mono1 and sp.end_ns > mono0]
        rec["spans"] = spans
        if prof is not None:
            rec["device"] = {"ops": ops,
                             "busy_ns": sum(e - s for s, e in busy),
                             "window_ns": mono1 - mono0}
        rec["bounds"] = recorder.bounds()
        rec["breakdown"] = {
            "device_ops": devtrace.top_ops(ops),
            "idle_gaps": devtrace.idle_gaps(busy, mono0, mono1, spans),
        }
    system.shutdown()
    if undo is not None:
        undo()

    metrics = {}
    for m in (c["per_layer"] if traced else c["end_to_end"]):
        kind = "layers" if traced else "e2e"
        value = manifest.reader(kind, m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = sum(
        1 for call in window_calls
        if call.error or rec["ended"].get(call.eval_id, (0, ""))[1]
        != "complete")
    checks = {name: {"value": numbers[name], "limit": limit}
              for name, limit in c["limits"].items()}
    out = {
        "correct": all(v["value"] <= v["limit"] for v in checks.values()),
        "attempted": len(window_calls),
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.startswith("cuda") else device,
            "kind": (torch.cuda.get_device_name(torch.device(device))
                     if device.startswith("cuda") else "cpu"),
            "count": int(c["workload"]["chips"]),
            "memory_peak_bytes": int(peak),
        },
    }
    if traced:
        dev = rec.get("device", {"busy_ns": 0, "window_ns": mono1 - mono0})
        out["device"]["busy_s"] = dev["busy_ns"] / 1e9
        out["device"]["window_s"] = dev["window_ns"] / 1e9
        out["breakdown"] = rec["breakdown"]
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var in SERVER_ENV:
        os.environ.pop(var, None)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")

    from portbench import manifest

    bench = manifest.load()
    chips = int(manifest.cell(bench, args.workload)["workload"]["chips"])
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA card; the benchmark runs only on one",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {bad}: the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    for name, v in out["checks"].items():
        print(f"check {name} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
