"""Finds what a cell is made of, by the names in BENCHMARK.json.

- configuration `<c>`: `configs/<c>.json`, the `file` its entry names;
- traffic mix `<t>`: `traffic/<t>.json`, whose `loop` names the
  generator that offers it, `loops/<loop>.py` (`parse`, `warm`,
  `window`, `ops`): a mix of a kind already there is data alone;
- cell `<w>`: the limits its `correct` holds it to, `cells/<w>.json`;
- metric `<m>`: a reader module, `e2e/<m>.py` for an end-to-end metric
  and `layers/<m>.py` for a per-layer one; where that file is missing,
  the reader of the name's first part (`layers/broker_wait_ms.py` reads
  `broker_wait_ms.backlog` and `broker_wait_ms.burst`). A reader's
  `read(rec)` returns the metric's value, or None where the window had
  nothing to read.

Adding a configuration, a mix, a cell or a metric adds files and
entries; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def read_json(rel: str) -> dict:
    with open(ROOT / rel) as f:
        return json.load(f)


def cell(bench: dict, workload: str) -> dict:
    """Everything one cell runs with: its entry, configuration, mix,
    limits, control and the metrics it reports with and without a
    trace."""
    w = _by_name(bench["workloads"], workload, "workload")
    c = _by_name(bench["configs"], w["config"], "config")

    def applies(m):
        return workload in m.get("workloads", [workload])

    own = read_json(f"{HERE.name}/cells/{workload}.json")
    return {
        "workload": w,
        "config": read_json(c["file"]),
        "traffic": read_json(f"{HERE.name}/traffic/{w['traffic']}.json"),
        "limits": own["limits"],
        "control": own["control"],
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def _module(kind: str, stem: str):
    path = HERE / kind / f"{stem}.py"
    if not path.exists():
        return None
    mod_name = f"portbench_{kind}_{stem.replace('.', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(kind: str, name: str):
    """The `read` function of metric `name`; kind is "e2e" or
    "layers"."""
    for stem in (name, name.split(".", 1)[0]):
        mod = _module(kind, stem)
        if mod is not None:
            return mod.read
    raise KeyError(f"no reader for {kind} metric {name!r}")


def loop(mix: dict):
    """The generator module a traffic mix names under `loop`."""
    kind = str(mix.get("loop", ""))
    mod = _module("loops", kind) if kind.isidentifier() else None
    if mod is None:
        raise KeyError(f"no generator loops/{kind}.py for this mix")
    return mod
