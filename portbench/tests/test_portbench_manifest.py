"""BENCHMARK.json against the benchmark's contract, and every name in
it found by the harness."""

import json
import math
import re

import pytest

from portbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

BENCH = manifest.load()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert len(manifest.MANIFEST.read_bytes()) <= 64 * 1024
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (manifest.ROOT / p).is_dir()


def test_run_seconds_fit_a_full_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and _line(cfg["why"])
    assert _line(cfg["source"]) and cfg["source"].startswith("https://")
    assert cfg["file"].startswith("portbench/configs/")
    doc = manifest.read_json(cfg["file"])
    assert doc["name"] == cfg["name"]
    assert doc["reduced"] == cfg["reduced"] and len(cfg["reduced"]) <= 16
    assert all(NAME.match(k) for k in cfg["reduced"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert cfg["name"] in used


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_entry(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for k in ("name", "config", "traffic"):
        assert NAME.match(w[k])
    assert w["chips"] in (1, 4) and _line(w["why"])
    c = manifest.cell(BENCH, w["name"])
    e2e = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c["per_layer"], "a cell reports at least one per-layer metric"
    for m in c["per_layer"]:
        assert m["moves"] in e2e
    assert c["limits"] and all(v >= 0 for v in c["limits"].values())


def test_names_unique_and_pairs_once():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, math.floor(0.25 * len(BENCH["workloads"])))


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    allowed = {"name", "unit", "better", "bound", "source", "workloads"}
    assert set(m) - allowed == set()
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    assert manifest.reader("e2e", m["name"])


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(m):
    allowed = {"name", "unit", "better", "source", "layer", "moves",
               "workloads"}
    assert set(m) - allowed == set()
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    assert _line(m["layer"])
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if "_roofline" in m["name"]:
        assert m["unit"] == "%"
    assert manifest.reader("layers", m["name"])


def test_layers_named_alike():
    """Metrics of one layer give the same layer name, letter for letter."""
    by_stem = {}
    for m in BENCH["per_layer"]:
        by_stem.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_stem.values())


def test_files_named_from_names():
    for p in manifest.HERE.rglob("*"):
        if "__pycache__" in p.parts or not p.is_file():
            continue
        assert PATH.match(str(p.relative_to(manifest.ROOT))), p


def test_reader_found_by_first_part(tmp_path):
    """A metric `x.suffix` with no file of its own takes `x`'s reader."""
    assert manifest.reader("layers", "broker_wait_ms.anything") is \
        not None
    with pytest.raises(KeyError):
        manifest.reader("layers", "no_such_metric.backlog")


def test_cell_finds_its_files():
    for w in BENCH["workloads"]:
        c = manifest.cell(BENCH, w["name"])
        assert c["config"]["fleet"]["nodes"] > 0
        assert manifest.loop(c["traffic"]).parse(c["traffic"])
    with pytest.raises(KeyError):
        manifest.cell(BENCH, "no.such")
    json.dumps(BENCH)
