"""The port's C fastpack against its Python twins, on the CPU.

nomad_tpu_torch/native/fastpack.c holds the wire codec's msgpack
encoder and decoder (pack, unpack, register_class, clear_registry and
wire_rows, held against their twins in tests/test_torch_codec.py) and
the three bulk helpers of the commit path: uuid_hex (alloc-id
formatting), pick_ports (dynamic-port draws over a free-port bitmap) and
store_rows (the store's node-grouped id-index inserts). Each has a
pure-Python twin that runs where no C compiler is; the C form must be
bit-equal to it on every seeded input here, and the twins to
nomad_tpu's. Tolerance: none. gcc builds the
extension into nomad_tpu_torch/_build/ at codec.warm_native().
"""

from __future__ import annotations

import os
import random
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from nomad_tpu_torch import codec
from nomad_tpu_torch.native import FASTPACK_ENTRY_POINTS, _SRC
from nomad_tpu_torch.state.store import StateStore
from nomad_tpu_torch.structs.network import (
    MAX_DYNAMIC_PORT,
    MIN_DYNAMIC_PORT,
    _pick_ports_py,
    _taken_bitmap,
    pick_dynamic_ports,
)
from nomad_tpu_torch.structs.structs import _uuid_hex_py

REPO = Path(__file__).resolve().parent.parent
SPAN = MAX_DYNAMIC_PORT - MIN_DYNAMIC_PORT + 1


def _fp():
    assert codec.warm_native(), "gcc builds the fastpack here"
    fp = codec.native_module()
    assert fp is not None
    return fp


def test_warm_native_covers_every_entry_point():
    fp = _fp()
    for name in FASTPACK_ENTRY_POINTS:
        assert callable(getattr(fp, name)), f"missing entry point {name}"


def test_entry_point_list_matches_c_method_table():
    """The declared contract and the C PyMethodDef table agree in both
    directions, as tests/test_native.py pins the reference's."""
    src = _SRC.read_text()
    table = src[src.index("static PyMethodDef methods[]"):]
    assert set(re.findall(r'\{"(\w+)",', table)) == set(FASTPACK_ENTRY_POINTS)
    # the wire codec's entry points, as the reference's fastpack has them,
    # and the decoder of the port's own
    assert set(FASTPACK_ENTRY_POINTS) == {
        "pack", "unpack", "register_class", "clear_registry", "uuid_hex",
        "wire_rows", "pick_ports", "store_rows"}


def test_only_codec_resolves_the_extension():
    """load_fastpack (the build point) is called from codec.py only, so
    warm_native stays the single build site, outside every lock."""
    offenders = [
        str(p) for p in (REPO / "nomad_tpu_torch").rglob("*.py")
        if "load_fastpack" in p.read_text()
        and p.name != "codec.py" and p.parent.name != "native"
    ]
    assert not offenders, offenders


def test_the_build_lands_in_the_package_build_dir():
    fp = _fp()
    built = Path(fp.__file__)
    assert built.parent == REPO / "nomad_tpu_torch" / "_build"
    assert built.name.startswith("fastpack-")


@pytest.mark.parametrize("n_ids", [0, 1, 7, 256, 1000])
def test_uuid_hex_bit_equal(n_ids):
    from nomad_tpu.structs.structs import _uuid_hex_py as j_uuid_hex_py

    fp = _fp()
    raw = random.Random(n_ids).randbytes(16 * n_ids)
    got = fp.uuid_hex(raw)
    assert got == _uuid_hex_py(raw) == j_uuid_hex_py(raw)
    assert all(len(u) == 36 for u in got)


def _taken_sets() -> dict:
    rng = random.Random(11)
    lo = MIN_DYNAMIC_PORT
    return {
        "empty": set(),
        "full": set(range(lo, lo + SPAN)),
        # every other port plus a dense block: draws collide often
        "fragmented": {lo + i for i in range(0, SPAN, 2)}
        | set(range(lo + 1000, lo + 3000)),
        # one free port left: the draws miss, the linear scan finds it
        "one-free": set(range(lo, lo + SPAN)) - {lo + SPAN - 3},
        "random-half": set(rng.sample(range(lo, lo + SPAN), SPAN // 2)),
        # ports outside the range are ignored
        "out-of-range": {1, 80, lo - 1, lo + SPAN, lo + 5},
    }


@pytest.mark.parametrize("taken_name", list(_taken_sets()))
def test_pick_ports_bit_equal(taken_name):
    from nomad_tpu.structs.network import _pick_ports_py as j_pick_ports_py

    fp = _fp()
    taken = _taken_sets()[taken_name]
    bitmap = _taken_bitmap(taken)
    for seed in (0, 1, 424242, (1 << 64) - 5):
        for k in (1, 2, 6):
            got = fp.pick_ports(bitmap, k, MIN_DYNAMIC_PORT,
                                MAX_DYNAMIC_PORT, seed)
            assert got == _pick_ports_py(taken, k, seed)
            assert got == j_pick_ports_py(taken, k, seed)
            if taken_name == "full" or (taken_name == "one-free" and k > 1):
                assert got is None
            else:
                assert len(set(got)) == k and not set(got) & taken


def test_pick_dynamic_ports_same_draws_on_both_paths(monkeypatch):
    """The public entry point: one seeded rng, the C path and the twin
    (the extension forced off) draw the same ports."""
    _fp()
    taken = _taken_sets()["fragmented"]
    c = [pick_dynamic_ports(taken, 4, random.Random(s)) for s in range(8)]
    monkeypatch.setattr(codec, "_fastpack", False)
    assert codec.native_module() is None
    py = [pick_dynamic_ports(taken, 4, random.Random(s)) for s in range(8)]
    assert c == py


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_store_rows_bit_equal(seed):
    """The C bulk id-index insert and the Python loop leave the same four
    tables in the same insertion order (first-touch node order, row
    order within a node — dict order is what the store serializes)."""
    fp = _fp()
    rng = np.random.default_rng(seed)
    n_rows, n_nodes = int(rng.integers(1, 300)), int(rng.integers(1, 40))
    idx = rng.integers(0, n_nodes, size=n_rows, dtype=np.int32)
    ids = [f"id-{seed}-{i:04d}" for i in range(n_rows)]
    handles = [object() for _ in range(n_rows)]
    # pre-existing rows in the tables: inserts append after them
    pre = {f"old-{i}": i for i in range(3)}

    def tables():
        return (dict(pre), dict(pre), dict(pre),
                {t: dict(pre) for t in range(n_nodes)})

    c_tabs, py_tabs = tables(), tables()
    fp.store_rows(ids, handles, idx.tobytes(), *c_tabs)
    StateStore._store_rows_py(ids, handles, idx.tolist(), *py_tabs)
    assert c_tabs == py_tabs
    for c_t, py_t in zip(c_tabs[:3], py_tabs[:3]):
        assert list(c_t) == list(py_t)
    for t in range(n_nodes):
        assert list(c_tabs[3][t]) == list(py_tabs[3][t])


def test_store_rows_rejects_bad_input():
    fp = _fp()
    with pytest.raises(ValueError):  # column length mismatch
        fp.store_rows(["a"], [], b"\0\0\0\0", {}, {}, {}, {})
    with pytest.raises(ValueError):  # negative node index
        fp.store_rows(["a"], [1], b"\xff\xff\xff\xff", {}, {}, {}, {0: {}})
    with pytest.raises(KeyError):  # missing node inner
        fp.store_rows(["a"], [1], b"\x02\0\0\0", {}, {}, {}, {0: {}})


_FALLBACK_SCRIPT = r"""
import os
os.environ["NOMAD_TPU_NO_FASTPACK"] = "1"
from nomad_tpu_torch import codec, native

assert codec.warm_native() is False, "extension must be unavailable"
assert codec.native_module() is None and native.last_error

from nomad_tpu_torch.structs import generate_uuid, generate_uuids
ids = generate_uuids(10)
assert len(ids) == 10 and all(len(i) == 36 for i in ids)
assert len(generate_uuid()) == 36

from nomad_tpu_torch.structs.network import pick_dynamic_ports
got = pick_dynamic_ports({20001, 20002}, 4)
assert got is not None and len(set(got)) == 4

# the SoA plan path commits on the twins: solve -> plan batches ->
# store commit (store_rows' twin) -> lazy reads
from nomad_tpu_torch import mock
from nomad_tpu_torch.scheduler.context import SchedulerConfig
from nomad_tpu_torch.scheduler.gpu import solve_eval_batch
from nomad_tpu_torch.testing import Harness

cfg = SchedulerConfig(device="cpu", small_batch_threshold=0)
h = Harness()
for _ in range(4):
    h.state.upsert_node(h.next_index(), mock.node())
job = mock.job(id="fb")
job.task_groups[0].count = 6
job.task_groups[0].tasks[0].resources.networks = []
h.state.upsert_job(h.next_index(), job)
ev = mock.eval_for_job(job)
plan = solve_eval_batch(h.snapshot(), h, [ev], cfg)[ev.id]
assert plan.alloc_batches, "fast-mint must emit SoA batches"
raw = codec.pack(plan)
rt = codec.unpack(raw)
assert sum(len(b) for b in rt.alloc_batches) == 6
# the wire on the twins: the Python writer's bytes are nomad_tpu's (its
# codec on its own fallback, the msgpack package), the Python reader
# reads them, and a PlanResult folds its batches through wire_rows' twin
from nomad_tpu import codec as jc
assert raw == jc.pack(jc.from_wire(codec.to_wire(plan)))
assert codec.to_wire(rt) == jc.to_wire(jc.unpack(raw))
from nomad_tpu_torch.structs import PlanResult
pr = PlanResult(alloc_batches=list(plan.alloc_batches), job=plan.job)
pr_raw = codec.pack(pr)
assert pr_raw == jc.pack(jc.from_wire(codec.to_wire(pr)))
assert sum(len(v) for v in codec.unpack(pr_raw).node_allocation.values()) == 6
h.submit_plan(plan)
allocs = h.state.allocs_by_job(job.namespace, job.id)
assert len(allocs) == 6 and all(a.node_id for a in allocs)
print("FALLBACK-OK")
"""


def test_twins_run_the_commit_path_without_the_extension():
    """With the extension unavailable (NOMAD_TPU_NO_FASTPACK) ids, port
    picks, the wire (pack, unpack, wire_rows) and the SoA commit run on
    the Python twins, and the loader says why."""
    proc = subprocess.run(
        [sys.executable, "-c", _FALLBACK_SCRIPT], capture_output=True,
        text=True, cwd=str(REPO), timeout=240,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FALLBACK-OK" in proc.stdout
