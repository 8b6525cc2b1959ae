"""The port's msgpack wire against nomad_tpu's, byte for byte, on the CPU.

nomad_tpu_torch.codec.pack writes the elided wire form as msgpack: the
C fastpack's struct encoder (native/fastpack.c ``pack``), its wire
writer for what that leaves to Python (``pack(wire, True)``), or the
pure-Python writer where the extension did not build. ``unpack`` reads
it back through the C decoder (``unpack``) or the pure-Python reader.
Every route must give the bytes ``nomad_tpu.codec.pack`` gives for the
reference twin of the same value (the msgpack package as referee, on
this side only), and each package must decode the other's bytes to the
same wire form. The corpus: the mock factories' structs, a c2m-shaped
PlanResult with its SoA alloc batches (the fold and ``wire_rows``), the
raft entries of ``job_register`` and ``apply_plan_results_batch``, and
hypothesis-drawn nesting of every msgpack scalar width and the tagged
forms. Tolerance: exact bytes. Every solve runs on the CPU twins
(``SchedulerConfig(device="cpu")``).
"""

from __future__ import annotations

import dataclasses
import math
import struct

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from nomad_tpu import codec as jc
from nomad_tpu import mock as jmock
from nomad_tpu.mock import factories as jfactories
from nomad_tpu_torch import codec as pc
from nomad_tpu_torch import mock
from nomad_tpu_torch.scheduler.context import SchedulerConfig
from nomad_tpu_torch.scheduler.gpu import solve_eval_batch
from nomad_tpu_torch.server.plan_apply import evaluate_plan
from nomad_tpu_torch.structs import Constraint, Spread
from nomad_tpu_torch.structs.node_class import compute_node_class
from nomad_tpu_torch.structs.placement_batch import (
    PlacementBatch,
    _wire_rows_py,
)
from nomad_tpu_torch.testing import Harness

DEVICE = "cpu"


def _fp():
    assert pc.warm_native(), "gcc builds the fastpack here"
    return pc.native_module()


@pytest.fixture(params=["c", "python"])
def route(request, monkeypatch):
    """Each test runs with the C fastpack live and with the Python twins
    (the extension made unavailable, as where it did not build)."""
    _fp()
    if request.param == "python":
        monkeypatch.setattr(pc, "_fastpack", False)
        assert pc.native_module() is None
    return request.param


def to_port(x_ref):
    """The port's twin of a reference value: its full wire form carried
    into the port."""
    return pc.from_wire(jc.to_wire(x_ref))


# -- the corpus ---------------------------------------------------------------


def _c2m_plan_result():
    """A PlanResult of c2m's shape (4000 MHz / 8192 MB nodes in dc1-dc4;
    jobs of 250 MHz / 128 MB allocs with the kernel.name constraint and
    the datacenter spread), cut to 64 nodes and 2 jobs of 40: the port's
    CPU-twin solve gives plans with SoA alloc batches, and the applier's
    evaluate_plan the PlanResult that carries them into a raft entry.
    Returns the reference's twin (crossed over the wire)."""
    h = Harness()
    for i in range(64):
        n = mock.node()
        n.datacenter = f"dc{i % 4 + 1}"
        n.resources.cpu = 4000
        n.resources.memory_mb = 8192
        n.computed_class = compute_node_class(n)
        h.state.upsert_node(h.next_index(), n)
    jobs = []
    for j in range(2):
        job = mock.job(id=f"c2m-{j}")
        job.datacenters = ["dc1", "dc2", "dc3", "dc4"]
        tg = job.task_groups[0]
        tg.count = 40
        tg.tasks[0].resources.cpu = 250
        tg.tasks[0].resources.memory_mb = 128
        tg.tasks[0].resources.networks = []
        job.constraints.append(
            Constraint("${attr.kernel.name}", "linux", "="))
        job.spreads = [Spread(attribute="${node.datacenter}", weight=50)]
        h.state.upsert_job(h.next_index(), job)
        jobs.append(job)
    evals = [mock.eval_for_job(j) for j in jobs]
    plans = solve_eval_batch(
        h.snapshot(), h, evals,
        SchedulerConfig(device=DEVICE, small_batch_threshold=0))
    results = [evaluate_plan(h.snapshot(), plans[ev.id]) for ev in evals]
    assert all(r.alloc_batches for r in results), "the SoA fast mint ran"
    return [jc.from_wire(pc.to_wire(r)) for r in results]


def _corpus() -> dict:
    """name -> the reference's value (structs built with nomad_tpu)."""
    job = jmock.job()
    results = _c2m_plan_result()
    return {
        "node": jmock.node(),
        "tpu_node": jfactories.tpu_node(),
        "service_job": job,
        "batch_job": jmock.batch_job(),
        "system_job": jmock.system_job(),
        "sysbatch_job": jfactories.sysbatch_job(),
        "evaluation": jfactories.evaluation(),
        "allocation": jmock.alloc(),
        "c2m_plan_result": results[0],
        "raft_job_register": (job, jfactories.eval_for_job(job)),
        "raft_apply_plan_results_batch": results,
    }


_CORPUS: dict = {}


def corpus(name: str):
    if not _CORPUS:
        _CORPUS.update(_corpus())
    return _CORPUS[name]


NAMES = ["node", "tpu_node", "service_job", "batch_job", "system_job",
         "sysbatch_job", "evaluation", "allocation", "c2m_plan_result",
         "raft_job_register", "raft_apply_plan_results_batch"]


def _structs(x, seen=None) -> list:
    """Every dataclass instance reachable from x (x included)."""
    seen = set() if seen is None else seen
    if id(x) in seen:
        return []
    seen.add(id(x))
    out = []
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        out.append(x)
        for f in dataclasses.fields(x):
            out += _structs(getattr(x, f.name), seen)
    elif isinstance(x, dict):
        for k, v in x.items():
            out += _structs(k, seen) + _structs(v, seen)
    elif isinstance(x, (list, tuple, set, frozenset)):
        for v in x:
            out += _structs(v, seen)
    return out


# -- the elision (its default_factory fields) ---------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_elided_wire_form_equals_the_reference(name):
    """Every registered struct the corpus reaches lowers to the elided
    wire form nomad_tpu's does: a field whose default comes from a
    factory is elided when its value is of the default's class and
    equals it, as nomad_tpu compares against factory()."""
    x_ref = corpus(name)
    structs = _structs(x_ref)
    assert structs
    for s in structs:
        assert pc.to_wire(to_port(s), _elide=True) == \
            jc.to_wire(s, _elide=True), type(s).__name__
    assert pc.to_wire(to_port(x_ref), _elide=True) == \
        jc.to_wire(x_ref, _elide=True)


def test_decoded_factory_defaults_are_fresh():
    """Elided factory fields come back as fresh instances, never one
    shared default: mutating one decoded struct's list leaves the
    next's empty."""
    for via in (pc.unpack, lambda raw: pc._unpack_py(raw)):
        a, b = via(pc.pack([mock.node(), mock.node()]))
        assert a.events == [] and a.events is not b.events
        a.events.append("x")
        assert b.events == []


# -- bytes and cross-decoding ---------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_pack_bytes_equal_the_reference(name, route):
    x_ref = corpus(name)
    assert pc.pack(to_port(x_ref)) == jc.pack(x_ref)


@pytest.mark.parametrize("name", NAMES)
def test_each_package_decodes_the_others_bytes(name, route):
    """The port's unpack of the reference's bytes and the reference's
    unpack of the port's bytes give the same wire form as each side's
    own round trip."""
    x_ref = corpus(name)
    ref_raw = jc.pack(x_ref)
    port_raw = pc.pack(to_port(x_ref))
    want = jc.to_wire(jc.unpack(ref_raw))
    assert pc.to_wire(pc.unpack(ref_raw)) == want
    assert jc.to_wire(jc.unpack(port_raw)) == want
    assert pc.pack(pc.unpack(ref_raw)) == ref_raw


@pytest.mark.parametrize("name", NAMES)
def test_c_pack_and_unpack_equal_their_twins(name):
    """The C encoder, the C wire writer and the Python writer give one
    set of bytes; the C decoder and the Python reader one wire form."""
    fp = _fp()
    x = to_port(corpus(name))
    wire = pc.to_wire(x, _elide=True)
    py_raw = pc._pack_py(wire)
    assert pc.pack(x) == fp.pack(wire, True) == py_raw
    assert pc.to_wire(fp.unpack(py_raw)) == pc.to_wire(pc._unpack_py(py_raw))


def test_plan_result_folds_its_batches_through_wire_rows():
    """A PlanResult's alloc batches fold into node_allocation rows (C
    wire_rows): its bytes equal the eager PlanResult's, whose rows are
    Allocation objects, and decode to no batches."""
    x = to_port(corpus("c2m_plan_result"))
    raw = pc.pack(x)
    back = pc.unpack(raw)
    assert not back.alloc_batches
    assert sum(len(v) for v in back.node_allocation.values()) == \
        sum(len(b) for b in x.alloc_batches)
    assert pc.pack(back) == raw


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_wire_rows_equals_its_twin(seed):
    import random

    fp = _fp()
    rng = random.Random(seed)
    k = rng.randrange(0, 300)
    template = {"$t": "Allocation", "job_id": "j", "id": "x", "name": "y",
                "node_id": "n", "resources": {"$t": "AllocatedResources"}}
    cols = [[f"{c}-{seed}-{i}" for i in range(k)] for c in "abcd"]
    got = fp.wire_rows(template, *cols)
    want = _wire_rows_py(template, *cols)
    assert got == want
    assert [list(d) for d in got] == [list(d) for d in want]
    with pytest.raises(ValueError):
        fp.wire_rows(template, cols[0], cols[1][:-1] + [], cols[2] + ["z"],
                     cols[3])


def test_placement_batch_index_column_crosses_as_one_bin():
    b = to_port(corpus("c2m_plan_result")).alloc_batches[0]
    assert isinstance(b, PlacementBatch)
    raw = pc.pack(b)
    assert b.node_idx_raw in raw
    back = pc.unpack(raw)
    assert back.node_idx_raw == b.node_idx_raw
    assert list(back.node_idx) == list(b.node_idx)


# -- scalars, nesting and the tagged forms ----------------------------------------

BOUNDARY_INTS = [
    0, 1, 0x7F, 0x80, 0xFF, 0x100, 0xFFFF, 0x10000, 0xFFFFFFFF,
    0x100000000, (1 << 63) - 1, 1 << 63, (1 << 64) - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -(1 << 31), -(1 << 31) - 1,
    -(1 << 63),
]


@pytest.mark.parametrize("v", BOUNDARY_INTS)
def test_every_int_width(v, route):
    raw = pc.pack(v)
    assert raw == jc.pack(v)
    assert pc.unpack(raw) == v == jc.unpack(raw)


def test_floats_and_float32():
    for v in (0.0, -0.0, 1.5, -1e300, math.inf, -math.inf, 5e-324):
        assert pc.pack(v) == jc.pack(v)
        assert struct.pack(">d", pc.unpack(pc.pack(v))) == \
            struct.pack(">d", v)
    nan = pc.pack(math.nan)
    assert nan == jc.pack(math.nan) and math.isnan(pc.unpack(nan))
    f32 = b"\xca" + struct.pack(">f", 1.25)
    assert pc.unpack(f32) == pc._unpack_py(f32) == jc.unpack(f32) == 1.25


def test_lengths_at_every_header_width(route):
    for n in (0, 15, 16, 31, 32, 255, 256, 65535, 65536):
        for v in ("x" * n, b"y" * n, list(range(n)),
                  {f"k{i}": i for i in range(n)}):
            raw = pc.pack(v)
            assert raw == jc.pack(v)
            assert pc.unpack(raw) == jc.unpack(raw)


def test_fallback_values_write_the_reference_bytes():
    """What the C struct encoder leaves to Python (an int subclass, a
    str subclass, a tuple subclass, an unregistered dataclass, nesting
    past its depth) gives the reference's bytes all the same."""
    import enum
    from collections import namedtuple

    class Level(enum.IntEnum):
        HIGH = 3

    class Tag(str):
        pass

    @dataclasses.dataclass
    class Loose:
        a: int = 1
        b: list = dataclasses.field(default_factory=list)

    Pair = namedtuple("Pair", "x y")
    deep: list = []
    cur = deep
    for _ in range(100):
        cur.append([])
        cur = cur[0]
    for v in (Level.HIGH, Tag("t"), Pair(1, "2"), {"l": Loose(2, [3])},
              deep, [1 << 63, {"k": (1 << 64) - 1}]):
        assert pc.pack(v) == jc.pack(v)


_keys = st.one_of(
    st.text(max_size=8),
    st.text(max_size=6).map(lambda s: "$" + s),
)
_scalars = st.one_of(
    st.none(), st.booleans(),
    st.integers(min_value=-(1 << 63), max_value=(1 << 64) - 1),
    st.sampled_from(BOUNDARY_INTS),
    st.floats(allow_nan=False), st.text(), st.binary(max_size=300),
)
_wire = st.recursive(
    _scalars,
    lambda children: st.one_of(
        st.lists(children, max_size=20),
        st.lists(children, max_size=5).map(tuple),
        st.dictionaries(_keys, children, max_size=8),
        st.dictionaries(st.integers(-300, 300), children, max_size=4),
        st.dictionaries(st.tuples(st.text(max_size=4), st.integers(-9, 9)),
                        children, max_size=4),
    ),
    max_leaves=40,
)


@settings(max_examples=300, deadline=None)
@given(_wire)
def test_drawn_values_match_the_reference(v):
    fp = _fp()
    raw = jc.pack(v)
    assert pc.pack(v) == raw
    assert pc._pack_py(pc.to_wire(v, _elide=True)) == raw
    want = jc.unpack(raw)
    assert fp.unpack(raw) == want
    assert pc._unpack_py(raw) == want


# -- malformed input ----------------------------------------------------------------


def _readers():
    fp = _fp()
    return {"c": fp.unpack, "python": pc._unpack_py}


@pytest.mark.parametrize("reader", ["c", "python"])
def test_truncated_input_raises(reader):
    read = _readers()[reader]
    raw = pc.pack(to_port(corpus("allocation")))
    for cut in range(len(raw)):
        with pytest.raises(ValueError):
            read(raw[:cut])


@pytest.mark.parametrize("reader", ["c", "python"])
@pytest.mark.parametrize("bad", [
    b"\xc1",                      # never used
    b"\xd4\x01\x00",              # fixext 1
    b"\xc7\x01\x05\x00",          # ext 8
    b"\x01\x02",                  # extra data after a value
    b"\xa2\xff\xfe",              # invalid utf-8
    b"\xdd\xff\xff\xff\xff",      # an array of 2**32 - 1, no items
    b"\xdf\xff\xff\xff\xff\x01",  # a map of 2**32 - 1, one byte
    b"\xc6\xff\xff\xff\xff",      # a bin of 4 GiB, no bytes
    b"\x91" * 300 + b"\xc0",      # nesting past the decoder's depth
    b"",
])
def test_malformed_input_raises(reader, bad):
    with pytest.raises(ValueError):
        _readers()[reader](bad)


@pytest.mark.parametrize("reader", ["c", "python"])
def test_unknown_struct_and_bad_tags_raise(reader):
    read = _readers()[reader]
    with pytest.raises(TypeError):
        read(pc._pack_py({"$t": "Nope", "a": 1}))
    with pytest.raises(TypeError):  # an unhashable map key
        read(b"\x81\x90\x01")
    with pytest.raises(ValueError):  # a $map pair of 3
        read(b"\x81\xa4$map\x91\x93\x01\x02\x03")


@pytest.mark.parametrize("reader", ["c", "python"])
def test_version_skew_drops_unknown_fields_and_defaults_the_rest(reader):
    """A struct map with a field this side does not know decodes as
    from_wire decodes it: the field dropped, every missing field at its
    default, a factory's freshly minted."""
    read = _readers()[reader]
    wire = {"$t": "Evaluation", "id": "e1", "future": 7}
    a, b = read(pc._pack_py([wire, wire]))
    assert a.id == "e1" and not hasattr(a, "future")
    assert pc.to_wire(a) == pc.to_wire(pc.from_wire(wire))
    fresh = [f.name for f in dataclasses.fields(a)
             if f.default_factory is not dataclasses.MISSING]
    assert fresh and all(getattr(a, n) is not getattr(b, n) for n in fresh)


def test_threads_pack_and_unpack_while_the_registry_resyncs():
    """Eight threads pack and unpack one struct while another re-syncs
    the class registry into the extension (two warm_native calls racing
    at start): every result is the reference's bytes and wire form."""
    import sys
    import threading

    fp = _fp()
    x = to_port(corpus("allocation"))
    raw = jc.pack(corpus("allocation"))
    want = pc.to_wire(pc.unpack(raw))
    errors, stop = [], threading.Event()

    def worker():
        try:
            for _ in range(300):
                assert pc.pack(x) == raw
                assert pc.to_wire(fp.unpack(raw)) == want
        except Exception as e:  # reported below, after the joins
            errors.append(e)

    def resync():
        while not stop.is_set():
            pc._sync_registry(fp)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        syncer = threading.Thread(target=resync)
        syncer.start()
        workers = [threading.Thread(target=worker) for _ in range(8)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(120)
        stop.set()
        syncer.join(30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in workers + [syncer])
    assert errors == []
