"""The wire codec for the shared struct vocabulary.

``to_wire`` lowers a registered dataclass (Job, Node, Allocation,
Evaluation, …) to plain JSON-able data, as ``nomad_tpu.codec.to_wire``
does: a dict tagged with its class name under ``"$t"``, tuples as
``{"$tuple": [...]}``, dicts with non-str keys as ``{"$map": [[k, v],
...]}`` and bytes as ``{"$b64": ...}``. ``from_wire`` rebuilds this
package's own structs from that form, so state built by either package
can be carried into the other without importing it. Fields the sender
elided or did not know get their declared defaults; fields this side
does not know are dropped.

``pack``/``unpack`` are the byte form of the RPC fabric's frames, the
raft log, the state store's snapshots and the client's state database:
the elided wire form as msgpack, byte for byte what ``nomad_tpu.codec.
pack`` writes for the same structs, so either package reads the other's
frames. The C fastpack (``native/fastpack.c``) encodes and decodes;
where it did not build, a pure-Python msgpack writer and reader (the
twins, ``_pack_py`` and ``_unpack_py``) give the same bytes and values.
JSON stays where the reference has it: the HTTP API (``json_default``).
``warm_native`` resolves the C fastpack once, outside every lock, and
syncs the class registry into it; ``native_module`` hands it out without
ever building.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Optional

_TYPE_KEY = "$t"
_TUPLE_KEY = "$tuple"
_MAP_KEY = "$map"
_BYTES_KEY = "$b64"

_REGISTRY: dict[str, type] = {}

_SCALARS = frozenset((bool, int, float, str, bytes, type(None)))
# element types a list may hold and still be its own wire form: a
# PlacementBatch's node-id and name columns (one string per node of the
# solve's table) then cross the wire with one C-level type scan instead
# of a to_wire/from_wire call per element
_FLAT = frozenset((bool, int, float, str, type(None)))
# cls -> [(name, compare_default, factory_or_None, has_default)]:
# compare_default is what an encoder elides against (a factory field's
# is one instance the factory minted); factory is what a decoder calls
# to mint a fresh default, never shared between decoded objects
_FIELD_PLANS: dict[type, list] = {}


def _registry() -> dict[str, type]:
    if not _REGISTRY:
        from .state.store import JobSummary
        from .structs import devices, network, placement_batch
        from .structs import structs as structs_mod

        for mod in (structs_mod, network, devices, placement_batch):
            for name in dir(mod):
                obj = getattr(mod, name)
                if isinstance(obj, type) and dataclasses.is_dataclass(obj):
                    _REGISTRY[obj.__name__] = obj
        # a non-dataclass store type that rides in state snapshots; it
        # round-trips through its __dict__
        _REGISTRY[JobSummary.__name__] = JobSummary
        # the ACL tables' rows ride in state snapshots too
        from .acl.structs import ACLPolicy, ACLToken

        _REGISTRY[ACLPolicy.__name__] = ACLPolicy
        _REGISTRY[ACLToken.__name__] = ACLToken
        # the driver plugin boundary's payloads (drivers/plugin.py)
        from .drivers import base as driver_base

        for name in ("Fingerprint", "TaskConfig", "ExitResult", "TaskStatus"):
            _REGISTRY[name] = getattr(driver_base, name)
    return _REGISTRY


def _field_plan(cls: type) -> list:
    plan = _FIELD_PLANS.get(cls)
    if plan is None:
        plan = []
        for f in dataclasses.fields(cls):
            if f.default is not dataclasses.MISSING:
                plan.append((f.name, f.default, None, True))
            elif f.default_factory is not dataclasses.MISSING:
                plan.append((f.name, f.default_factory(), f.default_factory,
                             True))
            else:
                plan.append((f.name, None, None, False))
        _FIELD_PLANS[cls] = plan
    return plan


def _decode_struct(tname: str, data: dict) -> Any:
    cls: Optional[type] = _registry().get(tname)
    if cls is None:
        raise TypeError(f"unknown wire type {tname!r}")
    obj = cls.__new__(cls)
    if not dataclasses.is_dataclass(cls):
        for k, v in data.items():
            if k != _TYPE_KEY:
                setattr(obj, k, from_wire(v))
        return obj
    plan = _field_plan(cls)
    for name, default, factory, has_default in plan:
        if name in data:
            setattr(obj, name, from_wire(data[name]))
        elif factory is not None:
            # mutable defaults are minted fresh, never shared
            setattr(obj, name, factory())
        elif has_default:
            setattr(obj, name, default)
    return obj


def from_wire(data: Any) -> Any:
    """Rebuild typed structs from their tagged wire form, recursively."""
    cls = data.__class__
    if data is None or cls in _SCALARS:
        return data
    if isinstance(data, list):
        if set(map(type, data)) <= _FLAT:
            return list(data)
        return [from_wire(v) for v in data]
    if not isinstance(data, dict):
        raise TypeError(f"cannot decode wire value of type {cls.__name__}")
    tname = data.get(_TYPE_KEY)
    if tname is not None:
        return _decode_struct(tname, data)
    if len(data) == 1:
        if _TUPLE_KEY in data:
            return tuple(from_wire(v) for v in data[_TUPLE_KEY])
        if _MAP_KEY in data:
            return {from_wire(k): from_wire(v) for k, v in data[_MAP_KEY]}
        if _BYTES_KEY in data:
            import base64

            return base64.b64decode(data[_BYTES_KEY])
    return {k: from_wire(v) for k, v in data.items()}


# -- encoding --------------------------------------------------------------

# cls -> generated elide-encoder. Like the dataclasses module itself, the
# codec compiles a specialized function per class: scalar fields are
# compared and emitted inline (no recursive to_wire frame per int/str),
# which matters when a raft apply packs 10^5 allocs.
_ENCODERS: dict[type, Any] = {}


def _gen_encoder(cls: type):
    lines = [
        "def _enc(obj):",
        f"    out = {{{_TYPE_KEY!r}: {cls.__name__!r}}}",
    ]
    ns: dict[str, Any] = {"_w": to_wire}
    for i, (name, default, _factory, has_default) in enumerate(
        _field_plan(cls)
    ):
        v, d, t = f"v{i}", f"d{i}", f"t{i}"
        lines.append(f"    {v} = obj.{name}")
        if not has_default:
            lines.append(f"    out[{name!r}] = _w({v}, True)")
        elif default is None:
            lines.append(f"    if {v} is not None:")
            lines.append(f"        out[{name!r}] = _w({v}, True)")
        elif default.__class__ in (bool, int, float, str, bytes):
            ns[d] = default
            ns[t] = default.__class__
            lines.append(f"    if {v}.__class__ is {t}:")
            lines.append(f"        if {v} != {d}:")
            lines.append(f"            out[{name!r}] = {v}")
            lines.append("    else:")
            lines.append(f"        out[{name!r}] = _w({v}, True)")
        else:
            ns[d] = default
            ns[t] = default.__class__
            lines.append(
                f"    if not ({v}.__class__ is {t} and {v} == {d}):"
            )
            lines.append(f"        out[{name!r}] = _w({v}, True)")
    lines.append("    return out")
    exec("\n".join(lines), ns)
    enc = ns["_enc"]
    _ENCODERS[cls] = enc
    return enc


def _encode_plan_result(r) -> dict:
    """The elide-encoder of PlanResult: alloc_batches (the SoA placement
    columns) FOLD into node_allocation as per-row wire maps minted from
    one shared template, so a raft entry carrying batches has the same
    bytes as the entry the eager-object path produces. Field order and
    elision follow the generated encoders."""
    out: dict[str, Any] = {_TYPE_KEY: "PlanResult"}
    v = r.node_update
    if not (v.__class__ is dict and not v):
        out["node_update"] = to_wire(v, True)
    na = r.node_allocation
    batches = r.alloc_batches
    if batches:
        m: dict[str, Any] = {
            nid: [to_wire(a, True) for a in allocs]
            for nid, allocs in na.items()
        }
        for b in batches:
            b.extend_wire_rows(m)
        out["node_allocation"] = m
    elif not (na.__class__ is dict and not na):
        out["node_allocation"] = to_wire(na, True)
    v = r.node_preemptions
    if not (v.__class__ is dict and not v):
        out["node_preemptions"] = to_wire(v, True)
    if r.job is not None:
        out["job"] = to_wire(r.job, True)
    if r.deployment is not None:
        out["deployment"] = to_wire(r.deployment, True)
    v = r.deployment_updates
    if not (v.__class__ is list and not v):
        out["deployment_updates"] = to_wire(v, True)
    v = r.preemption_evals
    if not (v.__class__ is list and not v):
        out["preemption_evals"] = to_wire(v, True)
    v = r.refresh_index
    if not (v.__class__ is int and v == 0):
        out["refresh_index"] = v if v.__class__ is int else to_wire(v, True)
    v = r.alloc_index
    if not (v.__class__ is int and v == 0):
        out["alloc_index"] = v if v.__class__ is int else to_wire(v, True)
    # alloc_batches itself is never emitted: it is the fold above
    return out


def _encoder_for(cls: type):
    enc = _ENCODERS.get(cls)
    if enc is None:
        if cls.__name__ == "PlanResult":
            enc = _ENCODERS[cls] = _encode_plan_result
        else:
            enc = _gen_encoder(cls)
    return enc


def to_wire(obj: Any, _elide: bool = False) -> Any:
    """Lower to JSON/msgpack-able data. Unknown object types are an error:
    payloads are built from registered structs and primitives.

    With _elide (the pack() path), dataclass fields still equal to their
    declared default are omitted: decoders restore defaults for missing
    fields, so elision is lossless for struct consumers, and most fields
    of bulk payloads (plan allocs) are defaults."""
    cls = obj.__class__
    if obj is None or cls in _SCALARS:
        return obj
    if cls is list:
        if set(map(type, obj)) <= _FLAT:
            return list(obj)
        return [to_wire(v, _elide) for v in obj]
    if cls is dict:
        # a "$"-prefixed key in user data could collide with the tags:
        # escape such dicts into the pair-list form
        if all(type(k) is str and not k.startswith("$") for k in obj):
            return {k: to_wire(v, _elide) for k, v in obj.items()}
        return {
            _MAP_KEY: [
                [to_wire(k, _elide), to_wire(v, _elide)] for k, v in obj.items()
            ]
        }
    if isinstance(obj, tuple):
        return {_TUPLE_KEY: [to_wire(v, _elide) for v in obj]}
    if isinstance(obj, (bool, int, float, str, bytes)):
        return obj
    if isinstance(obj, (list, set, frozenset)):
        return [to_wire(v, _elide) for v in obj]
    if isinstance(obj, dict):
        return to_wire(dict(obj), _elide)
    if dataclasses.is_dataclass(obj):
        if _elide:
            return _encoder_for(cls)(obj)
        out: dict[str, Any] = {_TYPE_KEY: cls.__name__}
        for name, _default, _factory, _has_default in _field_plan(cls):
            out[name] = to_wire(getattr(obj, name))
        return out
    if cls.__name__ in _registry():
        # non-dataclass registered types (JobSummary) via __dict__
        out = {_TYPE_KEY: cls.__name__}
        for k, v in vars(obj).items():
            out[k] = to_wire(v, _elide)
        return out
    if cls.__name__ == "AllocRow":
        # a lazy store-table handle that reached a wire boundary:
        # materialize (the cached row is the value the eager path stores)
        return to_wire(obj.get(), _elide)
    raise TypeError(f"cannot encode {cls.__name__!r} for the wire")


def json_default(o):
    """json.dumps default for wire payloads: bytes ride base64-tagged and
    registered structs lower through to_wire — HTTP handlers may return
    structs nested anywhere in a plain dict (e.g. Job.Plan's
    FailedTGAllocs)."""
    if isinstance(o, bytes):
        import base64

        return {_BYTES_KEY: base64.b64encode(o).decode()}
    if dataclasses.is_dataclass(o) and not isinstance(o, type):
        return to_wire(o)
    if type(o).__name__ == "AllocRow":
        # a lazy alloc handle at the HTTP/event boundary: materialize
        return to_wire(o.get())
    raise TypeError(f"not JSON serializable: {type(o).__name__}")


def pack(obj: Any) -> bytes:
    """The msgpack bytes of obj's elided wire form. With the fastpack
    resolved, its struct encoder writes obj; what it leaves to Python
    (Fallback: PlanResult, whose encoder folds its batches, or an
    unregistered class) is lowered by :func:`to_wire` and written by its
    wire writer. Without it, or past that writer too, the Python writer
    :func:`_pack_py`. Every route gives the same bytes."""
    fp = _fastpack or None
    if fp is not None:
        try:
            return fp.pack(obj)
        except fp.Fallback:
            pass
    wire = to_wire(obj, _elide=True)
    if fp is not None:
        try:
            return fp.pack(wire, True)
        except fp.Fallback:
            pass
    return _pack_py(wire)


def unpack(raw) -> Any:
    """Structs back from :func:`pack`'s bytes (or the reference's):
    the C decoder, or the Python reader where it did not build. Raises
    ValueError on truncated or malformed input."""
    fp = _fastpack or None
    if fp is not None:
        return fp.unpack(raw)
    return _unpack_py(raw)


# -- the pure-Python msgpack twins --------------------------------------------

# the nesting the reader accepts, as fastpack.c's MAX_DECODE_DEPTH
_MAX_DECODE_DEPTH = 256
# the nesting the writer accepts, as the msgpack package's packer
_MAX_ENCODE_DEPTH = 511

_F64 = struct.Struct(">d")
_F32 = struct.Struct(">f")


def _pack_py(wire: Any) -> bytes:
    """msgpack bytes of a wire value (dicts, lists, scalars, bytes), as
    the msgpack package's ``packb(use_bin_type=True)`` writes them: the
    smallest form of each int, str and container, floats as float64."""
    out = bytearray()
    _write(wire, out, 0)
    return bytes(out)


def _header(out: bytearray, n: int, fix: int, code16: int) -> None:
    """A map's or array's header: fixmap/fixarray below 16, then the
    16- and 32-bit forms (code16 and the code after it)."""
    if n < 16:
        out.append(fix | n)
    elif n <= 0xFFFF:
        out.append(code16)
        out += n.to_bytes(2, "big")
    else:
        out.append(code16 + 1)
        out += n.to_bytes(4, "big")


def _write(o: Any, out: bytearray, depth: int) -> None:
    if depth > _MAX_ENCODE_DEPTH:
        raise ValueError("recursion limit exceeded")
    if o is None:
        out.append(0xC0)
    elif o is True:
        out.append(0xC3)
    elif o is False:
        out.append(0xC2)
    elif isinstance(o, int):
        if 0 <= o < 0x80 or -32 <= o < 0:
            out.append(o & 0xFF)
        elif o > 0:
            for code, width in ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)):
                if o < 1 << (8 * width):
                    out.append(code)
                    out += o.to_bytes(width, "big")
                    return
            raise OverflowError("Integer value out of range")
        else:
            for code, width in ((0xD0, 1), (0xD1, 2), (0xD2, 4), (0xD3, 8)):
                if o >= -(1 << (8 * width - 1)):
                    out.append(code)
                    out += o.to_bytes(width, "big", signed=True)
                    return
            raise OverflowError("Integer value out of range")
    elif isinstance(o, str):
        b = o.encode("utf-8")
        n = len(b)
        if n < 32:
            out.append(0xA0 | n)
        elif n <= 0xFF:
            out.append(0xD9)
            out.append(n)
        elif n <= 0xFFFF:
            out.append(0xDA)
            out += n.to_bytes(2, "big")
        else:
            out.append(0xDB)
            out += n.to_bytes(4, "big")
        out += b
    elif isinstance(o, dict):
        _header(out, len(o), 0x80, 0xDE)
        for k, v in o.items():
            _write(k, out, depth + 1)
            _write(v, out, depth + 1)
    elif isinstance(o, list):
        _header(out, len(o), 0x90, 0xDC)
        for v in o:
            _write(v, out, depth + 1)
    elif isinstance(o, float):
        out.append(0xCB)
        out += _F64.pack(o)
    elif isinstance(o, bytes):
        n = len(o)
        if n <= 0xFF:
            out.append(0xC4)
            out.append(n)
        elif n <= 0xFFFF:
            out.append(0xC5)
            out += n.to_bytes(2, "big")
        else:
            out.append(0xC6)
            out += n.to_bytes(4, "big")
        out += o
    else:
        raise TypeError(f"can not serialize {type(o).__name__!r} object")


def _unpack_py(raw) -> Any:
    """The twin of fastpack's ``unpack``: a plain reader of every
    msgpack int and float width, str, bin, array and map, its value then
    rebuilt by :func:`from_wire`."""
    buf = bytes(raw)
    obj, pos = _read(buf, 0, 0)
    if pos != len(buf):
        raise ValueError("extra data after the msgpack value")
    return from_wire(obj)


def _need(buf: bytes, pos: int, n: int) -> None:
    if len(buf) - pos < n:
        raise ValueError("truncated msgpack input")


def _uint(buf: bytes, pos: int, n: int) -> int:
    _need(buf, pos, n)
    return int.from_bytes(buf[pos:pos + n], "big")


def _read(buf: bytes, pos: int, depth: int) -> tuple:
    depth += 1
    if depth > _MAX_DECODE_DEPTH:
        raise ValueError("msgpack nesting too deep")
    _need(buf, pos, 1)
    b = buf[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    kind = b & 0xE0
    if kind == 0xA0:
        return _read_str(buf, pos, b & 0x1F)
    if kind == 0x80:
        if b < 0x90:
            return _read_map(buf, pos, b & 0x0F, depth)
        return _read_array(buf, pos, b & 0x0F, depth)
    if b == 0xC0:
        return None, pos
    if b == 0xC2:
        return False, pos
    if b == 0xC3:
        return True, pos
    if 0xC4 <= b <= 0xC6:
        w = 1 << (b - 0xC4)
        n = _uint(buf, pos, w)
        pos += w
        _need(buf, pos, n)
        return buf[pos:pos + n], pos + n
    if b == 0xCA:
        _need(buf, pos, 4)
        return _F32.unpack_from(buf, pos)[0], pos + 4
    if b == 0xCB:
        _need(buf, pos, 8)
        return _F64.unpack_from(buf, pos)[0], pos + 8
    if 0xCC <= b <= 0xCF:
        w = 1 << (b - 0xCC)
        return _uint(buf, pos, w), pos + w
    if 0xD0 <= b <= 0xD3:
        w = 1 << (b - 0xD0)
        _need(buf, pos, w)
        return int.from_bytes(buf[pos:pos + w], "big", signed=True), pos + w
    if 0xD9 <= b <= 0xDB:
        w = 1 << (b - 0xD9)
        return _read_str(buf, pos + w, _uint(buf, pos, w))
    if b in (0xDC, 0xDD):
        w = 2 if b == 0xDC else 4
        return _read_array(buf, pos + w, _uint(buf, pos, w), depth)
    if b in (0xDE, 0xDF):
        w = 2 if b == 0xDE else 4
        return _read_map(buf, pos + w, _uint(buf, pos, w), depth)
    # 0xc1 (never used) and the ext family: nothing the codec emits
    raise ValueError(f"unsupported msgpack type 0x{b:02x}")


def _read_str(buf: bytes, pos: int, n: int) -> tuple:
    _need(buf, pos, n)
    return str(buf[pos:pos + n], "utf-8"), pos + n


def _read_array(buf: bytes, pos: int, n: int, depth: int) -> tuple:
    _need(buf, pos, n)  # each item takes a byte at least
    out = []
    for _ in range(n):
        v, pos = _read(buf, pos, depth)
        out.append(v)
    return out, pos


def _read_map(buf: bytes, pos: int, n: int, depth: int) -> tuple:
    _need(buf, pos, 2 * n)
    d = {}
    for _ in range(n):
        k, pos = _read(buf, pos, depth)
        v, pos = _read(buf, pos, depth)
        d[k] = v
    return d, pos


# -- the C fastpack ----------------------------------------------------------

_fastpack = None  # None: not resolved yet; False: unavailable
_native_reported = False


def _sync_registry(fp) -> None:
    """Hand the fastpack every registered class with its field plan, as
    the reference's ``_fastpack_module`` does. PlanResult is registered
    for decoding only: its Python encoder folds alloc_batches into
    node_allocation (``_encode_plan_result``), which the C field-plan
    encoder would emit as a field; the C encoder falls back for it.
    Idempotent: a second thread warming at the same time re-registers
    equal plans and never empties a registry another thread decodes
    with."""
    for name, cls in _registry().items():
        if dataclasses.is_dataclass(cls):
            fp.register_class(cls, tuple(_field_plan(cls)),
                              name != "PlanResult")
        else:
            fp.register_class(cls, None)


def native_module():
    """The fastpack extension if it is already resolved, else None —
    never triggers the C build (warm_native is the build point, outside
    any lock)."""
    return _fastpack or None


def warm_native() -> bool:
    """Resolve (and if necessary compile) the fastpack extension now.

    The commit path's callers (the store's bulk insert, id minting, port
    picking) only ever read :func:`native_module`, so the one-time gcc
    build can never land under the state store's lock or inside a
    dequeued batch. The batch worker calls this at start. Returns True
    when the C path is live; logs availability once and publishes
    ``nomad.native.{available,build_seconds}``."""
    global _fastpack, _native_reported
    if _fastpack is None:
        from .native import load_fastpack

        fp = load_fastpack()
        if fp is not None:
            _sync_registry(fp)
        # published only once synced: a decoder that meets a "$t" map
        # knows every registered class from its first call
        _fastpack = fp or False
    live = _fastpack is not False
    if not _native_reported:
        _native_reported = True
        import logging

        from . import metrics, native

        build_s = max(native.last_build_seconds, 0.0)
        metrics.set_gauge("nomad.native.available", 1.0 if live else 0.0)
        metrics.set_gauge("nomad.native.build_seconds", build_s)
        logging.getLogger("nomad_tpu_torch.native").info(
            "fastpack %s (resolved in %.3fs; entry points: %s)",
            "live" if live else "unavailable - pure-Python twins",
            build_s,
            ", ".join(native.FASTPACK_ENTRY_POINTS) if live else "none",
        )
    return live
