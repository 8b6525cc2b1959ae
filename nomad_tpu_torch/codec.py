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

``pack``/``unpack`` are the byte form the raft log keeps and the state
store's snapshots use: the elided wire form as compact JSON. (The
reference packs msgpack with a C encoder; the port's bytes need only be
self-consistent, and JSON, like msgpack, never aliases a repeated
value, so a plan's SoA rows and its eager rows encode to equal bytes.)
``warm_native`` resolves the C fastpack (``native/``) once, outside
every lock; ``native_module`` hands it out without ever building.
"""

from __future__ import annotations

import dataclasses
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
# cls -> [(name, default, factory_or_None, has_default)]
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
    return _REGISTRY


def _field_plan(cls: type) -> list:
    plan = _FIELD_PLANS.get(cls)
    if plan is None:
        plan = []
        for f in dataclasses.fields(cls):
            if f.default is not dataclasses.MISSING:
                plan.append((f.name, f.default, None, True))
            elif f.default_factory is not dataclasses.MISSING:
                plan.append((f.name, None, f.default_factory, True))
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
    """Lower to JSON-able data. Unknown object types are an error:
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


def _json_default(o):
    if isinstance(o, bytes):
        import base64

        return {_BYTES_KEY: base64.b64encode(o).decode()}
    raise TypeError(f"not JSON serializable: {type(o).__name__}")


def pack(obj: Any) -> bytes:
    import json

    return json.dumps(
        to_wire(obj, _elide=True), separators=(",", ":"),
        ensure_ascii=False, default=_json_default,
    ).encode()


def unpack(raw: bytes) -> Any:
    import json

    return from_wire(json.loads(raw))


# -- the C fastpack ----------------------------------------------------------

_fastpack = None  # None: not resolved yet; False: unavailable
_native_reported = False


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

        _fastpack = load_fastpack() or False
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
