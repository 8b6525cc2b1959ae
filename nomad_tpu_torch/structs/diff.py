"""Structural job diffing for plan dry-runs.

Port of ``nomad_tpu/structs/diff.py``, whole (it is host code and
imports nothing of torch). Reference: nomad/structs/diff.go — Job.Diff builds a tree of ObjectDiff /
FieldDiff nodes (Added/Deleted/Edited/None) that the CLI renders and the
scheduler's annotations ride alongside. This is a generic dataclass walker
rather than the reference's per-struct hand-rolled methods: the port's
structs are plain dataclasses, so one recursive differ covers the whole
tree and can't drift from the struct definitions.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

DIFF_NONE = "None"
DIFF_ADDED = "Added"
DIFF_DELETED = "Deleted"
DIFF_EDITED = "Edited"

# Fields that are bookkeeping, not user intent — never part of a diff.
_IGNORED_FIELDS = {
    "create_index",
    "modify_index",
    "job_modify_index",
    "submit_time",
    "version",
    "status",
    "stable",
    "modify_time",
    "create_time",
    "id",  # object identity compared by name/key, not uuid
}


def _is_struct(v: Any) -> bool:
    return dataclasses.is_dataclass(v) and not isinstance(v, type)


def _scalar(v: Any) -> str:
    if v is None:
        return ""
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def _name_of(v: Any, fallback: str) -> str:
    for attr in ("name", "label", "attribute", "ltarget"):
        n = getattr(v, attr, None)
        if n:
            return str(n)
    return fallback


def _empty(v: Any) -> bool:
    # bools are never "empty": False == 0 would otherwise make a
    # False -> True flip render as Added instead of Edited.
    if isinstance(v, bool):
        return False
    return v in (None, "", 0, [], {})


def field_diff(name: str, old: Any, new: Any) -> Optional[dict]:
    if old == new:
        return None
    if _empty(old) and not _empty(new):
        kind = DIFF_ADDED
    elif _empty(new) and not _empty(old):
        kind = DIFF_DELETED
    else:
        kind = DIFF_EDITED
    return {"Type": kind, "Name": name, "Old": _scalar(old), "New": _scalar(new)}


def object_diff(name: str, old: Any, new: Any) -> Optional[dict]:
    """Diff two same-shaped dataclasses (either may be None)."""
    if old is None and new is None:
        return None
    kind = DIFF_EDITED
    if old is None:
        kind = DIFF_ADDED
    elif new is None:
        kind = DIFF_DELETED
    ref = new if new is not None else old
    fields: list[dict] = []
    objects: list[dict] = []
    for f in dataclasses.fields(ref):
        if f.name in _IGNORED_FIELDS:
            continue
        ov = getattr(old, f.name, None) if old is not None else None
        nv = getattr(new, f.name, None) if new is not None else None
        d = _value_diff(f.name, ov, nv)
        if d is None:
            continue
        if isinstance(d, list):
            objects.extend(d)
        elif "Fields" in d or "Objects" in d:
            objects.append(d)
        else:
            fields.append(d)
    if not fields and not objects and kind == DIFF_EDITED:
        return None
    return {
        "Type": kind,
        "Name": name,
        "Fields": fields,
        "Objects": objects,
    }


def _value_diff(name: str, old: Any, new: Any):
    if _is_struct(old) or _is_struct(new):
        return object_diff(name, old, new)
    if isinstance(old, dict) or isinstance(new, dict):
        old, new = old or {}, new or {}
        out = []
        for k in sorted(set(old) | set(new), key=str):
            d = _value_diff(f"{name}[{k}]", old.get(k), new.get(k))
            if d is None:
                continue
            out.extend(d if isinstance(d, list) else [d])
        return out or None
    if isinstance(old, (list, tuple)) or isinstance(new, (list, tuple)):
        old, new = list(old or []), list(new or [])
        if old and _is_struct(old[0]) or new and _is_struct(new[0]):
            olds = {_name_of(v, str(i)): v for i, v in enumerate(old)}
            news = {_name_of(v, str(i)): v for i, v in enumerate(new)}
            out = []
            for k in sorted(set(olds) | set(news)):
                d = object_diff(f"{name}[{k}]", olds.get(k), news.get(k))
                if d is not None:
                    out.append(d)
            return out or None
        if old != new:
            return field_diff(name, old, new)
        return None
    return field_diff(name, old, new)


def job_diff(old, new) -> dict:
    """Top-level diff between two Job versions (reference diff.go:38).

    Task groups are matched by name and diffed as first-class objects so
    the CLI can render create/destroy/edit per group; the scheduler's
    annotations (in-place vs destructive) ride separately.
    """
    if old is None:
        d = object_diff(new.id, None, new) or {
            "Type": DIFF_ADDED, "Name": new.id, "Fields": [], "Objects": [],
        }
        d["Type"] = DIFF_ADDED
        return d
    d = object_diff(new.id, old, new)
    if d is None:
        return {"Type": DIFF_NONE, "Name": new.id, "Fields": [], "Objects": []}
    return d
