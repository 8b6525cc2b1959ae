"""Driver/plugin config schemas.

Port of ``nomad_tpu/drivers/configspec.py``.

Reference: plugins/shared/hclspec/ — drivers publish an hclspec the
agent uses to decode + validate their task config stanza (each driver's
``taskConfigSpec``; e.g. drivers/qemu/driver.go:100-118). The tpu-native
equivalent is a declarative attr spec validated at start_task time:
unknown keys, wrong types, and missing required attrs are rejected with
the driver's name in the error, and defaults are applied — so a typo'd
stanza fails loudly at dispatch instead of silently misconfiguring the
task.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from .base import DriverError

_TYPES = {
    "string": str,
    "int": int,
    "float": (int, float),
    "bool": bool,
    "list": list,
    "map": dict,
    "any": object,
}


@dataclass
class Attr:
    """One config attribute (reference hclspec.NewAttr)."""

    name: str
    type: str = "string"
    required: bool = False
    default: Any = None


@dataclass
class Spec:
    """A driver's task-config schema (reference hclspec.NewObject)."""

    attrs: list[Attr] = field(default_factory=list)
    # drivers with passthrough stanzas (mock) can accept unknown keys
    allow_unknown: bool = False

    def validate(self, config: Optional[dict], who: str = "driver") -> dict:
        """Returns the config with defaults applied; raises DriverError
        on unknown keys / wrong types / missing required attrs."""
        config = dict(config or {})
        by_name = {a.name: a for a in self.attrs}
        if not self.allow_unknown:
            unknown = sorted(set(config) - set(by_name))
            if unknown:
                raise DriverError(
                    f"{who}: unknown config keys {unknown}; valid keys: "
                    f"{sorted(by_name)}"
                )
        for attr in self.attrs:
            if attr.name not in config:
                if attr.required:
                    raise DriverError(
                        f"{who}: missing required config key "
                        f"{attr.name!r}"
                    )
            elif attr.required and config[attr.name] in ("", None):
                # an interpolation that resolved to empty must fail at
                # dispatch, not as an opaque runtime error downstream
                raise DriverError(
                    f"{who}: required config key {attr.name!r} is empty"
                )
            if attr.name not in config:
                if attr.default is not None:
                    config[attr.name] = (
                        list(attr.default)
                        if isinstance(attr.default, list)
                        else dict(attr.default)
                        if isinstance(attr.default, dict)
                        else attr.default
                    )
                continue
            if attr.required and config[attr.name] in ("", None):
                # an interpolation that resolved to empty must fail at
                # dispatch, not as an opaque runtime error downstream
                raise DriverError(
                    f"{who}: required config key {attr.name!r} is empty"
                )
            want = _TYPES[attr.type]
            val = config[attr.name]
            if attr.type == "any":
                continue
            # bool is an int subclass: screen it from int attrs
            if attr.type == "int" and isinstance(val, bool):
                raise DriverError(
                    f"{who}: config key {attr.name!r} must be int, "
                    f"got bool"
                )
            if not isinstance(val, want):
                raise DriverError(
                    f"{who}: config key {attr.name!r} must be "
                    f"{attr.type}, got {type(val).__name__}"
                )
        return config


# -- builtin driver specs (reference: each driver's taskConfigSpec) ----

RAWEXEC_SPEC = Spec([
    Attr("command", "string", required=True),
    Attr("args", "list", default=[]),
    Attr("cgroup_v2", "bool", default=True),
])

EXEC_SPEC = Spec([
    Attr("command", "string", required=True),
    Attr("args", "list", default=[]),
    Attr("cgroup_v2", "bool", default=True),
])

JAVA_SPEC = Spec([
    Attr("jar_path", "string"),
    Attr("class", "string"),
    Attr("class_path", "string"),
    Attr("args", "list", default=[]),
    Attr("jvm_options", "list", default=[]),
    Attr("java_bin", "string"),
])

QEMU_SPEC = Spec([
    Attr("image_path", "string", required=True),
    Attr("accelerator", "string", default="tcg"),
    Attr("graceful_shutdown", "bool", default=False),
    Attr("args", "list", default=[]),
    Attr("port_map", "map", default={}),
])

DOCKER_SPEC = Spec([
    Attr("image", "string", required=True),
    Attr("command", "string"),
    Attr("args", "list", default=[]),
    Attr("entrypoint", "list"),
    Attr("volumes", "list", default=[]),
    Attr("ports", "list", default=[]),
    Attr("network_mode", "string"),
    Attr("labels", "map", default={}),
    Attr("force_pull", "bool", default=False),
    Attr("auth", "map"),
    Attr("work_dir", "string"),
])
