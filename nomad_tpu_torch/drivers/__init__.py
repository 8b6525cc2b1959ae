"""Port of ``nomad_tpu/drivers/__init__.py``."""

from .base import (
    Driver,
    DriverError,
    ExitResult,
    Fingerprint,
    TaskConfig,
    TaskHandle,
    TaskStatus,
)
from .docker import DockerDriver
from .exec import ExecDriver
from .java import JavaDriver
from .mock import MockDriver
from .qemu import QemuDriver
from .rawexec import RawExecDriver

BUILTIN_DRIVERS = {
    "mock": MockDriver,
    "rawexec": RawExecDriver,
    "exec": ExecDriver,
    "docker": DockerDriver,
    "java": JavaDriver,
    "qemu": QemuDriver,
}


def new_driver(name: str) -> Driver:
    factory = BUILTIN_DRIVERS.get(name)
    if factory is None:
        raise ValueError(f"unknown driver '{name}'")
    return factory()
