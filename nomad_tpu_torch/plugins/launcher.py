"""Shared plugin-process launcher for the driver and device fabrics.

Port of ``nomad_tpu/plugins/launcher.py``.

Reference: helper/pluginutils + go-plugin's client lifecycle — launch
the plugin binary, read one handshake line from stdout, talk RPC, and
let the child die with the parent (stdin EOF). Both ExternalDriver
(drivers/plugin.py) and ExternalDevicePlugin (devices/plugin.py) wrap
this; fixes to the lifecycle land once.
"""

from __future__ import annotations

import subprocess
import threading
from typing import Optional

from ..rpc import ConnPool, RPCError


class PluginProcess:
    """One plugin subprocess: lazy launch, handshake, RPC calls,
    die-with-parent shutdown."""

    def __init__(
        self,
        argv: list[str],
        handshake_prefix: str,
        error_cls: type[Exception] = RuntimeError,
    ) -> None:
        self.argv = argv
        self.handshake_prefix = handshake_prefix
        self.error_cls = error_cls
        self._proc: Optional[subprocess.Popen] = None
        self._addr: Optional[tuple[str, int]] = None
        self._pool = ConnPool()
        self._lock = threading.Lock()

    def ensure_running(self) -> tuple[str, int]:
        with self._lock:
            if (
                self._proc is not None
                and self._proc.poll() is None
                and self._addr is not None
            ):
                return self._addr
            self._addr = None
            proc = subprocess.Popen(
                self.argv,
                stdin=subprocess.PIPE,
                stdout=subprocess.PIPE,
                text=True,
            )
            line = (proc.stdout.readline() or "").strip()  # type: ignore[union-attr]
            if not line.startswith(self.handshake_prefix):
                # A bad handshake must not leave a zombie child behind or
                # poison later calls with half-initialized state.
                try:
                    proc.kill()
                    proc.wait(timeout=5)
                except Exception:
                    pass
                raise self.error_cls(f"bad plugin handshake: {line!r}")
            self._proc = proc
            host, _, port = line[len(self.handshake_prefix):].partition(":")
            self._addr = (host, int(port))
            return self._addr

    def shutdown(self) -> None:
        with self._lock:
            if self._proc is not None:
                try:
                    self._proc.stdin.close()  # type: ignore[union-attr]
                    self._proc.wait(timeout=5)
                except Exception:
                    try:
                        self._proc.kill()
                        self._proc.wait(timeout=5)
                    except Exception:
                        pass
                self._proc = None
                self._addr = None

    def call(self, method: str, args=None, timeout_s: float = 30.0):
        addr = self.ensure_running()
        try:
            return self._pool.call(addr, method, args, timeout_s=timeout_s)
        except RPCError as e:
            raise self.error_cls(str(e)) from None


def instantiate_plugin(cls: type, config: Optional[dict]):
    """Build the plugin object, passing config only when the constructor
    takes it — inspected, not duck-typed, so a TypeError raised INSIDE a
    config-accepting __init__ propagates instead of silently dropping
    the operator's config."""
    import inspect

    try:
        params = inspect.signature(cls).parameters
    except (TypeError, ValueError):
        params = {}
    takes_arg = any(
        p.kind
        in (
            inspect.Parameter.POSITIONAL_ONLY,
            inspect.Parameter.POSITIONAL_OR_KEYWORD,
            inspect.Parameter.VAR_POSITIONAL,
            inspect.Parameter.VAR_KEYWORD,
        )
        or p.name == "config"
        for p in params.values()
    )
    return cls(config or {}) if takes_arg else cls()
