"""The C fastpack (``fastpack.c``), compiled on demand.

gcc builds the extension into ``nomad_tpu_torch/_build/`` (listed in
``.gitignore``), under a name keyed by the source's hash and the
interpreter's ABI tag, as ``scheduler/gpu/libkernels.py`` keys the CUDA
library: an edited source never loads a stale build. Nothing here runs
at import time; ``codec.warm_native()`` is the one place that calls
:func:`load_fastpack`, outside every lock.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path

_SRC = Path(__file__).parent / "fastpack.c"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CFLAGS = ("-O2", "-shared", "-fPIC")
_LOCK = threading.Lock()
_module = None
_load_failed = False

# The extension's public surface, one build for all of it. Each entry
# has a pure-Python twin with identical behavior; tests/test_torch_native.py
# pins this list against the C method table and the twins.
FASTPACK_ENTRY_POINTS = (
    "pack",            # elide-defaults msgpack encoder (codec.pack)
    "unpack",          # msgpack decoder to structs (codec.unpack)
    "register_class",  # class-plan registry sync (codec.warm_native)
    "clear_registry",
    "uuid_hex",        # bulk id formatting (structs.generate_uuids)
    "wire_rows",       # SoA plan-row wire assembly (placement_batch)
    "pick_ports",      # bulk dynamic-port picking (structs.network)
    "store_rows",      # bulk store id-index inserts (state.store)
)

# Wall seconds load_fastpack spent making the extension importable in
# this process (compile on a cold cache, dlopen on a warm one); -1.0
# until attempted.
last_build_seconds: float = -1.0
# why the last load failed ("" when it did not)
last_error = ""


def load_fastpack():
    """Compile (once) and import the fastpack extension; None when the
    toolchain is unavailable — callers fall back to the Python twins."""
    global _module, _load_failed, last_build_seconds, last_error
    if _module is not None or _load_failed:
        return _module
    with _LOCK:
        if _module is not None or _load_failed:
            return _module
        import time

        t0 = time.monotonic()
        try:
            _module = _build_and_load()
        except Exception as exc:
            import logging

            logging.getLogger("nomad_tpu_torch.native").warning(
                "fastpack build failed (%s); using the pure-Python twins",
                exc,
            )
            last_error = str(exc)
            _load_failed = True
        last_build_seconds = time.monotonic() - t0
    return _module


def _build_and_load():
    if os.environ.get("NOMAD_TPU_NO_FASTPACK"):
        raise RuntimeError("fastpack disabled by NOMAD_TPU_NO_FASTPACK")
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    h.update(_SRC.read_bytes())
    abi = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    so = BUILD_DIR / f"fastpack-{h.hexdigest()[:16]}{abi}"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cc = shutil.which("gcc") or shutil.which("cc")
        if cc is None:
            raise RuntimeError("no C compiler")
        include = sysconfig.get_paths()["include"]
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [cc, *CFLAGS, f"-I{include}", "-o", tmp, str(_SRC)],
            capture_output=True, text=True, timeout=120,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"fastpack compile failed: {proc.stderr[:400]}")
        os.replace(tmp, so)
    loader = importlib.machinery.ExtensionFileLoader("fastpack", str(so))
    spec = importlib.util.spec_from_loader("fastpack", loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    return mod
