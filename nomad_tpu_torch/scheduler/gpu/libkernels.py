"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` (one ``nvcc`` per source,
all started together) and the objects link into one shared library with
a plain C interface, which ``ctypes`` loads. The build happens at first
use, into ``_build/`` inside the package (listed in ``.gitignore``), under
a name keyed by the sources, their headers (``csrc/*.cuh``) and the
flags, so an edited kernel or header never loads a stale library.
Nothing here runs at import time: the CPU tests import every module of
the package on a machine with no ``nvcc``.

Every C entry point returns the ``cudaError_t`` of its launches; the
wrappers in kernels.py raise on a nonzero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# --fmad=false and IEEE division: the placement score must round exactly
# as the reference kernel's does, with its fused steps written out as
# __fmaf_rn (csrc/solve_common.cuh). No fast math.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# wall seconds of this process's build (None: loaded a finished build or
# not loaded yet) and the compilers' output (ptxas register/spill lines)
build_seconds: Optional[float] = None
build_log = ""


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _build() -> Path:
    global build_seconds, build_log
    srcs = sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    lib_path = BUILD_DIR / f"libnomad_kernels-{h.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    work = BUILD_DIR / f"work-{os.getpid()}"
    work.mkdir(exist_ok=True)
    try:
        procs = [
            (
                src,
                subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", str(src),
                     "-o", str(work / (src.stem + ".o"))],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                ),
            )
            for src in srcs
        ]
        logs, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        build_log = "".join(logs)
        if failed:
            raise RuntimeError(
                f"nvcc failed for {', '.join(failed)}:\n{build_log}"
            )
        tmp_lib = work / lib_path.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib),
             *[str(work / (s.stem + ".o")) for s in srcs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return lib_path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nomad_solve_compact.argtypes = [
        p, p, p, p,      # cap, used_in, asks, counts
        p, p, p, p,      # feas_packed, feas_idx, bias_rows, bias_idx
        p, i, p,         # ucap_rows, ucap_i16, ucap_idx
        i, i, i, i,      # np, gp, max_count, k
        p, p, p,         # score, units, pick scratch
        p, p, p,         # inst, over, used_out
        p, p,            # launch info (host), stream
    ]
    lib.nomad_solve_compact.restype = i
    lib.nomad_solve_dense.argtypes = [
        p, p, p, p,      # cap, used, asks, counts
        p, p, p,         # feas, bias, ucap
        i, i,            # np, gp
        p, p, p,         # workspace, assign, used_out
        p, p,            # launch info (host), stream
    ]
    lib.nomad_solve_dense.restype = i
    lib.nomad_solve_preempt.argtypes = [
        p, p, p, i,      # cap, used_exist, prefix, tp
        p, p,            # asks, counts
        p, p, p, p,      # feas, bias, ucap, tier_limit
        i, i,            # np, gp
        p, p, p, p,      # workspace, assign, evict, used_out
        p, p,            # launch info (host), stream
    ]
    lib.nomad_solve_preempt.restype = i
    lib.nomad_shard_score.argtypes = [
        i, i, i,         # mode, g, init
        p, p, p,         # cap, used_in, used
        p, p, p,         # used_new, freed, take1
        p, i, p, p,      # prefix, tp, tier_limit, rem
        p, p,            # asks, counts
        p, p, p,         # feas, bias, ucap
        p, p,            # assign, evict
        p, p,            # score, units scratch
        p, p, p,         # gathered score, units, index
        i, i, i, i,      # shards on the card, w, first shard, k
        p,               # stream
    ]
    lib.nomad_shard_score.restype = i
    lib.nomad_shard_cluster.argtypes = [i, i]  # shards on the card, w
    lib.nomad_shard_cluster.restype = i
    lib.nomad_candidate_fill.argtypes = [
        i, p, p,         # g, asks, counts
        p, p, p,         # gathered score, units, index
        i, i, i, i, i,   # d, k, w, first shard, rows
        p, p, p, i, p,   # used, assign, inst, max_count, picks scratch
        i, p,            # gp, stream
    ]
    lib.nomad_candidate_fill.restype = i
    lib.nomad_gathered_waterfill.argtypes = [
        i, i, p, p, p,   # mode, g, asks, counts, rem
        p, p,            # gathered score, units
        i, i, i,         # np, first global row, rows
        p, p, p,         # cap, used_in, used
        p, p, p,         # used_new, freed, take1
        p, i, p,         # prefix, tp, tier_limit
        p, p,            # assign, evict
        p,               # stream
    ]
    lib.nomad_gathered_waterfill.restype = i
    lib.nomad_water_cluster.argtypes = [i]  # gathered entries
    lib.nomad_water_cluster.restype = i
    lib.nomad_shard_finish.argtypes = [
        i, p, p, p,      # preempt, cap, used_in, used
        p, p, p, p,      # freed, used_new, used_out, over
        i,               # rows
        p, i, i, p, i,   # picks, gp, D*k, inst, max_count (compact mode)
        p,               # stream
    ]
    lib.nomad_shard_finish.restype = i
    for name in ("nomad_scatter_rows", "nomad_scatter_add_rows"):
        fn = getattr(lib, name)
        # src, dst, idx, rows, b, np, stream
        fn.argtypes = [p, p, p, p, i, i, p]
        fn.restype = i
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(_build())))
        return _lib


def loaded() -> bool:
    """Whether the kernel library is built and loaded in this process."""
    return _lib is not None


def check(code: int, kernel: str) -> None:
    """Raise on a nonzero cudaError_t from a launch."""
    if code != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed (cudaError {code})")
