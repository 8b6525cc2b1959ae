"""Nothing the benchmark runs imports JAX or the JAX package, compared
by whole top-level module name; the reference imports nothing of the
program; without a card the harness fails and prints no result."""

import ast
import os
import subprocess
import sys

import pytest

from portbench import manifest
from portbench.run import FORBIDDEN

PROGRAM = "nomad_tpu_torch"


def _imports(path) -> set:
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub=""):
    root = manifest.HERE / sub
    return [p for p in root.rglob("*.py")
            if "tests" not in p.relative_to(manifest.HERE).parts]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_anywhere(path):
    assert not _imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", _sources("reference"),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    got = _imports(path)
    assert PROGRAM not in got and not got & set(FORBIDDEN)
    assert got <= {"__future__", "dataclasses", "re", "numpy"}


def test_prefix_is_not_a_match():
    """The port's name begins with the JAX package's: whole names only."""
    sys.modules.setdefault("nomad_tpu_torch_probe", object())
    try:
        from portbench.run import forbidden_modules

        assert "nomad_tpu" not in forbidden_modules()
    finally:
        sys.modules.pop("nomad_tpu_torch_probe", None)


def test_a_run_loads_nothing_forbidden():
    """Importing every module a run imports pulls in no JAX."""
    code = ("import sys; sys.path.insert(0, %r);"
            "import portbench.run, portbench.port, portbench.devtrace,"
            " portbench.roofline, portbench.control, portbench.faults;"
            "from portbench import manifest; b = manifest.load();"
            "[manifest.loop(manifest.cell(b, w['name'])['traffic'])"
            " for w in b['workloads']];"
            "from portbench.run import forbidden_modules;"
            "print(forbidden_modules())" % str(manifest.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, str(manifest.HERE / "run.py"), "--workload",
         "preempt.burst", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=manifest.ROOT)
    assert out.returncode != 0 and out.stdout == ""
