"""The port's import rule, for every module of ``nomad_tpu_torch``.

* No module imports ``jax`` or anything of ``nomad_tpu``: the port keeps
  its own copy of every module it needs, and state crosses between the
  two packages only as wire dicts, in the tests.
* ``torch`` is imported at module load only under ``scheduler/gpu``;
  everywhere else it is imported inside the function that needs it, so
  the host modules load without it.
* A fresh interpreter importing the tenancy and cluster tables' modules
  (ACL, the event stream, the volume watcher, the watch hub, search)
  loads neither torch nor jax nor nomad_tpu.
"""

import ast
import pathlib
import subprocess
import sys

import pytest

PKG = pathlib.Path(__file__).resolve().parents[1] / "nomad_tpu_torch"
MODULES = sorted(PKG.rglob("*.py"))


def _imported(node):
    """Top-level package names an import statement names."""
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
        return [node.module]
    return []


def _load_time_imports(tree):
    """Imports that run when the module loads: everything but what sits
    inside a function body."""
    out = []
    todo = list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        out.extend(_imported(node))
        todo.extend(ast.iter_child_nodes(node))
    return out


def _rel(path):
    return path.relative_to(PKG.parent).as_posix()


def test_every_module_is_scanned():
    assert len(MODULES) > 80
    assert PKG / "acl" / "policy.py" in MODULES
    assert PKG / "stream" / "event_broker.py" in MODULES


@pytest.mark.parametrize("path", MODULES, ids=_rel)
def test_module_never_imports_jax_or_nomad_tpu(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [name for node in ast.walk(tree) for name in _imported(node)
           if name.split(".")[0] in ("jax", "jaxlib", "nomad_tpu")]
    assert bad == [], f"{_rel(path)} imports {bad}"


@pytest.mark.parametrize("path", MODULES, ids=_rel)
def test_torch_loads_eagerly_only_under_scheduler_gpu(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    eager = [name for name in _load_time_imports(tree)
             if name.split(".")[0] in ("torch", "triton")]
    if path.is_relative_to(PKG / "scheduler" / "gpu"):
        return
    assert eager == [], f"{_rel(path)} imports {eager} at module load"


def test_tenancy_modules_load_no_torch_jax_or_nomad_tpu():
    code = (
        "import sys\n"
        "import nomad_tpu_torch.acl\n"
        "import nomad_tpu_torch.jobspec\n"
        "import nomad_tpu_torch.stream\n"
        "import nomad_tpu_torch.state.events\n"
        "import nomad_tpu_torch.server.search\n"
        "import nomad_tpu_torch.server.watch_hub\n"
        "import nomad_tpu_torch.server.volume_watcher\n"
        "import nomad_tpu_torch.server.core_sched\n"
        "bad = sorted(m for m in sys.modules if m in ('torch', 'jax')"
        " or m.startswith(('torch.', 'jax.', 'nomad_tpu.')) or m == "
        "'nomad_tpu')\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        check=True, timeout=120, cwd=str(PKG.parent),
    ).stdout.strip()
    assert out == "[]"
