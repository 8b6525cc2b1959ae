"""``tests/test_feasible.py`` against the port.

Its cases with their imports pointed at ``nomad_tpu_torch``
(``scheduler.tpu`` read as ``scheduler.gpu``) and the reference's
scheduler defaults written out in place of a conftest: a
``SchedulerConfig`` built here defaults to ``backend="host"`` (the
reference's default), reads the backend ``"tpu"`` as ``"gpu"`` and runs
on ``device="cpu"``; a ``Harness`` pass given no config runs on that
default. The assertions are the reference's.
"""

from nomad_tpu_torch import mock
from nomad_tpu_torch.scheduler.context import EvalContext
from nomad_tpu_torch.scheduler.feasible import (
    check_constraint,
    check_version_constraint,
    node_matches_constraint,
    resolve_target,
)
from nomad_tpu_torch.structs import Constraint
from nomad_tpu_torch.testing import Harness as _PortHarness

from nomad_tpu_torch.scheduler.context import SchedulerConfig as _PortConfig


def SchedulerConfig(**kw):
    """The port's config with the reference's defaults, on the CPU."""
    kw.setdefault("backend", "host")
    if kw["backend"] == "tpu":
        kw["backend"] = "gpu"
    kw.setdefault("device", "cpu")
    return _PortConfig(**kw)


class Harness(_PortHarness):
    """The port's Harness; a pass given no config runs on
    SchedulerConfig()'s defaults above."""

    def process(self, scheduler_name, eval_obj, config=None, **kwargs):
        return super().process(scheduler_name, eval_obj,
                               config or SchedulerConfig(), **kwargs)


def ctx():
    return EvalContext(Harness().snapshot())


def test_resolve_target_forms():
    n = mock.node()
    assert resolve_target(n, "${node.datacenter}") == ("dc1", True)
    assert resolve_target(n, "${node.unique.id}") == (n.id, True)
    assert resolve_target(n, "${attr.kernel.name}") == ("linux", True)
    assert resolve_target(n, "${attr.nope}")[1] is False
    assert resolve_target(n, "literal") == ("literal", True)
    n.meta["rack"] = "r1"
    assert resolve_target(n, "${meta.rack}") == ("r1", True)


def test_comparison_operands():
    c = ctx()
    assert check_constraint(c, "=", "a", "a", True, True)
    assert not check_constraint(c, "=", "a", "b", True, True)
    assert check_constraint(c, "!=", "a", "b", True, True)
    # numeric compare
    assert check_constraint(c, ">", "10", "9", True, True)
    assert not check_constraint(c, ">", "9", "10", True, True)
    # lexical fallback
    assert check_constraint(c, "<", "abc", "abd", True, True)
    assert check_constraint(c, "is_set", "x", "", True, False)
    assert check_constraint(c, "is_not_set", "", "", False, False)


def test_regex_and_sets():
    c = ctx()
    assert check_constraint(c, "regexp", "linux-4.15", r"^linux", True, True)
    assert not check_constraint(c, "regexp", "darwin", r"^linux", True, True)
    assert check_constraint(c, "set_contains", "a,b,c", "b,c", True, True)
    assert not check_constraint(c, "set_contains", "a,b", "b,c", True, True)
    assert check_constraint(c, "set_contains_any", "a,b", "c,b", True, True)


def test_version_constraints():
    assert check_version_constraint("1.2.3", ">= 1.2")
    assert check_version_constraint("1.2.3", ">= 1.2, < 2.0")
    assert not check_version_constraint("2.1.0", ">= 1.2, < 2.0")
    assert check_version_constraint("1.2.3", "~> 1.2")
    assert not check_version_constraint("1.3.0", "~> 1.2.0")
    assert check_version_constraint("0.9.0", "= 0.9.0")
    assert not check_version_constraint("0.9.1", "= 0.9.0")
    # pre-release ordering
    assert check_version_constraint("1.0.0", "> 1.0.0-beta1")


def test_node_matches_constraint():
    c = ctx()
    n = mock.node()
    assert node_matches_constraint(
        c, n, Constraint("${attr.kernel.name}", "linux", "=")
    )
    assert not node_matches_constraint(
        c, n, Constraint("${attr.kernel.name}", "windows", "=")
    )
    assert node_matches_constraint(
        c, n, Constraint("${attr.cpu.numcores}", "2", ">=")
    )


def test_class_memoization():
    from nomad_tpu_torch.scheduler.feasible import ConstraintChecker, feasibility_pipeline

    c = ctx()
    job = mock.job()
    c.eligibility.set_job(job)
    nodes = [mock.node() for _ in range(50)]  # identical class
    calls = 0

    class CountingChecker:
        def feasible(self, node):
            nonlocal calls
            calls += 1
            return True, ""

    out = list(
        feasibility_pipeline(c, nodes, [CountingChecker()], [], "web")
    )
    assert len(out) == 50
    assert calls == 1  # memoized per computed class
