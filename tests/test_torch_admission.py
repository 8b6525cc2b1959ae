"""Job admission on both packages' Servers, on the CPU.

nomad_tpu's ``Server.job_register`` admits a job through
``check_eval_admission`` and ``validate_job_submission``: Connect sidecar
injection, the memory-oversubscription gate (``memory_max_mb`` is
stripped unless ``SchedulerConfig.memory_oversubscription`` is set) and a
cron check. The port's register once only canonicalised and validated,
so a job registered with ``memory_max_mb`` above ``memory_mb`` was stored
with it, and a re-register that changed only ``memory_max_mb`` rolled
every alloc. Each case registers the same job (built with nomad_tpu's
mocks, carried over the wire) on nomad_tpu's Server and on the port's
(workers on the CPU twins) and holds the two to the same outcome.
"""

import pytest

from nomad_tpu import codec as jcodec
from nomad_tpu import mock as jmock
from nomad_tpu.scheduler.context import SchedulerConfig as JConfig
from nomad_tpu.server import Server as JServer
from nomad_tpu.structs.structs import (
    Connect,
    NetworkResource,
    PeriodicConfig,
    Port,
    Service,
    SidecarService,
)

from nomad_tpu_torch import codec as tcodec
from nomad_tpu_torch.scheduler.context import SchedulerConfig as TConfig
from nomad_tpu_torch.server import Server as TServer

# Bookkeeping the two stores stamp differently (nomad_tpu's register
# also writes the default namespace, one raft entry more).
_INDEXES = ("create_index", "modify_index", "job_modify_index",
            "submit_time")


def _w(obj):
    return tcodec.from_wire(jcodec.to_wire(obj))


def _spec(wire):
    """A job's wire dict without its store indexes; the injected
    sidecar's module named without its package."""
    if isinstance(wire, dict):
        return {k: _spec(v) for k, v in wire.items() if k not in _INDEXES}
    if isinstance(wire, list):
        return [_spec(v) for v in wire]
    if isinstance(wire, str):
        return wire.replace("nomad_tpu_torch.connect", "nomad_tpu.connect")
    return wire


class Pair:
    """nomad_tpu's Server and the port's, leaders, on the same nodes."""

    def __init__(self, oversubscribe=False, **broker):
        # the knob is passed only when set: the default config is the
        # one the fault showed under
        knob = {"memory_oversubscription": True} if oversubscribe else {}
        self.j = JServer(num_workers=2, scheduler_config=JConfig(**knob))
        self.t = TServer(num_workers=2, scheduler_config=TConfig(
            device="cpu", **knob))
        for s in (self.j, self.t):
            for k, v in broker.items():
                setattr(s.eval_broker, k, v)
            s.establish_leadership()
        for _ in range(3):
            n = jmock.node()
            self.j.node_register(n)
            self.t.node_register(_w(n))

    def register(self, job):
        """Register on both; returns the two eval ids."""
        return self.j.job_register(job), self.t.job_register(_w(job))

    def settle(self):
        assert self.j.wait_for_evals(20) and self.t.wait_for_evals(20)

    def stored(self, job):
        return (self.j.state.job_by_id(job.namespace, job.id),
                self.t.state.job_by_id(job.namespace, job.id))

    def shutdown(self):
        self.j.shutdown()
        self.t.shutdown()


@pytest.fixture
def pair():
    p = Pair()
    yield p
    p.shutdown()


def _memory_max_job(memory_max_mb=512):
    job = jmock.job(id="memmax")
    tg = job.task_groups[0]
    tg.count = 2
    tg.tasks[0].resources.memory_mb = 128
    tg.tasks[0].resources.memory_max_mb = memory_max_mb
    tg.tasks[0].resources.networks = []
    return job


def test_memory_max_stripped_at_register(pair):
    """Default config: both stores hold the job with memory_max_mb 0,
    and the two stored specs are equal."""
    job = _memory_max_job()
    pair.register(job)
    pair.settle()
    js, ts = pair.stored(job)
    assert js.task_groups[0].tasks[0].resources.memory_max_mb == 0
    assert ts.task_groups[0].tasks[0].resources.memory_max_mb == 0
    assert _spec(tcodec.to_wire(ts)) == _spec(jcodec.to_wire(js))


def test_memory_max_only_reregister_is_a_noop(pair):
    """A re-register that changes only memory_max_mb: both servers keep
    the job's version, and its eval stops and places nothing."""
    job = _memory_max_job()
    pair.register(job)
    pair.settle()

    def live(srv):
        return sorted((a.name, a.node_id, a.id) for a in
                      srv.state.allocs_by_job(job.namespace, job.id)
                      if not a.terminal_status())

    before = live(pair.j), live(pair.t)
    assert len(before[0]) == len(before[1]) == 2
    jev, tev = pair.register(_memory_max_job(memory_max_mb=1024))
    pair.settle()
    for srv, ev_id, was in ((pair.j, jev, before[0]),
                            (pair.t, tev, before[1])):
        assert srv.state.eval_by_id(ev_id).status == "complete"
        assert live(srv) == was  # nothing stopped, nothing placed
        allocs = srv.state.allocs_by_job(job.namespace, job.id)
        assert len(allocs) == 2
        assert srv.state.job_by_id(job.namespace, job.id).version == 0


def test_memory_oversubscription_keeps_memory_max():
    """With SchedulerConfig(memory_oversubscription=True) both servers
    keep memory_max_mb."""
    p = Pair(oversubscribe=True)
    try:
        job = _memory_max_job()
        p.register(job)
        js, ts = p.stored(job)
        assert js.task_groups[0].tasks[0].resources.memory_max_mb == 512
        assert ts.task_groups[0].tasks[0].resources.memory_max_mb == 512
        assert _spec(tcodec.to_wire(ts)) == _spec(jcodec.to_wire(js))
    finally:
        p.shutdown()


def test_plan_applies_the_same_gate(pair):
    """job_plan strips memory_max_mb as register does: a plan that
    changes only memory_max_mb shows no changes on either server."""
    job = _memory_max_job()
    pair.register(job)
    pair.settle()
    cand = _memory_max_job(memory_max_mb=2048)
    jr, tr = pair.j.job_plan(cand), pair.t.job_plan(_w(cand))
    assert jr["Changes"] is False and tr["Changes"] is False
    assert tr["Annotations"] == jr["Annotations"]
    assert tr["Diff"] == jr["Diff"]


@pytest.mark.parametrize("spec", ["not a cron", "61 * * * *",
                                  "@every 0s", "*/5 * * *"])
def test_malformed_cron_refused_at_register(pair, spec):
    job = jmock.job(id="bad-cron")
    job.type = "batch"
    job.periodic = PeriodicConfig(enabled=True, spec=spec)
    with pytest.raises(ValueError):
        pair.j.job_register(job)
    with pytest.raises(ValueError):
        pair.t.job_register(_w(job))
    assert pair.j.state.job_by_id(job.namespace, job.id) is None
    assert pair.t.state.job_by_id(job.namespace, job.id) is None


def _connect_job(job_id="api"):
    """tests/test_connect.py connect_job's shape."""
    job = jmock.job(id=job_id)
    tg = job.task_groups[0]
    tg.count = 1
    tg.networks = [NetworkResource(
        mode="bridge", dynamic_ports=[Port(label="http", to=8080)])]
    tg.tasks[0].resources.networks = []
    tg.services = [Service(name=job_id, port_label="http",
                           connect=Connect(sidecar_service=SidecarService()))]
    return job


def test_connect_job_stored_with_the_same_sidecar(pair):
    """A Connect job is stored with the same injected sidecar task, port
    and mesh service on both servers (the sidecar runs each package's
    own relay module)."""
    job = _connect_job()
    pair.register(job)
    js, ts = pair.stored(job)
    tasks = [t.name for t in ts.task_groups[0].tasks]
    assert tasks == [t.name for t in js.task_groups[0].tasks]
    assert "connect-proxy-api" in tasks
    sidecar = ts.task_groups[0].lookup_task("connect-proxy-api")
    assert sidecar.config["args"][1] == "nomad_tpu_torch.connect.sidecar"
    assert _spec(tcodec.to_wire(ts)) == _spec(jcodec.to_wire(js))


def test_connect_needs_bridge_mode(pair):
    from nomad_tpu.connect.hook import ConnectValidationError as JErr
    from nomad_tpu_torch.connect.hook import ConnectValidationError as TErr

    job = _connect_job()
    job.task_groups[0].networks[0].mode = "host"
    with pytest.raises(JErr):
        pair.j.job_register(job)
    with pytest.raises(TErr):
        pair.t.job_register(_w(job))


def test_saturated_broker_refuses_register_before_raft():
    """A broker at its admission depth: register, force-evaluate and
    dispatch are refused before raft with a retry hint on both."""
    from nomad_tpu.ratelimit import BrokerSaturatedError as JSat
    from nomad_tpu_torch.ratelimit import BrokerSaturatedError

    p = Pair(admission_depth=1)
    try:
        for s in (p.j, p.t):  # no worker dequeues the pending eval
            for w in s.workers:
                w.stop()
            for w in s.workers:
                w.join(timeout=5)
        first = jmock.job(id="first")
        p.register(first)  # one pending eval: the broker is at its depth
        job = jmock.job(id="second")
        with pytest.raises(JSat):
            p.j.job_register(job)
        with pytest.raises(BrokerSaturatedError) as err:
            p.t.job_register(_w(job))
        assert err.value.retry_after_s > 0
        assert p.t.state.job_by_id(job.namespace, job.id) is None
        with pytest.raises(BrokerSaturatedError):
            p.t.job_force_evaluate(first.namespace, first.id)
    finally:
        p.shutdown()
