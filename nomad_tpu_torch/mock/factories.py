"""Mock object factories used by every layer's tests.

Reference: nomad/mock/mock.go — Node():14, Job():232, Alloc():1277,
Eval():1216. Shapes chosen to mirror the reference's defaults (4000MHz/8GB
nodes, 500MHz/256MB web tasks) so differential benchmarks are comparable.
"""

from __future__ import annotations

import itertools

from ..structs import (
    AllocatedResources,
    AllocatedTaskResources,
    Allocation,
    Constraint,
    Evaluation,
    Job,
    NetworkResource,
    Node,
    NodeResources,
    Port,
    Resources,
    Task,
    TaskGroup,
    UpdateStrategy,
    alloc_name,
    generate_uuid,
    now_ns,
)
from ..structs.structs import (
    EVAL_TRIGGER_JOB_REGISTER,
    EVAL_STATUS_PENDING,
    JOB_TYPE_BATCH,
    JOB_TYPE_SERVICE,
    JOB_TYPE_SYSBATCH,
    JOB_TYPE_SYSTEM,
    NODE_STATUS_READY,
    DriverInfo,
)
from ..structs.node_class import compute_node_class

_counter = itertools.count()


def node(**overrides) -> Node:
    i = next(_counter)
    n = Node(
        id=generate_uuid(),
        name=f"node-{i}",
        datacenter="dc1",
        node_class="linux-medium-pci",
        attributes={
            "kernel.name": "linux",
            "arch": "x86",
            "nomad.version": "1.2.0",
            "driver.exec": "1",
            "driver.mock": "1",
            "cpu.frequency": "2800",
            "cpu.numcores": "4",
        },
        resources=NodeResources(
            cpu=4000,
            memory_mb=8192,
            disk_mb=100 * 1024,
            total_cores=4,
            networks=[
                NetworkResource(
                    device="eth0", cidr="192.168.0.100/32", ip="192.168.0.100", mbits=1000
                )
            ],
        ),
        drivers={
            "mock": DriverInfo(detected=True, healthy=True),
            "exec": DriverInfo(detected=True, healthy=True),
        },
        status=NODE_STATUS_READY,
    )
    for k, v in overrides.items():
        setattr(n, k, v)
    n.canonicalize()
    n.computed_class = compute_node_class(n)
    return n


def _web_task() -> Task:
    return Task(
        name="web",
        driver="mock",
        config={"run_for": "0s"},
        env={"FOO": "bar"},
        resources=Resources(
            cpu=500,
            memory_mb=256,
            networks=[NetworkResource(mbits=50, dynamic_ports=[Port(label="http")])],
        ),
    )


def job(**overrides) -> Job:
    i = next(_counter)
    j = Job(
        id=f"mock-service-{generate_uuid()[:8]}-{i}",
        name="my-job",
        type=JOB_TYPE_SERVICE,
        priority=50,
        all_at_once=False,
        datacenters=["dc1"],
        constraints=[Constraint(ltarget="${attr.kernel.name}", rtarget="linux", operand="=")],
        task_groups=[
            TaskGroup(
                name="web",
                count=10,
                tasks=[_web_task()],
            )
        ],
        update=UpdateStrategy(
            stagger_s=30,
            max_parallel=5,
            health_check="checks",
            min_healthy_time_s=10,
            healthy_deadline_s=300,
            progress_deadline_s=600,
        ),
        status="pending",
        version=0,
        create_index=42,
        modify_index=99,
        job_modify_index=99,
    )
    for k, v in overrides.items():
        setattr(j, k, v)
    j.canonicalize()
    return j


def batch_job(**overrides) -> Job:
    j = job(**overrides)
    if "type" not in overrides:
        j.type = JOB_TYPE_BATCH
    if "id" not in overrides:
        j.id = f"mock-batch-{generate_uuid()[:8]}"
    j.update = None
    for tg in j.task_groups:
        tg.update = None
        tg.reschedule_policy = None
        tg.count = 1
        for t in tg.tasks:
            t.resources.networks = []
    j.canonicalize()
    return j


def system_job(**overrides) -> Job:
    j = job(**overrides)
    if "type" not in overrides:
        j.type = JOB_TYPE_SYSTEM
    if "id" not in overrides:
        j.id = f"mock-system-{generate_uuid()[:8]}"
    j.update = None
    for tg in j.task_groups:
        tg.count = 1
        tg.update = None
        tg.reschedule_policy = None
    j.canonicalize()
    return j


def sysbatch_job(**overrides) -> Job:
    j = system_job(**overrides)
    j.type = JOB_TYPE_SYSBATCH
    if "id" not in overrides:
        j.id = f"mock-sysbatch-{generate_uuid()[:8]}"
    return j


def alloc(job_: Job | None = None, node_: Node | None = None, index: int = 0, **overrides) -> Allocation:
    j = job_ if job_ is not None else job()
    tg = j.task_groups[0]
    a = Allocation(
        id=generate_uuid(),
        namespace=j.namespace,
        eval_id=generate_uuid(),
        name=alloc_name(j.id, tg.name, index),
        node_id=node_.id if node_ is not None else "",
        job_id=j.id,
        job=j,
        task_group=tg.name,
        resources=AllocatedResources(
            tasks={
                t.name: AllocatedTaskResources(
                    cpu=t.resources.cpu, memory_mb=t.resources.memory_mb
                )
                for t in tg.tasks
            },
            shared_disk_mb=tg.ephemeral_disk.size_mb,
        ),
        desired_status="run",
        client_status="pending",
        create_time=now_ns(),
        modify_time=now_ns(),
    )
    for k, v in overrides.items():
        setattr(a, k, v)
    return a


def evaluation(**overrides) -> Evaluation:
    e = Evaluation(
        id=generate_uuid(),
        priority=50,
        type=JOB_TYPE_SERVICE,
        triggered_by=EVAL_TRIGGER_JOB_REGISTER,
        job_id=generate_uuid(),
        status=EVAL_STATUS_PENDING,
        create_time=now_ns(),
        modify_time=now_ns(),
    )
    for k, v in overrides.items():
        setattr(e, k, v)
    return e


def eval_for_job(j: Job, **overrides) -> Evaluation:
    return evaluation(
        job_id=j.id,
        namespace=j.namespace,
        type=j.type,
        priority=j.priority,
        job_modify_index=j.job_modify_index,
        **overrides,
    )
