"""Everything the benchmark touches of the program under test,
`nomad_tpu_torch`: the Server it drives, the structs it hands it, the
store it watches and reads back, the metrics registry and the kernel
entry points it counts. Imported only once the harness has checked for
a card (or by a test that drives the CPU twins)."""

from __future__ import annotations

import queue
import threading
import time

from nomad_tpu_torch import gctune, metrics
from nomad_tpu_torch.scheduler.context import SchedulerConfig
from nomad_tpu_torch.server import Server
from nomad_tpu_torch.state.store import TABLE_ALLOCS, TABLE_EVALS
from nomad_tpu_torch.structs import (
    AllocatedResources,
    AllocatedTaskResources,
    Allocation,
    Constraint,
    Job,
    NetworkResource,
    Node,
    NodeResources,
    Resources,
    Spread,
    Task,
    TaskGroup,
)
from nomad_tpu_torch.structs.node_class import compute_node_class
from nomad_tpu_torch.structs.structs import (
    JOB_TYPE_SERVICE,
    NODE_STATUS_READY,
    DriverInfo,
    alloc_name,
    generate_uuid,
)

from .reference.check import Allocs

NAMESPACE = "default"
# node registrations a raft entry during set-up
NODE_CHUNK = 1000
# eval statuses after which an eval is done with
DONE = ("complete", "failed", "canceled")
# alloc statuses the servers set when they stop an alloc, and those a
# client reports once it has
STOPPED = ("stop", "evict")
CLIENT_DONE = ("complete", "failed", "lost")
# allocs the clients report in one call
ACK_CHUNK = 10000


def to_node(fleet, i: int) -> Node:
    node = Node(
        id=fleet.ids[i],
        name=f"node-{i}",
        datacenter=fleet.datacenter[i],
        node_class="linux-medium",
        attributes={"kernel.name": fleet.kernel, "arch": "x86",
                    "driver.mock": "1"},
        resources=NodeResources(
            cpu=int(fleet.cpu_mhz[i]),
            memory_mb=int(fleet.memory_mb[i]),
            disk_mb=int(fleet.disk_mb[i]),
            networks=[NetworkResource(device="eth0",
                                      cidr="192.168.0.100/32",
                                      ip="192.168.0.100", mbits=1000)],
        ),
        drivers={"mock": DriverInfo(detected=True, healthy=True)},
        status=NODE_STATUS_READY,
    )
    node.canonicalize()
    node.computed_class = compute_node_class(node)
    return node


def to_job(spec) -> Job:
    task = Task(name="web", driver="mock", config={"run_for": "0s"},
                resources=Resources(cpu=spec.cpu_mhz,
                                    memory_mb=spec.memory_mb))
    job = Job(
        id=spec.id,
        name=spec.id,
        type=JOB_TYPE_SERVICE,
        priority=spec.priority,
        datacenters=list(spec.datacenters),
        task_groups=[TaskGroup(name="web", count=spec.count, tasks=[task])],
    )
    if spec.kernel:
        job.constraints = [Constraint("${attr.kernel.name}", spec.kernel,
                                      "=")]
    if spec.spread_weight:
        job.spreads = [Spread(attribute="${node.datacenter}",
                              weight=spec.spread_weight)]
    job.canonicalize()
    return job


class EvalWatch:
    """Timestamps each eval's end from the store's own publish, on the
    thread that applies the write: `done` maps an eval id to (host
    seconds, status), and each end is also put on `ends` for a driver
    that waits on them."""

    def __init__(self, state) -> None:
        self.done: dict = {}
        self.ends: "queue.SimpleQueue" = queue.SimpleQueue()
        state.subscribe(self._on_write)

    def _on_write(self, index, table, objs, etype) -> None:
        if table != TABLE_EVALS:
            return
        now = time.perf_counter()
        for ev in objs:
            if ev.status in DONE and ev.id not in self.done:
                self.done[ev.id] = (now, ev.status)
                self.ends.put(ev.id)


class Clients:
    """The fleet's clients, as far as the servers see them (the
    benchmark runs none): every `report_s` seconds they report each
    alloc that a committed plan stopped or evicted since their last
    report as complete, through the server's client update. That is the
    capacity event a blocked eval waits for: the jobs a preemption
    evicted are placed again once room frees. `stopped_at` keeps the
    raft index at which each alloc was stopped or evicted."""

    def __init__(self, srv, report_s: float) -> None:
        self.srv = srv
        self.report_s = report_s
        self.todo: "queue.SimpleQueue" = queue.SimpleQueue()
        self.stopped_at: dict = {}
        self.reported = 0
        self._stop = threading.Event()
        self._thread = None
        srv.state.subscribe(self._on_write)

    def _on_write(self, index, table, objs, etype) -> None:
        if table != TABLE_ALLOCS or etype != "PlanResult":
            return
        for a in objs:
            if a.desired_status in STOPPED and a.id not in self.stopped_at:
                self.stopped_at[a.id] = index
                if a.client_status not in CLIENT_DONE:
                    self.todo.put((a.id, a.namespace, a.job_id, a.node_id,
                                   a.name))

    def report(self) -> int:
        """Report what waits now; returns how many."""
        got: dict = {}
        while True:
            try:
                a = self.todo.get_nowait()
            except queue.Empty:
                break
            got[a[0]] = Allocation(id=a[0], namespace=a[1], job_id=a[2],
                                   node_id=a[3], name=a[4],
                                   client_status="complete")
        todo = list(got.values())
        for i in range(0, len(todo), ACK_CHUNK):
            self.srv.update_allocs_from_client(todo[i:i + ACK_CHUNK])
        self.reported += len(todo)
        return len(todo)

    def _loop(self) -> None:
        while not self._stop.wait(self.report_s):
            self.report()

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="portbench-clients")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None


class System:
    """One Server with the GPU batch worker, on the server's defaults
    but for the device its solver uses."""

    def __init__(self, device: str, report_s: float = 1.0) -> None:
        self.srv = Server(use_tpu_batch_worker=True,
                          scheduler_config=SchedulerConfig(device=device))
        self.srv.establish_leadership()
        self.watch = EvalWatch(self.srv.state)
        self.clients = Clients(self.srv, report_s)

    def register_fleet(self, fleet) -> None:
        nodes = [to_node(fleet, i) for i in range(len(fleet))]
        for i in range(0, len(nodes), NODE_CHUNK):
            self.srv.raft_apply("node_register_batch",
                                nodes[i:i + NODE_CHUNK])

    def commit_fill(self, fleet, layout) -> None:
        """The fill as a running cluster holds it, committed through
        raft without a scheduler pass: each job registered with no
        eval, then its allocs, running, on the nodes `layout`
        (inputs.fill_layout) deals them to."""
        for spec, positions in layout:
            job = to_job(spec)
            self.srv.raft_apply("job_register", (job, None))
            job = self.srv.state.job_by_id(NAMESPACE, spec.id)
            tg = job.task_groups[0]
            allocs = [Allocation(
                id=generate_uuid(), namespace=NAMESPACE,
                eval_id="", name=alloc_name(job.id, tg.name, i),
                node_id=fleet.ids[int(pos)], job_id=job.id, job=job,
                task_group=tg.name,
                resources=AllocatedResources(
                    tasks={t.name: AllocatedTaskResources(
                        cpu=t.resources.cpu,
                        memory_mb=t.resources.memory_mb)
                        for t in tg.tasks},
                    shared_disk_mb=tg.ephemeral_disk.size_mb),
                desired_status="run", client_status="running")
                for i, pos in enumerate(positions)]
            self.srv.raft_apply("alloc_update", allocs)

    def freeze(self) -> None:
        """What a server does once it is warm (gctune's post-warm-up
        form): move the resident heap out of the collector's scans."""
        gctune.freeze_resident_heap()

    def register(self, job) -> str:
        return self.srv.job_register(job)

    def deregister(self, job_id: str) -> str:
        return self.srv.job_deregister(NAMESPACE, job_id)

    def latest_index(self) -> int:
        return self.srv.state.latest_index()

    def quiet(self) -> bool:
        """No eval waits in the broker or runs, no plan waits."""
        b = self.srv.eval_broker
        return (b.pending_count() == 0 and b.inflight_count() == 0
                and self.srv.plan_queue.depth() == 0)

    def wait_quiet(self, timeout_s: float, settle_s: float = 0.5) -> bool:
        """Until the system has been quiet for settle_s, or timeout_s."""
        deadline = time.perf_counter() + timeout_s
        since = None
        while time.perf_counter() < deadline:
            if self.quiet():
                since = since or time.perf_counter()
                if time.perf_counter() - since >= settle_s:
                    return True
            else:
                since = None
            time.sleep(0.02)
        return False

    def allocs(self) -> Allocs:
        """The committed allocations, read column by column: the lazy
        rows of a placement batch answer these fields without being
        materialized. eval_index is the raft index at which the eval
        that placed the alloc was created, stop_index the one at which a
        committed plan stopped or evicted it (0: never)."""
        st = self.srv.state
        made = {e.id: e.create_index
                for e in list(st._tables[TABLE_EVALS].values())}
        stopped_at = self.clients.stopped_at
        out = Allocs([], [], [], [], [], [], [], [], [], [])
        for a in list(st._tables[TABLE_ALLOCS].values()):
            out.id.append(a.id)
            out.job_id.append(a.job_id)
            out.name.append(a.name)
            out.node_id.append(a.node_id)
            out.desired_status.append(a.desired_status)
            out.client_status.append(a.client_status)
            out.preempted_by.append(
                a.preempted_by_allocation
                if a.desired_status == "evict" else "")
            out.create_index.append(a.create_index)
            out.eval_index.append(made.get(a.eval_id, 0))
            out.stop_index.append(stopped_at.get(a.id, 0))
        return out

    def diagnose(self, job_ids: list) -> dict:
        """What the store and the registry say of jobs the judge found
        short: each one's evals (trigger, status, unplaced allocs,
        blocked eval) and the worker's fault counters."""
        st = self.srv.state
        jobs = {}
        for job_id in job_ids[:4]:
            live = sum(1 for a in st.allocs_by_job(NAMESPACE, job_id)
                       if a.desired_status == "run")
            evs = sorted(st.evals_by_job(NAMESPACE, job_id),
                         key=lambda e: e.create_index)
            jobs[job_id] = {"live": live, "evals": [
                [e.triggered_by, e.status, e.create_index,
                 sum(m.coalesced_failures + 1
                     for m in e.failed_tg_allocs.values()),
                 e.status_description[:60]] for e in evs]}
        counters = metrics.snapshot()["counters"]
        keys = ("nomad.tpu.partial_commits", "nomad.tpu.chained_batches",
                "nomad.tpu.chain_parent_failed", "nomad.worker.invoke.failed",
                "nomad.worker.device_failover",
                "nomad.worker.backpressure_throttled")
        return {"jobs": jobs,
                "counters": {k: counters.get(k, 0) for k in keys},
                "blocked": dict(self.srv.blocked_evals.stats)}

    def shutdown(self) -> None:
        self.clients.stop()
        self.srv.shutdown()
        for t in threading.enumerate():
            if t is not threading.current_thread() and not t.daemon:
                t.join(timeout=10)


def metrics_snapshot() -> dict:
    return metrics.snapshot()
