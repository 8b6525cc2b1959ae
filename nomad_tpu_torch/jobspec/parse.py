"""Jobspec stanza mapping: HCL body → Job struct.

Port of ``nomad_tpu/jobspec/parse.py``.

Reference: jobspec/parse.go + parse_job.go / parse_group.go /
parse_task.go (5,330 LoC of hand-rolled mapstructure); same stanza
vocabulary here, mapped onto the port's structs.
"""

from __future__ import annotations

from typing import Optional

from ..structs.structs import (
    Affinity,
    Constraint,
    EphemeralDisk,
    Job,
    LogConfig,
    MigrateStrategy,
    NetworkResource,
    ParameterizedJobConfig,
    PeriodicConfig,
    Port,
    ReschedulePolicy,
    Resources,
    RestartPolicy,
    ScalingPolicy,
    Service,
    Spread,
    SpreadTarget,
    Task,
    TaskArtifact,
    TaskGroup,
    TaskLifecycleConfig,
    Template,
    UpdateStrategy,
    VolumeMount,
    VolumeRequest,
    RequestedDevice,
)
from .hcl import Block, Body, HCLParseError, parse, parse_duration


class JobspecError(Exception):
    pass


def parse_job(src: str, variables: Optional[dict] = None) -> Job:
    """Parse an HCL jobspec into a Job (reference jobspec2.Parse)."""
    body = parse(src, variables)
    jb = body.block("job")
    if jb is None:
        raise JobspecError("no job block found")
    return _job(jb)


def _job(b: Block) -> Job:
    a = b.body.attrs()
    job = Job(
        id=b.labels[0] if b.labels else a.get("id", ""),
        name=a.get("name", b.labels[0] if b.labels else ""),
        namespace=a.get("namespace", "default"),
        region=a.get("region", "global"),
        type=a.get("type", "service"),
        priority=int(a.get("priority", 50)),
        all_at_once=bool(a.get("all_at_once", False)),
        datacenters=list(a.get("datacenters", ["dc1"])),
        meta={k: str(v) for k, v in a.get("meta", {}).items()},
    )
    mb = b.body.block("meta")
    if mb is not None:
        job.meta.update({k: str(v) for k, v in mb.body.attrs().items()})
    job.constraints = [_constraint(c) for c in b.body.blocks("constraint")]
    job.affinities = [_affinity(c) for c in b.body.blocks("affinity")]
    job.spreads = [_spread(c) for c in b.body.blocks("spread")]
    ub = b.body.block("update")
    if ub is not None:
        job.update = _update(ub)
    pb = b.body.block("periodic")
    if pb is not None:
        job.periodic = _periodic(pb)
    qb = b.body.block("parameterized")
    if qb is not None:
        job.parameterized = _parameterized(qb)
    groups = b.body.blocks("group")
    if groups:
        job.task_groups = [_group(g, job) for g in groups]
    else:
        # task directly under job: implicit group of the same name
        # (reference jobspec behavior)
        tasks = b.body.blocks("task")
        if tasks:
            tg = TaskGroup(name=job.id, count=1, tasks=[_task(t) for t in tasks])
            job.task_groups = [tg]
    if not job.task_groups:
        raise JobspecError(f"job {job.id!r} has no groups or tasks")
    return job


def _group(b: Block, job: Job) -> TaskGroup:
    a = b.body.attrs()
    tg = TaskGroup(
        name=b.labels[0] if b.labels else "",
        count=int(a.get("count", 1)),
        meta={k: str(v) for k, v in a.get("meta", {}).items()},
    )
    mb = b.body.block("meta")
    if mb is not None:
        tg.meta.update({k: str(v) for k, v in mb.body.attrs().items()})
    tg.constraints = [_constraint(c) for c in b.body.blocks("constraint")]
    tg.affinities = [_affinity(c) for c in b.body.blocks("affinity")]
    tg.spreads = [_spread(c) for c in b.body.blocks("spread")]
    rb = b.body.block("restart")
    if rb is not None:
        tg.restart_policy = _restart(rb)
    sb = b.body.block("reschedule")
    if sb is not None:
        tg.reschedule_policy = _reschedule(sb)
    ub = b.body.block("update")
    if ub is not None:
        tg.update = _update(ub)
    mb2 = b.body.block("migrate")
    if mb2 is not None:
        tg.migrate = _migrate(mb2)
    eb = b.body.block("ephemeral_disk")
    if eb is not None:
        ea = eb.body.attrs()
        tg.ephemeral_disk = EphemeralDisk(
            sticky=bool(ea.get("sticky", False)),
            size_mb=int(ea.get("size", 300)),
            migrate=bool(ea.get("migrate", False)),
        )
    nb = b.body.block("network")
    if nb is not None:
        tg.networks = [_network(nb)]
    for vb in b.body.blocks("volume"):
        va = vb.body.attrs()
        tg.volumes[vb.labels[0] if vb.labels else ""] = VolumeRequest(
            name=vb.labels[0] if vb.labels else "",
            type=va.get("type", "host"),
            source=va.get("source", ""),
            read_only=bool(va.get("read_only", False)),
            access_mode=va.get("access_mode", ""),
            attachment_mode=va.get("attachment_mode", ""),
            per_alloc=bool(va.get("per_alloc", False)),
        )
    scb = b.body.block("scaling")
    if scb is not None:
        sca = scb.body.attrs()
        pol = {}
        pb2 = scb.body.block("policy")
        if pb2 is not None:
            # the policy is OPAQUE autoscaler config: round-trip nested
            # blocks (check/strategy stanzas) as nested dicts, not just
            # top-level attrs
            pol = _config_dict(pb2.body)
        tg.scaling = ScalingPolicy(
            type=sca.get("type", "horizontal"),
            min=int(sca.get("min", 0)),
            max=int(sca.get("max", 0)),
            enabled=bool(sca.get("enabled", True)),
            policy=pol,
        )
    for sb2 in b.body.blocks("service"):
        tg.services.append(_service(sb2))
    tg.tasks = [_task(t) for t in b.body.blocks("task")]
    sd = a.get("shutdown_delay")
    if sd is not None:
        tg.shutdown_delay_s = parse_duration(sd)
    return tg


def _task(b: Block) -> Task:
    a = b.body.attrs()
    task = Task(
        name=b.labels[0] if b.labels else "",
        driver=a.get("driver", "mock"),
        user=a.get("user", ""),
        leader=bool(a.get("leader", False)),
        kill_signal=a.get("kill_signal", ""),
        meta={k: str(v) for k, v in a.get("meta", {}).items()},
    )
    cb = b.body.block("config")
    if cb is not None:
        task.config = _config_dict(cb.body)
    eb = b.body.block("env")
    if eb is not None:
        task.env = {k: str(v) for k, v in eb.body.attrs().items()}
    mb = b.body.block("meta")
    if mb is not None:
        task.meta.update({k: str(v) for k, v in mb.body.attrs().items()})
    rb = b.body.block("resources")
    if rb is not None:
        task.resources = _resources(rb)
    task.constraints = [_constraint(c) for c in b.body.blocks("constraint")]
    task.affinities = [_affinity(c) for c in b.body.blocks("affinity")]
    vb = b.body.block("vault")
    if vb is not None:
        va = vb.body.attrs()
        task.vault = {
            "policies": [str(x) for x in va.get("policies", [])],
            "env": bool(va.get("env", True)),
        }
    for vm in b.body.blocks("volume_mount"):
        vma = vm.body.attrs()
        task.volume_mounts.append(
            VolumeMount(
                volume=vma.get("volume", ""),
                destination=vma.get("destination", ""),
                read_only=bool(vma.get("read_only", False)),
                propagation_mode=vma.get("propagation_mode", "private"),
            )
        )
    for ab in b.body.blocks("artifact"):
        aa = ab.body.attrs()
        opts = {}
        ob = ab.body.block("options")
        if ob is not None:
            opts = {k: str(v) for k, v in ob.body.attrs().items()}
        task.artifacts.append(
            TaskArtifact(
                getter_source=aa.get("source", ""),
                getter_options=opts,
                getter_mode=aa.get("mode", "any"),
                relative_dest=aa.get("destination", "local/"),
            )
        )
    for tb in b.body.blocks("template"):
        ta = tb.body.attrs()
        task.templates.append(
            Template(
                source_path=ta.get("source", ""),
                dest_path=ta.get("destination", ""),
                embedded_tmpl=ta.get("data", ""),
                change_mode=ta.get("change_mode", "restart"),
                change_signal=ta.get("change_signal", ""),
                splay_s=parse_duration(ta.get("splay", "5s")),
                perms=str(ta.get("perms", "0644")),
            )
        )
    lb = b.body.block("logs")
    if lb is not None:
        la = lb.body.attrs()
        task.log_config = LogConfig(
            max_files=int(la.get("max_files", 10)),
            max_file_size_mb=int(la.get("max_file_size", 10)),
        )
    lcb = b.body.block("lifecycle")
    if lcb is not None:
        la = lcb.body.attrs()
        task.lifecycle = TaskLifecycleConfig(
            hook=la.get("hook", ""), sidecar=bool(la.get("sidecar", False))
        )
    for sb in b.body.blocks("service"):
        task.services.append(_service(sb))
    kt = a.get("kill_timeout")
    if kt is not None:
        task.kill_timeout_s = parse_duration(kt)
    sdd = a.get("shutdown_delay")
    if sdd is not None:
        task.shutdown_delay_s = parse_duration(sdd)
    return task


def _config_dict(body: Body) -> dict:
    out = dict(body.attrs())
    for blk in body.blocks():
        out.setdefault(blk.type, []).append(_config_dict(blk.body))
    return out


def _resources(b: Block) -> Resources:
    a = b.body.attrs()
    res = Resources(
        cpu=int(a.get("cpu", 100)),
        memory_mb=int(a.get("memory", 300)),
        memory_max_mb=int(a.get("memory_max", 0)),
        disk_mb=int(a.get("disk", 0)),
        cores=int(a.get("cores", 0)),
    )
    nb = b.body.block("network")
    if nb is not None:
        res.networks = [_network(nb)]
    for db in b.body.blocks("device"):
        da = db.body.attrs()
        res.devices.append(
            RequestedDevice(
                name=db.labels[0] if db.labels else "",
                count=int(da.get("count", 1)),
                constraints=[
                    _constraint(c) for c in db.body.blocks("constraint")
                ],
                affinities=[_affinity(c) for c in db.body.blocks("affinity")],
            )
        )
    return res


def _network(b: Block) -> NetworkResource:
    a = b.body.attrs()
    net = NetworkResource(
        mode=a.get("mode", "host"), mbits=int(a.get("mbits", 0))
    )
    for pb in b.body.blocks("port"):
        pa = pb.body.attrs()
        label = pb.labels[0] if pb.labels else ""
        port = Port(
            label=label,
            value=int(pa.get("static", 0)),
            to=int(pa.get("to", 0)),
            host_network=pa.get("host_network", "default"),
        )
        if port.value:
            net.reserved_ports.append(port)
        else:
            net.dynamic_ports.append(port)
    return net


def _service(b: Block) -> Service:
    a = b.body.attrs()
    svc = Service(
        name=a.get("name", b.labels[0] if b.labels else ""),
        port_label=str(a.get("port", "")),
        tags=[str(t) for t in a.get("tags", [])],
        provider=a.get("provider", "builtin"),
    )
    conn = b.body.block("connect")
    if conn is not None:
        from ..structs.structs import Connect, ConnectUpstream, SidecarService

        c = Connect(native=bool(conn.body.attrs().get("native", False)))
        sb = conn.body.block("sidecar_service")
        if sb is not None:
            sc = SidecarService(port=str(sb.body.attrs().get("port", "")))
            pb = sb.body.block("proxy")
            if pb is not None:
                for ub in pb.body.blocks("upstreams"):
                    ua = ub.body.attrs()
                    sc.upstreams.append(
                        ConnectUpstream(
                            destination_name=str(
                                ua.get("destination_name", "")
                            ),
                            local_bind_port=int(
                                ua.get("local_bind_port", 0)
                            ),
                        )
                    )
            c.sidecar_service = sc
        svc.connect = c
    for cb in b.body.blocks("check"):
        ca = cb.body.attrs()
        check = {
            "name": ca.get("name", ""),
            "type": ca.get("type", "tcp"),
            "path": ca.get("path", ""),
            "interval_s": parse_duration(ca.get("interval", "10s")),
            "timeout_s": parse_duration(ca.get("timeout", "2s")),
        }
        if ca.get("task"):
            # group-service checks name the task that hosts script
            # execs / owns the restart (reference ServiceCheck.TaskName)
            check["task"] = str(ca["task"])
        if ca.get("command"):
            # script checks exec inside the task (reference
            # structs.go ServiceCheck Command/Args)
            check["command"] = str(ca["command"])
            check["args"] = [str(x) for x in ca.get("args", [])]
        for rb in cb.body.blocks("check_restart"):
            ra = rb.body.attrs()
            check["check_restart"] = {
                "limit": int(ra.get("limit", 0)),
                "grace_s": parse_duration(ra.get("grace", "1s")),
            }
        svc.checks.append(check)
    return svc


def _constraint(b: Block) -> Constraint:
    a = b.body.attrs()
    operand = a.get("operator", "=")
    # sugar: `distinct_hosts = true` / `distinct_property = "x"`
    if "distinct_hosts" in a:
        return Constraint(operand="distinct_hosts")
    if "distinct_property" in a:
        return Constraint(
            ltarget=str(a["distinct_property"]),
            rtarget=str(a.get("value", "")),
            operand="distinct_property",
        )
    return Constraint(
        ltarget=str(a.get("attribute", "")),
        rtarget=str(a.get("value", "")),
        operand=operand,
    )


def _affinity(b: Block) -> Affinity:
    a = b.body.attrs()
    return Affinity(
        ltarget=str(a.get("attribute", "")),
        rtarget=str(a.get("value", "")),
        operand=a.get("operator", "="),
        weight=int(a.get("weight", 50)),
    )


def _spread(b: Block) -> Spread:
    a = b.body.attrs()
    sp = Spread(
        attribute=str(a.get("attribute", "")), weight=int(a.get("weight", 50))
    )
    for tb in b.body.blocks("target"):
        ta = tb.body.attrs()
        sp.targets.append(
            SpreadTarget(
                value=tb.labels[0] if tb.labels else str(ta.get("value", "")),
                percent=int(ta.get("percent", 0)),
            )
        )
    return sp


def _update(b: Block) -> UpdateStrategy:
    a = b.body.attrs()
    u = UpdateStrategy(
        max_parallel=int(a.get("max_parallel", 1)),
        health_check=a.get("health_check", "checks"),
        auto_revert=bool(a.get("auto_revert", False)),
        auto_promote=bool(a.get("auto_promote", False)),
        canary=int(a.get("canary", 0)),
    )
    if "stagger" in a:
        u.stagger_s = parse_duration(a["stagger"])
    if "min_healthy_time" in a:
        u.min_healthy_time_s = parse_duration(a["min_healthy_time"])
    if "healthy_deadline" in a:
        u.healthy_deadline_s = parse_duration(a["healthy_deadline"])
    if "progress_deadline" in a:
        u.progress_deadline_s = parse_duration(a["progress_deadline"])
    return u


def _migrate(b: Block) -> MigrateStrategy:
    a = b.body.attrs()
    m = MigrateStrategy(
        max_parallel=int(a.get("max_parallel", 1)),
        health_check=a.get("health_check", "checks"),
    )
    if "min_healthy_time" in a:
        m.min_healthy_time_s = parse_duration(a["min_healthy_time"])
    if "healthy_deadline" in a:
        m.healthy_deadline_s = parse_duration(a["healthy_deadline"])
    return m


def _restart(b: Block) -> RestartPolicy:
    a = b.body.attrs()
    r = RestartPolicy(
        attempts=int(a.get("attempts", 2)),
        mode=a.get("mode", "fail"),
    )
    if "interval" in a:
        r.interval_s = parse_duration(a["interval"])
    if "delay" in a:
        r.delay_s = parse_duration(a["delay"])
    return r


def _reschedule(b: Block) -> ReschedulePolicy:
    a = b.body.attrs()
    r = ReschedulePolicy(
        attempts=int(a.get("attempts", 0)),
        delay_function=a.get("delay_function", "exponential"),
        unlimited=bool(a.get("unlimited", True)),
    )
    if "interval" in a:
        r.interval_s = parse_duration(a["interval"])
    if "delay" in a:
        r.delay_s = parse_duration(a["delay"])
    if "max_delay" in a:
        r.max_delay_s = parse_duration(a["max_delay"])
    return r


def _periodic(b: Block) -> PeriodicConfig:
    a = b.body.attrs()
    return PeriodicConfig(
        enabled=bool(a.get("enabled", True)),
        spec=a.get("cron", a.get("crons", "")),
        prohibit_overlap=bool(a.get("prohibit_overlap", False)),
        timezone=a.get("time_zone", "UTC"),
    )


def _parameterized(b: Block) -> ParameterizedJobConfig:
    a = b.body.attrs()
    return ParameterizedJobConfig(
        payload=a.get("payload", "optional"),
        meta_required=[str(m) for m in a.get("meta_required", [])],
        meta_optional=[str(m) for m in a.get("meta_optional", [])],
    )
