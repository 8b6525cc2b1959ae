"""The tenancy and cluster tables on both packages' Servers, in lockstep.

chip_smoke.py's ``tenancy_lockstep`` (the steps its ``tenancy`` phase
runs at c2m's width, here at TEN_SMALL: 200 nodes, jobs of 50, batches of
8, every batch and watcher pass driven by hand) runs on nomad_tpu's
Server (``backend="tpu"``) and on the port's (``device="cpu"``), on the
same nodes (dc1's carrying the CSI plugin) and jobs, built with
nomad_tpu's mocks and carried over the wire. Everything it returns must
be equal, no tolerance: placements, every volume's claims with the index
each was written at, services, scaling policies and events, namespaces,
ACL policies and tokens, secrets, each step's refusals and numbers, the
event stream as (index, topic, type, key) and the batch verdicts. Two
more cases hold the store's snapshot of the new tables and the search
endpoints.
"""

import random

from nomad_tpu import codec as jcodec

from nomad_tpu_torch.codec import from_wire


def _chip_smoke():
    import importlib.util
    import pathlib
    import sys

    if "chip_smoke" in sys.modules:
        return sys.modules["chip_smoke"]
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def _ref_fleet(n_nodes):
    """chip_smoke.c2m_nodes' fleet, built with nomad_tpu's mocks, dc1's
    nodes with the CSI plugin."""
    from nomad_tpu import mock as jmock
    from nomad_tpu.structs.node_class import compute_node_class

    cs = _chip_smoke()
    nodes = []
    for i in range(n_nodes):
        n = jmock.node()
        n.datacenter = cs.DCS[i % 4]
        n.resources.cpu = 4000
        n.resources.memory_mb = 8192
        n.computed_class = compute_node_class(n)
        nodes.append(n)
    return cs.with_plugin(nodes, compute_node_class)


def _ref_make(job_id, count):
    """chip_smoke.make_job's c2m job, built with nomad_tpu's mocks."""
    from nomad_tpu import mock as jmock
    from nomad_tpu.structs import Constraint, Spread

    job = jmock.job(id=job_id)
    job.datacenters = ["dc1", "dc2", "dc3", "dc4"]
    tg = job.task_groups[0]
    tg.count = count
    tg.tasks[0].resources.cpu = 250
    tg.tasks[0].resources.memory_mb = 128
    tg.tasks[0].resources.networks = []
    job.constraints.append(Constraint("${attr.kernel.name}", "linux", "="))
    job.spreads = [Spread(attribute="${node.datacenter}", weight=50)]
    return job


def _ref_kit():
    import types

    from nomad_tpu.acl import structs as acl
    from nomad_tpu.server.core_sched import CoreScheduler
    from nomad_tpu.server.search import prefix_search
    from nomad_tpu.structs import structs as S

    return types.SimpleNamespace(S=S, acl=acl, core=CoreScheduler,
                                 prefix_search=prefix_search)


def _wire(obj):
    return from_wire(jcodec.to_wire(obj))


def test_tenancy_lockstep_matches_nomad_tpu():
    from nomad_tpu.scheduler.context import SchedulerConfig as JConfig
    from nomad_tpu.server import Server as JServer

    from nomad_tpu_torch.scheduler.context import SchedulerConfig
    from nomad_tpu_torch.server import Server as TServer

    cs = _chip_smoke()
    cfg = cs.TEN_SMALL
    random.seed(0)
    nodes = _ref_fleet(cfg["nodes"])
    jsrv = JServer(use_tpu_batch_worker=True, scheduler_config=JConfig(
        backend="tpu", small_batch_threshold=0))
    tsrv = TServer(use_tpu_batch_worker=True, scheduler_config=SchedulerConfig(
        device="cpu", small_batch_threshold=0))
    for srv in (jsrv, tsrv):
        srv.tpu_worker.batch_size = cs.SERVER_BATCH
        srv.tpu_worker.lane_priority = 0
    try:
        jout = cs.tenancy_lockstep(jsrv, _ref_kit(), _ref_make, nodes, cfg)
        tout = cs.tenancy_lockstep(
            tsrv, cs.port_kit(), lambda jid, c: _wire(_ref_make(jid, c)),
            [_wire(n) for n in nodes], cfg)
    finally:
        jsrv.shutdown()
        tsrv.shutdown()
    assert sorted(tout) == sorted(jout)
    for key in jout:
        assert tout[key] == jout[key], key
    steps = tout["steps"]
    # the data jobs all on the plugin's nodes, each claim in its commit
    data = tout["claims"]["team-a/data"]
    assert len(data) == cfg["data_jobs"] * cfg["count"]
    dc1 = {n.id for n in nodes if n.datacenter == "dc1"}
    assert {row[2] for row in data} <= dc1
    assert steps["volumes"]["plugin_nodes"] == len(dc1)
    # solo: the second job waited, then claimed after the release
    assert [row[0] for row in tout["claims"]["team-a/solo"]] == [
        "ten-solo-2"]
    assert steps["setup"]["c1_refused"].startswith("ValueError")
    assert len(tout["scaling_policies"]) == cfg["jobs"]
    assert list(tout["scaling_events"]) == ["default/ten-job-0"]
    assert tout["services"] == []
    assert any(chained and accepted
               for _, chained, accepted, _ in tout["verdicts"])


def test_snapshot_carries_every_tenancy_table():
    """The store's snapshot bytes carry the new tables (namespaces, ACL
    policies and tokens, volumes with their claims, services, secrets,
    scaling policies and events, operator config): a fresh store
    restored from them reads the same rows, and a restore re-primes the
    watch hub's routes through the restore hook."""
    from nomad_tpu_torch import codec, mock
    from nomad_tpu_torch.acl.structs import ACLPolicy, ACLToken
    from nomad_tpu_torch.server.watch_hub import AllocWatchHub
    from nomad_tpu_torch.state import StateStore
    from nomad_tpu_torch.state import store as st
    from nomad_tpu_torch.structs import structs as S

    src = StateStore()
    job = mock.job(id="snap")
    job.task_groups[0].scaling = S.ScalingPolicy(min=1, max=20)
    alloc = mock.alloc(job_=job)
    alloc.node_id = "node-1"
    writes = [
        lambda i: src.upsert_namespace(i, S.Namespace(name="team-a")),
        lambda i: src.upsert_acl_policies(i, [ACLPolicy(
            name="p", rules='node { policy = "read" }')]),
        lambda i: src.upsert_acl_tokens(i, [ACLToken.new(
            name="t", policies=["p"])]),
        lambda i: src.upsert_job(i, job),
        lambda i: src.upsert_allocs(i, [alloc]),
        lambda i: src.upsert_volume(i, S.Volume(
            id="v", name="v", type="csi", plugin_id="ebs")),
        lambda i: src.claim_volume(i, "default", "v", alloc.id,
                                   alloc.node_id, False),
        lambda i: src.upsert_service_registrations(i, [
            S.ServiceRegistration(id="r", service_name="web",
                                  alloc_id=alloc.id)]),
        lambda i: src.upsert_secret(i, S.SecretEntry(
            path="db", items={"k": "v"})),
        lambda i: src.upsert_scaling_event(i, "default", "snap", "web",
                                           {"Count": 2}),
        lambda i: src.upsert_operator_config(i, "autopilot", {"x": 1}),
    ]
    for i, w in enumerate(writes, start=1):
        w(i)
    dst = StateStore()
    primed = []
    hub = AllocWatchHub(dst)
    dst.subscribe_restore(lambda index, nodes: primed.append(
        (index, sorted(nodes))))
    try:
        dst.restore_from(src.serialize())
    finally:
        hub.stop()
    for table in (st.TABLE_NAMESPACES, st.TABLE_ACL_POLICIES,
                  st.TABLE_ACL_TOKENS, st.TABLE_VOLUMES, st.TABLE_SERVICES,
                  st.TABLE_SECRETS, st.TABLE_SCALING_POLICIES,
                  st.TABLE_SCALING_EVENTS, st.TABLE_OPERATOR):
        assert src._tables[table], table
        assert (codec.to_wire(dst._tables[table])
                == codec.to_wire(src._tables[table])), table
    assert dst.latest_index() == len(writes)
    assert set(dst.volume_by_id("default", "v").claims) == {alloc.id}
    assert primed == [(len(writes), [alloc.node_id])]
    assert hub.index_of(alloc.node_id) == len(writes)
    dst.rebase_indexes(100)
    assert dst.latest_index() == 100
    assert dst.table_index(st.TABLE_SECRETS) == 100


def test_search_matches_nomad_tpu():
    """prefix_search and fuzzy_search on the same rows in both packages'
    stores (jobs in two namespaces, nodes, namespaces, a volume): equal
    answers for the contexts whose ids the caller chose, and a search of
    one namespace never returns another's job or alloc ids (the
    reference's agent cases in tests/test_namespaces.py reach these
    through the HTTP API)."""
    from nomad_tpu import mock as jmock
    from nomad_tpu.server import search as jsearch
    from nomad_tpu.state import StateStore as JStore
    from nomad_tpu.structs import structs as JS

    from nomad_tpu_torch.server import search as tsearch
    from nomad_tpu_torch.state import StateStore as TStore

    rows = [("ns", JS.Namespace(name="other"))]
    rows += [("node", jmock.node()) for _ in range(3)]
    for ns, jid in (("default", "search-target"), ("default", "web-x"),
                    ("other", "scoped-job")):
        job = jmock.job(id=jid)
        job.namespace = ns
        rows.append(("job", job))
        alloc = jmock.alloc(job_=job)
        alloc.namespace = ns
        rows.append(("alloc", alloc))
    rows.append(("vol", JS.Volume(id="search-vol", name="search-vol")))

    def load(store, wire):
        for i, (kind, obj) in enumerate(rows, start=1):
            obj = wire(obj)
            {"ns": store.upsert_namespace, "node": store.upsert_node,
             "job": store.upsert_job, "vol": store.upsert_volume,
             "alloc": lambda i, a: store.upsert_allocs(i, [a])}[kind](i, obj)
        return store

    js, ts = load(JStore(), lambda o: o), load(TStore(), _wire)
    for query, ctx, ns in (("search-", "all", "default"),
                           ("", "all", "default"), ("scoped-", "jobs",
                                                    "other"),
                           ("", "namespaces", "default"),
                           ("search-", "volumes", "default")):
        got = tsearch.prefix_search(ts, query, ctx, ns)
        want = jsearch.prefix_search(js, query, ctx, ns)
        for key in ("jobs", "nodes", "namespaces", "volumes"):
            assert got["Matches"].get(key) == want["Matches"].get(key)
        assert got["Truncations"] == want["Truncations"]
        theirs = {a.id for a in ts.allocs() if a.namespace != ns}
        assert not theirs & set(got["Matches"].get("allocs", []))
    for text in ("web", "search", "scoped"):
        got = tsearch.fuzzy_search(ts, text)
        want = jsearch.fuzzy_search(js, text)
        assert got["Matches"].get("jobs") == want["Matches"].get("jobs")
    assert ("default", "search-target") in {
        tuple(h["Scope"]) for h in tsearch.fuzzy_search(ts, "web")
        ["Matches"]["jobs"]}
