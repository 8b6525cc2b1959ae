"""CSI volumes against the port: the store, the scheduler's
CSIVolumeChecker and the Server.

The cases of ``tests/test_csi.py``, the CSIManager, external-plugin,
client e2e, controller and detach cases on the port's ``client/`` and
``plugins/``, with imports pointed at ``nomad_tpu_torch`` and the
Server's scheduler config written out (``backend="host"``,
``device="cpu"``: the reference's default backend, on the CPU). The
assertions are the reference's.
Reference intent: scheduler/feasible.go CSIVolumeChecker, nomad/state
CSIPlugin aggregation.
"""

import os
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.client.csimanager import CSIManager
from nomad_tpu_torch.plugins.csi import CSIError, FakeCSIPlugin
from nomad_tpu_torch.scheduler.context import SchedulerConfig
from nomad_tpu_torch.structs.structs import (
    VOLUME_ACCESS_SINGLE_WRITER,
    Volume,
    VolumeClaim,
    VolumeMount,
    VolumeRequest,
)


def wait_until(fn, timeout_s=10.0, interval=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


def _host_config():
    return SchedulerConfig(backend="host", device="cpu")


def _csi_vol(vol_id="csivol", plugin="hostpath", name=None, access=None):
    return Volume(
        id=vol_id,
        name=name or vol_id,
        type="csi",
        plugin_id=plugin,
        external_id=f"ext-{vol_id}",
        access_mode=access or "multi-node-multi-writer",
    )


class TestCSIFeasibility:
    def _ctx_with_vol(self, vol):
        from nomad_tpu_torch.scheduler.context import EvalContext
        from nomad_tpu_torch.state.store import StateStore

        state = StateStore()
        state.upsert_volume(10, vol)
        return EvalContext(state=state)

    def test_node_without_plugin_infeasible(self):
        from nomad_tpu_torch.scheduler.feasible import CSIVolumeChecker

        ctx = self._ctx_with_vol(_csi_vol())
        asks = {"v": VolumeRequest(name="v", type="csi", source="csivol")}
        checker = CSIVolumeChecker(ctx, asks)
        bare = mock.node()
        ok, why = checker.feasible(bare)
        assert not ok
        with_plugin = mock.node()
        with_plugin.csi_plugins["hostpath"] = {
            "healthy": True, "node": True, "controller": True,
        }
        ok, _ = checker.feasible(with_plugin)
        assert ok

    def test_unhealthy_plugin_infeasible(self):
        from nomad_tpu_torch.scheduler.feasible import CSIVolumeChecker

        ctx = self._ctx_with_vol(_csi_vol())
        asks = {"v": VolumeRequest(name="v", type="csi", source="csivol")}
        checker = CSIVolumeChecker(ctx, asks)
        n = mock.node()
        n.csi_plugins["hostpath"] = {"healthy": False, "node": True}
        ok, _ = checker.feasible(n)
        assert not ok

    def test_claimed_single_writer_blocks_new_writer(self):
        from nomad_tpu_torch.scheduler.feasible import CSIVolumeChecker

        vol = _csi_vol(access=VOLUME_ACCESS_SINGLE_WRITER)
        vol.claims["a1"] = VolumeClaim(alloc_id="a1", read_only=False)
        ctx = self._ctx_with_vol(vol)
        asks = {"v": VolumeRequest(name="v", type="csi", source="csivol")}
        checker = CSIVolumeChecker(ctx, asks)
        n = mock.node()
        n.csi_plugins["hostpath"] = {"healthy": True, "node": True}
        ok, _ = checker.feasible(n)
        assert not ok, "single-writer volume with live writer must reject"
        ro_asks = {
            "v": VolumeRequest(
                name="v", type="csi", source="csivol", read_only=True
            )
        }
        ok, _ = CSIVolumeChecker(ctx, ro_asks).feasible(n)
        assert ok, "readers still welcome"


# ---------------------------------------------------------------------------
# State aggregation
# ---------------------------------------------------------------------------


def test_csi_plugin_state_aggregation():
    from nomad_tpu_torch.state.store import StateStore

    state = StateStore()
    n1 = mock.node()
    n1.csi_plugins["hostpath"] = {
        "version": "1.0.0", "healthy": True, "controller": True, "node": True,
    }
    n2 = mock.node()
    n2.csi_plugins["hostpath"] = {
        "version": "1.0.0", "healthy": False, "controller": False,
        "node": True,
    }
    state.upsert_node(10, n1)
    state.upsert_node(11, n2)
    agg = state.csi_plugins()
    assert agg["hostpath"]["controllers_expected"] == 1
    assert agg["hostpath"]["controllers_healthy"] == 1
    assert agg["hostpath"]["nodes_expected"] == 2
    assert agg["hostpath"]["nodes_healthy"] == 1


# ---------------------------------------------------------------------------
# The Server
# ---------------------------------------------------------------------------


def test_csi_job_does_not_place_without_plugin(tmp_path):
    """Nodes lacking the plugin are screened by feasibility: the eval
    blocks instead of placing."""
    from nomad_tpu_torch.server import Server

    server = Server(num_workers=2, scheduler_config=_host_config())
    server.establish_leadership()
    try:
        server.volume_register(_csi_vol())
        n = mock.node()  # no csi plugins
        server.node_register(n)
        server.node_heartbeat(n.id)
        job = mock.job(id="csi-blocked")
        tg = job.task_groups[0]
        tg.count = 1
        tg.volumes = {
            "data": VolumeRequest(name="data", type="csi", source="csivol")
        }
        server.job_register(job)
        time.sleep(1.0)
        allocs = server.state.allocs_by_job(job.namespace, job.id)
        live = [a for a in allocs if not a.terminal_status()]
        assert live == [], "no plugin on any node: nothing may place"
    finally:
        server.shutdown()


def test_csi_claims_written_with_the_placements():
    """Without a client: a csi-type group places only on the node that
    runs the plugin, every placement's claim lands in the same commit as
    the alloc, deregistering the claimed volume is refused, and once the
    job stops the volume watcher's pass releases every claim."""
    from nomad_tpu_torch.server import Server
    from nomad_tpu_torch.structs.node_class import compute_node_class

    server = Server(num_workers=2, scheduler_config=_host_config())
    server.establish_leadership()
    try:
        server.volume_register(_csi_vol())
        plain = mock.node()
        with_plugin = mock.node()
        with_plugin.csi_plugins["hostpath"] = {"healthy": True, "node": True}
        # the plugin is part of the node's class: recompute it, or the
        # feasibility cache may judge one node for both
        with_plugin.computed_class = compute_node_class(with_plugin)
        for n in (plain, with_plugin):
            server.node_register(n)
        job = mock.job(id="csi-claims")
        tg = job.task_groups[0]
        tg.count = 3
        tg.tasks[0].resources.networks = []
        tg.volumes = {
            "data": VolumeRequest(name="data", type="csi", source="csivol")
        }
        ev_id = server.job_register(job)
        assert wait_until(
            lambda: server.state.eval_by_id(ev_id).status == "complete")
        live = [a for a in server.state.allocs_by_job("default", job.id)
                if not a.terminal_status()]
        assert len(live) == 3
        assert {a.node_id for a in live} == {with_plugin.id}
        vol = server.state.volume_by_id("default", "csivol")
        assert set(vol.claims) == {a.id for a in live}
        for a in live:
            assert vol.claims[a.id].create_index == a.create_index
            assert vol.claims[a.id].node_id == with_plugin.id
        assert server.state.volumes_for_alloc(live[0].id)[0].id == "csivol"
        try:
            server.volume_deregister("default", "csivol")
            raise AssertionError("a claimed volume was deregistered")
        except ValueError as e:
            assert "3 active claims" in str(e)
        ev_id = server.job_deregister("default", job.id)
        assert wait_until(
            lambda: server.state.eval_by_id(ev_id).status == "complete")
        server.volume_watcher.run_once()
        assert server.state.volume_by_id("default", "csivol").claims == {}
        server.volume_deregister("default", "csivol")
        assert server.state.volume_by_id("default", "csivol") is None
    finally:
        server.shutdown()


class TestCSIManager:
    def _mgr(self, tmp_path):
        mgr = CSIManager(str(tmp_path / "client"), node_id="n1")
        plugin = FakeCSIPlugin(backing_dir=str(tmp_path / "backing"))
        mgr.register("hostpath", plugin)
        return mgr, plugin

    def test_fingerprint_shape(self, tmp_path):
        mgr, _ = self._mgr(tmp_path)
        fp = mgr.fingerprint()
        assert fp["hostpath"]["healthy"] is True
        assert fp["hostpath"]["controller"] is True
        assert fp["hostpath"]["node"] is True
        assert fp["hostpath"]["version"] == "1.0.0"

    def test_unhealthy_plugin_fingerprints_unhealthy(self, tmp_path):
        mgr, plugin = self._mgr(tmp_path)
        plugin.healthy = False
        assert mgr.fingerprint()["hostpath"]["healthy"] is False

    def test_mount_publish_write_roundtrip(self, tmp_path):
        mgr, plugin = self._mgr(tmp_path)
        vol = _csi_vol()
        target = mgr.mount_volume(vol, "alloc-1", read_only=False)
        assert os.path.islink(target)
        # a write through the published path lands in the backing store
        with open(os.path.join(target, "hello.txt"), "w") as f:
            f.write("hi")
        backing = os.path.join(
            str(tmp_path / "backing"), vol.external_id, "hello.txt"
        )
        assert open(backing).read() == "hi"
        # controller saw the attach
        assert "n1" in plugin.attached[vol.external_id]

    def test_stage_refcount_across_allocs(self, tmp_path):
        mgr, plugin = self._mgr(tmp_path)
        vol = _csi_vol()
        t1 = mgr.mount_volume(vol, "alloc-1", read_only=False)
        t2 = mgr.mount_volume(vol, "alloc-2", read_only=False)
        assert t1 != t2
        assert len(plugin.staged) == 1, "one staging per volume per node"
        mgr.unmount_alloc("alloc-1")
        assert len(plugin.staged) == 1, "still one user left"
        assert not os.path.lexists(t1)
        mgr.unmount_alloc("alloc-2")
        assert len(plugin.staged) == 0, "last user unstages"
        assert plugin.attached[vol.external_id] == set()

    def test_missing_plugin_raises(self, tmp_path):
        mgr, _ = self._mgr(tmp_path)
        vol = _csi_vol(plugin="ebs")
        with pytest.raises(CSIError):
            mgr.mount_volume(vol, "alloc-1", read_only=False)

    def test_publish_failure_rolls_back_refcount(self, tmp_path):
        mgr, plugin = self._mgr(tmp_path)
        vol = _csi_vol()

        def boom(ctx):
            raise CSIError("no")

        plugin.node_publish = boom
        with pytest.raises(CSIError):
            mgr.mount_volume(vol, "alloc-1", read_only=False)
        assert mgr._stage_users.get(vol.id) == set()


def test_external_csi_plugin_roundtrip():
    """The plugin-process transport: handshake + identity verbs
    (mirrors drivers/plugin.py's out-of-proc boundary)."""
    from nomad_tpu_torch.plugins.csi import ExternalCSIPlugin

    ext = ExternalCSIPlugin("fake", "nomad_tpu_torch.plugins.csi:FakeCSIPlugin")
    try:
        info = ext.plugin_info()
        assert info.name == "hostpath"
        assert info.version == "1.0.0"
        assert ext.probe() is True
        assert ext.node_get_info()["node_id"].startswith("fake-")
        pub = ext.controller_publish("v1", "ext-v1", "n1", False)
        assert pub == {"attached_on": "n1"}
    finally:
        ext.shutdown_plugin()


def test_csi_volume_e2e(tmp_path):
    """A csi-type group volume schedules only onto plugin-bearing nodes,
    gets claimed at plan apply, mounts through the node plugin, and the
    task's volume_mount symlink lands in the task dir."""
    from nomad_tpu_torch.client import Client, ServerRPC
    from nomad_tpu_torch.server import Server
    from nomad_tpu_torch.structs.node_class import compute_node_class

    server = Server(num_workers=2, scheduler_config=SchedulerConfig(backend="host", device="cpu"))
    server.establish_leadership()
    client = None
    try:
        server.volume_register(_csi_vol())
        client = Client(ServerRPC(server), data_dir=str(tmp_path / "c0"))
        client.csi_manager.register(
            "hostpath", FakeCSIPlugin(backing_dir=str(tmp_path / "backing"))
        )
        client._fingerprint_csi()
        client.node.computed_class = compute_node_class(client.node)
        client.start()
        assert client.wait_registered(10)

        job = mock.job(id="csi-job")
        job.datacenters = [client.node.datacenter]
        tg = job.task_groups[0]
        tg.count = 1
        tg.volumes = {
            "data": VolumeRequest(name="data", type="csi", source="csivol")
        }
        task = tg.tasks[0]
        task.driver = "mock"
        task.config = {}
        task.volume_mounts = [
            VolumeMount(volume="data", destination="data")
        ]
        server.job_register(job)

        def running():
            return [
                a
                for a in server.state.allocs_by_job(job.namespace, job.id)
                if a.client_status == "running"
            ]

        assert wait_until(lambda: running(), 15)
        alloc = running()[0]
        # claim attached at plan apply
        vol = server.state.volume_by_id("default", "csivol")
        assert alloc.id in vol.claims
        # the volume_mount symlink is inside the task dir and writable
        runner = client.alloc_runners[alloc.id]
        link = os.path.join(runner.alloc_dir, task.name, "data")
        assert wait_until(lambda: os.path.islink(link), 5)
        with open(os.path.join(link, "out.txt"), "w") as f:
            f.write("written-through-csi")
        assert (
            (tmp_path / "backing" / "ext-csivol" / "out.txt").read_text()
            == "written-through-csi"
        )
        # /v1-level aggregation sees the node plugin
        agg = server.state.csi_plugins()
        assert agg["hostpath"]["nodes_healthy"] == 1
    finally:
        if client is not None:
            client.shutdown()
        server.shutdown()


def test_volume_create_and_delete_via_controller(tmp_path):
    """`volume create` provisions through a controller-bearing client
    then registers; delete deprovisions after deregistration
    (reference csi_endpoint.go Create/Delete → ClientCSI routing)."""
    from nomad_tpu_torch.server.cluster import ClusterServer
    from nomad_tpu_torch.server.cluster import ClusterRPC
    from nomad_tpu_torch.client import Client
    from nomad_tpu_torch.structs.node_class import compute_node_class

    cs = ClusterServer("s1", scheduler_config=SchedulerConfig(backend="host", device="cpu"), port=0, num_workers=1, bootstrap_expect=1)
    cs.start()
    client = None
    try:
        assert wait_until(lambda: cs.is_leader(), 10)
        client = Client(
            ClusterRPC([cs.rpc.addr]),
            data_dir=str(tmp_path / "c0"),
        )
        backing = tmp_path / "backing"
        client.csi_manager.register(
            "hostpath", FakeCSIPlugin(backing_dir=str(backing))
        )
        client._fingerprint_csi()
        client.node.computed_class = compute_node_class(client.node)
        client.start()
        assert client.wait_registered(10)

        vol = _csi_vol(vol_id="made", plugin="hostpath", name="made")
        vol.external_id = ""  # the plugin assigns it
        created = cs.rpc_self("Volume.create", {"volume": vol})
        assert created.external_id == "vol-made"
        assert (backing / "vol-made").is_dir(), "storage provisioned"
        assert cs.server.state.volume_by_id("default", "made") is not None

        cs.rpc_self(
            "Volume.delete", {"namespace": "default", "volume_id": "made"}
        )
        assert cs.server.state.volume_by_id("default", "made") is None
        assert not (backing / "vol-made").exists(), "storage deprovisioned"
    finally:
        if client is not None:
            client.shutdown()
        cs.shutdown()


def test_volume_snapshot_lifecycle_via_controller(tmp_path):
    """`volume snapshot create/list/delete` route to a controller-bearing
    client's plugin (reference csi_endpoint.go CreateSnapshot/
    ListSnapshots/DeleteSnapshot): the snapshot is a real point-in-time
    copy of the volume's contents."""
    from nomad_tpu_torch.client import Client
    from nomad_tpu_torch.server.cluster import ClusterRPC, ClusterServer
    from nomad_tpu_torch.structs.node_class import compute_node_class

    cs = ClusterServer("s1", scheduler_config=SchedulerConfig(backend="host", device="cpu"), port=0, num_workers=1, bootstrap_expect=1)
    cs.start()
    client = None
    try:
        assert wait_until(lambda: cs.is_leader(), 10)
        client = Client(
            ClusterRPC([cs.rpc.addr]), data_dir=str(tmp_path / "c0")
        )
        backing = tmp_path / "backing"
        client.csi_manager.register(
            "hostpath", FakeCSIPlugin(backing_dir=str(backing))
        )
        client._fingerprint_csi()
        client.node.computed_class = compute_node_class(client.node)
        client.start()
        assert client.wait_registered(10)

        vol = _csi_vol(vol_id="snappy", plugin="hostpath", name="snappy")
        vol.external_id = ""
        cs.rpc_self("Volume.create", {"volume": vol})
        (backing / "vol-snappy" / "data.txt").write_text("precious")

        snap = cs.rpc_self(
            "Volume.snapshot_create",
            {"namespace": "default", "volume_id": "snappy", "name": "s1"},
        )
        assert snap["snapshot_id"].startswith("snap-s1-")
        assert snap["source_external_id"] == "vol-snappy"
        assert snap["ready"] is True
        copied = (
            backing / "_snapshots" / snap["snapshot_id"] / "data.txt"
        )
        assert copied.read_text() == "precious", "point-in-time copy"

        # the copy is independent of later volume writes
        (backing / "vol-snappy" / "data.txt").write_text("mutated")
        assert copied.read_text() == "precious"

        listed = cs.rpc_self(
            "Volume.snapshot_list", {"plugin_id": "hostpath"}
        )
        assert [s["snapshot_id"] for s in listed] == [snap["snapshot_id"]]

        cs.rpc_self(
            "Volume.snapshot_delete",
            {
                "plugin_id": "hostpath",
                "snapshot_id": snap["snapshot_id"],
            },
        )
        assert (
            cs.rpc_self(
                "Volume.snapshot_list", {"plugin_id": "hostpath"}
            )
            == []
        )
        # snapshotting an unprovisioned volume errors cleanly
        import pytest as _pytest

        from nomad_tpu_torch.rpc import RPCError

        with _pytest.raises((RPCError, ValueError, KeyError)):
            cs.rpc_self(
                "Volume.snapshot_create",
                {"namespace": "default", "volume_id": "ghost"},
            )
    finally:
        if client is not None:
            client.shutdown()
        cs.shutdown()


def test_volume_detach_releases_claims_and_unpublishes(tmp_path):
    """`volume detach <vol> <node>` drops the node's claims and runs
    controller-unpublish (reference csi_endpoint.go Unpublish)."""
    from nomad_tpu_torch.client import Client
    from nomad_tpu_torch.server.cluster import ClusterRPC, ClusterServer
    from nomad_tpu_torch.structs.node_class import compute_node_class
    from nomad_tpu_torch.structs.structs import VolumeClaim

    cs = ClusterServer("s1", scheduler_config=SchedulerConfig(backend="host", device="cpu"), port=0, num_workers=1, bootstrap_expect=1)
    cs.start()
    client = None
    try:
        assert wait_until(lambda: cs.is_leader(), 10)
        client = Client(
            ClusterRPC([cs.rpc.addr]), data_dir=str(tmp_path / "c0")
        )
        backing = tmp_path / "backing"
        fake = FakeCSIPlugin(backing_dir=str(backing))
        client.csi_manager.register("hostpath", fake)
        client._fingerprint_csi()
        client.node.computed_class = compute_node_class(client.node)
        client.start()
        assert client.wait_registered(10)

        vol = _csi_vol(vol_id="stuck", plugin="hostpath", name="stuck")
        vol.external_id = ""
        cs.rpc_self("Volume.create", {"volume": vol})
        # simulate a wedged attachment: claims + plugin-side attach
        # state (upsert_volume deliberately preserves existing claims,
        # so wedge the table directly like the claim txn would)
        state = cs.server.state
        stored = state.volume_by_id("default", "stuck")
        wedged = stored.copy()
        wedged.claims["alloc-1"] = VolumeClaim(
            alloc_id="alloc-1", node_id="node-A"
        )
        wedged.claims["alloc-2"] = VolumeClaim(
            alloc_id="alloc-2", node_id="node-B"
        )
        with state._lock:
            state._wtable("volumes")[("default", "stuck")] = wedged
        fake.attached["vol-stuck"] = {"node-A", "node-B"}

        # the SAME alloc also holds a claim on another volume — detach
        # must be scoped to the named volume, not sweep the alloc's
        # claims everywhere
        vol2 = _csi_vol(vol_id="other", plugin="hostpath", name="other")
        vol2.external_id = ""
        cs.rpc_self("Volume.create", {"volume": vol2})
        o = state.volume_by_id("default", "other").copy()
        o.claims["alloc-1"] = VolumeClaim(
            alloc_id="alloc-1", node_id="node-A"
        )
        with state._lock:
            state._wtable("volumes")[("default", "other")] = o

        out = cs.rpc_self(
            "Volume.detach",
            {
                "namespace": "default",
                "volume_id": "stuck",
                "node_id": "node-A",
            },
        )
        assert out["released_claims"] == 1
        after = cs.server.state.volume_by_id("default", "stuck")
        assert set(after.claims) == {"alloc-2"}, "node-B claim survives"
        assert fake.attached["vol-stuck"] == {"node-B"}, (
            "controller unpublished node-A only"
        )
        assert set(
            cs.server.state.volume_by_id("default", "other").claims
        ) == {"alloc-1"}, "alloc-1's claim on the OTHER volume survives"
    finally:
        if client is not None:
            client.shutdown()
        cs.shutdown()
