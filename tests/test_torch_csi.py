"""CSI volumes against the port: the store, the scheduler's
CSIVolumeChecker and the Server.

The cases of ``tests/test_csi.py`` that need no client, plugin process or
cluster (its CSIManager, external-plugin, client e2e, controller and
detach cases wait for ``client/`` and ``plugins/``), with imports pointed
at ``nomad_tpu_torch`` and the Server's scheduler config written out
(``backend="host"``, ``device="cpu"``: the reference's default backend,
on the CPU). The assertions are the reference's.
Reference intent: scheduler/feasible.go CSIVolumeChecker, nomad/state
CSIPlugin aggregation.
"""

import time

from nomad_tpu_torch import mock
from nomad_tpu_torch.scheduler.context import SchedulerConfig
from nomad_tpu_torch.structs.structs import (
    VOLUME_ACCESS_SINGLE_WRITER,
    Volume,
    VolumeClaim,
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
