"""``tests/test_blackbox.py`` against the port (nomad_tpu_torch/blackbox.py
and server/blackbox_wire.py, ported whole), with the reference's
assertions: imports pointed at ``nomad_tpu_torch``, every server and
agent on ``device="cpu"`` (the reference's host backend for a server's
own workers, the kernels' plain twins for the SoA fast mint), the
front-door throughput gate in its clean-subprocess form and 0.95 bound.

The reference's docstring: blackbox flight recorder battery
(nomad_tpu/blackbox.py + server/blackbox_wire.py): trigger-engine units (fire / dedup /
rate-limit / reload), journal-ring bounds, causal-timeline
reconstruction, the /v1/blackbox//v1/incidents//v1/timeline HTTP + ACL
surface, the operator incidents/timeline CLI, single-flight incident
capture with on-disk bundles, the SIGHUP reload path, the
AllocMetric-from-dense-mask satellite, the chaos partition +
leader-kill "exactly one deduped incident" scenario, and the
front-door throughput gate with the recorder enabled (>= 0.95x, the
round-13 paired-burst recipe)."""

import dataclasses
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from nomad_tpu_torch import blackbox, metrics, mock
from nomad_tpu_torch.blackbox import (
    KIND_EVENT,
    KIND_INCIDENT,
    KIND_LEADERSHIP,
    KIND_TRIGGER,
    FlightRecorder,
    TriggerEngine,
    TriggerRule,
    build_timeline,
    default_rules,
)
from nomad_tpu_torch.metrics import Registry
from nomad_tpu_torch.scheduler.context import SchedulerConfig

pytestmark = pytest.mark.incident

# every solve on the CPU: the kernels' plain twins
DEVICE = "cpu"


def host_config() -> SchedulerConfig:
    """A server's own schedulers as the reference's default: the host
    backend, on the CPU."""
    return SchedulerConfig(backend="host", device=DEVICE)


REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def wait_until(fn, timeout_s=15.0, interval=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


@pytest.fixture(autouse=True)
def _fresh_recorder():
    """A private FlightRecorder per test (the _install swap hook), so
    journal counts, trigger history, and incident indexes never leak
    across tests; the module recording gate is restored to ON."""
    old = blackbox._install(FlightRecorder())
    blackbox.set_enabled(True)
    yield
    blackbox.set_enabled(True)
    blackbox._install(old)


def _rule(name="r", source="counter:x", kind="delta", threshold=5,
          window_s=60.0, reason="test rule"):
    return TriggerRule(name, source, kind, threshold,
                       window_s=window_s, reason=reason)


# ---------------------------------------------------------------------------
# Trigger-engine units (explicit `now=` timestamps: no wall-clock races)
# ---------------------------------------------------------------------------


class TestTriggerEngine:
    def test_delta_fires_on_rise_within_window(self):
        eng = TriggerEngine([_rule()], dedup_window_s=0)
        assert eng.evaluate({"counter:x": 0}, now=0) == []
        assert eng.evaluate({"counter:x": 4}, now=10) == []
        out = eng.evaluate({"counter:x": 6}, now=20)
        assert len(out) == 1
        f = out[0]
        assert f["rule"] == "r" and f["kind"] == "delta"
        assert f["value"] == 6 and f["delta"] == 6
        assert f["threshold"] == 5 and f["reason"] == "test rule"
        assert eng.fired == 1

    def test_delta_rise_before_window_never_fires(self):
        eng = TriggerEngine([_rule(window_s=60)], dedup_window_s=0)
        eng.evaluate({"counter:x": 0}, now=0)
        # the rise happened, but the 0-baseline sample left the window:
        # the oldest in-window sample IS the high value — delta 0
        assert eng.evaluate({"counter:x": 6}, now=100) == []
        assert eng.fired == 0

    def test_missing_source_is_skipped(self):
        eng = TriggerEngine([_rule()])
        assert eng.evaluate({}, now=0) == []
        assert eng.evaluate({"counter:other": 99}, now=1) == []

    def test_level_rule(self):
        eng = TriggerEngine(
            [_rule(kind="level", threshold=30.0, source="p99:e")],
            dedup_window_s=0,
        )
        assert eng.evaluate({"p99:e": 29.9}, now=0) == []
        out = eng.evaluate({"p99:e": 31.0}, now=1)
        assert len(out) == 1 and out[0]["value"] == 31.0

    def test_dedup_window_suppresses_refire(self):
        eng = TriggerEngine([_rule()], dedup_window_s=300)
        eng.evaluate({"counter:x": 0}, now=0)
        assert len(eng.evaluate({"counter:x": 6}, now=10)) == 1
        # keeps crossing inside the dedup window: counted, not fired
        assert eng.evaluate({"counter:x": 20}, now=20) == []
        assert eng.deduped == 1
        # past the dedup window a NEW in-window rise fires again
        eng.evaluate({"counter:x": 40}, now=320)  # fresh baseline
        out = eng.evaluate({"counter:x": 50}, now=330)
        assert len(out) == 1 and eng.fired == 2

    def test_fired_delta_rule_resets_its_history(self):
        """The same rise must not re-fire once the dedup window ends —
        firing starts a fresh baseline at the fired value."""
        eng = TriggerEngine([_rule()], dedup_window_s=0)
        eng.evaluate({"counter:x": 0}, now=0)
        assert len(eng.evaluate({"counter:x": 6}, now=10)) == 1
        # value FLAT after the fire: no new delta, no fire
        assert eng.evaluate({"counter:x": 6}, now=20) == []
        assert eng.evaluate({"counter:x": 8}, now=30) == []  # +2 < 5
        # a fresh full-threshold rise relative to the reset baseline
        assert len(eng.evaluate({"counter:x": 12}, now=40)) == 1

    def test_global_rate_limit_across_rules(self):
        rules = [
            _rule(name=f"lvl{i}", source=f"p99:s{i}", kind="level",
                  threshold=1) for i in range(3)
        ]
        eng = TriggerEngine(rules, dedup_window_s=0, max_per_hour=2)
        out = eng.evaluate({f"p99:s{i}": 5 for i in range(3)}, now=0)
        assert len(out) == 2
        assert eng.rate_limited == 1
        # an hour later the budget refills
        out = eng.evaluate({"p99:s2": 5}, now=3601)
        assert len(out) == 1

    def test_reload_keeps_surviving_history_drops_rest(self):
        eng = TriggerEngine(
            [_rule(name="keep"), _rule(name="drop", source="counter:y")],
            dedup_window_s=0,
        )
        eng.evaluate({"counter:x": 0, "counter:y": 0}, now=0)
        eng.reload([_rule(name="keep")])
        assert [r.name for r in eng.rules] == ["keep"]
        # "keep" still has its t=0 baseline: the rise fires immediately
        assert len(eng.evaluate({"counter:x": 6}, now=10)) == 1
        # reload() with no args restores the stock catalogue
        eng.reload()
        assert {r.name for r in eng.rules} == {
            r.name for r in default_rules()
        }

    def test_status_shape(self):
        eng = TriggerEngine([_rule()], dedup_window_s=0)
        st = eng.status()
        assert st["rules"][0]["name"] == "r"
        assert st["rules"][0]["last_fired_ago_s"] is None
        eng.evaluate({"counter:x": 0})
        eng.evaluate({"counter:x": 99})
        st = eng.status()
        assert st["fired"] == 1
        assert st["rules"][0]["last_fired_ago_s"] is not None

    def test_default_rules_quiet_on_clean_boot_shape(self):
        """The false-positive contract: one leadership establish (a
        healthy boot) must never trip leader-churn, two edges must."""
        eng = TriggerEngine(default_rules())
        src = f"journal:{KIND_LEADERSHIP}"
        assert eng.evaluate({src: 0}, now=0) == []
        assert eng.evaluate({src: 1}, now=1) == []  # the boot establish
        out = eng.evaluate({src: 3}, now=30)  # revoke + re-establish
        assert [f["rule"] for f in out] == ["leader-churn"]


# ---------------------------------------------------------------------------
# Flight-recorder units
# ---------------------------------------------------------------------------


class TestFlightRecorder:
    def test_ring_bound_and_eviction_accounting(self):
        rec = FlightRecorder(capacity=16)
        for i in range(20):
            rec.record("event", f"eval:e{i}")
        rows = rec.snapshot()
        assert len(rows) == 16
        assert rows[0]["key"] == "eval:e4"  # oldest 4 evicted
        st = rec.stats()
        assert st["journal_recorded"] == 20
        assert st["journal_entries"] == 16
        assert st["journal_evicted"] == 4
        assert rec.kind_counts() == {"event": 20}

    def test_snapshot_filters_and_limit(self):
        rec = FlightRecorder()
        rec.record("event", "eval:e1", rel=["node:n1"])
        rec.record("shed", "eval:e2", reason="depth")
        rec.record("event", "eval:e3")
        assert [r["key"] for r in rec.snapshot(kind="event")] == [
            "eval:e1", "eval:e3",
        ]
        assert [r["key"] for r in rec.snapshot(key_contains="e2")] == [
            "eval:e2",
        ]
        assert [r["key"] for r in rec.snapshot(limit=1)] == ["eval:e3"]
        # seq is a total order even at equal timestamps
        seqs = [r["seq"] for r in rec.snapshot()]
        assert seqs == sorted(seqs)

    def test_recording_gate(self):
        rec = FlightRecorder()
        old = blackbox._install(rec)
        try:
            blackbox.set_enabled(False)
            blackbox.record("event", "eval:gated")
            assert rec.recorded == 0
            blackbox.set_enabled(True)
            blackbox.record("event", "eval:open")
            assert rec.recorded == 1
        finally:
            blackbox.set_enabled(True)
            blackbox._install(old)

    def test_incident_index_newest_first_and_lookup(self):
        rec = FlightRecorder()
        a = rec.add_incident("20260101-000000-a", "ra", "", {"v": 1})
        b = rec.add_incident("20260101-000001-b", "rb", "", {"v": 2})
        assert [r["id"] for r in rec.incidents()] == [b["id"], a["id"]]
        assert rec.incident(a["id"])["reason"] == "ra"
        assert rec.incident("nope") is None
        # every capture leaves its own journal row
        assert rec.kind_counts()[KIND_INCIDENT] == 2
        st = rec.stats()
        assert st["incidents_captured"] == 2
        assert st["incidents_stored"] == 2

    def test_set_incident_max_resizes_live(self):
        rec = FlightRecorder(incident_max=4)
        for i in range(4):
            rec.add_incident(f"i{i}", "r", "", {})
        rec.set_incident_max(2)
        assert [r["id"] for r in rec.incidents()] == ["i3", "i2"]
        assert rec.incident_max == 2
        rec.suppress_incident()
        assert rec.stats()["incidents_suppressed"] == 1


# ---------------------------------------------------------------------------
# Causal-timeline reconstruction units
# ---------------------------------------------------------------------------


def _journal_chain(rec):
    """A small eval -> plan -> alloc -> node causal chain plus one
    unrelated eval's rows."""
    rec.record("event", "eval:e1", topic="Evaluation",
               rel=["eval:e1", "job:j1"])
    rec.record("event", "plan:p1", topic="Plan", rel=["plan:p1", "eval:e1"])
    rec.record("event", "alloc:a1", topic="Allocation",
               rel=["alloc:a1", "eval:e1", "node:n1", "job:j1"])
    rec.record("heartbeat_expiry", "node:n1", rel=["node:n1"])
    rec.record("event", "eval:zz", topic="Evaluation",
               rel=["eval:zz", "job:other"])


class TestTimeline:
    def test_seed_and_one_hop(self):
        rec = FlightRecorder()
        _journal_chain(rec)
        tl = build_timeline("eval", "e1", rec.snapshot())
        keys = [r["key"] for r in tl["rows"]]
        assert "eval:e1" in keys and "plan:p1" in keys
        assert "alloc:a1" in keys
        assert tl["kind"] == "eval" and tl["id"] == "e1"
        assert not tl["truncated"]

    def test_two_hop_reaches_the_node(self):
        """eval -> alloc (hop 1) -> the node's heartbeat expiry (hop 2):
        the eval's postmortem sees the node death that killed its
        alloc, with no direct eval<->node link in any single row."""
        rec = FlightRecorder()
        _journal_chain(rec)
        tl = build_timeline("eval", "e1", rec.snapshot())
        assert "node:n1" in tl["related"]
        assert any(r["kind"] == "heartbeat_expiry" for r in tl["rows"])

    def test_unrelated_rows_excluded(self):
        rec = FlightRecorder()
        _journal_chain(rec)
        tl = build_timeline("eval", "e1", rec.snapshot())
        assert all("zz" not in r["key"] for r in tl["rows"])
        # ...and the unrelated eval seeds its own timeline
        tl2 = build_timeline("eval", "zz", rec.snapshot())
        assert [r["key"] for r in tl2["rows"]] == ["eval:zz"]

    def test_rows_sorted_and_limit_truncates(self):
        rec = FlightRecorder()
        for i in range(30):
            rec.record("event", "eval:e1", rel=["eval:e1"])
        tl = build_timeline("eval", "e1", rec.snapshot(), limit=10)
        assert len(tl["rows"]) == 10 and tl["truncated"]
        ts = [(r["ts"], r["seq"]) for r in tl["rows"]]
        assert ts == sorted(ts)


# ---------------------------------------------------------------------------
# Satellite: AllocMetric populated from the dense feasibility mask
# ---------------------------------------------------------------------------


class TestAllocMetricFromDenseMask:
    def test_group_alloc_metric_dimension_split(self):
        """Resource-shaped screens land in dimension_exhausted,
        membership screens in constraint_filtered — mirroring the
        reference's per-checker AllocMetric attribution."""
        from nomad_tpu_torch.scheduler.gpu.solver import group_alloc_metric

        grp = SimpleNamespace(
            feasible=np.array([True, False, False, False]),
            filtered_dims={
                "datacenters": 1,
                "constraint.${attr.kernel.name} =": 1,
                "cores": 1,
                "network.port.8080": 1,
            },
        )
        m = group_alloc_metric(grp, 4)
        assert m.nodes_evaluated == 4
        assert m.nodes_filtered == 3
        assert m.constraint_filtered == {
            "datacenters": 1,
            "constraint.${attr.kernel.name} =": 1,
        }
        assert m.dimension_exhausted == {
            "cores": 1,
            "network.port.8080": 1,
        }

    def test_fast_mint_path_populates_placed_alloc_metrics(self):
        """The compact/SoA fast path minted allocs with empty metrics
        before this round; now every placed alloc carries the dense
        kernel's evaluated/filtered counts and the per-screen split."""
        from nomad_tpu_torch.scheduler.gpu import solve_eval_batch
        from nomad_tpu_torch.testing import Harness

        h = Harness()
        for _ in range(4):
            n = mock.node()
            h.state.upsert_node(h.next_index(), n)
        windows = []
        for _ in range(3):
            n = mock.node()
            n.attributes["kernel.name"] = "windows"
            h.state.upsert_node(h.next_index(), n)
            windows.append(n)
        job = mock.job(id="bb-metrics")  # carries kernel.name = linux
        job.task_groups[0].count = 2
        h.state.upsert_job(h.next_index(), job)
        ev = mock.eval_for_job(job)
        cfg = SchedulerConfig(backend="gpu", device=DEVICE,
                              small_batch_threshold=0)
        plans = solve_eval_batch(h.snapshot(), h, [ev], cfg)
        h.submit_plan(plans[ev.id])
        allocs = [
            a
            for a in h.state.allocs_by_job(job.namespace, job.id)
            if not a.terminal_status()
        ]
        assert len(allocs) == 2
        win_ids = {n.id for n in windows}
        for a in allocs:
            assert a.node_id not in win_ids
            m = a.metrics
            assert m.nodes_evaluated == 7
            assert m.nodes_filtered == 3, m.constraint_filtered
            assert sum(m.constraint_filtered.values()) == 3
            assert any(
                "kernel.name" in k for k in m.constraint_filtered
            ), m.constraint_filtered

    def test_failure_metrics_name_the_exhausted_dimension(self):
        from nomad_tpu_torch.scheduler.gpu import solve_eval_batch
        from nomad_tpu_torch.testing import Harness

        h = Harness()
        for _ in range(3):
            n = mock.node()
            n.attributes["kernel.name"] = "windows"
            h.state.upsert_node(h.next_index(), n)
        # mock.job carries kernel.name = linux: every node screens out
        job = mock.job(id="bb-impossible")
        job.task_groups[0].count = 1
        h.state.upsert_job(h.next_index(), job)
        ev = mock.eval_for_job(job)
        cfg = SchedulerConfig(backend="gpu", device=DEVICE,
                              small_batch_threshold=0)
        plans = solve_eval_batch(h.snapshot(), h, [ev], cfg)
        h.submit_plan(plans[ev.id])
        assert ev.failed_tg_allocs, "expected a failed placement"
        metric = next(iter(ev.failed_tg_allocs.values()))
        assert metric.nodes_evaluated == 3
        assert metric.nodes_filtered == 3
        filtered = {
            k: v for k, v in metric.constraint_filtered.items()
            if "kernel.name" in k
        }
        assert sum(filtered.values()) == 3, metric.constraint_filtered


# ---------------------------------------------------------------------------
# Wiring: single-flight capture, on-disk bundles, trigger loop, reload
# ---------------------------------------------------------------------------


class TestCaptureWiring:
    def test_capture_single_flight_suppresses_concurrent(self):
        from nomad_tpu_torch.server.blackbox_wire import BlackboxWiring

        w = BlackboxWiring(SimpleNamespace(node_id="t0"), incident_dir="")
        assert w._capture_lock.acquire(blocking=False)
        try:
            # a second firing while a capture is writing: suppressed,
            # counted, never queued (the pprof 429 discipline)
            assert w.capture("rule-b", {"reason": "busy"}) is None
            assert blackbox.recorder().incidents_suppressed == 1
        finally:
            w._capture_lock.release()
        rec = w.capture("rule-a", {"reason": "free"})
        assert rec is not None and rec["id"].endswith("rule-a")
        assert rec["path"] == ""  # no incident_dir: memory-only index
        assert len(blackbox.recorder().incidents()) == 1
        assert w.retry_after_s() > 0

    def test_bundle_trigger_loop_and_reload_on_live_server(self, tmp_path):
        """One dev server end to end: a manual capture writes the full
        bundle under data_dir/incidents/, a reloaded level rule drives
        trigger -> capture -> dedup through the real trigger loop, and
        the SIGHUP reload path gates recording and resizes the index."""
        from nomad_tpu_torch.server.cluster import ClusterServer

        old_reg = metrics._install_registry(Registry())
        cs = ClusterServer("bb0", data_dir=str(tmp_path), num_workers=1,
                           scheduler_config=host_config())
        cs.start()
        try:
            assert wait_until(cs.is_leader)
            # -- manual capture: the on-disk bundle contract ----------
            rec = cs.blackbox.capture(
                "unit-rule", {"reason": "unit test", "value": 2,
                              "threshold": 1},
            )
            assert rec is not None
            assert rec["path"].startswith(
                os.path.join(str(tmp_path), "incidents")
            )
            files = sorted(os.listdir(rec["path"]))
            assert files == [
                "cluster_health.json", "journal.json", "meta.json",
                "metrics.json", "profile_stacks.txt",
                "profile_status.json", "solver_status.json",
                "traces.json",
            ]
            with open(os.path.join(rec["path"], "meta.json")) as f:
                meta = json.load(f)
            assert meta["rule"] == "unit-rule" and meta["node"] == "bb0"
            with open(os.path.join(rec["path"], "journal.json")) as f:
                journal = json.load(f)
            # the journal context holds the boot's leadership establish
            assert any(
                r["kind"] == KIND_LEADERSHIP for r in journal
            ), [r["kind"] for r in journal]
            # -- the real trigger loop fires a reloaded rule ----------
            blackbox.recorder().triggers.reload([
                TriggerRule(
                    "unit-level", f"journal:{KIND_LEADERSHIP}", "level",
                    1, reason="test: any leadership row",
                ),
            ])
            cs.blackbox.interval_s = 0.2
            assert wait_until(
                lambda: any(
                    r["reason"] == "test: any leadership row"
                    for r in blackbox.recorder().incidents()
                ),
                timeout_s=15,
            ), blackbox.recorder().incidents()
            kinds = blackbox.recorder().kind_counts()
            assert kinds.get(KIND_TRIGGER, 0) >= 1
            # the level rule keeps crossing every sweep: dedup absorbs
            assert wait_until(
                lambda: blackbox.recorder().triggers.deduped >= 1,
                timeout_s=10,
            )
            assert sum(
                1 for r in blackbox.recorder().incidents()
                if r["reason"] == "test: any leadership row"
            ) == 1
            # provider gauges ride the registry
            snap = metrics.snapshot()
            assert snap["gauges"]["nomad.blackbox.incidents_captured"] >= 2
            assert "nomad.blackbox.capture_seconds" in snap["samples"]
            # -- SIGHUP reload: gate + resize -------------------------
            cs.blackbox.reload(enabled=False)
            assert not blackbox.enabled()
            assert cs.blackbox._stop is None  # threads stopped
            before = blackbox.recorder().recorded
            blackbox.record("event", "eval:gated")
            assert blackbox.recorder().recorded == before
            cs.blackbox.reload(enabled=True, incident_max=4)
            assert blackbox.enabled()
            assert cs.blackbox._stop is not None
            assert blackbox.recorder().incident_max == 4
        finally:
            cs.shutdown()
            metrics._install_registry(old_reg)


# ---------------------------------------------------------------------------
# HTTP + SDK + CLI surface (dev agent, no ACL)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dev_agent(tmp_path_factory):
    from nomad_tpu_torch.agent import Agent, AgentConfig

    cfg = AgentConfig(device=DEVICE)
    cfg.server_enabled = True
    cfg.client_enabled = False
    cfg.dev_mode = True
    cfg.http_port = 0
    cfg.data_dir = str(tmp_path_factory.mktemp("blackbox-agent"))
    # dev mode hands ClusterServer data_dir=None, so the configured
    # incident_dir is the only way a dev agent writes bundles to disk
    cfg.incident_dir = os.path.join(cfg.data_dir, "incidents")
    agent = Agent(cfg)
    agent.start()
    assert wait_until(lambda: agent.server.is_leader(), 15)
    yield agent
    agent.shutdown()


@pytest.fixture()
def api(dev_agent):
    from nomad_tpu_torch.api.client import NomadClient

    host, port = dev_agent.http_addr
    return NomadClient(f"http://{host}:{port}")


class TestHTTPSurface:
    def test_blackbox_status_payload(self, dev_agent, api):
        blackbox.record("event", "eval:probe", rel=["eval:probe"])
        snap = api.agent.blackbox_status()
        assert snap["enabled"] is True
        assert snap["incident_dir"].endswith("incidents")
        assert snap["stats"]["journal_recorded"] >= 1
        names = {r["name"] for r in snap["triggers"]["rules"]}
        assert "leader-churn" in names and "shed-storm" in names
        assert "journal" not in snap
        tail = api.agent.blackbox_status(journal=5)
        assert 1 <= len(tail["journal"]) <= 5

    def test_incidents_index_and_404(self, dev_agent, api):
        from nomad_tpu_torch.api.client import APIError

        assert api.agent.incidents() == []
        with pytest.raises(APIError) as e:
            api.agent.incident("never-captured")
        assert e.value.status == 404
        blackbox.recorder().add_incident(
            "20260807-000000-unit", "unit reason", "", {"value": 3},
        )
        idx = api.agent.incidents()
        assert [r["id"] for r in idx] == ["20260807-000000-unit"]
        rec = api.agent.incident("20260807-000000-unit")
        assert rec["reason"] == "unit reason" and rec["files"] == []

    def test_timeline_rejects_unknown_kind(self, dev_agent, api):
        from nomad_tpu_torch.api.client import APIError

        with pytest.raises(APIError) as e:
            api.agent.timeline("volcano", "x1")
        assert e.value.status == 400
        assert "kind must be one of" in str(e.value)

    def test_timeline_over_http_for_a_real_eval(self, dev_agent, api):
        """Submit a real job and read the eval's causal view back over
        HTTP: the pump journaled the broker events, the reconstructor
        links eval -> alloc -> node/job."""
        srv = dev_agent.server.server
        srv.raft_apply("node_register", mock.node())
        job = mock.job(id="bb-tl-job")
        job.task_groups[0].count = 1
        srv.job_register(job)
        assert wait_until(
            lambda: any(
                not a.terminal_status()
                for a in srv.state.allocs_by_job("default", job.id)
            )
        )
        alloc = next(
            a for a in srv.state.allocs_by_job("default", job.id)
            if not a.terminal_status()
        )
        # the pump thread journals asynchronously: wait for the alloc's
        # event row to land before reconstructing
        assert wait_until(
            lambda: any(
                alloc.id in (r["key"] or "")
                for r in blackbox.recorder().snapshot()
            )
        )
        tl = api.agent.timeline("eval", alloc.eval_id)
        assert tl["kind"] == "eval" and tl["id"] == alloc.eval_id
        assert tl["rows"], "timeline empty for a placed eval"
        assert f"alloc:{alloc.id}" in tl["related"]
        assert f"job:{job.id}" in tl["related"]
        assert any(r["kind"] == KIND_EVENT for r in tl["rows"])
        # the alloc seed walks back to the same chain
        tl2 = api.agent.timeline("alloc", alloc.id)
        assert f"eval:{alloc.eval_id}" in tl2["related"]

    def test_debug_bundle_grabs_incidents_and_journal(self, dev_agent, api):
        from nomad_tpu_torch.agent.debug import debug_bundle

        blackbox.recorder().add_incident(
            "20260807-000001-bundle", "bundle reason", "", {},
        )
        bundle = debug_bundle(api)
        assert [r["id"] for r in bundle["incidents"]] == [
            "20260807-000001-bundle",
        ]
        assert bundle["blackbox"]["stats"]["incidents_stored"] == 1
        assert "journal" in bundle["blackbox"]

    def test_cli_incidents_and_timeline(self, dev_agent, api, capsys):
        from nomad_tpu_torch.cli.main import main

        host, port = dev_agent.http_addr
        addr = f"http://{host}:{port}"
        assert main(
            ["operator", "incidents", "list", "-address", addr]
        ) == 0
        assert "blackbox is quiet" in capsys.readouterr().out
        blackbox.recorder().add_incident(
            "20260807-000002-cli", "cli reason", "",
            {"value": 7, "threshold": 2, "source": "counter:x"},
        )
        assert main(
            ["operator", "incidents", "list", "-address", addr]
        ) == 0
        out = capsys.readouterr().out
        assert "20260807-000002-cli" in out and "cli reason" in out
        assert main(
            ["operator", "incidents", "show", "20260807-000002-cli",
             "-address", addr]
        ) == 0
        out = capsys.readouterr().out
        assert "cli reason" in out and "counter:x" in out
        blackbox.record("event", "eval:cli-e1", rel=["eval:cli-e1"])
        assert main(
            ["operator", "timeline", "eval", "cli-e1", "-json",
             "-address", addr]
        ) == 0
        payload = json.loads(capsys.readouterr().out)
        assert payload["kind"] == "eval" and payload["rows"]
        assert main(
            ["operator", "timeline", "eval", "cli-e1", "-address", addr]
        ) == 0
        assert "eval:cli-e1" in capsys.readouterr().out

    def test_operator_top_incidents_row_only_when_loud(self, dev_agent, api):
        from nomad_tpu_torch.cli.main import _render_top

        snap = api.agent.metrics()
        quiet = {"stats": blackbox.FlightRecorder().stats(),
                 "incidents": []}
        assert "Incidents" not in _render_top(snap, None, blackbox=quiet)
        loud = {
            "stats": {
                "triggers_fired": 2.0, "triggers_deduped": 1.0,
                "incidents_captured": 1.0, "incidents_stored": 1.0,
                "incidents_suppressed": 0.0,
            },
            "incidents": [{"id": "20260807-000003-churn"}],
        }
        frame = _render_top(snap, None, blackbox=loud)
        assert "Incidents" in frame
        assert "20260807-000003-churn" in frame


# ---------------------------------------------------------------------------
# Agent reload (SIGHUP) + HCL telemetry stanza
# ---------------------------------------------------------------------------


def test_agent_reload_flips_blackbox(tmp_path):
    from nomad_tpu_torch.agent import Agent, AgentConfig

    cfg = AgentConfig(device=DEVICE)
    cfg.server_enabled = True
    cfg.dev_mode = True
    cfg.http_port = 0
    cfg.data_dir = str(tmp_path)
    agent = Agent(cfg)
    agent.start()
    try:
        assert wait_until(lambda: agent.server.is_leader(), 15)
        new = dataclasses.replace(
            agent.config, blackbox_enabled=False, incident_max=4,
        )
        changed = agent.reload(new)
        assert "blackbox" in changed
        assert not agent.server.blackbox.enabled
        assert not blackbox.enabled()
        assert blackbox.recorder().incident_max == 4
        # a second identical reload is a no-op
        assert "blackbox" not in agent.reload(new)
        back = dataclasses.replace(agent.config, blackbox_enabled=True)
        assert "blackbox" in agent.reload(back)
        assert blackbox.enabled() and agent.server.blackbox.enabled
    finally:
        agent.shutdown()


def test_hcl_telemetry_blackbox_keys(tmp_path):
    from nomad_tpu_torch.cli.main import _load_agent_config

    p = tmp_path / "agent.hcl"
    p.write_text(
        'data_dir = "%s"\n'
        "telemetry {\n"
        "  blackbox_enabled = false\n"
        '  incident_dir     = "/var/tmp/bb-incidents"\n'
        "  incident_max     = 4\n"
        "}\n" % tmp_path
    )
    cfg = _load_agent_config(str(p))
    assert cfg.blackbox_enabled is False
    assert cfg.incident_dir == "/var/tmp/bb-incidents"
    assert cfg.incident_max == 4
    # defaults when the stanza is silent
    p2 = tmp_path / "plain.hcl"
    p2.write_text('data_dir = "%s"\n' % tmp_path)
    cfg2 = _load_agent_config(str(p2))
    assert cfg2.blackbox_enabled is True
    assert cfg2.incident_max == 16


# ---------------------------------------------------------------------------
# ACL battery: the three routes sit behind agent:read
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def acl_agent(tmp_path_factory):
    from nomad_tpu_torch.agent import Agent, AgentConfig

    cfg = AgentConfig.dev()
    cfg.device = DEVICE
    cfg.acl_enabled = True
    cfg.data_dir = str(tmp_path_factory.mktemp("blackbox-acl"))
    a = Agent(cfg)
    a.start()
    assert wait_until(lambda: a.server.is_leader(), 15)
    yield a
    a.shutdown()


@pytest.fixture(scope="module")
def root(acl_agent):
    from nomad_tpu_torch.api.client import NomadClient

    host, port = acl_agent.http_addr
    api = NomadClient(f"http://{host}:{port}")
    token = api.acl.bootstrap()
    return NomadClient(f"http://{host}:{port}", token=token.secret_id)


class TestBlackboxACL:
    """Anon 401, a namespace-only token 403, agent:read 200 — the same
    gate as /v1/metrics, on all three blackbox routes."""

    def _token(self, root, name, rules):
        root.acl.policy_apply(name, rules)
        return root.acl.token_create(name=name, policies=[name])

    def _calls(self, client):
        return [
            lambda: client.agent.blackbox_status(),
            lambda: client.agent.incidents(),
            lambda: client.agent.timeline("eval", "e-acl"),
        ]

    def test_anon_denied(self, acl_agent):
        from nomad_tpu_torch.api.client import APIError, NomadClient

        host, port = acl_agent.http_addr
        anon = NomadClient(f"http://{host}:{port}")
        for call in self._calls(anon):
            with pytest.raises(APIError) as e:
                call()
            assert e.value.status in (401, 403)

    def test_namespace_token_denied(self, acl_agent, root):
        from nomad_tpu_torch.api.client import APIError, NomadClient

        host, port = acl_agent.http_addr
        tok = self._token(
            root, "bb-ns-only",
            'namespace "default" { policy = "read" }',
        )
        nsr = NomadClient(f"http://{host}:{port}", token=tok.secret_id)
        for call in self._calls(nsr):
            with pytest.raises(APIError) as e:
                call()
            assert e.value.status == 403

    def test_agent_read_suffices(self, acl_agent, root):
        from nomad_tpu_torch.api.client import NomadClient

        host, port = acl_agent.http_addr
        tok = self._token(
            root, "bb-agent-r", 'agent { policy = "read" }',
        )
        reader = NomadClient(f"http://{host}:{port}", token=tok.secret_id)
        assert "stats" in reader.agent.blackbox_status()
        assert reader.agent.incidents() == []
        assert reader.agent.timeline("eval", "e-acl")["rows"] == []
        # management passes everywhere
        assert "triggers" in root.agent.blackbox_status()


# ---------------------------------------------------------------------------
# Chaos: partition + leader kill => exactly ONE deduped incident whose
# timeline carries the leadership transitions
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_chaos_partition_and_leader_kill_one_deduped_incident(tmp_path):
    """The acceptance scenario: a 3-node cluster survives a leader
    partition + heal + leader kill. The churn (establish / revoke
    edges from multiple processes-worth of wirings sharing one
    in-process engine) crosses the leader-churn delta, capture fires
    ONCE, every further crossing inside the dedup window is absorbed,
    and the new leader's node timeline shows the transition."""
    from nomad_tpu_torch.testing.chaos import ChaosCluster

    cluster = ChaosCluster(3, str(tmp_path), seed=11,
                           scheduler_config=host_config()).start()
    try:
        first = cluster.wait_for_stable_leader()
        assert first is not None
        lead_id = first.node_id
        # tighten every wiring's trigger loop to the test budget and
        # let at least one sweep record the healthy baseline
        for cs in cluster.servers.values():
            cs.blackbox.interval_s = 0.2
        time.sleep(0.6)
        others = [nid for nid in cluster.ids if nid != lead_id]
        # partition the leader away: the survivors hold quorum and
        # elect; healing deposes the stale leader (a revoke edge)
        cluster.partition([lead_id], others)
        assert wait_until(
            lambda: any(
                cluster.servers[nid].is_leader() for nid in others
            ),
            timeout_s=45,
        ), "survivors never elected through the partition"
        cluster.heal()
        # ...then kill whoever leads now: a third transition
        second = cluster.wait_for_stable_leader()
        assert second is not None
        cluster.kill(second.node_id)
        final = cluster.wait_for_stable_leader()
        assert final is not None
        rec = blackbox.recorder()
        assert wait_until(
            lambda: rec.incidents_captured >= 1, timeout_s=30
        ), rec.stats()
        # several more sweeps: the continuing churn inside the dedup
        # window must NOT mint a second incident
        time.sleep(1.5)
        incidents = rec.incidents()
        assert len(incidents) == 1, incidents
        inc = incidents[0]
        assert inc["detail"]["rule"] == "leader-churn"
        assert inc["detail"]["delta"] >= 2
        # the bundle landed under the capturing node's data dir
        assert inc["path"] and os.path.isdir(inc["path"]), inc
        assert "meta.json" in os.listdir(inc["path"])
        # the causal timeline for the surviving leader's node carries
        # the leadership transition rows
        tl = build_timeline("node", final.node_id, rec.snapshot())
        lead_rows = [
            r for r in tl["rows"] if r["kind"] == KIND_LEADERSHIP
        ]
        assert lead_rows, tl["rows"][:5]
        assert any(
            r["detail"]["transition"] == "establish" for r in lead_rows
        )
        cluster.check_invariants()
    finally:
        cluster.shutdown()


# ---------------------------------------------------------------------------
# Throughput gate: front door with the recorder ON vs OFF
# ---------------------------------------------------------------------------

OVERHEAD_SCRIPT = r"""
import json, random, statistics, sys, tempfile, time
sys.path.insert(0, %r)

from nomad_tpu_torch import blackbox
from nomad_tpu_torch.scheduler.context import SchedulerConfig
from nomad_tpu_torch.server.cluster import ClusterServer

# One dev-mode server with its blackbox wiring live (pump + trigger
# threads running, journal hook sites armed); the measured op is the
# front door itself: an in-process dispatch (rpc_self) plus a fabric
# round-trip (ConnPool -> RPCServer._dispatch) per iteration.
cs = ClusterServer("bench-bb0", num_workers=1,
                   scheduler_config=SchedulerConfig(backend="host",
                                                    device="cpu"))
cs.start()
deadline = time.monotonic() + 15
while cs.raft.leader_id is None and time.monotonic() < deadline:
    time.sleep(0.01)
addr = cs.rpc.addr


def once(instrumented: bool, reps: int) -> float:
    blackbox.set_enabled(instrumented)
    try:
        t0 = time.perf_counter()
        for _ in range(reps):
            cs.rpc_self("Status.ping", {})
            cs.pool.call(addr, "Status.ping", {})
        return time.perf_counter() - t0
    finally:
        blackbox.set_enabled(True)


# warm sockets + code paths, then size bursts to ~60ms of wall
t1 = float("inf")
for _ in range(3):
    t0 = time.perf_counter()
    once(True, 20)
    t1 = min(t1, (time.perf_counter() - t0) / 20)
reps = max(20, int(0.06 / max(t1, 1e-6)))
pairs = 24
ratios = []
for _ in range(pairs):
    order = [False, True]
    random.shuffle(order)
    t = {}
    for on in order:
        t[on] = once(on, reps)
    ratios.append(t[False] / t[True])
cs.shutdown()
out = {"median": statistics.median(ratios), "reps": reps,
       "burst_ms": t1 * reps * 1e3}
print(json.dumps(out))
"""


def test_blackbox_throughput_vs_disabled():
    """Front-door throughput with the flight recorder ON stays >=
    0.95x the gated-off path. Statistic per the round-13 recipe: the
    median of temporally-adjacent off/on burst-pair ratios judged
    WITHIN one clean subprocess, best across attempts (paired bursts
    cancel between-subprocess floor drift on a shared box; a load
    spike lands in one pair and dies at the median; a real regression
    shifts every pair alike)."""
    medians = []
    for _attempt in range(5):
        proc = subprocess.run(
            [sys.executable, "-c", OVERHEAD_SCRIPT % REPO_ROOT],
            capture_output=True,
            text=True,
            timeout=300,
            env=dict(os.environ, JAX_PLATFORMS="cpu"),
            cwd=REPO_ROOT,
        )
        assert proc.returncode == 0, proc.stderr[-2000:]
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        medians.append(round(out["median"], 3))
        if out["median"] >= 0.95:
            return
    pytest.fail(
        f"blackbox-enabled front-door throughput < 0.95x disabled in "
        f"5 attempts; per-attempt paired-burst medians: {medians}"
    )
