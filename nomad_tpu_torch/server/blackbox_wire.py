"""Blackbox wiring: pumps the live control plane into the flight
recorder and turns trigger firings into on-disk incident captures.

Port of ``nomad_tpu/server/blackbox_wire.py``. The leaf (blackbox.py)
is pure bookkeeping — journal ring,
trigger math, incident index, timeline merge — and never imports
metrics/trace/stream. This module is the impure half, one instance per
ClusterServer:

  * event pump — a broker subscription over ALL topics journals every
    node/eval/alloc/deployment event with extracted cross-object links
    (``rel: ["eval:<id>", "node:<id>", ...]``), which is what makes the
    timeline reconstructor's causal expansion work;
  * health/trigger loop — journals a periodic health frame (raft
    indices, broker depths, plan-queue depth) and evaluates the trigger
    engine over journal-kind counts + registry counters + last-window
    histogram p99s;
  * incident capture — a firing writes a full debug-bundle-equivalent
    (journal, metrics, traces, profile summary + collapsed stacks,
    solver status, cluster health) under ``incident_dir/<ts>-<rule>/``.
    Capture is single-flight behind a non-blocking lock + busy-until
    deadline: a flapping trigger suppresses concurrent writes instead
    of stacking them.

Leadership edges, dup-mint trims, sheds, expiry batches, and
pool-member faults are journaled directly at their hook sites (they
carry context the event stream doesn't); this module only owns the
pumps and the capture.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Optional

from .. import blackbox, metrics
from ..stream.event_broker import SubscriptionClosedError

logger = logging.getLogger("nomad_tpu_torch.server")

DEFAULT_INTERVAL_S = 2.0
CAPTURE_HOLD_S = 5.0

# broker topic -> timeline token kind
_TOPIC_KIND = {
    "Node": "node",
    "Evaluation": "eval",
    "Allocation": "alloc",
    "Job": "job",
    "Deployment": "deployment",
}
# payload attribute -> timeline token kind (cross-object links)
_REL_ATTRS = (
    ("eval_id", "eval"),
    ("node_id", "node"),
    ("job_id", "job"),
    ("deployment_id", "deployment"),
)


def event_rels(topic: str, key: str, payload) -> list[str]:
    """The ``kind:id`` tokens one broker event mentions: the event's
    own object plus every cross-object id its payload carries."""
    rels = []
    kind = _TOPIC_KIND.get(topic)
    if kind and key:
        rels.append(f"{kind}:{key}")
    for attr, k in _REL_ATTRS:
        v = getattr(payload, attr, None)
        if v and isinstance(v, str):
            tok = f"{k}:{v}"
            if tok not in rels:
                rels.append(tok)
    return rels


class BlackboxWiring:
    """Per-ClusterServer pumps + capture for the process-global flight
    recorder. ``interval_s`` is instance-tunable (the heartbeat-wheel
    idiom) so chaos scenarios tighten the trigger loop to fit a test
    budget without faking the evaluation path."""

    def __init__(
        self,
        cluster,
        incident_dir: str = "",
        incident_max: int = blackbox.DEFAULT_INCIDENT_MAX,
        enabled: bool = True,
        interval_s: float = DEFAULT_INTERVAL_S,
    ) -> None:
        self.cluster = cluster
        self.incident_dir = incident_dir or ""
        self.enabled = bool(enabled)
        self.interval_s = float(interval_s)
        self._stop: Optional[threading.Event] = None
        self._threads: list[threading.Thread] = []
        self._provider = None
        # single-flight capture gate (the pprof pattern: non-blocking
        # acquire + busy-until deadline; concurrent firings are
        # suppressed, counted, and report Retry-After upstream)
        self._capture_lock = threading.Lock()
        self._busy_until = 0.0
        if blackbox.recorder().incident_max != int(incident_max):
            blackbox.recorder().set_incident_max(incident_max)

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        if not self.enabled or self._stop is not None:
            return
        self._stop = threading.Event()
        self._provider = metrics.register_provider(
            "nomad.blackbox", blackbox.recorder().stats
        )
        for name, fn in (
            ("blackbox-pump", self._pump_loop),
            ("blackbox-triggers", self._trigger_loop),
        ):
            t = threading.Thread(
                target=fn, args=(self._stop,), name=name, daemon=True
            )
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        stop, self._stop = self._stop, None
        if stop is None:
            return
        stop.set()
        for t in self._threads:
            t.join(timeout=5)
        self._threads = []
        if self._provider is not None:
            metrics.unregister_provider("nomad.blackbox", self._provider)
            self._provider = None

    def reload(
        self,
        enabled: Optional[bool] = None,
        incident_dir: Optional[str] = None,
        incident_max: Optional[int] = None,
    ) -> None:
        """SIGHUP path: flip the recording gate / retarget the incident
        dir / resize the ledger without restarting the agent."""
        if incident_dir is not None:
            self.incident_dir = incident_dir
        if incident_max is not None:
            blackbox.recorder().set_incident_max(incident_max)
        if enabled is not None and bool(enabled) != self.enabled:
            self.enabled = bool(enabled)
            # the module flag gates the hook-site record() calls too —
            # process-wide, which matches one-agent-per-process prod
            blackbox.set_enabled(self.enabled)
            if self.enabled:
                self.start()
            else:
                self.stop()

    # -- event pump ----------------------------------------------------

    def _pump_loop(self, stop: threading.Event) -> None:
        broker = self.cluster.server.event_broker
        sub = broker.subscribe(None)
        while not stop.is_set():
            try:
                events = sub.next(timeout_s=0.5)
            except SubscriptionClosedError:
                # evicted (slow consumer) or broker restarted: the gap
                # is counted by nomad.stream.evicted_total; resubscribe
                # from the live head
                try:
                    sub = broker.subscribe(None)
                except Exception:
                    if stop.wait(0.5):
                        return
                continue
            for ev in events:
                rels = event_rels(ev.topic, ev.key, ev.payload)
                blackbox.record(
                    blackbox.KIND_EVENT,
                    rels[0] if rels else ev.key,
                    topic=ev.topic,
                    type=ev.type,
                    index=ev.index,
                    rel=rels,
                )
        try:
            sub.close()
        except Exception:
            pass

    # -- health frames + trigger evaluation ----------------------------

    def _trigger_loop(self, stop: threading.Event) -> None:
        while not stop.wait(self.interval_s):
            try:
                self._health_frame()
                for firing in blackbox.recorder().triggers.evaluate(
                    self._trigger_values()
                ):
                    # the firing's own "kind" (delta|level) would shadow
                    # the journal-row kind positional: journal it as
                    # rule_kind
                    detail = {
                        k: v for k, v in firing.items()
                        if k not in ("rule", "kind")
                    }
                    detail["rule_kind"] = firing["kind"]
                    blackbox.record(
                        blackbox.KIND_TRIGGER, firing["rule"], **detail
                    )
                    self.capture(firing["rule"], firing)
            except Exception:
                logger.exception("blackbox trigger sweep failed")

    def _health_frame(self) -> None:
        c = self.cluster
        raft = c.raft
        srv = c.server
        blackbox.record(
            blackbox.KIND_HEALTH,
            f"node:{c.node_id}",
            raft_state=raft.state,
            term=raft.current_term,
            commit_index=raft.commit_index,
            applied_index=raft.last_applied,
            broker=srv.eval_broker.stats_snapshot(),
            plan_queue_depth=srv.plan_queue.depth(),
            stream=srv.event_broker.stats(),
        )

    def _trigger_values(self) -> dict:
        vals: dict[str, float] = {}
        for kind, n in blackbox.recorder().kind_counts().items():
            vals[f"journal:{kind}"] = float(n)
        snap = metrics.snapshot()
        for name, v in snap["counters"].items():
            vals[f"counter:{name}"] = float(v)
        for name, s in snap["samples"].items():
            w = s.get("window") or s
            p99 = w.get("p99")
            if p99 is not None:
                vals[f"p99:{name}"] = float(p99)
        return vals

    # -- incident capture ----------------------------------------------

    def capture(self, rule: str, detail: dict) -> Optional[dict]:
        """Write one incident bundle; single-flight. Returns the ledger
        record, or None when suppressed by the in-progress gate."""
        if not self._capture_lock.acquire(blocking=False):
            blackbox.recorder().suppress_incident()
            return None
        try:
            # FIRST thing under the lock (the pprof discipline): a
            # crashed capture must not leave busy_until stale-low
            self._busy_until = time.monotonic() + CAPTURE_HOLD_S
            t0 = time.monotonic()
            incident_id = "%s-%s" % (
                time.strftime("%Y%m%d-%H%M%S"), rule
            )
            path = ""
            if self.incident_dir:
                path = os.path.join(self.incident_dir, incident_id)
                try:
                    self._write_bundle(path, rule, detail)
                except Exception:
                    logger.exception(
                        "blackbox incident write failed: %s", path
                    )
                    path = ""
            rec = blackbox.recorder().add_incident(
                incident_id, detail.get("reason") or rule, path, detail
            )
            metrics.observe(
                "nomad.blackbox.capture_seconds",
                time.monotonic() - t0,
            )
            logger.warning(
                "blackbox incident captured: %s (%s)",
                incident_id, detail.get("reason") or rule,
            )
            return rec
        finally:
            self._capture_lock.release()

    def retry_after_s(self) -> float:
        """How long a single-flight-suppressed caller should wait."""
        return max(0.1, self._busy_until - time.monotonic())

    def _write_bundle(self, path: str, rule: str, detail: dict) -> None:
        from .. import hostobs, solverobs, trace

        os.makedirs(path, exist_ok=True)

        def dump(name: str, fn) -> None:
            try:
                payload = fn()
            except Exception as e:  # capture what we can, note the rest
                payload = {"error": str(e)}
            with open(os.path.join(path, name), "w") as f:
                if isinstance(payload, str):
                    f.write(payload)
                else:
                    json.dump(payload, f, indent=1, default=str)

        dump("meta.json", lambda: {
            "rule": rule,
            "detail": detail,
            "node": self.cluster.node_id,
            "captured_at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        })
        dump("journal.json", lambda: blackbox.recorder().snapshot())
        dump("metrics.json", metrics.snapshot)
        dump("traces.json", lambda: trace.recorder().list(limit=200))
        dump("profile_status.json", lambda: hostobs.snapshot(top=50))
        dump("profile_stacks.txt", hostobs.collapsed)
        dump("solver_status.json", solverobs.snapshot)
        dump("cluster_health.json", lambda: self.cluster.cluster_health(
            per_peer_timeout_s=0.5, top=5
        ))
