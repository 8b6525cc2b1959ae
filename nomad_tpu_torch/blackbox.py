"""Blackbox flight recorder: always-on control-plane journal,
anomaly triggers, incident ledger, and causal timeline math.

Port of ``nomad_tpu/blackbox.py``. Four pieces, all bounded:

  * :class:`FlightRecorder` — a ring journal of control-plane
    transitions (broker events, leadership edges, dup-mint trims,
    admission sheds, heartbeat expiry batches, pool-member faults,
    periodic health frames). A record is a timestamp + kind + key +
    small detail dict; the deque maxlen is the eviction bound and
    evictions are counted, never silent.
  * :class:`TriggerEngine` — declarative anomaly rules over plain
    name->value inputs: ``delta`` rules fire when a monotonic counter
    rises by >= threshold inside a sliding window, ``level`` rules when
    a sampled value crosses a threshold. Firings are deduped per rule
    and rate-limited globally so a flapping trigger cannot storm
    captures.
  * the incident ledger — a bounded index of captured incidents (the
    wiring in server/blackbox_wire.py writes the bundles).
  * :func:`build_timeline` — a pure merge of journal rows (which carry
    cross-object ``rel`` links) into one causal view for a seed object.

A stdlib-only leaf: journal writes come from hook sites that hold their
own imports, trigger inputs arrive as plain dicts, and the
``nomad.blackbox.*`` gauges are pull-read by a provider the wiring
layer registers.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

DEFAULT_JOURNAL_CAPACITY = 4096
DEFAULT_INCIDENT_MAX = 16
DEFAULT_DEDUP_WINDOW_S = 300.0
DEFAULT_MAX_PER_HOUR = 6

# Journal kinds (the closed vocabulary hook sites record under).
KIND_EVENT = "event"              # broker event (node/eval/alloc/...)
KIND_LEADERSHIP = "leadership"    # establish/revoke edge
KIND_DUP_MINT = "dup_mint"        # plan-apply duplicate-mint trim
KIND_SHED = "shed"                # eval-broker admission shed
KIND_EXPIRY = "heartbeat_expiry"  # heartbeat wheel expiry batch
KIND_POOL_FAULT = "pool_fault"    # solver-pool member fault
KIND_HEALTH = "health"            # periodic health frame
KIND_TRIGGER = "trigger"          # a rule fired
KIND_INCIDENT = "incident"        # a capture completed

_enabled = True


def enabled() -> bool:
    return _enabled


def set_enabled(on: bool) -> None:
    """Recording gate (GIL-atomic flag): the uninstrumented side of the
    front-door throughput comparison gate; production leaves it on."""
    global _enabled
    _enabled = bool(on)


# -- trigger rules --------------------------------------------------------


@dataclass
class TriggerRule:
    """One declarative anomaly rule.

    ``source`` names a key in the values dict the engine is evaluated
    with (the wiring feeds ``journal:<kind>`` journal-kind counts,
    ``counter:<name>`` registry counters, and ``p99:<name>`` last-window
    histogram p99s). ``kind`` is ``delta`` (rise of a monotonic value by
    >= threshold within window_s) or ``level`` (sampled value >=
    threshold)."""

    name: str
    source: str
    kind: str  # "delta" | "level"
    threshold: float
    window_s: float = 60.0
    reason: str = ""


def default_rules() -> list[TriggerRule]:
    """The stock trigger catalogue (docs/incidents.md documents each).

    Thresholds are deliberately conservative: the tier-1 false-positive
    gate asserts a clean mini-soak captures ZERO incidents, so every
    default must be unreachable without a real anomaly. The leader
    rule's threshold of 2 is what keeps a clean boot quiet: a process
    establishes leadership exactly once on a healthy cluster, so two
    transitions inside one window always means churn."""
    return [
        TriggerRule(
            "leader-churn", f"journal:{KIND_LEADERSHIP}", "delta", 2,
            window_s=120.0,
            reason="2+ leadership transitions inside the window",
        ),
        TriggerRule(
            "shed-storm", "counter:nomad.broker.shed", "delta", 50,
            window_s=60.0,
            reason="admission control shed 50+ evals in the window",
        ),
        TriggerRule(
            "throttle-storm", "counter:nomad.http.throttled", "delta",
            100, window_s=60.0,
            reason="front door returned 100+ 429s in the window",
        ),
        TriggerRule(
            "device-failover-burst",
            "counter:nomad.worker.device_failover", "delta", 3,
            window_s=60.0,
            reason="3+ solver device failovers in the window",
        ),
        TriggerRule(
            "dup-mint-invariant",
            "counter:nomad.plan_apply.dup_mint_trimmed", "delta", 1,
            window_s=3600.0,
            reason="plan-apply trimmed a duplicate mint "
                   "(invariant counter moved)",
        ),
        TriggerRule(
            "e2e-p99-breach", "p99:nomad.eval.e2e_seconds", "level",
            30.0, window_s=60.0,
            reason="eval end-to-end p99 crossed 30s",
        ),
    ]


class TriggerEngine:
    """Evaluates rules over plain name->value inputs; dedupes and
    rate-limits firings.

    History is per rule: a deque of (t, value) samples pruned to the
    rule's window, so a ``delta`` rule compares the newest sample to
    the oldest one still inside the window — a counter that rose
    before the window opened never re-fires. Dedup suppresses a rule
    that fired inside ``dedup_window_s``; the global
    ``max_per_hour`` cap bounds capture volume across ALL rules (a
    flapping cluster must not fill the disk with bundles)."""

    def __init__(
        self,
        rules: Optional[list[TriggerRule]] = None,
        dedup_window_s: float = DEFAULT_DEDUP_WINDOW_S,
        max_per_hour: int = DEFAULT_MAX_PER_HOUR,
    ) -> None:
        self._lock = threading.Lock()
        self.rules: list[TriggerRule] = (
            list(rules) if rules is not None else default_rules()
        )
        self.dedup_window_s = float(dedup_window_s)
        self.max_per_hour = int(max_per_hour)
        self._history: dict[str, deque] = {}
        self._last_fired: dict[str, float] = {}
        self._fire_times: deque = deque(maxlen=256)
        self.fired = 0
        self.deduped = 0
        self.rate_limited = 0

    def reload(self, rules: Optional[list[TriggerRule]] = None) -> None:
        """Swap the rule set live (SIGHUP path); history for rules that
        survive by name is kept so windows don't reset on reload."""
        with self._lock:
            self.rules = (
                list(rules) if rules is not None else default_rules()
            )
            keep = {r.name for r in self.rules}
            for name in [n for n in self._history if n not in keep]:
                del self._history[name]

    def evaluate(
        self, values: dict, now: Optional[float] = None
    ) -> list[dict]:
        """One evaluation pass. Returns the firings that SURVIVED dedup
        and rate limiting, each as {"rule", "source", "kind", "value",
        "delta", "threshold", "reason"}."""
        t = time.monotonic() if now is None else now
        out: list[dict] = []
        with self._lock:
            for rule in self.rules:
                v = values.get(rule.source)
                if v is None:
                    continue
                v = float(v)
                crossed = False
                delta = 0.0
                if rule.kind == "delta":
                    hist = self._history.get(rule.name)
                    if hist is None:
                        hist = self._history[rule.name] = deque()
                    hist.append((t, v))
                    while hist and hist[0][0] < t - rule.window_s:
                        hist.popleft()
                    delta = v - hist[0][1]
                    crossed = delta >= rule.threshold
                else:  # level
                    delta = v
                    crossed = v >= rule.threshold
                if not crossed:
                    continue
                last = self._last_fired.get(rule.name)
                if last is not None and t - last < self.dedup_window_s:
                    self.deduped += 1
                    continue
                recent = sum(
                    1 for ft in self._fire_times if ft > t - 3600.0
                )
                if recent >= self.max_per_hour:
                    self.rate_limited += 1
                    continue
                self._last_fired[rule.name] = t
                self._fire_times.append(t)
                self.fired += 1
                # a delta rule that fired starts a fresh window so the
                # SAME rise can't re-fire after the dedup window ends
                if rule.kind == "delta":
                    self._history[rule.name] = deque([(t, v)])
                out.append({
                    "rule": rule.name,
                    "source": rule.source,
                    "kind": rule.kind,
                    "value": v,
                    "delta": round(delta, 6),
                    "threshold": rule.threshold,
                    "reason": rule.reason,
                })
        return out

    def status(self) -> dict:
        with self._lock:
            return {
                "rules": [
                    {
                        "name": r.name,
                        "source": r.source,
                        "kind": r.kind,
                        "threshold": r.threshold,
                        "window_s": r.window_s,
                        "reason": r.reason,
                        "last_fired_ago_s": (
                            round(
                                time.monotonic()
                                - self._last_fired[r.name], 3,
                            )
                            if r.name in self._last_fired else None
                        ),
                    }
                    for r in self.rules
                ],
                "dedup_window_s": self.dedup_window_s,
                "max_per_hour": self.max_per_hour,
                "fired": self.fired,
                "deduped": self.deduped,
                "rate_limited": self.rate_limited,
            }


# -- the flight recorder --------------------------------------------------

MAX_KINDS = 64


class FlightRecorder:
    """Bounded journal ring + trigger engine + incident index.

    One instance per process in production (the module global below);
    in-process test clusters share it, which is exactly what the chaos
    "exactly one deduped incident" assertion wants — dedup state is
    cluster-wide when the cluster is one process."""

    def __init__(
        self,
        capacity: int = DEFAULT_JOURNAL_CAPACITY,
        incident_max: int = DEFAULT_INCIDENT_MAX,
    ) -> None:
        self._lock = threading.Lock()
        self.capacity = max(16, int(capacity))
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self._kind_counts: dict[str, int] = {}
        self.recorded = 0
        self.triggers = TriggerEngine()
        self.incident_max = max(1, int(incident_max))
        self._incidents: deque = deque(maxlen=self.incident_max)
        self.incidents_captured = 0
        self.incidents_suppressed = 0

    # -- journal -------------------------------------------------------

    def record(self, kind: str, key: str = "", **detail) -> None:
        """Append one journal row. Hot-path cheap: a dict build + deque
        append under the lock; the deque maxlen is the eviction bound."""
        if not _enabled:
            return
        row = {"ts": time.time(), "kind": kind, "key": key}
        if detail:
            row["detail"] = detail
        with self._lock:
            self._seq += 1
            row["seq"] = self._seq
            self.recorded += 1
            if kind in self._kind_counts:
                self._kind_counts[kind] += 1
            elif len(self._kind_counts) < MAX_KINDS:
                self._kind_counts[kind] = 1
            self._ring.append(row)

    def snapshot(
        self,
        limit: int = 0,
        kind: Optional[str] = None,
        key_contains: Optional[str] = None,
    ) -> list[dict]:
        """Journal rows oldest-first, optionally filtered; ``limit``
        keeps the NEWEST n after filtering (0 = all buffered)."""
        with self._lock:
            rows = list(self._ring)
        if kind is not None:
            rows = [r for r in rows if r["kind"] == kind]
        if key_contains:
            rows = [r for r in rows if key_contains in r["key"]]
        if limit and len(rows) > limit:
            rows = rows[-limit:]
        return rows

    def kind_counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._kind_counts)

    # -- incident index ------------------------------------------------

    def add_incident(
        self, incident_id: str, reason: str, path: str, detail: dict
    ) -> dict:
        rec = {
            "id": incident_id,
            "ts": time.time(),
            "reason": reason,
            "path": path,
            "detail": detail,
        }
        with self._lock:
            self._incidents.append(rec)
            self.incidents_captured += 1
        self.record(KIND_INCIDENT, incident_id, reason=reason, path=path)
        return rec

    def set_incident_max(self, incident_max: int) -> None:
        """Resize the incident index live (SIGHUP path); existing
        records are kept newest-last up to the new bound."""
        with self._lock:
            self.incident_max = max(1, int(incident_max))
            self._incidents = deque(
                self._incidents, maxlen=self.incident_max
            )

    def suppress_incident(self) -> None:
        """A capture was skipped by the single-flight gate (concurrent
        trigger while a bundle write was in progress)."""
        with self._lock:
            self.incidents_suppressed += 1

    def incidents(self) -> list[dict]:
        """Newest first (the /v1/incidents index)."""
        with self._lock:
            return list(reversed(self._incidents))

    def incident(self, incident_id: str) -> Optional[dict]:
        with self._lock:
            for rec in self._incidents:
                if rec["id"] == incident_id:
                    return dict(rec)
        return None

    # -- stats / lifecycle ---------------------------------------------

    def stats(self) -> dict:
        """Flat provider gauges (``nomad.blackbox.*`` rides the metrics
        registry via the wiring layer's register_provider)."""
        with self._lock:
            return {
                "journal_entries": float(len(self._ring)),
                "journal_recorded": float(self.recorded),
                "journal_evicted": float(
                    max(0, self.recorded - len(self._ring))
                ),
                "triggers_fired": float(self.triggers.fired),
                "triggers_deduped": float(self.triggers.deduped),
                "triggers_rate_limited": float(
                    self.triggers.rate_limited
                ),
                "incidents_captured": float(self.incidents_captured),
                "incidents_suppressed": float(self.incidents_suppressed),
                "incidents_stored": float(len(self._incidents)),
            }

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._seq = 0
            self._kind_counts.clear()
            self.recorded = 0
            self._incidents.clear()
            self.incidents_captured = 0
            self.incidents_suppressed = 0
            self.triggers = TriggerEngine(
                self.triggers.rules,
                self.triggers.dedup_window_s,
                self.triggers.max_per_hour,
            )


# -- causal timeline reconstruction ---------------------------------------

TIMELINE_KINDS = ("eval", "alloc", "node", "job", "deployment", "plan")


def _tokens_of(row: dict) -> set[str]:
    """Every object token one journal row mentions: its key plus the
    extracted ``rel`` cross-links (``kind:id`` strings the wiring
    attaches when it journals a broker event)."""
    toks: set[str] = set()
    key = row.get("key") or ""
    if ":" in key:
        toks.add(key)
    det = row.get("detail") or {}
    for tok in det.get("rel") or ():
        toks.add(tok)
    return toks


def build_timeline(
    kind: str,
    obj_id: str,
    rows: list[dict],
    hops: int = 2,
    limit: int = 500,
) -> dict:
    """Merge journal rows into one causal timeline for ``kind:obj_id``.

    Pure function over plain dicts: seed with the object's token,
    collect every row that mentions it, then expand ``hops`` times
    through the rows' cross-object links — one hop reaches an eval's
    plan and allocs, two reach the allocs' nodes — so the returned view
    is the ``eval -> plan -> alloc -> node`` chain the postmortem
    needs. Bounded: expansion stops at ``limit`` rows and the frontier
    only grows through tokens of :data:`TIMELINE_KINDS` shapes."""
    seed = f"{kind}:{obj_id}"
    wanted: set[str] = {seed}
    matched: dict[int, dict] = {}
    for _ in range(max(1, hops) + 1):
        frontier: set[str] = set()
        for row in rows:
            rid = row.get("seq", id(row))
            if rid in matched:
                continue
            toks = _tokens_of(row)
            if toks & wanted or obj_id and obj_id in (row.get("key") or ""):
                matched[rid] = row
                frontier |= toks
                if len(matched) >= limit:
                    break
        new = frontier - wanted
        if not new or len(matched) >= limit:
            break
        wanted |= new
    ordered = sorted(
        matched.values(), key=lambda r: (r.get("ts", 0), r.get("seq", 0))
    )
    return {
        "kind": kind,
        "id": obj_id,
        "related": sorted(wanted),
        "rows": ordered,
        "truncated": len(matched) >= limit,
    }


# -- process-global recorder ----------------------------------------------

_global = FlightRecorder()


def recorder() -> FlightRecorder:
    return _global


def record(kind: str, key: str = "", **detail) -> None:
    """Module-level journal write — what the hook sites call (reads the
    global at call time so _install retargets them all)."""
    _global.record(kind, key, **detail)


def _install(rec: FlightRecorder) -> FlightRecorder:
    """Swap the process-global recorder (test isolation hook, mirroring
    clusterobs._install / metrics._install_registry)."""
    global _global
    old = _global
    _global = rec
    return old
