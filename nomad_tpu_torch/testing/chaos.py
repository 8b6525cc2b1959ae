"""Chaos scenario harness: scripted kill/partition/heal clusters.

Port of ``nomad_tpu/testing/chaos.py``. The FaultPlane core lives in the
production-side leaf ``faultplane.py`` (hook sites import only that);
this module is the TEST surface — it re-exports the whole plane API —
plus :class:`ChaosCluster`, the in-process multi-server cluster that
scenarios kill, restart, partition, and heal, with the standard
invariants every scenario asserts: no acked write lost, no duplicate
alloc minted, convergence within a bound.

``ChaosCluster`` hands its keyword arguments to every ClusterServer it
boots: a test asks for the CPU with
``scheduler_config=SchedulerConfig(device="cpu")``.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Iterable, Optional

from ..faultplane import (  # noqa: F401  (re-exported plane API)
    DeviceFault,
    DropResponse,
    FaultPlane,
    InjectedDiskError,
    InjectedRPCError,
    active,
    env_knobs_active,
    install,
    uninstall,
)


def __getattr__(name):
    # `chaos.plane` must always reflect the LIVE slot in faultplane
    # (install/uninstall rebind it there); a by-value re-export would
    # go stale after the first install.
    if name == "plane":
        from .. import faultplane

        return faultplane.plane
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# ---------------------------------------------------------------------------
# Scenario harness: a live in-process cluster scripted kills/partitions run
# against, with the standard invariants.
# ---------------------------------------------------------------------------


class ChaosCluster:
    """An in-process raft cluster with durable per-node data dirs that
    scenarios can kill, restart, partition, and heal.

    Every server's ConnPool and raft store carry the node's label so
    the installed FaultPlane can target them; ``install_plane=True``
    (default) installs a fresh seeded plane for the cluster's lifetime
    and uninstalls it on shutdown.
    """

    def __init__(self, n: int, data_root: str, seed: int = 0,
                 install_plane: bool = True, **server_kw) -> None:
        import socket

        self.data_root = data_root
        self.seed = seed
        self.server_kw = dict(server_kw)
        self.plane: Optional[FaultPlane] = None
        self._installed = False
        if install_plane:
            self.plane = install(FaultPlane(seed=seed))
            self._installed = True
        socks = [socket.create_server(("127.0.0.1", 0)) for _ in range(n)]
        ports = [s.getsockname()[1] for s in socks]
        for s in socks:
            s.close()
        self.ids = [f"s{i}" for i in range(n)]
        self.addrs = {
            nid: ("127.0.0.1", ports[i]) for i, nid in enumerate(self.ids)
        }
        self.servers: dict[str, object] = {}
        # acked-write journal for the no-acked-write-lost invariant:
        # scenarios record ids here only after the RPC returned success
        self.acked_jobs: set[str] = set()
        # Election accounting that survives kills: a killed server's
        # in-memory raft counter dies with it, so harvest it at kill
        # time and add the live counters on read (total_elections).
        self._elections_harvested = 0

    # -- lifecycle -----------------------------------------------------

    def _boot_one(self, nid: str):
        from ..server.cluster import ClusterServer

        kw = dict(self.server_kw)
        cs = ClusterServer(
            nid,
            peers={p: a for p, a in self.addrs.items() if p != nid},
            port=self.addrs[nid][1],
            num_workers=kw.pop("num_workers", 1),
            data_dir=os.path.join(self.data_root, nid),
            **kw,
        )
        # ClusterServer.__init__ already labels its pool/rpc/raft_store
        # with the node id for the plane; the harness only needs to
        # teach the plane which fabric addr belongs to which label.
        if self.plane is not None:
            self.plane.register_addr(nid, cs.rpc.addr)
        cs.start()
        self.servers[nid] = cs
        return cs

    def start(self) -> "ChaosCluster":
        for nid in self.ids:
            self._boot_one(nid)
        return self

    def shutdown(self) -> None:
        for cs in list(self.servers.values()):
            try:
                cs.shutdown()
            except Exception:
                pass
        self.servers.clear()
        if self._installed:
            uninstall()

    # -- scripted faults -----------------------------------------------

    def kill(self, nid: str) -> None:
        """Hard-stop one server (threads die with the sockets; the data
        dir survives for restart)."""
        cs = self.servers.pop(nid, None)
        if cs is not None:
            self._elections_harvested += cs.raft.leadership_transitions
            cs.shutdown()

    def restart(self, nid: str):
        """Boot a fresh incarnation of a killed server from its disk."""
        assert nid not in self.servers, f"{nid} still running"
        return self._boot_one(nid)

    def kill_when(self, nid: str, cond: Callable[[object], bool],
                  timeout_s: float = 30.0) -> bool:
        """Kill `nid` the moment cond(server) first holds — the scripted
        way to land a crash inside a specific window (e.g. mid-replay:
        ``cond=lambda cs: cs.raft.last_applied >= k``). Condition-
        triggered, not timing-triggered, so it reproduces across boxes."""
        cs = self.servers.get(nid)
        if cs is None:
            return False
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if cond(cs):
                self.kill(nid)
                return True
            time.sleep(0.002)
        return False

    def partition(self, group_a: Iterable[str], group_b: Iterable[str]) -> None:
        assert self.plane is not None, "cluster booted without a plane"
        self.plane.partition(group_a, group_b)

    def heal(self, kind: Optional[str] = None) -> None:
        """Drop all fault rules, or only one kind (e.g. 'rpc.drop' to
        end a partition while keeping disk/device faults live)."""
        if self.plane is not None:
            self.plane.heal(kind)

    # -- production-ops scenarios --------------------------------------

    def rotate_secret_on(self, nid: str, new_secret: str,
                         window_s=None) -> bool:
        """Rotate ONE server's keyring in place — the per-agent step of
        a staggered rpc_secret rollout (what `Agent.reload` does on
        SIGHUP; rpc/keyring.py dual-accept window)."""
        cs = self.servers[nid]
        return cs.keyring.rotate(new_secret, window_s=window_s)

    def rotate_secret(self, new_secret: str, window_s=None,
                      stagger_s: float = 0.0) -> int:
        """Rotate every live server, optionally pausing between agents
        (a real rollout is never simultaneous — the dual-accept window
        plus the pool's previous-secret dial fallback is what keeps the
        mixed cluster flowing). Future restarts boot with the new
        secret. Returns how many keyrings actually rotated."""
        rotated = 0
        for nid in sorted(self.servers):
            if self.rotate_secret_on(nid, new_secret, window_s=window_s):
                rotated += 1
            if stagger_s > 0:
                time.sleep(stagger_s)
        self.server_kw["rpc_secret"] = new_secret
        return rotated

    def total_elections(self) -> int:
        """Elections won across the cluster's whole history, dead
        incarnations included — the rolling-upgrade churn bound."""
        return self._elections_harvested + sum(
            cs.raft.leadership_transitions for cs in self.servers.values()
        )

    def wait_caught_up(self, nid: str, timeout_s: float = 45.0) -> bool:
        """The restarted-server barrier of a rolling upgrade: wait until
        `nid` has applied everything the CURRENT leader had committed
        when we started waiting — i.e. its replay finished AND it is
        accepting AppendEntries from the live leader again (so it
        counts toward quorum for the next kill)."""
        deadline = time.monotonic() + timeout_s
        target = None
        while time.monotonic() < deadline:
            cs = self.servers.get(nid)
            if cs is None:
                return False
            lead = self.leader()
            if lead is not None and target is None:
                target = lead.raft.commit_index
            if target is not None and cs.raft.last_applied >= target:
                return True
            time.sleep(0.02)
        return False

    def rolling_restart(
        self,
        order=None,
        settle_timeout_s: float = 60.0,
        pause_s: float = 0.0,  # dwell after each step (traffic flows
                               # against the n-1 quorum and then the
                               # freshly-rejoined server)
        pre_kill=None,   # optional hook(nid) before each kill
        post_step=None,  # optional hook(nid) after each re-join settles
    ) -> dict:
        """Restart every server one at a time — the rolling-upgrade
        scenario. Between steps the roll WAITS for a stable quorum and
        for the restarted server's replay barrier, exactly like an
        operator following an upgrade runbook.
        Returns evidence: servers rolled, elections across the roll,
        and per-step timings. Raises AssertionError if any step never
        re-converged — a roll must not proceed on a degraded quorum."""
        elections_before = self.total_elections()
        steps = []
        for nid in (list(order) if order else list(self.ids)):
            t0 = time.monotonic()
            if pre_kill is not None:
                pre_kill(nid)
            if pause_s > 0:
                time.sleep(pause_s)
            self.kill(nid)
            # survivors must hold (or re-establish) a working quorum
            # before the node comes back
            lead = self.wait_for_stable_leader(settle_timeout_s)
            assert lead is not None, (
                f"rolling restart: no stable leader after killing {nid}"
            )
            self.restart(nid)
            assert self.wait_caught_up(nid, settle_timeout_s), (
                f"rolling restart: {nid} never caught up after restart"
            )
            if post_step is not None:
                post_step(nid)
            if pause_s > 0:
                time.sleep(pause_s)
            steps.append(
                {"node": nid, "seconds": round(time.monotonic() - t0, 2)}
            )
        return {
            "restarted": len(steps),
            "elections": self.total_elections() - elections_before,
            "steps": steps,
        }

    # -- observation ---------------------------------------------------

    def leader(self):
        for cs in self.servers.values():
            if cs.is_leader():
                return cs
        return None

    def wait_for_stable_leader(self, timeout_s: float = 45.0,
                               stable_for_s: float = 0.0):
        """Wait for exactly one live leader whose replay barrier has
        applied (its FSM is caught up with its own log) and — when
        stable_for_s > 0 — that keeps the lease that long. This is the
        recovery-time 'wait for a stable leader' primitive: callers
        retry through churn instead of failing on the first
        NotLeaderError."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            leaders = [c for c in self.servers.values() if c.is_leader()]
            if len(leaders) == 1:
                lead = leaders[0]
                if lead.raft.wait_for_replay(
                    timeout_s=min(5.0, max(0.1, deadline - time.monotonic()))
                ):
                    if stable_for_s <= 0:
                        return lead
                    t0 = time.monotonic()
                    while time.monotonic() - t0 < stable_for_s:
                        if not lead.is_leader():
                            break
                        time.sleep(0.02)
                    else:
                        return lead
            time.sleep(0.02)
        return None

    def converged(self, timeout_s: float = 45.0) -> bool:
        """Every live server applied the same log prefix (last_applied
        equal across the cluster and no committed entry unapplied)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            lead = self.leader()
            if lead is not None:
                applied = [
                    cs.raft.last_applied for cs in self.servers.values()
                ]
                if (
                    len(set(applied)) == 1
                    and lead.raft.last_applied >= lead.raft.commit_index
                    and lead.raft.commit_index > 0
                ):
                    return True
            time.sleep(0.05)
        return False

    # -- invariants ----------------------------------------------------

    def check_invariants(self) -> None:
        """Assert the scenario-independent safety properties on every
        live server: no acked write lost, no duplicate alloc minted."""
        for nid, cs in self.servers.items():
            st = cs.server.state
            jobs = {
                j.id for j in st.jobs() if not j.stop
            }
            missing = self.acked_jobs - jobs
            assert not missing, (
                f"acked writes lost on {nid}: jobs {sorted(missing)}"
            )
            assert_no_duplicate_allocs(st, label=nid, cluster_server=cs)


def duplicate_alloc_forensics(state, key, id_a, id_b,
                              cluster_server=None) -> dict:
    """Evidence bundle for a duplicate-alloc invariant failure: the two
    allocs' store rows, their minting evals' PLAN-APPLY SNAPSHOT INDEX vs the
    server's raft commit/applied indexes, and the raft log entries that
    carry each alloc id — everything the stale-snapshot-re-placement
    theory needs to be confirmed or killed on evidence. Failure-path
    only; the raft-log scan is a raw substring search over the encoded
    entries (alloc ids are uuid strings, the codec stores them verbatim).
    """
    out: dict = {"key": list(key)}
    for aid in (id_a, id_b):
        a = state.alloc_by_id(aid)
        row: dict = {"id": aid}
        if a is not None:
            row.update(
                create_index=a.create_index,
                modify_index=a.modify_index,
                desired_status=a.desired_status,
                client_status=a.client_status,
                eval_id=a.eval_id,
            )
            ev = state.eval_by_id(a.eval_id) if a.eval_id else None
            if ev is not None:
                row["eval"] = {
                    "snapshot_index": ev.snapshot_index,
                    "status": ev.status,
                    "triggered_by": ev.triggered_by,
                    "create_index": ev.create_index,
                    "modify_index": ev.modify_index,
                }
        out.setdefault("allocs", []).append(row)
    raft = getattr(cluster_server, "raft", None)
    if raft is not None:
        out["raft"] = {
            "commit_index": getattr(raft, "commit_index", None),
            "last_applied": getattr(raft, "last_applied", None),
            # entries at or below this index are compacted into the
            # snapshot — a mint below it is unscannable (noted, not
            # silently absent)
            "snapshot_last_index": getattr(
                raft, "_snap_last_index", None
            ),
        }
        try:
            log = list(getattr(raft, "_log", ()) or ())
        except Exception:
            log = []
        mints: dict[str, list] = {id_a: [], id_b: []}
        for e in log:
            raw = getattr(e, "payload", b"")
            if not isinstance(raw, (bytes, bytearray)):
                continue
            for aid in (id_a, id_b):
                if aid.encode() in raw:
                    mints[aid].append(
                        {"index": e.index, "type": e.msg_type}
                    )
        out["mint_entries"] = mints
    return out


def assert_no_duplicate_allocs(state, label: str = "",
                               cluster_server=None) -> None:
    """No two live allocations may share (namespace, job, alloc name) —
    a duplicate means one placement request was minted twice (e.g. an
    eval restored from a stale mid-replay snapshot re-placed a job).
    On failure the message carries the store/raft forensics
    (duplicate_alloc_forensics) so a flaky reproduction is evidence,
    not just a flag."""
    import json as _json

    seen: dict[tuple, str] = {}
    for a in state.allocs():
        if a.terminal_status():
            continue
        key = (a.namespace, a.job_id, a.name)
        if key in seen:
            detail = duplicate_alloc_forensics(
                state, key, seen[key], a.id, cluster_server=cluster_server
            )
            raise AssertionError(
                f"duplicate alloc minted{' on ' + label if label else ''}: "
                f"{key} -> {seen[key]} and {a.id}; forensics: "
                + _json.dumps(detail, default=str, sort_keys=True)
            )
        seen[key] = a.id
