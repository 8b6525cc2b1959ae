"""Gossip membership: SWIM-style failure detection + state merge.

Port of ``nomad_tpu/server/membership.py``. Reference: the Go tree vendors hashicorp/serf + memberlist and wires them
in nomad/server.go:394 (setupSerf) / nomad/serf.go (member-join and
member-failed events feed leader reconciliation, nomad/leader.go:1121
reconcileMember → addRaftPeer/removeRaftPeer).

This is a from-scratch SWIM-lite over the RPC fabric:
  * every `probe_interval_s` each member pings one random peer; the ping
    piggybacks the full member list both ways (anti-entropy merge — small
    control planes don't need memberlist's delta broadcasts);
  * a failed direct probe triggers indirect probes through up to `k`
    other members (SWIM's core trick: distinguish "target died" from
    "my link to target is bad");
  * still unreachable ⇒ suspect; suspicion timeout ⇒ failed, event fired;
  * incarnation numbers let a live member refute stale failure rumors —
    a member seeing itself reported failed bumps its incarnation.

Merge rule: higher incarnation wins; at equal incarnation, alive < suspect
< failed (worse status wins, so rumors propagate).
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..rpc import ConnPool

logger = logging.getLogger("nomad_tpu_torch.membership")

ALIVE = "alive"
SUSPECT = "suspect"
FAILED = "failed"
LEFT = "left"

_STATUS_RANK = {ALIVE: 0, SUSPECT: 1, FAILED: 2, LEFT: 3}


@dataclass
class Member:
    id: str
    addr: tuple  # (host, port) of the member's RPC fabric
    status: str = ALIVE
    incarnation: int = 0
    tags: dict = field(default_factory=dict)  # role/region/etc.

    def to_wire(self) -> dict:
        return {
            "id": self.id,
            "addr": list(self.addr),
            "status": self.status,
            "incarnation": self.incarnation,
            "tags": dict(self.tags),
        }

    @staticmethod
    def from_wire(d: dict) -> "Member":
        return Member(
            id=d["id"],
            addr=tuple(d["addr"]),
            status=d["status"],
            incarnation=d["incarnation"],
            tags=dict(d.get("tags", {})),
        )


class SerfEndpoint:
    """RPC surface registered as `Serf` on the fabric."""

    def __init__(self, mgr: "Membership") -> None:
        self._mgr = mgr

    def ping(self, args):
        self._mgr._merge([Member.from_wire(m) for m in args.get("members", [])])
        return {"members": self._mgr.wire_members()}

    def join(self, args):
        self._mgr._merge([Member.from_wire(m) for m in args.get("members", [])])
        return {"members": self._mgr.wire_members()}

    def indirect_ping(self, args):
        """Probe `target` on behalf of a peer whose direct probe failed."""
        target = tuple(args["target"])
        try:
            self._mgr.pool.call(
                target,
                "Serf.ping",
                {"members": self._mgr.wire_members()},
                timeout_s=self._mgr.probe_timeout_s,
            )
            return {"ok": True}
        except Exception:
            return {"ok": False}

    def leave(self, args):
        return self._mgr._on_leave_rumor(args["id"], args["incarnation"])


class Membership:
    def __init__(
        self,
        node_id: str,
        addr: tuple[str, int],
        pool: Optional[ConnPool] = None,
        tags: Optional[dict] = None,
        probe_interval_s: float = 0.5,
        probe_timeout_s: float = 1.0,
        suspicion_timeout_s: float = 3.0,
        indirect_k: int = 3,
        on_event: Optional[Callable[[str, Member], None]] = None,
    ) -> None:
        self.node_id = node_id
        self.pool = pool or ConnPool()
        self.probe_interval_s = probe_interval_s
        self.probe_timeout_s = probe_timeout_s
        self.suspicion_timeout_s = suspicion_timeout_s
        self.indirect_k = indirect_k
        # on_event(kind, member) with kind in
        # member-join / member-failed / member-leave / member-alive
        self.on_event = on_event
        self._lock = threading.Lock()
        self.local = Member(node_id, addr, ALIVE, 0, dict(tags or {}))
        self._members: dict[str, Member] = {node_id: self.local}
        self._suspect_since: dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.endpoint = SerfEndpoint(self)

    # -- views ---------------------------------------------------------

    def members(self) -> list[Member]:
        with self._lock:
            return [
                Member(m.id, m.addr, m.status, m.incarnation, dict(m.tags))
                for m in self._members.values()
            ]

    def alive_members(self) -> list[Member]:
        return [m for m in self.members() if m.status == ALIVE]

    def wire_members(self) -> list[dict]:
        with self._lock:
            return [m.to_wire() for m in self._members.values()]

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._probe_loop, name=f"serf-{self.node_id}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)

    def join(self, seeds: list[tuple[str, int]]) -> int:
        """Contact seeds, merge their views. Returns contacted count."""
        n = 0
        for addr in seeds:
            if tuple(addr) == self.local.addr:
                continue
            try:
                resp = self.pool.call(
                    tuple(addr),
                    "Serf.join",
                    {"members": self.wire_members()},
                    timeout_s=self.probe_timeout_s,
                )
                self._merge([Member.from_wire(m) for m in resp["members"]])
                n += 1
            except Exception:
                logger.debug("join seed %s unreachable", addr)
        return n

    def leave(self) -> None:
        """Graceful departure: tell everyone before going away."""
        with self._lock:
            self.local.incarnation += 1
            self.local.status = LEFT
            peers = [
                m for m in self._members.values()
                if m.id != self.node_id and m.status == ALIVE
            ]
        for m in peers:
            try:
                self.pool.call(
                    m.addr,
                    "Serf.leave",
                    {"id": self.node_id, "incarnation": self.local.incarnation},
                    timeout_s=self.probe_timeout_s,
                )
            except Exception:
                pass
        self.stop()

    # -- probe loop ----------------------------------------------------

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_interval_s):
            target = self._pick_probe_target()
            if target is not None:
                self._probe(target)
            self._expire_suspects()

    def _pick_probe_target(self) -> Optional[Member]:
        with self._lock:
            candidates = [
                m
                for m in self._members.values()
                if m.id != self.node_id and m.status in (ALIVE, SUSPECT)
            ]
        return random.choice(candidates) if candidates else None

    def _probe(self, target: Member) -> None:
        try:
            resp = self.pool.call(
                target.addr,
                "Serf.ping",
                {"members": self.wire_members()},
                timeout_s=self.probe_timeout_s,
            )
            self._merge([Member.from_wire(m) for m in resp["members"]])
            self._mark_alive(target.id)
            return
        except Exception:
            pass
        # Direct probe failed: ask up to k others to try (SWIM indirect).
        with self._lock:
            helpers = [
                m
                for m in self._members.values()
                if m.id not in (self.node_id, target.id) and m.status == ALIVE
            ]
        for helper in random.sample(helpers, min(self.indirect_k, len(helpers))):
            try:
                resp = self.pool.call(
                    helper.addr,
                    "Serf.indirect_ping",
                    {"target": list(target.addr)},
                    timeout_s=self.probe_timeout_s * 2,
                )
                if resp.get("ok"):
                    self._mark_alive(target.id)
                    return
            except Exception:
                continue
        self._mark_suspect(target.id)

    def _expire_suspects(self) -> None:
        now = time.monotonic()
        newly_failed: list[Member] = []
        with self._lock:
            for mid, since in list(self._suspect_since.items()):
                if now - since >= self.suspicion_timeout_s:
                    m = self._members.get(mid)
                    del self._suspect_since[mid]
                    if m is not None and m.status == SUSPECT:
                        m.status = FAILED
                        newly_failed.append(m)
        for m in newly_failed:
            logger.info("member %s failed", m.id)
            self._fire("member-failed", m)

    # -- state transitions ---------------------------------------------

    def _mark_alive(self, member_id: str) -> None:
        with self._lock:
            m = self._members.get(member_id)
            if m is None or m.status == ALIVE:
                return
            m.status = ALIVE
            self._suspect_since.pop(member_id, None)
        self._fire("member-alive", m)

    def _mark_suspect(self, member_id: str) -> None:
        with self._lock:
            m = self._members.get(member_id)
            if m is None or m.status != ALIVE:
                return
            m.status = SUSPECT
            self._suspect_since[member_id] = time.monotonic()
        logger.debug("member %s suspected", member_id)

    def _on_leave_rumor(self, member_id: str, incarnation: int) -> bool:
        """Returns whether the rumor was ACCEPTED — a caller counting
        acknowledgements (force-leave) must not mistake a dropped
        lower-incarnation rumor for one."""
        with self._lock:
            m = self._members.get(member_id)
            if m is None or incarnation < m.incarnation:
                return False
            m.incarnation = incarnation
            m.status = LEFT
            self._suspect_since.pop(member_id, None)
        self._fire("member-leave", m)
        return True

    def _merge(self, remote: list[Member]) -> None:
        # (kind, member) transitions to fire after releasing the lock —
        # failures learned by RUMOR must fire events too, not only
        # directly-detected ones (the leader reconciles on them).
        fired: list[tuple[str, Member]] = []
        refute = False
        with self._lock:
            for rm in remote:
                if rm.id == self.node_id:
                    # Someone thinks we're suspect/failed: refute by
                    # bumping our incarnation past the rumor's.
                    if rm.status != ALIVE and rm.incarnation >= self.local.incarnation:
                        self.local.incarnation = rm.incarnation + 1
                        refute = True
                    continue
                cur = self._members.get(rm.id)
                if cur is None:
                    self._members[rm.id] = rm
                    if rm.status == ALIVE:
                        fired.append(("member-join", rm))
                    elif rm.status == FAILED:
                        fired.append(("member-failed", rm))
                    continue
                if rm.incarnation > cur.incarnation or (
                    rm.incarnation == cur.incarnation
                    and _STATUS_RANK[rm.status] > _STATUS_RANK[cur.status]
                ):
                    was = cur.status
                    cur.status = rm.status
                    cur.incarnation = rm.incarnation
                    cur.tags = dict(rm.tags)
                    cur.addr = rm.addr
                    if rm.status == ALIVE:
                        self._suspect_since.pop(rm.id, None)
                    if was != rm.status:
                        if rm.status == ALIVE:
                            fired.append(("member-join", cur))
                        elif rm.status == FAILED:
                            fired.append(("member-failed", cur))
                        elif rm.status == LEFT:
                            fired.append(("member-leave", cur))
        for kind, m in fired:
            self._fire(kind, m)
        if refute:
            logger.info("%s: refuted failure rumor", self.node_id)

    def _fire(self, kind: str, member: Member) -> None:
        if self.on_event is not None:
            try:
                self.on_event(kind, member)
            except Exception:
                logger.exception("membership event handler failed")
