"""Multi-node Raft replication over the RPC fabric.

Port of ``nomad_tpu/server/raft_replication.py``. Reference: the Go tree
vendors hashicorp/raft and wires it in nomad/server.go:1210 (setupRaft)
with a dedicated stream transport (nomad/raft_rpc.go); the FSM is
nomad/fsm.go. A from-scratch Raft (Ongaro & Ousterhout, "In Search of an
Understandable Consensus Algorithm"): elections with randomized timeouts,
log replication with the AppendEntries consistency check, majority
commit restricted to current-term entries (§5.4.2), and InstallSnapshot
for lagging followers.

Raft RPCs ride the same framed fabric as everything else (`Raft.*`
endpoint methods) instead of a dedicated byte-stream layer. An entry's
packed payload crosses as one msgpack bin inside the AppendEntries frame
(rpc/wire.py).

The FSM contract is unchanged from the single-node path (raft.py): apply()
is only ever invoked with committed entries, in order, exactly once per
index on a given store. `RaftNode.apply()` blocks until commit, then
returns the entry's index — the same contract `Server.raft_apply` has
with InmemLog, so the whole control plane is replication-agnostic.
"""

from __future__ import annotations

import logging
import queue
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from .. import codec, metrics
from ..gctune import paused_gc
from ..rpc import ConnPool
from .raft import FSM

logger = logging.getLogger("nomad_tpu_torch.raft")

FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"


class NotLeaderError(Exception):
    """Raised BEFORE a write reached the log (or after it provably did
    not commit): safe for callers to retry against the new leader."""

    def __init__(self, leader_addr: Optional[tuple[str, int]]):
        self.leader_addr = leader_addr
        super().__init__(f"not the leader (leader hint: {leader_addr})")


class LeadershipLostError(NotLeaderError):
    """Deposed AFTER the entry was appended and replicating: the write's
    outcome is UNKNOWN (the new leader may still commit it). Subclasses
    NotLeaderError so churn backoff paths treat it the same, but the
    RPC forwarder must NOT auto-retry it — a retry could double-apply a
    write that did commit."""


@dataclass
class LogEntry:
    """payload is the ENCODED command (codec.pack), packed once on the leader at
    append time. Storing bytes (not live objects) means (a) the FSM decodes
    a fresh object graph per apply, so the state store can take ownership of
    applied structs without aliasing the log, (b) replication sends the same
    bytes to every follower instead of re-packing per peer per send, and
    (c) the durable store writes them verbatim."""

    index: int
    term: int
    msg_type: str
    payload: bytes


class RaftEndpoint:
    """RPC surface registered as `Raft` on the fabric."""

    def __init__(self, node: "RaftNode") -> None:
        self._node = node

    def request_vote(self, args):
        return self._node._handle_request_vote(args)

    def append_entries(self, args):
        return self._node._handle_append_entries(args)

    def install_snapshot(self, args):
        return self._node._handle_install_snapshot(args)


class RaftNode:
    """One Raft participant. Owns the log and drives the FSM.

    Timers (defaults sized for in-process clusters; production configs
    scale them up): heartbeat every `heartbeat_ms`, election timeout
    randomized in [election_ms, 2*election_ms].
    """

    def __init__(
        self,
        node_id: str,
        fsm: FSM,
        pool: ConnPool,
        advertise: tuple[str, int],
        peers: dict[str, tuple[str, int]],
        heartbeat_ms: int = 60,
        election_ms: int = 250,
        bootstrap_expect: int = 1,
        snapshot_threshold: int = 8192,
        snapshot_fn: Optional[Callable[[], bytes]] = None,
        restore_fn: Optional[Callable[[bytes], None]] = None,
        on_leader_change: Optional[Callable[[bool], None]] = None,
        store=None,
    ) -> None:
        self.node_id = node_id
        self.fsm = fsm
        self.pool = pool
        self.advertise = advertise
        # peers maps node_id -> rpc addr for every OTHER member
        self.peers = dict(peers)
        # Elections only start once the known cluster reaches this size
        # (reference bootstrap_expect): a blank server joining an existing
        # cluster must never elect itself leader of a cluster of one.
        # 0 ⇒ never self-bootstrap (wait to be adopted via raft_add_peer).
        self.bootstrap_expect = bootstrap_expect
        self.heartbeat_s = heartbeat_ms / 1000.0
        self.election_s = election_ms / 1000.0
        self.snapshot_threshold = snapshot_threshold
        self.snapshot_fn = snapshot_fn
        self.restore_fn = restore_fn
        self.on_leader_change = on_leader_change

        # Warm the native codec while no lock exists yet: the first
        # pack() otherwise happens under _lock (_become_leader_locked
        # packs the barrier entry) and a cold fastpack build would
        # stall the node mid-election.
        codec.warm_native()
        self._lock = threading.RLock()
        self._commit_cv = threading.Condition(self._lock)
        # Persistent state. With a `store` (raft_store.RaftLogStore,
        # SQLite — the reference's raft-boltdb analog) the term/vote/log/
        # snapshot survive restarts per §5.1; without one (in-process
        # test clusters) everything is memory-only.
        self.store = store
        self.current_term = 0
        self.voted_for: Optional[str] = None
        self._log: list[LogEntry] = []  # log[i] has index snapshot_index+i+1
        self._snap_last_index = 0
        self._snap_last_term = 0
        self._snap_bytes: Optional[bytes] = None
        if store is not None:
            self.current_term, self.voted_for = store.get_state()
            snap = store.load_snapshot()
            if snap is not None:
                self._snap_bytes, self._snap_last_index, self._snap_last_term = snap
            self._log = store.load_log()
            # Drop any stale prefix a crash may have left behind the
            # persisted snapshot.
            self._log = [e for e in self._log if e.index > self._snap_last_index]
        # Volatile state
        self.state = FOLLOWER
        self.commit_index = 0
        self.last_applied = 0
        if store is not None and self._snap_bytes is not None:
            # Rebuild the FSM from the persisted snapshot; the log tail
            # replays once the next leader re-commits it (no-op barrier).
            if restore_fn is not None:
                restore_fn(self._snap_bytes)
            self.commit_index = self._snap_last_index
            self.last_applied = self._snap_last_index
        self.leader_id: Optional[str] = None
        self._last_heartbeat = time.monotonic()
        self._votes: set[str] = set()
        # How many times THIS node won an election (the process-global
        # nomad.raft.leader_changes counter mixes every in-process node
        # and counts step-downs too; per-node won-election counts let a
        # chaos scenario bound leadership churn exactly: sum of deltas
        # across a cluster == elections that happened).
        self.leadership_transitions = 0
        # Leader volatile state
        self._next_index: dict[str, int] = {}
        self._match_index: dict[str, int] = {}
        self._repl_wake: dict[str, threading.Event] = {}
        # peer id -> monotonic time of its last RPC response to us
        # (leader-side CheckQuorum input, see _handle_request_vote's
        # disruptive-server guard)
        self._peer_contact: dict[str, float] = {}
        # Leader-direct apply stash: index -> (term, original payload).
        # The local FSM applies the submitted object instead of decoding
        # its own encoded entry (decode of a 10^5-alloc plan dwarfed the
        # whole apply); the encoded log remains the replication source of
        # truth and followers still decode, which converges because
        # decode(pack(x)) == x (tests/test_torch_raft.py). Entries are
        # keyed by (index, term) so a deposed leader's truncated indexes
        # can never resolve to a stale payload; the stash clears on
        # step-down.
        self._direct_payloads: dict[int, tuple[int, object]] = {}

        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        # Leadership transitions are delivered IN ORDER on one dispatcher
        # thread — firing them on ad-hoc threads could run a revoke before
        # the establish it follows, leaving leader subsystems on a follower.
        self._leader_events: "queue.Queue[Optional[bool]]" = queue.Queue()
        # Bumped by InstallSnapshot so an in-flight apply batch of stale
        # entries is discarded instead of landing on top of restored state;
        # the mutex serializes individual FSM applies against the restore
        # itself (the epoch check alone can't cover an apply in progress).
        self._restore_epoch = 0
        self._fsm_mutex = threading.Lock()
        # Index of the no-op barrier this node appended when it last
        # became leader; wait_for_replay() blocks on it.
        self._barrier_index = 0
        self.endpoint = RaftEndpoint(self)

    # ------------------------------------------------------------------
    # log helpers (all under lock)

    def _persist_state_locked(self) -> None:
        if self.store is not None:
            self.store.set_state(self.current_term, self.voted_for)

    def _last_log_index(self) -> int:
        return self._log[-1].index if self._log else self._snap_last_index

    def _last_log_term(self) -> int:
        return self._log[-1].term if self._log else self._snap_last_term

    def _entry_at(self, index: int) -> Optional[LogEntry]:
        i = index - self._snap_last_index - 1
        if 0 <= i < len(self._log):
            return self._log[i]
        return None

    def _term_at(self, index: int) -> Optional[int]:
        if index == 0:
            return 0
        if index == self._snap_last_index:
            return self._snap_last_term
        e = self._entry_at(index)
        return e.term if e else None

    # ------------------------------------------------------------------
    # lifecycle

    def start(self) -> None:
        # A deliberate single-node cluster needs no timeout dance: elect
        # immediately (dev mode / tests would otherwise wait 1-2s).
        if not self.peers and self.bootstrap_expect == 1:
            self._start_election()
        t = threading.Thread(target=self._ticker, name=f"raft-tick-{self.node_id}", daemon=True)
        t.start()
        self._threads.append(t)
        t = threading.Thread(target=self._apply_loop, name=f"raft-apply-{self.node_id}", daemon=True)
        t.start()
        self._threads.append(t)
        t = threading.Thread(
            target=self._leader_change_loop,
            name=f"raft-leadership-{self.node_id}",
            daemon=True,
        )
        t.start()
        self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        self._leader_events.put(None)
        with self._commit_cv:
            self._commit_cv.notify_all()
            wakes = list(self._repl_wake.values())
        for ev in wakes:
            ev.set()
        for t in self._threads:
            t.join(timeout=2)

    def _emit_leader_change(self, is_leader: bool) -> None:
        if self.on_leader_change:
            self._leader_events.put(is_leader)

    def _leader_change_loop(self) -> None:
        last: Optional[bool] = None
        while True:
            ev = self._leader_events.get()
            if ev is None:
                return
            if ev == last:
                continue
            last = ev
            try:
                self.on_leader_change(ev)
            except Exception:
                logger.exception("%s: leader-change callback failed", self.node_id)

    # ------------------------------------------------------------------
    # public write path

    def apply(self, msg_type: str, payload, timeout_s: float = 10.0):
        """Append on the leader, replicate, block until committed AND
        applied locally. Returns the entry index."""
        t0 = time.perf_counter()
        index, term = self.apply_submit(msg_type, payload)
        out = self.apply_wait(index, term, timeout_s)
        # same name as InmemLog.apply (raft.py): encode + replicate +
        # commit + local fsm apply, whichever log backs the server
        metrics.observe(
            "nomad.raft.apply_seconds", time.perf_counter() - t0
        )
        return out

    def apply_submit(self, msg_type: str, payload) -> tuple[int, int]:
        """Append on the leader and kick replication WITHOUT waiting for
        the commit. Returns (index, term) for apply_wait. This is what
        lets the plan applier verify plan N+1 while plan N replicates."""
        # Encode OUTSIDE the lock: packing a large plan payload under
        # _lock would stall the replication loops' heartbeats and get the
        # leader deposed. The bytes depend only on the payload.
        with paused_gc():
            raw = codec.pack(payload)
        with self._lock:
            if self.state != LEADER:
                raise NotLeaderError(self.leader_addr())
            index = self._last_log_index() + 1
            term = self.current_term
            entry = LogEntry(index, term, msg_type, raw)
            self._log.append(entry)
            if self.store is not None:
                try:
                    self.store.append([entry])
                except Exception:
                    # A failed durable append must not leave the entry in
                    # the in-memory log: it would replicate and commit an
                    # entry this node forgets on restart.
                    self._log.pop()
                    raise
            self._direct_payloads[index] = (term, payload)
            self._match_index[self.node_id] = index
            for ev in self._repl_wake.values():
                ev.set()
            if not self.peers:
                self._advance_commit_locked()
        return index, term

    def apply_wait(self, index: int, term: int, timeout_s: float = 10.0) -> int:
        """Block until a submitted entry is committed and applied locally."""
        deadline = time.monotonic() + timeout_s
        with self._commit_cv:
            while self.last_applied < index:
                # A leader's log in its own term is append-only, so staying
                # LEADER at `term` guarantees our entry is still at `index`.
                # Any truncation implies a follower interlude (term bump),
                # which this check catches even if we re-won in between.
                if self.state != LEADER or self.current_term != term:
                    # Deposed mid-wait with the entry already appended
                    # and replicating: the new leader may yet commit it,
                    # so the outcome is UNKNOWN — callers must not
                    # auto-retry (LeadershipLostError, not the
                    # retry-safe NotLeaderError).
                    raise LeadershipLostError(self.leader_addr())
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"raft apply timed out at index {index}")
                self._commit_cv.wait(remaining)
            # Applied. Still leader at `term` ⇒ our own-term log is
            # append-only ⇒ the applied entry at `index` is ours: done
            # (this also covers entries already compacted into a
            # snapshot, where the term can no longer be read).
            if self.state == LEADER and self.current_term == term:
                return index
            # Deposed after the apply. The write still succeeded iff the
            # entry at `index` carries our term — applied implies
            # committed, and committed entries never truncate (erroring
            # on a durable write would make retry-hardened callers
            # re-submit it). A different term there means ours was
            # truncated pre-commit: definitely not applied, retry-safe.
            t_at = self._term_at(index)
            if t_at == term:
                return index
            if t_at is None:
                # compacted below the snapshot while deposed: ownership
                # can no longer be verified — outcome unknown
                raise LeadershipLostError(self.leader_addr())
            raise NotLeaderError(self.leader_addr())

    # -- membership changes (single-server-at-a-time, via the log) ------

    def add_peer(self, peer_id: str, addr: tuple[str, int]) -> None:
        """Leader-only: adopt a new member (reference leader.go
        addRaftPeer). Rides the log so every replica converges on the
        same configuration at the same index."""
        if peer_id == self.node_id or peer_id in self.peers:
            return
        self.apply("raft_add_peer", (peer_id, tuple(addr)))

    def remove_peer(self, peer_id: str) -> None:
        """Leader-only (reference removeRaftPeer / autopilot cleanup)."""
        if peer_id not in self.peers:
            return
        self.apply("raft_remove_peer", peer_id)

    def _apply_peer_change(
        self, msg_type: str, payload, epoch: Optional[int] = None
    ) -> None:
        with self._lock:
            if epoch is not None and self._restore_epoch != epoch:
                return
            if msg_type == "raft_add_peer":
                peer_id, addr = payload
                addr = tuple(addr)
                if peer_id == self.node_id or peer_id in self.peers:
                    return
                self.peers[peer_id] = addr
                if self.state == LEADER:
                    self._next_index[peer_id] = self._last_log_index() + 1
                    self._match_index[peer_id] = 0
                    self._repl_wake[peer_id] = threading.Event()
                    t = threading.Thread(
                        target=self._replicate_loop,
                        args=(peer_id,),
                        name=f"raft-repl-{self.node_id}-{peer_id}",
                        daemon=True,
                    )
                    t.start()
                    self._threads.append(t)
            else:
                peer_id = payload
                self.peers.pop(peer_id, None)
                self._next_index.pop(peer_id, None)
                self._match_index.pop(peer_id, None)
                wake = self._repl_wake.pop(peer_id, None)
                if wake is not None:
                    wake.set()  # its replicate loop exits on next check
                if self.state == LEADER:
                    self._advance_commit_locked()

    def leader_addr(self) -> Optional[tuple[str, int]]:
        if self.leader_id is None:
            return None
        if self.leader_id == self.node_id:
            return self.advertise
        return self.peers.get(self.leader_id)

    def is_leader(self) -> bool:
        return self.state == LEADER

    def wait_for_replay(self, timeout_s: float = 30.0) -> bool:
        """Leader-only: block until the local FSM has applied this
        leader's own no-op barrier — i.e. every entry committed before
        (or at) this leadership is reflected in local state. This is the
        reference's establish-leadership barrier (leader.go Barrier):
        without it a fresh leader restores broker state from a
        MID-REPLAY snapshot and can re-run evaluations whose effects are
        still in the unapplied log tail (duplicate allocs). Returns
        False when deposed or timed out — the caller must then skip
        stale-state reads (a revoke is on its way, or state isn't
        trustworthy yet)."""
        deadline = time.monotonic() + timeout_s
        with self._commit_cv:
            while True:
                if self._stop.is_set() or self.state != LEADER:
                    return False
                if self.last_applied >= self._barrier_index:
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                # bounded slice: _commit_cv is notified on applies and
                # step-downs, the slice only guards a missed stop()
                self._commit_cv.wait(min(remaining, 0.25))

    @property
    def last_index(self) -> int:
        with self._lock:
            return self._last_log_index()

    # ------------------------------------------------------------------
    # ticker: election timeout + heartbeats

    def _ticker(self) -> None:
        timeout = self._rand_election_timeout()
        while not self._stop.is_set():
            time.sleep(self.heartbeat_s / 2)
            try:
                with self._lock:
                    state = self.state
                    elapsed = time.monotonic() - self._last_heartbeat
                if state == LEADER:
                    continue  # replication threads heartbeat
                if elapsed >= timeout:
                    with self._lock:
                        quorum_known = (
                            self.bootstrap_expect > 0
                            and len(self.peers) + 1 >= self.bootstrap_expect
                        )
                    if quorum_known:
                        self._start_election()
                    timeout = self._rand_election_timeout()
            except Exception:
                # The ticker is the node's heartbeat-of-last-resort; it
                # must survive anything (a dead ticker = a zombie node
                # that can never call an election again).
                logger.exception("%s: ticker iteration failed", self.node_id)

    def _rand_election_timeout(self) -> float:
        return self.election_s * (1.0 + random.random())

    def _start_election(self) -> None:
        with self._lock:
            self.state = CANDIDATE
            self.current_term += 1
            term = self.current_term
            self.voted_for = self.node_id
            self._persist_state_locked()
            self._votes = {self.node_id}
            self.leader_id = None
            self._last_heartbeat = time.monotonic()
            last_idx = self._last_log_index()
            last_term = self._last_log_term()
            peers = dict(self.peers)  # snapshot: applies mutate in place
        logger.debug("%s: starting election term %d", self.node_id, term)
        if self._won_locked_check():
            return
        for peer_id, addr in peers.items():
            threading.Thread(
                target=self._solicit_vote,
                args=(peer_id, addr, term, last_idx, last_term),
                name=f"raft-vote-{peer_id}",
                daemon=True,
            ).start()

    def _solicit_vote(self, peer_id, addr, term, last_idx, last_term) -> None:
        try:
            resp = self.pool.call(
                addr,
                "Raft.request_vote",
                {
                    "term": term,
                    "candidate_id": self.node_id,
                    "last_log_index": last_idx,
                    "last_log_term": last_term,
                },
                timeout_s=self.election_s,
            )
        except Exception:
            return
        with self._lock:
            if resp["term"] > self.current_term:
                self._become_follower_locked(resp["term"])
                return
            if (
                self.state != CANDIDATE
                or self.current_term != term
                or not resp.get("granted")
            ):
                return
            self._votes.add(peer_id)
        self._won_locked_check()

    def _won_locked_check(self) -> bool:
        with self._lock:
            cluster_n = len(self.peers) + 1
            if self.state == CANDIDATE and len(self._votes) * 2 > cluster_n:
                self._become_leader_locked()
                return True
        return False

    def _become_leader_locked(self) -> None:
        logger.info("%s: leader for term %d", self.node_id, self.current_term)
        self.state = LEADER
        self.leader_id = self.node_id
        self.leadership_transitions += 1
        # Churn observability: every local leadership transition counts
        # (step-downs increment in _become_follower_locked). A climbing
        # rate on `operator top` is the signature of election storms.
        metrics.incr("nomad.raft.leader_changes")
        # Barrier no-op in our own term: commit can only count current-term
        # entries (§5.4.2), so without this a fresh leader would sit on
        # fully-replicated prior-term entries until the next real write.
        barrier = LogEntry(
            self._last_log_index() + 1, self.current_term, "noop",
            codec.pack(None),
        )
        self._log.append(barrier)
        if self.store is not None:
            try:
                self.store.append([barrier])
            except Exception:
                # Cannot lead without a durable barrier: keeping it only
                # in memory while later appends persist would leave a
                # HOLE in the stored log, and load_log's contiguity
                # assumption (log[i] has index snap+i+1) would read
                # shifted entries on restart. Abort this leadership —
                # the cluster re-elects (possibly us, once the disk
                # recovers).
                logger.exception(
                    "%s: barrier persist failed; abandoning leadership",
                    self.node_id,
                )
                self._log.pop()
                self.state = FOLLOWER
                self.leader_id = None
                return
        # Everything at or below this index is this leader's replay
        # debt: wait_for_replay() blocks until the local FSM has applied
        # it, i.e. this replica's state reflects every prior commit.
        self._barrier_index = barrier.index
        last = self._last_log_index()
        self._next_index = {p: last + 1 for p in self.peers}
        self._match_index = {p: 0 for p in self.peers}
        self._match_index[self.node_id] = last
        self._repl_wake = {p: threading.Event() for p in self.peers}
        for peer_id in self.peers:
            t = threading.Thread(
                target=self._replicate_loop,
                args=(peer_id,),
                name=f"raft-repl-{self.node_id}-{peer_id}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)
        if not self.peers:
            self._advance_commit_locked()
        self._emit_leader_change(True)

    def _become_follower_locked(self, term: int) -> None:
        was_leader = self.state == LEADER
        if was_leader:
            metrics.incr("nomad.raft.leader_changes")
        if term > self.current_term:
            self.current_term = term
            self.voted_for = None
            self._persist_state_locked()
        self.state = FOLLOWER
        # A deposed leader's uncommitted tail may be truncated and its
        # indexes rewritten by the new leader — drop the direct-apply
        # stash (the term check would reject them anyway).
        self._direct_payloads.clear()
        # Forget the old leader until an AppendEntries names the new one —
        # a deposed leader keeping itself as the hint would make forwards
        # loop back to itself.
        self.leader_id = None
        self._last_heartbeat = time.monotonic()
        if was_leader:
            self._emit_leader_change(False)
        self._commit_cv.notify_all()

    # ------------------------------------------------------------------
    # leader replication

    def _replicate_loop(self, peer_id: str) -> None:
        """One thread per follower: push entries / heartbeats, retry on
        mismatch by walking next_index back (§5.3)."""
        addr = self.peers[peer_id]
        while not self._stop.is_set():
            with self._lock:
                if self.state != LEADER or peer_id not in self.peers:
                    return
                term = self.current_term
                next_idx = self._next_index[peer_id]
                if next_idx <= self._snap_last_index:
                    self._send_snapshot(peer_id, addr, term)
                    continue
                prev_idx = next_idx - 1
                prev_term = self._term_at(prev_idx)
                if prev_term is None:
                    self._send_snapshot(peer_id, addr, term)
                    continue
                off = next_idx - self._snap_last_index - 1
                entries = self._log[off : off + 512]
                req = {
                    "term": term,
                    "leader_id": self.node_id,
                    "prev_log_index": prev_idx,
                    "prev_log_term": prev_term,
                    "entries": [
                        (e.index, e.term, e.msg_type, e.payload) for e in entries
                    ],
                    "leader_commit": self.commit_index,
                }
                wake = self._repl_wake[peer_id]
                wake.clear()
            try:
                resp = self.pool.call(
                    addr, "Raft.append_entries", req, timeout_s=2.0
                )
            except Exception:
                wake.wait(self.heartbeat_s)
                continue
            with self._lock:
                # any response (success or not) proves the peer is
                # reachable — CheckQuorum input for the vote guard
                self._peer_contact[peer_id] = time.monotonic()
                if self.state != LEADER or self.current_term != term:
                    return
                if resp["term"] > self.current_term:
                    self._become_follower_locked(resp["term"])
                    return
                if resp.get("success"):
                    if entries:
                        self._match_index[peer_id] = entries[-1].index
                        self._next_index[peer_id] = entries[-1].index + 1
                        self._advance_commit_locked()
                    more = self._last_log_index() >= self._next_index[peer_id]
                else:
                    # Conflict: follower tells us how far back to jump.
                    hint = resp.get("conflict_index")
                    self._next_index[peer_id] = max(
                        1, hint if hint else self._next_index[peer_id] - 1
                    )
                    more = True
            if not more:
                wake.wait(self.heartbeat_s)

    def _send_snapshot(self, peer_id: str, addr, term: int) -> None:
        """Called under lock; releases it around the network call."""
        if self._snap_bytes is None and self.snapshot_fn is not None:
            self._take_snapshot_locked()
        snap = (self._snap_bytes, self._snap_last_index, self._snap_last_term)
        # Snapshot carries the member configuration too: a blank follower
        # restored from snapshot must know the full peer set (the add-peer
        # log entries it would have learned it from were compacted away).
        config = {self.node_id: list(self.advertise)}
        config.update({p: list(a) for p, a in self.peers.items()})
        self._lock.release()
        try:
            resp = self.pool.call(
                addr,
                "Raft.install_snapshot",
                {
                    "term": term,
                    "leader_id": self.node_id,
                    "last_included_index": snap[1],
                    "last_included_term": snap[2],
                    "data": snap[0],
                    "config": config,
                },
                timeout_s=10.0,
            )
        except Exception:
            resp = None
            time.sleep(self.heartbeat_s)
        finally:
            self._lock.acquire()
        if resp is None:
            return
        if resp["term"] > self.current_term:
            self._become_follower_locked(resp["term"])
            return
        self._next_index[peer_id] = snap[1] + 1
        self._match_index[peer_id] = snap[1]

    def _advance_commit_locked(self) -> None:
        """Majority-match commit, current-term entries only (§5.4.2)."""
        cluster_n = len(self.peers) + 1
        matches = sorted(
            self._match_index.get(p, 0) for p in list(self.peers) + [self.node_id]
        )
        # Highest index replicated on a strict majority: with matches
        # ascending, that's matches[n - majority] = matches[(n-1)//2]
        # (e.g. n=4 ⇒ 3 replicas needed ⇒ matches[1], NOT matches[2]).
        majority_idx = matches[(cluster_n - 1) // 2]
        # walk down to the highest current-term entry <= majority_idx
        n = majority_idx
        while n > self.commit_index:
            if self._term_at(n) == self.current_term:
                self.commit_index = n
                self._commit_cv.notify_all()
                break
            n -= 1

    # ------------------------------------------------------------------
    # apply loop (leader and followers)

    def _apply_loop(self) -> None:
        while not self._stop.is_set():
            with self._commit_cv:
                while (
                    self.last_applied >= self.commit_index
                    and not self._stop.is_set()
                ):
                    self._commit_cv.wait(0.5)
                if self._stop.is_set():
                    return
                start = self.last_applied + 1
                end = self.commit_index
                epoch = self._restore_epoch
                off = start - self._snap_last_index - 1
                entries = self._log[off : off + (end - start + 1)] if off >= 0 else []
            with paused_gc():
                for e in entries:
                    # A snapshot restore while we were applying makes the
                    # rest of this batch stale — re-applying old entries on
                    # top of newer restored state would corrupt it.
                    direct = self._direct_payloads.pop(e.index, None)
                    if e.msg_type in ("raft_add_peer", "raft_remove_peer"):
                        # Raft-level config change: needs _lock, not the FSM
                        # mutex (taking _lock under _fsm_mutex would deadlock
                        # against InstallSnapshot's _lock → _fsm_mutex order).
                        self._apply_peer_change(
                            e.msg_type, codec.unpack(e.payload), epoch
                        )
                        continue
                    with self._fsm_mutex:
                        if self._restore_epoch != epoch:
                            break
                        try:
                            # Leader-direct: the submitted payload applies
                            # as-is when this entry is provably ours (term
                            # match); anything else decodes fresh — the FSM
                            # (and through it the state store) owns applied
                            # structs outright either way.
                            if direct is not None and direct[0] == e.term:
                                payload = direct[1]
                            else:
                                payload = codec.unpack(e.payload)
                            self.fsm.apply(e.index, e.msg_type, payload)
                        except Exception:
                            logger.exception(
                                "%s: FSM apply failed at %d",
                                self.node_id, e.index,
                            )
            with self._commit_cv:
                if self._restore_epoch == epoch and end > self.last_applied:
                    self.last_applied = end
                    self._commit_cv.notify_all()
                self._maybe_compact_locked()

    def _take_snapshot_locked(self) -> None:
        if self.snapshot_fn is None:
            return
        idx = self.last_applied
        term = self._term_at(idx)
        if term is None:
            return
        self._snap_bytes = self.snapshot_fn()
        self._snap_last_index = idx
        self._snap_last_term = term
        self._log = [e for e in self._log if e.index > idx]
        if self.store is not None:
            # store_snapshot also compacts the persisted log prefix
            self.store.store_snapshot(self._snap_bytes, idx, term)
        logger.info("%s: snapshot at index %d", self.node_id, idx)

    def _maybe_compact_locked(self) -> None:
        if (
            self.snapshot_fn is not None
            and len(self._log) >= self.snapshot_threshold
            and self.last_applied > self._snap_last_index
        ):
            self._take_snapshot_locked()

    # ------------------------------------------------------------------
    # RPC handlers (follower side)

    def _quorum_contact_fresh_locked(self) -> bool:
        """Leader-side CheckQuorum: have we heard RPC responses from a
        majority within the election timeout? (self counts)"""
        if not self.peers:
            return True
        now = time.monotonic()
        live = 1 + sum(
            1
            for p in self.peers
            if now - self._peer_contact.get(p, 0.0) < self.election_s
        )
        return live * 2 > len(self.peers) + 1

    def _handle_request_vote(self, args):
        with self._lock:
            term = args["term"]
            if term < self.current_term:
                return {"term": self.current_term, "granted": False}
            if term > self.current_term:
                # Disruptive-server guard (Ongaro §4.2.3 / hashicorp
                # CheckQuorum): a node that cannot HEAR the cluster (dead
                # listener, healing partition) election-times-out on a
                # loop and solicits votes at ever-climbing terms; without
                # this guard each request deposes the healthy leader and
                # the cluster churns for as long as the node stays deaf.
                # A leader in contact with a quorum, and a follower that
                # heard its leader within the minimum election timeout,
                # both IGNORE the higher term (no step-down, no term
                # bump, no vote). Real failovers are unaffected: once
                # heartbeats actually stop, the guard lapses before any
                # follower's own election timer fires.
                if self.state == LEADER and self._quorum_contact_fresh_locked():
                    return {"term": self.current_term, "granted": False}
                if (
                    self.state != LEADER
                    and self.leader_id is not None
                    and time.monotonic() - self._last_heartbeat < self.election_s
                ):
                    return {"term": self.current_term, "granted": False}
                self._become_follower_locked(term)
            up_to_date = args["last_log_term"] > self._last_log_term() or (
                args["last_log_term"] == self._last_log_term()
                and args["last_log_index"] >= self._last_log_index()
            )
            if up_to_date and self.voted_for in (None, args["candidate_id"]):
                self.voted_for = args["candidate_id"]
                # The vote MUST hit disk before the reply (§5.1): a
                # rebooted node that forgot its vote could vote twice
                # in one term and elect two leaders.
                self._persist_state_locked()
                self._last_heartbeat = time.monotonic()
                return {"term": self.current_term, "granted": True}
            return {"term": self.current_term, "granted": False}

    def _handle_append_entries(self, args):
        with self._lock:
            term = args["term"]
            if term < self.current_term:
                return {"term": self.current_term, "success": False}
            if term > self.current_term or self.state != FOLLOWER:
                self._become_follower_locked(term)
            self.leader_id = args["leader_id"]
            self._last_heartbeat = time.monotonic()

            prev_idx = args["prev_log_index"]
            prev_term = args["prev_log_term"]
            our_term = self._term_at(prev_idx)
            if our_term is None:
                # We don't have prev_idx at all — tell the leader where
                # our log ends so it can jump straight there.
                return {
                    "term": self.current_term,
                    "success": False,
                    "conflict_index": self._last_log_index() + 1,
                }
            if our_term != prev_term:
                # Find the first index of the conflicting term.
                ci = prev_idx
                while ci > self._snap_last_index + 1 and self._term_at(ci - 1) == our_term:
                    ci -= 1
                return {
                    "term": self.current_term,
                    "success": False,
                    "conflict_index": ci,
                }
            appended: list[LogEntry] = []
            for raw in args["entries"]:
                idx, eterm, msg_type, payload = raw
                existing = self._entry_at(idx)
                if existing is not None:
                    if existing.term == eterm:
                        continue
                    # conflict: truncate from idx on
                    keep = idx - self._snap_last_index - 1
                    self._log = self._log[:keep]
                    if self.store is not None:
                        self.store.truncate_from(idx)
                if idx == self._last_log_index() + 1:
                    entry = LogEntry(idx, eterm, msg_type, payload)
                    self._log.append(entry)
                    appended.append(entry)
            if appended and self.store is not None:
                # Persist before acking: success tells the leader these
                # entries are stable on this follower.
                try:
                    self.store.append(appended)
                except Exception:
                    # Roll the in-memory suffix back too: otherwise the
                    # leader's RETRY finds the entries already present,
                    # skips the store write, and acks entries that never
                    # hit disk — a full-cluster restart would then lose
                    # an acked write (exposed by the chaos fsync fault).
                    keep = appended[0].index - self._snap_last_index - 1
                    self._log = self._log[:keep]
                    raise
            if args["leader_commit"] > self.commit_index:
                # §5.3: clamp to the index of the last entry COVERED BY
                # THIS REQUEST, not our last log index — we may hold
                # stale divergent entries beyond the appended batch that
                # must not be marked committed before truncation.
                last_new = (
                    args["entries"][-1][0] if args["entries"] else prev_idx
                )
                new_commit = min(args["leader_commit"], last_new)
                if new_commit > self.commit_index:
                    self.commit_index = new_commit
                    self._commit_cv.notify_all()
            return {"term": self.current_term, "success": True}

    def _handle_install_snapshot(self, args):
        with self._lock:
            term = args["term"]
            if term < self.current_term:
                return {"term": self.current_term}
            self._become_follower_locked(term)
            self.leader_id = args["leader_id"]
            self._last_heartbeat = time.monotonic()
            last_idx = args["last_included_index"]
            last_term = args["last_included_term"]
            if last_idx <= self._snap_last_index or last_idx <= self.last_applied:
                return {"term": self.current_term}
            with self._fsm_mutex:
                self._restore_epoch += 1
                if self.restore_fn is not None and args["data"] is not None:
                    self.restore_fn(args["data"])
            config = args.get("config")
            if config:
                self.peers = {
                    p: tuple(a) for p, a in config.items() if p != self.node_id
                }
            self._snap_bytes = args["data"]
            self._snap_last_index = last_idx
            self._snap_last_term = last_term
            self._log = [e for e in self._log if e.index > last_idx]
            if self.store is not None and args["data"] is not None:
                self.store.store_snapshot(args["data"], last_idx, last_term)
            self.commit_index = max(self.commit_index, last_idx)
            self.last_applied = max(self.last_applied, last_idx)
            self._commit_cv.notify_all()
            return {"term": self.current_term}
