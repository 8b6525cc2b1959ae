"""Durable raft storage: log + stable state + FSM snapshot on disk.

Port of ``nomad_tpu/server/raft_store.py``. Reference: the Go tree wires hashicorp/raft-boltdb as the LogStore and
StableStore and streams FSM snapshots to a snapshot dir
(nomad/server.go:1210 setupRaft, nomad/fsm.go:1367 Snapshot /
:1860 Persist, helper/snapshot/). Here one SQLite file (same engine as
the reference client's state DB) carries all three roles:

  log(idx, term, msg_type, payload)   — the replicated log
  stable(key, value)                  — current_term / voted_for (§5.1:
                                        votes MUST survive restarts or a
                                        node can vote twice in a term)
  snapshot(id=1, last_index, last_term, data) — latest FSM snapshot

Entry payloads are the bytes of the package's codec (codec.pack), so
anything that can be replicated can be persisted by construction.

Recovery contract (load()): the FSM is restored from the snapshot, then
the log tail replays as the cluster re-commits it — commit_index is
deliberately NOT persisted; a restarted node learns it from the next
leader's AppendEntries (standard Raft: the leader's no-op barrier entry
re-commits the prefix).
"""

from __future__ import annotations

import os
import sqlite3
import threading
from typing import Optional

from .. import faultplane
from .raft_replication import LogEntry


class RaftLogStore:
    def __init__(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        # Fault-plane identity (faultplane.py): injected fsync
        # failures / slow-disk rules match this label (the owning
        # node's id when run under ChaosCluster).
        self.chaos_label = ""
        self._lock = threading.Lock()
        # Exclusive advisory lock: two agents sharing a data_dir would
        # silently interleave terms/votes/logs (raft-boltdb fails fast on
        # its file lock; so do we).
        import fcntl

        self._lockfile = open(path + ".lock", "w")
        try:
            fcntl.flock(self._lockfile, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError as e:
            self._lockfile.close()
            raise RuntimeError(
                f"raft store {path} is locked — is another server agent "
                f"using this data_dir?"
            ) from e
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        # NORMAL loses at most the tail of the WAL on power loss — the
        # raft protocol tolerates a truncated suffix (it simply re-
        # replicates); it does NOT tolerate torn pages, which WAL rules out.
        self._db.execute("PRAGMA synchronous=NORMAL")
        self._db.executescript(
            """
            CREATE TABLE IF NOT EXISTS log (
                idx INTEGER PRIMARY KEY,
                term INTEGER NOT NULL,
                msg_type TEXT NOT NULL,
                payload BLOB
            );
            CREATE TABLE IF NOT EXISTS stable (
                key TEXT PRIMARY KEY,
                value BLOB
            );
            CREATE TABLE IF NOT EXISTS snapshot (
                id INTEGER PRIMARY KEY CHECK (id = 1),
                last_index INTEGER NOT NULL,
                last_term INTEGER NOT NULL,
                data BLOB
            );
            """
        )
        self._db.commit()

    # -- stable store ---------------------------------------------------

    def set_state(self, term: int, voted_for: Optional[str]) -> None:
        if faultplane.plane is not None:
            faultplane.plane.on_disk(self.chaos_label, "state")
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO stable(key, value) VALUES ('term', ?)",
                (str(term),),
            )
            self._db.execute(
                "INSERT OR REPLACE INTO stable(key, value) VALUES ('voted_for', ?)",
                (voted_for or "",),
            )
            self._db.commit()

    def get_state(self) -> tuple[int, Optional[str]]:
        with self._lock:
            rows = dict(
                self._db.execute("SELECT key, value FROM stable").fetchall()
            )
        term = int(rows.get("term") or 0)
        voted = rows.get("voted_for") or None
        return term, voted

    # -- log ------------------------------------------------------------

    def append(self, entries: list[LogEntry]) -> None:
        if not entries:
            return
        # Injected fsync failure / slow disk (faultplane.py): raised
        # BEFORE the write, so a "failed" append is never durable — the
        # caller must treat it exactly like a torn write that rolled
        # back, which is what the raft layer's error paths assume.
        if faultplane.plane is not None:
            faultplane.plane.on_disk(self.chaos_label, "append")
        with self._lock:
            self._db.executemany(
                "INSERT OR REPLACE INTO log(idx, term, msg_type, payload) "
                "VALUES (?, ?, ?, ?)",
                # e.payload is already the packed command bytes
                # (LogEntry contract) — written verbatim.
                [(e.index, e.term, e.msg_type, e.payload) for e in entries],
            )
            self._db.commit()

    def truncate_from(self, index: int) -> None:
        """Drop entries with idx >= index (conflict truncation)."""
        with self._lock:
            self._db.execute("DELETE FROM log WHERE idx >= ?", (index,))
            self._db.commit()

    def compact_to(self, index: int) -> None:
        """Drop entries with idx <= index (snapshot compaction)."""
        with self._lock:
            self._db.execute("DELETE FROM log WHERE idx <= ?", (index,))
            self._db.commit()

    # -- snapshot -------------------------------------------------------

    def store_snapshot(self, data: bytes, last_index: int, last_term: int) -> None:
        if faultplane.plane is not None:
            faultplane.plane.on_disk(self.chaos_label, "snapshot")
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO snapshot(id, last_index, last_term, data) "
                "VALUES (1, ?, ?, ?)",
                (last_index, last_term, data),
            )
            self._db.execute("DELETE FROM log WHERE idx <= ?", (last_index,))
            self._db.commit()

    def load_snapshot(self) -> Optional[tuple[bytes, int, int]]:
        with self._lock:
            row = self._db.execute(
                "SELECT data, last_index, last_term FROM snapshot WHERE id = 1"
            ).fetchone()
        if row is None:
            return None
        return row[0], row[1], row[2]

    def load_log(self) -> list[LogEntry]:
        with self._lock:
            rows = self._db.execute(
                "SELECT idx, term, msg_type, payload FROM log ORDER BY idx"
            ).fetchall()
        return [
            LogEntry(idx, term, msg_type, payload)
            for idx, term, msg_type, payload in rows
        ]

    def close(self) -> None:
        with self._lock:
            self._db.close()
            self._lockfile.close()  # releases the flock
