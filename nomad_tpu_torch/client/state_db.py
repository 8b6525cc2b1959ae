"""Client-local persistent state.

Port of ``nomad_tpu/client/state_db.py``.

Reference: client/state/state_database.go — BoltDB buckets (:61-94) for
allocations, task runner state, driver task handles, and dyn plugin
state, so a restarted agent restores its allocs and REATTACHES to live
tasks instead of killing them. sqlite3 (stdlib) stands in for BoltDB;
blobs are codec-packed structs. The `schema_version` row is the upgrade
hook (reference client/state/upgrade.go).
"""

from __future__ import annotations

import os
import sqlite3
import threading
from typing import Optional

from .. import codec
from ..structs import Allocation, TaskState

SCHEMA_VERSION = 1


class StateDB:
    def __init__(self, data_dir: str) -> None:
        os.makedirs(data_dir, exist_ok=True)
        self.path = os.path.join(data_dir, "client_state.db")
        self._lock = threading.Lock()
        self._closed = False
        self._db = sqlite3.connect(self.path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._migrate()

    def _migrate(self) -> None:
        with self._lock, self._db:
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS meta (key TEXT PRIMARY KEY, value TEXT)"
            )
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS allocs (id TEXT PRIMARY KEY, blob BLOB)"
            )
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS task_state ("
                "alloc_id TEXT, task TEXT, blob BLOB,"
                "PRIMARY KEY (alloc_id, task))"
            )
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS task_handles ("
                "alloc_id TEXT, task TEXT, blob BLOB,"
                "PRIMARY KEY (alloc_id, task))"
            )
            row = self._db.execute(
                "SELECT value FROM meta WHERE key='schema_version'"
            ).fetchone()
            if row is None:
                self._db.execute(
                    "INSERT INTO meta VALUES ('schema_version', ?)",
                    (str(SCHEMA_VERSION),),
                )
            # future: elif int(row[0]) < SCHEMA_VERSION: upgrade path

    # -- meta ----------------------------------------------------------

    def get_meta(self, key: str) -> Optional[str]:
        with self._lock:
            row = self._db.execute(
                "SELECT value FROM meta WHERE key=?", (key,)
            ).fetchone()
        return row[0] if row else None

    def put_meta(self, key: str, value: str) -> None:
        with self._lock, self._db:
            self._db.execute(
                "INSERT OR REPLACE INTO meta VALUES (?, ?)", (key, value)
            )

    # -- allocs --------------------------------------------------------

    def put_alloc(self, alloc: Allocation) -> None:
        with self._lock:
            if self._closed:
                return
            with self._db:
                self._db.execute(
                    "INSERT OR REPLACE INTO allocs VALUES (?, ?)",
                    (alloc.id, codec.pack(alloc)),
                )

    def get_allocs(self) -> list[Allocation]:
        with self._lock:
            rows = self._db.execute("SELECT blob FROM allocs").fetchall()
        return [codec.unpack(r[0]) for r in rows]

    def delete_alloc(self, alloc_id: str) -> None:
        with self._lock:
            if self._closed:
                return
            self._delete_alloc_locked(alloc_id)

    def _delete_alloc_locked(self, alloc_id: str) -> None:
        with self._db:
            self._db.execute("DELETE FROM allocs WHERE id=?", (alloc_id,))
            self._db.execute(
                "DELETE FROM task_state WHERE alloc_id=?", (alloc_id,)
            )
            self._db.execute(
                "DELETE FROM task_handles WHERE alloc_id=?", (alloc_id,)
            )

    # -- task state / handles ------------------------------------------

    def put_task_state(self, alloc_id: str, task: str, state: TaskState) -> None:
        with self._lock:
            if self._closed:
                # late writes from still-draining runner threads after an
                # agent shutdown are expected; drop them
                return
            with self._db:
                self._db.execute(
                    "INSERT OR REPLACE INTO task_state VALUES (?, ?, ?)",
                    (alloc_id, task, codec.pack(state)),
                )

    def get_task_states(self, alloc_id: str) -> dict[str, TaskState]:
        with self._lock:
            rows = self._db.execute(
                "SELECT task, blob FROM task_state WHERE alloc_id=?",
                (alloc_id,),
            ).fetchall()
        return {task: codec.unpack(blob) for task, blob in rows}

    def put_task_handle(self, alloc_id: str, task: str, handle: dict) -> None:
        with self._lock:
            if self._closed:
                return
            self._put_task_handle_locked(alloc_id, task, handle)

    def _put_task_handle_locked(self, alloc_id: str, task: str, handle: dict) -> None:
        with self._db:
            self._db.execute(
                "INSERT OR REPLACE INTO task_handles VALUES (?, ?, ?)",
                (alloc_id, task, codec.pack(handle)),
            )

    def get_task_handle(self, alloc_id: str, task: str) -> Optional[dict]:
        with self._lock:
            row = self._db.execute(
                "SELECT blob FROM task_handles WHERE alloc_id=? AND task=?",
                (alloc_id, task),
            ).fetchone()
        return codec.unpack(row[0]) if row else None

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._db.close()
