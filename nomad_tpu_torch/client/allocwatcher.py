"""Previous-allocation watcher + ephemeral disk migration.

Port of ``nomad_tpu/client/allocwatcher.py``.

Reference: client/allocwatcher/ — a replacement alloc (reschedule,
migrate, destructive update) with `ephemeral_disk { sticky = true }` or
`{ migrate = true }` waits for its predecessor to terminate and inherits
its shared data dir: moved on the same node, streamed over the client
fabric (the FS.ls/FS.cat surface) from the old node otherwise.
"""

from __future__ import annotations

import logging
import os
import shutil
import time
from typing import Callable, Optional

logger = logging.getLogger("nomad_tpu_torch.allocwatcher")


class PrevAllocMigrator:
    def __init__(
        self,
        alloc,
        tg,
        allocdir,
        local_runner_fn: Callable[[str], Optional[object]],
        rpc=None,
        secret="",  # str | rpc.keyring.Keyring
        wait_timeout_s: float = 30.0,
        tls_context=None,
    ) -> None:
        self.tls_context = tls_context
        self.alloc = alloc
        self.tg = tg
        self.allocdir = allocdir
        self.local_runner_fn = local_runner_fn
        self.rpc = rpc
        self.secret = secret
        self.wait_timeout_s = wait_timeout_s

    def run(self) -> None:
        """Blocks (bounded) until the previous alloc's data is inherited.
        Failures degrade to an empty data dir — migration is best-effort,
        never a reason to fail the replacement (reference allocwatcher
        logs and moves on)."""
        prev_id = self.alloc.previous_allocation
        ed = self.tg.ephemeral_disk
        if not prev_id or not (ed.sticky or ed.migrate):
            return
        try:
            local = self.local_runner_fn(prev_id)
            if local is not None:
                self._wait_local(local)
                self._move_local(local)
            elif ed.migrate and self.rpc is not None:
                self._fetch_remote(prev_id)
        except Exception:
            logger.exception(
                "alloc %s: ephemeral disk migration from %s failed",
                self.alloc.id[:8],
                prev_id[:8],
            )

    # -- local (same node) ---------------------------------------------

    def _wait_local(self, runner) -> None:
        deadline = time.monotonic() + self.wait_timeout_s
        while time.monotonic() < deadline:
            if runner.alloc.client_terminal_status():
                return
            states = runner.alloc.task_states or {}
            if states and all(ts.state == "dead" for ts in states.values()):
                return
            time.sleep(0.1)
        logger.warning(
            "previous alloc %s still running after %.0fs; migrating anyway",
            runner.alloc.id[:8],
            self.wait_timeout_s,
        )

    def _move_local(self, runner) -> None:
        src = runner.allocdir.data_dir
        dst = self.allocdir.data_dir
        if not os.path.isdir(src):
            return
        os.makedirs(dst, exist_ok=True)
        moved = 0
        for name in os.listdir(src):
            shutil.move(os.path.join(src, name), os.path.join(dst, name))
            moved += 1
        logger.info(
            "alloc %s: inherited %d entries from %s (local move)",
            self.alloc.id[:8],
            moved,
            runner.alloc.id[:8],
        )

    # -- remote (cross-node, over the client fabric) -------------------

    def _prev_addr(self, prev_id: str):
        fn = getattr(self.rpc, "alloc_client_addr", None)
        if fn is None:
            return None, None
        try:
            return fn(prev_id)
        except Exception:
            return None, None

    def _fetch_remote(self, prev_id: str) -> None:
        from ..rpc import ConnPool

        deadline = time.monotonic() + self.wait_timeout_s
        prev, addr_s = None, None
        while time.monotonic() < deadline:
            prev, addr_s = self._prev_addr(prev_id)
            if prev is None:
                return  # GC'd already: nothing to inherit
            if prev.client_terminal_status():
                break
            time.sleep(0.2)
        if not addr_s:
            return
        host, _, port = str(addr_s).rpartition(":")
        addr = (host, int(port))
        pool = ConnPool(secret=self.secret, tls_context=self.tls_context)
        try:
            copied = self._fetch_tree(pool, addr, prev_id, "alloc/data", "")
            logger.info(
                "alloc %s: streamed %d files from %s@%s (migrate)",
                self.alloc.id[:8],
                copied,
                prev_id[:8],
                addr_s,
            )
        finally:
            pool.shutdown()

    def _fetch_tree(
        self, pool, addr, prev_id: str, remote_base: str, rel: str
    ) -> int:
        remote = os.path.join(remote_base, rel) if rel else remote_base
        session = pool.stream(
            addr, "FS.ls", {"alloc_id": prev_id, "path": remote}
        )
        try:
            msg = session.recv(timeout_s=30)
        finally:
            session.close()
        if msg.get("error"):
            raise OSError(f"remote ls {remote}: {msg['error']}")
        copied = 0
        for entry in msg.get("entries", []):
            child = os.path.join(rel, entry["name"]) if rel else entry["name"]
            if entry.get("is_dir"):
                os.makedirs(
                    os.path.join(self.allocdir.data_dir, child), exist_ok=True
                )
                copied += self._fetch_tree(
                    pool, addr, prev_id, remote_base, child
                )
                continue
            dst = os.path.join(self.allocdir.data_dir, child)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            cat = pool.stream(
                addr,
                "FS.cat",
                {"alloc_id": prev_id, "path": os.path.join(remote_base, child)},
            )
            try:
                with open(dst, "wb") as f:
                    while True:
                        m = cat.recv(timeout_s=30)
                        if m.get("error"):
                            raise OSError(f"remote cat {child}: {m['error']}")
                        data = m.get("data")
                        if data:
                            f.write(data)
                        if m.get("eof"):
                            break
            finally:
                cat.close()
            copied += 1
        return copied
