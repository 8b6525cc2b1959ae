"""Log rotation.

Port of ``nomad_tpu/client/logmon.py``.

Reference: client/logmon/ (~1,000 LoC) — an out-of-process plugin that
pumps task FIFOs into size-rotated files (logging/rotator.go). Our
drivers append directly to files, so rotation is copy-truncate (the
writer keeps its fd; we copy the full file to the next index and
truncate in place — the same trade logrotate's copytruncate makes: a
small window of loss between copy and truncate).

Files are named <task>.<stream>.<n> with n=0 the live file, matching the
reference's naming that the fs/logs API sorts on.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

logger = logging.getLogger("nomad_tpu_torch.logmon")


class LogRotator:
    def __init__(
        self,
        live_path: str,  # e.g. .../logs/web.stdout.0
        max_files: int = 10,
        max_file_size_mb: int = 10,
        check_interval_s: float = 2.0,
    ) -> None:
        self.live_path = live_path
        self.max_files = max(1, max_files)
        self.max_bytes = max_file_size_mb * 1024 * 1024
        self.check_interval_s = check_interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="logmon"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)

    def _loop(self) -> None:
        while not self._stop.wait(self.check_interval_s):
            try:
                self.rotate_if_needed()
            except OSError:
                logger.exception("log rotation failed for %s", self.live_path)

    def rotate_if_needed(self) -> bool:
        try:
            size = os.path.getsize(self.live_path)
        except OSError:
            return False
        if size < self.max_bytes:
            return False
        base = self.live_path[: -len(".0")]
        # shift .(n) -> .(n+1), dropping the oldest beyond max_files
        oldest = self.max_files - 1
        for n in range(oldest, 0, -1):
            src = f"{base}.{n}"
            if not os.path.exists(src):
                continue
            if n == oldest:
                os.unlink(src)
            else:
                os.replace(src, f"{base}.{n + 1}")
        # copy-truncate the live file into .1
        with open(self.live_path, "rb") as live, open(f"{base}.1", "wb") as out:
            while True:
                chunk = live.read(1 << 20)
                if not chunk:
                    break
                out.write(chunk)
        with open(self.live_path, "r+b") as live:
            live.truncate(0)
        return True
