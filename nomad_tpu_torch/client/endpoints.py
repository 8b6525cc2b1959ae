"""Client-agent RPC surface: streaming fs/logs/exec.

Port of ``nomad_tpu/client/endpoints.py``.

Reference: the client half of the 4-boundary streaming path (SURVEY
§3.5) — client/fs_endpoint.go (Logs/Stream/List/Stat), client
/alloc_endpoint.go (exec → driver ExecTaskStreaming). The reference
reverse-dials over pooled yamux sessions (nomad/client_rpc.go); here the
client agent runs a small listener on the shared fabric and advertises
its address as the node attribute `unique.client.rpc` — servers dial it
directly to splice streams through to API consumers.

Stream wire format (msgpack frames over a fabric StreamSession):
  {"data": bytes}            — payload chunk (fs/logs: file bytes;
                                exec: process output)
  {"stdin": bytes}           — exec input (consumer → client)
  {"eof": True}              — end of stream
  {"error": str}             — terminal failure
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Optional

from ..rpc.server import RPCServer, StreamSession

logger = logging.getLogger("nomad_tpu_torch.client.endpoints")

CHUNK = 64 * 1024


class ClientEndpoints:
    """Owns the client agent's listener and its stream handlers."""

    def __init__(self, client, host: str = "127.0.0.1", secret="",
                 tls_context=None) -> None:
        self.client = client
        self.rpc = RPCServer(
            host=host, port=0, secret=secret, tls_context=tls_context
        )
        self.rpc.register_stream("FS.logs", self._fs_logs)
        self.rpc.register_stream("FS.ls", self._fs_ls)
        self.rpc.register_stream("FS.cat", self._fs_cat)
        self.rpc.register_stream("FS.stat", self._fs_stat)
        self.rpc.register_stream("Exec.exec", self._exec)
        self.rpc.register_stream("Alloc.restart", self._alloc_restart)
        self.rpc.register_stream("Alloc.signal", self._alloc_signal)
        self.rpc.register_stream("Alloc.stats", self._alloc_stats)
        self.rpc.register_stream("CSI.create", self._csi_create)
        self.rpc.register_stream("CSI.delete", self._csi_delete)
        self.rpc.register_stream(
            "CSI.create_snapshot", self._csi_create_snapshot
        )
        self.rpc.register_stream(
            "CSI.delete_snapshot", self._csi_delete_snapshot
        )
        self.rpc.register_stream(
            "CSI.list_snapshots", self._csi_list_snapshots
        )
        self.rpc.register_stream(
            "CSI.controller_unpublish", self._csi_controller_unpublish
        )

    @property
    def addr(self) -> tuple[str, int]:
        return self.rpc.addr

    def start(self) -> None:
        self.rpc.start()

    def stop(self) -> None:
        self.rpc.shutdown()

    # -- CSI controller relay (reference client/csi_endpoint.go: the
    # server routes controller RPCs to a node running the plugin) ------

    def _csi_plugin(self, session, header):
        plugin = self.client.csi_manager.plugins.get(
            header.get("plugin_id", "")
        )
        if plugin is None:
            session.send({
                "error": f"plugin {header.get('plugin_id')!r} not on "
                f"this client"
            })
            return None
        return plugin

    def _csi_create(self, session, header) -> None:
        plugin = self._csi_plugin(session, header)
        if plugin is None:
            return
        try:
            out = plugin.create_volume(
                header.get("name", ""), header.get("params") or {}
            )
            session.send({"ok": True, **out})
        except Exception as e:
            session.send({"error": f"{type(e).__name__}: {e}"})

    def _csi_delete(self, session, header) -> None:
        plugin = self._csi_plugin(session, header)
        if plugin is None:
            return
        try:
            plugin.delete_volume(header.get("external_id", ""))
            session.send({"ok": True})
        except Exception as e:
            session.send({"error": f"{type(e).__name__}: {e}"})

    def _csi_controller_unpublish(self, session, header) -> None:
        plugin = self._csi_plugin(session, header)
        if plugin is None:
            return
        try:
            plugin.controller_unpublish(
                header.get("volume_id", ""),
                header.get("external_id", ""),
                header.get("node_id", ""),
            )
            session.send({"ok": True})
        except Exception as e:
            session.send({"error": f"{type(e).__name__}: {e}"})

    def _csi_create_snapshot(self, session, header) -> None:
        plugin = self._csi_plugin(session, header)
        if plugin is None:
            return
        try:
            out = plugin.create_snapshot(
                header.get("external_id", ""),
                header.get("name", ""),
                header.get("params") or {},
            )
            session.send({"ok": True, **out})
        except Exception as e:
            session.send({"error": f"{type(e).__name__}: {e}"})

    def _csi_delete_snapshot(self, session, header) -> None:
        plugin = self._csi_plugin(session, header)
        if plugin is None:
            return
        try:
            plugin.delete_snapshot(header.get("snapshot_id", ""))
            session.send({"ok": True})
        except Exception as e:
            session.send({"error": f"{type(e).__name__}: {e}"})

    def _csi_list_snapshots(self, session, header) -> None:
        plugin = self._csi_plugin(session, header)
        if plugin is None:
            return
        try:
            session.send(
                {"ok": True, "snapshots": plugin.list_snapshots()}
            )
        except Exception as e:
            session.send({"error": f"{type(e).__name__}: {e}"})

    # -- alloc lifecycle (reference client/alloc_endpoint.go) -----------

    def _alloc_lifecycle(self, session, header, verb) -> None:
        runner = self.client.alloc_runners.get(header.get("alloc_id", ""))
        if runner is None:
            session.send({"error": "alloc not running on this client"})
            return
        try:
            verb(runner)
            session.send({"ok": True})
        except KeyError as e:
            session.send({"error": str(e)})
        except Exception as e:
            session.send({"error": f"{type(e).__name__}: {e}"})

    def _alloc_restart(self, session, header) -> None:
        self._alloc_lifecycle(
            session, header,
            lambda r: r.restart(header.get("task", "")),
        )

    def _alloc_signal(self, session, header) -> None:
        self._alloc_lifecycle(
            session, header,
            lambda r: r.signal(
                header.get("signal", "SIGTERM"), header.get("task", "")
            ),
        )

    def _alloc_stats(self, session, header) -> None:
        """Resource usage for one alloc: per-task driver stats plus the
        alloc's reserved device instances' stats (reference:
        GET /v1/client/allocation/:id/stats → AllocResourceUsage; the
        nvidia plugin's Stats stream feeds the DeviceStats section)."""
        runner = self.client.alloc_runners.get(header.get("alloc_id", ""))
        if runner is None:
            session.send({"error": "alloc not running on this client"})
            return
        tasks: dict = {}
        for name, tr in runner.task_runners.items():
            try:
                tasks[name] = tr.driver.task_stats(tr.task_id) or {}
            except Exception:
                tasks[name] = {}
        # device stats, filtered to the instances this alloc holds
        assigned: set[str] = set()
        res = runner.alloc.resources
        if res is not None:
            for tr_res in res.tasks.values():
                for dev in tr_res.devices or []:
                    assigned.update(dev.get("device_ids", []))
        devices: dict = {}
        if assigned:
            for plugin, insts in self.client.device_manager.stats().items():
                mine = {
                    iid: s for iid, s in insts.items() if iid in assigned
                }
                if mine:
                    devices[plugin] = mine
        session.send({"tasks": tasks, "devices": devices})

    # -- helpers --------------------------------------------------------

    def _alloc_dir(self, alloc_id: str):
        runner = self.client.alloc_runners.get(alloc_id)
        if runner is None:
            return None
        return runner.allocdir

    def _resolve(self, alloc_dir, rel_path: str) -> str:
        """Confine a user path to the alloc dir (same rule as templates)."""
        from .allocdir import confine

        return confine(alloc_dir.alloc_dir, rel_path or ".")

    # -- fs -------------------------------------------------------------

    def _fs_logs(self, session: StreamSession, header: dict) -> None:
        """Stream a task's stdout/stderr log, optionally following
        (reference client/fs_endpoint.go Logs)."""
        try:
            alloc_id = header.get("alloc_id", "")
            adir = self._alloc_dir(alloc_id)
            runner = self.client.alloc_runners.get(alloc_id)
            if adir is None or runner is None:
                session.send({"error": "unknown allocation"})
                return
            task = header.get("task", "")
            # The task name is caller-controlled: a path-shaped value
            # would escape the alloc dir through stdout_path's join.
            if task not in runner.task_runners:
                session.send({"error": f"unknown task {task!r}"})
                return
            log_type = header.get("type", "stdout")
            if log_type not in ("stdout", "stderr"):
                session.send({"error": f"bad log type {log_type!r}"})
                return
            path = (
                adir.stdout_path(task)
                if log_type == "stdout"
                else adir.stderr_path(task)
            )
            follow = bool(header.get("follow"))
            offset = int(header.get("offset", 0))
            origin = header.get("origin", "start")
            try:
                f = open(path, "rb")
            except OSError as e:
                session.send({"error": f"open log: {e}"})
                return
            with f:
                if origin == "end":
                    f.seek(0, os.SEEK_END)
                    size = f.tell()
                    f.seek(max(0, size - offset))
                elif offset:
                    f.seek(offset)
                idle = 0.0
                while True:
                    chunk = f.read(CHUNK)
                    if chunk:
                        idle = 0.0
                        session.send({"data": chunk})
                        continue
                    if not follow:
                        session.send({"eof": True})
                        return
                    # follow: wait for growth; detect copy-truncate
                    # rotation (logmon) by the file shrinking under us
                    time.sleep(0.2)
                    idle += 0.2
                    try:
                        size = os.path.getsize(path)
                    except OSError:
                        size = 0
                    if size < f.tell():
                        f.seek(0)
                    if idle > 5.0:
                        # heartbeat keeps half-open connections detected
                        session.send({"data": b""})
                        idle = 0.0
        except (ConnectionError, OSError):
            pass
        finally:
            session.close()

    def _fs_ls(self, session: StreamSession, header: dict) -> None:
        from .allocdir import EscapeError

        try:
            adir = self._alloc_dir(header.get("alloc_id", ""))
            if adir is None:
                session.send({"error": "unknown allocation"})
                return
            try:
                path = self._resolve(adir, header.get("path", ""))
            except EscapeError as e:
                session.send({"error": str(e)})
                return
            entries = []
            try:
                for name in sorted(os.listdir(path)):
                    full = os.path.join(path, name)
                    st = os.stat(full)
                    entries.append(
                        {
                            "name": name,
                            "is_dir": os.path.isdir(full),
                            "size": st.st_size,
                            "mtime_ns": st.st_mtime_ns,
                        }
                    )
            except OSError as e:
                session.send({"error": f"ls: {e}"})
                return
            session.send({"entries": entries, "eof": True})
        except (ConnectionError, OSError):
            pass
        finally:
            session.close()

    def _fs_stat(self, session: StreamSession, header: dict) -> None:
        from .allocdir import EscapeError

        try:
            adir = self._alloc_dir(header.get("alloc_id", ""))
            if adir is None:
                session.send({"error": "unknown allocation"})
                return
            try:
                path = self._resolve(adir, header.get("path", ""))
                st = os.stat(path)
            except (EscapeError, OSError) as e:
                session.send({"error": str(e)})
                return
            session.send(
                {
                    "stat": {
                        "name": os.path.basename(path),
                        "is_dir": os.path.isdir(path),
                        "size": st.st_size,
                        "mtime_ns": st.st_mtime_ns,
                    },
                    "eof": True,
                }
            )
        except (ConnectionError, OSError):
            pass
        finally:
            session.close()

    def _fs_cat(self, session: StreamSession, header: dict) -> None:
        from .allocdir import EscapeError

        try:
            adir = self._alloc_dir(header.get("alloc_id", ""))
            if adir is None:
                session.send({"error": "unknown allocation"})
                return
            try:
                path = self._resolve(adir, header.get("path", ""))
                f = open(path, "rb")
            except (EscapeError, OSError) as e:
                session.send({"error": str(e)})
                return
            with f:
                while True:
                    chunk = f.read(CHUNK)
                    if not chunk:
                        break
                    session.send({"data": chunk})
            session.send({"eof": True})
        except (ConnectionError, OSError):
            pass
        finally:
            session.close()

    # -- exec -----------------------------------------------------------

    def _exec(self, session: StreamSession, header: dict) -> None:
        """Interactive exec into a running task: splice the fabric
        session onto the driver's exec socket (reference
        client/alloc_endpoint.go exec → ExecTaskStreaming)."""
        sock = None
        try:
            alloc_id = header.get("alloc_id", "")
            task_name = header.get("task", "")
            cmd = list(header.get("cmd") or [])
            runner = self.client.alloc_runners.get(alloc_id)
            if runner is None:
                session.send({"error": "unknown allocation"})
                return
            tr = runner.task_runners.get(task_name)
            if tr is None:
                names = list(runner.task_runners)
                if len(names) == 1 and not task_name:
                    tr = runner.task_runners[names[0]]
                else:
                    session.send({"error": f"unknown task {task_name!r}"})
                    return
            if not cmd:
                session.send({"error": "exec needs a command"})
                return
            try:
                sock = tr.driver.exec_task_streaming(
                    tr.task_id, cmd, tty=bool(header.get("tty"))
                )
            except Exception as e:
                session.send({"error": f"exec: {e}"})
                return
            session.send({"ok": True})
            done = threading.Event()

            def pump_out() -> None:
                try:
                    while True:
                        data = sock.recv(CHUNK)
                        if not data:
                            break
                        session.send({"data": data})
                    session.send({"eof": True})
                except (ConnectionError, OSError):
                    pass
                finally:
                    done.set()

            t = threading.Thread(
                target=pump_out, name="alloc-exec-out", daemon=True
            )
            t.start()
            while not done.is_set():
                try:
                    msg = session.recv(timeout_s=0.5)
                except TimeoutError:
                    continue
                except (ConnectionError, OSError):
                    break
                if msg is None or msg.get("eof"):
                    try:
                        sock.shutdown(2)
                    except OSError:
                        pass
                    break
                stdin = msg.get("stdin")
                if stdin:
                    try:
                        sock.sendall(stdin)
                    except OSError:
                        break
            done.wait(timeout=5)
        except (ConnectionError, OSError):
            pass
        finally:
            if sock is not None:
                sock.close()
            session.close()


class ReverseDialer:
    """Reverse-dial fallback for NAT'd clients (reference
    nomad/client_rpc.go: servers open streams over yamux sessions the
    CLIENT established).

    Keeps `idle_target` connections parked on a server's fabric: each
    registers with our node id, then blocks waiting for the server to
    send a stream request header. On receipt the request is dispatched to
    the SAME handlers the forward-dial listener uses, then the connection
    is consumed and a fresh one parked in its place.
    """

    def __init__(
        self,
        client,
        endpoints: ClientEndpoints,
        addrs_fn,  # () -> list[(host, port)] of server fabric addrs
        idle_target: int = 2,
        secret="",  # str | rpc.keyring.Keyring
        retry_s: float = 2.0,
        tls_context=None,
    ) -> None:
        from ..rpc import ConnPool

        self.client = client
        self.endpoints = endpoints
        self.addrs_fn = addrs_fn
        self.idle_target = idle_target
        self.retry_s = retry_s
        self.pool = ConnPool(secret=secret, tls_context=tls_context)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._lock = threading.Lock()
        self._parked: list[StreamSession] = []

    def start(self) -> None:
        self._stop = threading.Event()
        # One parker per known server (at least idle_target threads):
        # the relay only finds sessions parked on the SERVER IT RUNS ON,
        # so every server needs coverage, not just addrs[0].
        n = max(self.idle_target, len(self.addrs_fn() or []))
        for i in range(n):
            t = threading.Thread(
                target=self._run, args=(self._stop, i), daemon=True,
                name=f"reverse-dial-{i}",
            )
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            parked = list(self._parked)
            self._parked.clear()
        for s in parked:
            s.close()  # unblocks the recv below

    def _run(self, stop: threading.Event, base: int = 0) -> None:
        rotate = 0
        while not stop.is_set():
            addrs = list(self.addrs_fn() or [])
            if not addrs:
                stop.wait(self.retry_s)
                continue
            # thread i pins to server i (mod n); rotate only on failure
            addr = tuple(addrs[(base + rotate) % len(addrs)])
            try:
                session = self.pool.stream(
                    addr,
                    "ClientReverse.register",
                    {"node_id": self.client.node.id},
                )
            except Exception:
                rotate += 1
                stop.wait(self.retry_s)
                continue
            with self._lock:
                self._parked.append(session)
            try:
                req = session.recv(timeout_s=None)  # park until needed
            except Exception:
                with self._lock:
                    if session in self._parked:
                        self._parked.remove(session)
                session.close()
                stop.wait(self.retry_s if not stop.is_set() else 0)
                continue
            with self._lock:
                if session in self._parked:
                    self._parked.remove(session)
            if stop.is_set():
                session.close()
                return
            method = (req or {}).get("method", "")
            handler = self.endpoints.rpc._stream_handlers.get(method)
            if handler is None:
                try:
                    session.send({"error": f"unknown stream method {method!r}"})
                finally:
                    session.close()
                continue
            try:
                session.send({"ok": True})
                handler(session, req)
            except Exception:
                logger.exception("reverse stream %s failed", method)
            finally:
                session.close()
