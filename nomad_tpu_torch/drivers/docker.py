"""Docker task driver.

Port of ``nomad_tpu/drivers/docker.py``.

Reference: drivers/docker/driver.go (container lifecycle, stats, exec,
docklog) and drivers/docker/coordinator.go (deduped concurrent image
pulls). The reference links the Docker SDK; here the Engine REST API is
spoken directly over the unix socket with stdlib http.client — no
dependency, and the tests can stand up a fake daemon on a temp socket
(real dockerd e2e runs when /var/run/docker.sock exists).

Layering:
  DockerAPI        — minimal Engine client (images, containers, exec)
  PullCoordinator  — one in-flight pull per image ref, others wait
  DockerDriver     — the Driver interface: start/wait/stop/destroy/
                     stats/signal/exec/recover; container logs are pumped
                     into the task's stdout/stderr files (the docklog
                     analog, feeding the existing logmon rotation).
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import re
import socket
import struct
import threading
import time
from typing import Any, Optional

from .base import (
    Driver,
    DriverError,
    ExitResult,
    Fingerprint,
    HEALTH_STATE_HEALTHY,
    HEALTH_STATE_UNDETECTED,
    TASK_STATE_EXITED,
    TASK_STATE_RUNNING,
    TASK_STATE_UNKNOWN,
    TaskConfig,
    TaskHandle,
    TaskStatus,
)

logger = logging.getLogger("nomad_tpu_torch.drivers.docker")

DEFAULT_SOCKET = "/var/run/docker.sock"
API_VERSION = "v1.40"


class _UnixHTTPConnection(http.client.HTTPConnection):
    def __init__(self, path: str, timeout: Optional[float] = None) -> None:
        super().__init__("localhost", timeout=timeout)
        self._unix_path = path

    def connect(self) -> None:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        if self.timeout is not None:
            sock.settimeout(self.timeout)
        sock.connect(self._unix_path)
        self.sock = sock


class DockerAPIError(DriverError):
    def __init__(self, status: int, message: str) -> None:
        self.status = status
        super().__init__(f"docker api {status}: {message}")


class DockerAPI:
    """Minimal Docker Engine REST client over a unix socket."""

    def __init__(self, socket_path: str = DEFAULT_SOCKET,
                 timeout_s: float = 60.0) -> None:
        self.socket_path = socket_path
        self.timeout_s = timeout_s

    def _conn(self, timeout_s: Optional[float] = None) -> _UnixHTTPConnection:
        return _UnixHTTPConnection(
            self.socket_path, timeout=timeout_s or self.timeout_s
        )

    def _request(
        self,
        method: str,
        path: str,
        body: Optional[dict] = None,
        timeout_s: Optional[float] = None,
        stream: bool = False,
    ):
        """Returns parsed JSON (or b'' for 204). stream=True returns the
        live (conn, response) pair — caller owns closing the conn."""
        conn = self._conn(timeout_s)
        data = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"} if data else {}
        try:
            conn.request(method, f"/{API_VERSION}{path}", body=data,
                         headers=headers)
            resp = conn.getresponse()
        except (OSError, http.client.HTTPException) as e:
            conn.close()
            raise DriverError(f"docker daemon unreachable: {e}") from e
        if resp.status >= 400:
            try:
                msg = json.loads(resp.read() or b"{}").get("message", "")
            except Exception:
                msg = ""
            conn.close()
            raise DockerAPIError(resp.status, msg or resp.reason)
        if stream:
            return conn, resp
        try:
            raw = resp.read()
        finally:
            conn.close()
        if not raw:
            return None
        ctype = resp.headers.get("Content-Type", "")
        if "json" in ctype:
            # progress endpoints emit newline-delimited JSON objects
            lines = [ln for ln in raw.split(b"\n") if ln.strip()]
            if len(lines) > 1:
                return [json.loads(ln) for ln in lines]
            return json.loads(lines[0]) if lines else None
        return raw

    # -- daemon ---------------------------------------------------------

    def ping(self) -> bool:
        try:
            conn = self._conn(2.0)
            conn.request("GET", "/_ping")
            ok = conn.getresponse().status == 200
            conn.close()
            return ok
        except OSError:
            return False

    def version(self) -> dict:
        return self._request("GET", "/version") or {}

    # -- images ---------------------------------------------------------

    def image_inspect(self, ref: str) -> Optional[dict]:
        try:
            return self._request("GET", f"/images/{ref}/json")
        except DockerAPIError as e:
            if e.status == 404:
                return None
            raise

    def image_pull(self, ref: str, timeout_s: float = 300.0) -> None:
        """POST /images/create; consumes the progress stream to completion
        and surfaces daemon-reported errors."""
        if "@" in ref:
            # digest-pinned (image@sha256:...): the digest IS the
            # reference; a tag split would cut inside the digest
            query = f"fromImage={ref}"
        elif ":" in ref.rsplit("/", 1)[-1]:
            image, tag = ref.rsplit(":", 1)
            query = f"fromImage={image}&tag={tag}"
        else:
            query = f"fromImage={ref}&tag=latest"
        conn, resp = self._request(
            "POST",
            f"/images/create?{query}",
            timeout_s=timeout_s,
            stream=True,
        )
        try:
            buf = b""
            while True:
                chunk = resp.read(8192)
                if not chunk:
                    break
                buf += chunk
            for ln in buf.split(b"\n"):
                if not ln.strip():
                    continue
                try:
                    msg = json.loads(ln)
                except ValueError:
                    continue
                if msg.get("error"):
                    raise DriverError(f"pull {ref}: {msg['error']}")
        finally:
            conn.close()

    # -- containers -------------------------------------------------------

    def container_create(self, name: str, config: dict) -> str:
        out = self._request("POST", f"/containers/create?name={name}", config)
        return out["Id"]

    def container_start(self, cid: str) -> None:
        self._request("POST", f"/containers/{cid}/start")

    def container_stop(self, cid: str, timeout_s: int) -> None:
        self._request(
            "POST",
            f"/containers/{cid}/stop?t={int(timeout_s)}",
            timeout_s=timeout_s + 15,
        )

    def container_kill(self, cid: str, signal: str = "SIGKILL") -> None:
        self._request("POST", f"/containers/{cid}/kill?signal={signal}")

    def container_remove(self, cid: str, force: bool = False) -> None:
        f = "true" if force else "false"
        self._request("DELETE", f"/containers/{cid}?force={f}&v=true")

    def container_inspect(self, cid: str) -> dict:
        return self._request("GET", f"/containers/{cid}/json")

    def container_wait(self, cid: str, timeout_s: Optional[float] = None) -> int:
        out = self._request(
            "POST", f"/containers/{cid}/wait", timeout_s=timeout_s or 10**8
        )
        return int(out.get("StatusCode", -1))

    def container_stats(self, cid: str) -> dict:
        return self._request("GET", f"/containers/{cid}/stats?stream=false")

    def container_logs_stream(self, cid: str, since: int = 0):
        """(conn, resp) for the multiplexed follow stream."""
        return self._request(
            "GET",
            f"/containers/{cid}/logs?follow=true&stdout=true&stderr=true"
            f"&since={since}",
            timeout_s=10**8,
            stream=True,
        )

    # -- exec -------------------------------------------------------------

    def exec_create(self, cid: str, cmd: list[str], tty: bool) -> str:
        out = self._request(
            "POST",
            f"/containers/{cid}/exec",
            {
                "AttachStdin": True,
                "AttachStdout": True,
                "AttachStderr": True,
                "Tty": tty,
                "Cmd": cmd,
            },
        )
        return out["Id"]

    def exec_start_socket(self, exec_id: str, tty: bool) -> socket.socket:
        """Start the exec and hijack the connection into a raw socket.

        Hand-rolled handshake: http.client buffers past the headers, which
        would swallow the first stream bytes — instead the response head is
        read byte-wise up to the blank line and the socket handed over
        clean."""
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self.timeout_s)
        try:
            sock.connect(self.socket_path)
            body = json.dumps({"Detach": False, "Tty": tty}).encode()
            req = (
                f"POST /{API_VERSION}/exec/{exec_id}/start HTTP/1.1\r\n"
                f"Host: localhost\r\nContent-Type: application/json\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"Connection: Upgrade\r\nUpgrade: tcp\r\n\r\n"
            ).encode() + body
            sock.sendall(req)
            head = b""
            while b"\r\n\r\n" not in head:
                b = sock.recv(1)
                if not b:
                    raise DriverError("exec start: connection closed")
                head += b
            status_line = head.split(b"\r\n", 1)[0].decode(errors="replace")
            parts = status_line.split()
            status = int(parts[1]) if len(parts) > 1 else 500
            if status >= 400:
                raise DockerAPIError(status, status_line)
            sock.settimeout(None)
            return sock
        except DriverError:
            sock.close()
            raise
        except (OSError, ValueError) as e:
            sock.close()
            raise DriverError(f"exec start failed: {e}") from e

    def exec_inspect(self, exec_id: str) -> dict:
        return self._request("GET", f"/exec/{exec_id}/json")


def demux_stream(read_fn, on_stdout, on_stderr) -> None:
    """Decode Docker's 8-byte-header multiplexed stream until EOF
    (reference: stdcopy). read_fn(n) -> bytes ('' on EOF)."""
    buf = b""
    while True:
        while len(buf) < 8:
            chunk = read_fn(8 - len(buf))
            if not chunk:
                return
            buf += chunk
        kind, length = buf[0], struct.unpack(">I", buf[4:8])[0]
        buf = buf[8:]
        while len(buf) < length:
            chunk = read_fn(length - len(buf))
            if not chunk:
                return
            buf += chunk
        payload, buf = buf[:length], buf[length:]
        (on_stderr if kind == 2 else on_stdout)(payload)


class PullCoordinator:
    """One in-flight pull per image ref; concurrent requesters wait for
    the winner's outcome (reference drivers/docker/coordinator.go)."""

    def __init__(self, api: DockerAPI) -> None:
        self.api = api
        self._lock = threading.Lock()
        self._inflight: dict[str, threading.Event] = {}
        self._results: dict[str, Optional[Exception]] = {}

    def pull(self, ref: str, timeout_s: float = 300.0) -> None:
        with self._lock:
            ev = self._inflight.get(ref)
            if ev is None:
                ev = self._inflight[ref] = threading.Event()
                owner = True
            else:
                owner = False
        if not owner:
            if not ev.wait(timeout_s):
                raise DriverError(f"pull {ref}: timed out waiting on peer")
            err = self._results.get(ref)
            if err is not None:
                raise DriverError(f"pull {ref} failed: {err}")
            return
        err: Optional[Exception] = None
        try:
            self.api.image_pull(ref, timeout_s)
        except Exception as e:
            err = e
        finally:
            with self._lock:
                self._results[ref] = err
                self._inflight.pop(ref, None)
            ev.set()
        if err is not None:
            raise DriverError(f"pull {ref} failed: {err}")


class _DockerTask:
    def __init__(self, cfg: TaskConfig, cid: str) -> None:
        self.cfg = cfg
        self.cid = cid
        self.exit: Optional[ExitResult] = None
        self.done = threading.Event()
        self.started_ns = time.time_ns()
        self.completed_ns = 0
        self._log_conn = None


_NAME_RE = re.compile(r"[^a-zA-Z0-9_.-]")


class DockerDriver(Driver):
    """Reference parity: drivers/docker/driver.go StartTask :370,
    pull dedup via coordinator.go, docklog via the logs follow stream."""

    # volume_mounts become real (ro-capable) binds, not symlinks
    bind_mounts = True

    name = "docker"

    def __init__(self, socket_path: Optional[str] = None) -> None:
        # NOMAD_DOCKER_SOCKET mirrors the reference's docker.endpoint
        # plugin config knob (tests point it at a fake daemon).
        if socket_path is None:
            socket_path = os.environ.get("NOMAD_DOCKER_SOCKET", DEFAULT_SOCKET)
        self.api = DockerAPI(socket_path)
        self.coordinator = PullCoordinator(self.api)
        self.tasks: dict[str, _DockerTask] = {}
        self._lock = threading.Lock()

    # -- fingerprint ----------------------------------------------------

    def fingerprint(self) -> Fingerprint:
        if not os.path.exists(self.api.socket_path) or not self.api.ping():
            return Fingerprint(
                attributes={},
                health=HEALTH_STATE_UNDETECTED,
                health_description="docker daemon not reachable",
            )
        try:
            v = self.api.version()
        except DriverError:
            v = {}
        return Fingerprint(
            attributes={
                "driver.docker": "1",
                "driver.docker.version": str(v.get("Version", "unknown")),
            },
            health=HEALTH_STATE_HEALTHY,
            health_description="",
        )

    # -- lifecycle ------------------------------------------------------

    def start_task(self, cfg: TaskConfig) -> TaskHandle:
        from .configspec import DOCKER_SPEC

        conf = DOCKER_SPEC.validate(cfg.config, "docker")
        image = conf["image"]
        if conf.get("force_pull") or self.api.image_inspect(image) is None:
            self.coordinator.pull(image)

        env = [f"{k}={v}" for k, v in (cfg.env or {}).items()]
        binds = list(conf.get("volumes") or [])
        if cfg.task_dir:
            # the task dir rides at /local like the reference's task mounts
            binds.append(f"{cfg.task_dir}:/local")
        # group-volume mounts resolved by the task runner (host + CSI);
        # container paths must be absolute for the Docker API, so a
        # relative destination roots at / (the filesystem drivers root
        # theirs at the task dir)
        for m in getattr(cfg, "mounts", None) or []:
            mode = ":ro" if m.get("read_only") else ""
            dest = m["task_path"]
            if not dest.startswith("/"):
                dest = "/" + dest
            binds.append(f"{m['host_path']}:{dest}{mode}")
        host_config: dict[str, Any] = {
            "Binds": binds,
            "Memory": int(
                cfg.resources_memory_max_mb or cfg.resources_memory_mb
            ) * 1024 * 1024,
            "CpuShares": int(cfg.resources_cpu),
        }
        if conf.get("network_mode"):
            host_config["NetworkMode"] = conf["network_mode"]
        create: dict[str, Any] = {
            "Image": image,
            "Env": env,
            "HostConfig": host_config,
            "Labels": {
                "nomad_tpu_torch.task_id": cfg.id,
                "nomad_tpu_torch.alloc_id": cfg.alloc_id,
                **(conf.get("labels") or {}),
            },
        }
        if conf.get("entrypoint"):
            create["Entrypoint"] = list(conf["entrypoint"])
        cmd: list[str] = []
        if conf.get("command"):
            cmd.append(conf["command"])
        cmd.extend(conf.get("args") or [])
        if cmd:
            create["Cmd"] = cmd
        if conf.get("work_dir"):
            create["WorkingDir"] = conf["work_dir"]
        if cfg.user:
            create["User"] = cfg.user

        # Keep the FRONT of the id (the alloc uuid that makes it unique)
        # and add a digest suffix: tail-truncation could collide two
        # allocs of a long-named task and the 409 retry would then
        # force-remove a healthy container.
        import hashlib

        digest = hashlib.sha256(cfg.id.encode()).hexdigest()[:8]
        cname = f"nomad-{_NAME_RE.sub('-', cfg.id)[:46]}-{digest}"
        try:
            cid = self.api.container_create(cname, create)
        except DockerAPIError as e:
            if e.status == 409:
                # leftover from a crashed run: remove and retry once
                # (reference driver.go createContainer purge semantics)
                try:
                    self.api.container_remove(cname, force=True)
                except DriverError:
                    pass
                cid = self.api.container_create(cname, create)
            else:
                raise
        self.api.container_start(cid)

        task = _DockerTask(cfg, cid)
        with self._lock:
            self.tasks[cfg.id] = task
        self._spawn_waiter(task)
        self._spawn_log_pump(task, since=0)
        return TaskHandle(
            cfg.id,
            self.name,
            {
                "container_id": cid,
                "task_name": cfg.name,
                "stdout_path": cfg.stdout_path,
                "stderr_path": cfg.stderr_path,
            },
        )

    def _spawn_waiter(self, task: _DockerTask) -> None:
        def waiter():
            code = -1
            oom = False
            try:
                code = self.api.container_wait(task.cid)
                try:
                    st = self.api.container_inspect(task.cid)["State"]
                    oom = bool(st.get("OOMKilled"))
                except DriverError:
                    pass
            except DriverError as e:
                task.exit = ExitResult(exit_code=-1, err=str(e))
            if task.exit is None:
                task.exit = ExitResult(exit_code=code, oom_killed=oom)
            task.completed_ns = time.time_ns()
            task.done.set()

        threading.Thread(
            target=waiter, daemon=True, name=f"docker-wait-{task.cid[:12]}"
        ).start()

    def _spawn_log_pump(self, task: _DockerTask, since: int) -> None:
        """The docklog analog: follow the container's multiplexed log
        stream and append to the task's stdout/stderr files, where the
        existing logmon rotation + FS.logs streaming pick them up."""
        cfg = task.cfg
        if not cfg.stdout_path:
            return

        def pump():
            try:
                conn, resp = self.api.container_logs_stream(task.cid, since)
            except DriverError:
                return
            task._log_conn = conn
            try:
                with open(cfg.stdout_path, "ab") as out_f, open(
                    cfg.stderr_path or cfg.stdout_path, "ab"
                ) as err_f:
                    def w(f):
                        def write(b):
                            f.write(b)
                            f.flush()
                        return write

                    demux_stream(resp.read, w(out_f), w(err_f))
            except (OSError, ValueError, AttributeError):
                # AttributeError: destroy_task tore the connection down
                # under us (http.client nulls resp.fp on close)
                pass
            finally:
                conn.close()

        threading.Thread(
            target=pump, daemon=True, name=f"docker-log-{task.cid[:12]}"
        ).start()

    def _get(self, task_id: str) -> _DockerTask:
        with self._lock:
            task = self.tasks.get(task_id)
        if task is None:
            raise DriverError(f"unknown task {task_id}")
        return task

    def wait_task(
        self, task_id: str, timeout_s: Optional[float] = None
    ) -> Optional[ExitResult]:
        task = self._get(task_id)
        if not task.done.wait(timeout_s):
            return None
        return task.exit

    def stop_task(self, task_id: str, timeout_s: float, signal: str = "") -> None:
        task = self._get(task_id)
        try:
            if signal and signal not in ("SIGTERM", "TERM"):
                self.api.container_kill(task.cid, signal)
                if not task.done.wait(timeout_s):
                    self.api.container_kill(task.cid, "SIGKILL")
            else:
                # docker stop = SIGTERM, grace period, SIGKILL
                self.api.container_stop(task.cid, int(max(1, timeout_s)))
        except DockerAPIError as e:
            if e.status not in (304, 404, 409):  # already stopped/gone
                raise

    def destroy_task(self, task_id: str, force: bool = False) -> None:
        task = self._get(task_id)
        if not task.done.is_set() and not force:
            raise DriverError("task still running; use force")
        try:
            self.api.container_remove(task.cid, force=True)
        except DockerAPIError as e:
            if e.status != 404:
                raise
        self._close_log_conn(task)
        with self._lock:
            self.tasks.pop(task_id, None)

    @staticmethod
    def _close_log_conn(task: _DockerTask) -> None:
        """Force the follow-stream down: shut the raw socket first so a
        pump thread blocked mid-recv unblocks immediately (plain
        HTTPConnection.close() would wait for the response to drain)."""
        conn = task._log_conn
        if conn is None:
            return
        try:
            if conn.sock is not None:
                conn.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            conn.close()
        except OSError:
            pass

    def inspect_task(self, task_id: str) -> TaskStatus:
        task = self._get(task_id)
        state = TASK_STATE_UNKNOWN
        try:
            st = self.api.container_inspect(task.cid)["State"]
            state = TASK_STATE_RUNNING if st.get("Running") else TASK_STATE_EXITED
        except DriverError:
            if task.done.is_set():
                state = TASK_STATE_EXITED
        return TaskStatus(
            id=task_id,
            name=task.cfg.name,
            state=state,
            started_at_ns=task.started_ns,
            completed_at_ns=task.completed_ns,
            exit_result=task.exit,
        )

    def task_stats(self, task_id: str) -> dict[str, Any]:
        task = self._get(task_id)
        try:
            s = self.api.container_stats(task.cid) or {}
        except DriverError:
            return {}
        cpu = s.get("cpu_stats", {}).get("cpu_usage", {})
        mem = s.get("memory_stats", {})
        return {
            "cpu_user_s": cpu.get("usage_in_usermode", 0) / 1e9,
            "cpu_system_s": cpu.get("usage_in_kernelmode", 0) / 1e9,
            "memory_rss_bytes": mem.get("usage", 0),
            "memory_cgroup_bytes": mem.get("limit", -1),
        }

    def signal_task(self, task_id: str, signal: str) -> None:
        task = self._get(task_id)
        self.api.container_kill(task.cid, signal)

    # -- exec ------------------------------------------------------------

    def exec_task_streaming(self, task_id: str, cmd: list[str], tty: bool = False):
        task = self._get(task_id)
        exec_id = self.api.exec_create(task.cid, cmd, tty)
        sock = self.api.exec_start_socket(exec_id, tty)
        return sock

    def exec_task(
        self, task_id: str, cmd: list[str], timeout_s: float = 30.0
    ) -> tuple[bytes, int]:
        """One-shot exec. timeout_s is a WALL-CLOCK bound: on expiry the
        partial output returns with exit code 124 (the exec driver's
        convention), never a silent -1."""
        task = self._get(task_id)
        exec_id = self.api.exec_create(task.cid, cmd, tty=False)
        sock = self.api.exec_start_socket(exec_id, tty=False)
        out = bytearray()
        deadline = time.monotonic() + timeout_s
        timed_out = False
        try:
            def read_fn(n):
                nonlocal timed_out
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    timed_out = True
                    return b""
                sock.settimeout(remaining)
                try:
                    return sock.recv(n)
                except TimeoutError:
                    timed_out = True
                    return b""
                except OSError:
                    return b""

            demux_stream(read_fn, out.extend, out.extend)
        finally:
            sock.close()
        if timed_out:
            return bytes(out), 124
        poll_deadline = time.monotonic() + 5.0
        code = -1
        while time.monotonic() < poll_deadline:
            info = self.api.exec_inspect(exec_id)
            if not info.get("Running", False):
                code = int(info.get("ExitCode") or 0)
                break
            time.sleep(0.05)
        return bytes(out), code

    # -- recovery --------------------------------------------------------

    def recover_task(self, handle: TaskHandle) -> None:
        cid = handle.state.get("container_id")
        if not cid:
            raise DriverError("no container_id in handle")
        try:
            st = self.api.container_inspect(cid)["State"]
        except DriverError as e:
            raise DriverError(f"container {cid[:12]} is gone: {e}") from e
        cfg = TaskConfig(
            id=handle.task_id,
            name=handle.state.get("task_name", ""),
            stdout_path=handle.state.get("stdout_path", ""),
            stderr_path=handle.state.get("stderr_path", ""),
        )
        task = _DockerTask(cfg, cid)
        with self._lock:
            self.tasks[handle.task_id] = task
        if st.get("Running"):
            self._spawn_waiter(task)
            self._spawn_log_pump(task, since=int(time.time()))
        else:
            task.exit = ExitResult(exit_code=int(st.get("ExitCode", -1)))
            task.completed_ns = time.time_ns()
            task.done.set()
