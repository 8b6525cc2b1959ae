"""Python side of the native executor.

Port of ``nomad_tpu/drivers/executor.py``.

Reference: drivers/shared/executor — the Go client half that talks gRPC
to the out-of-process supervisor (z_executor_cmd.go re-attach). Here:
compile `native/executor.cc` once per machine (g++, cached by source
hash), launch it detached, and speak its line protocol over the unix
socket. Re-attach after a client restart = reconnect to the socket.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import socket
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).parent / "native" / "executor.cc"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_BUILD_LOCK = threading.Lock()


class ExecutorError(Exception):
    pass


def executor_binary(cache_dir: Optional[str] = None) -> str:
    """Compile (once) and return the executor binary path.

    The binary goes into the package's own build dir
    (``nomad_tpu_torch/_build/``, beside the fastpack and the kernel
    library) unless ``cache_dir`` names another.
    """
    cache = Path(cache_dir) if cache_dir else _BUILD_DIR
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    out = cache / f"nomad-executor-{tag}"
    if out.exists():
        return str(out)
    with _BUILD_LOCK:
        if out.exists():
            return str(out)
        cache.mkdir(parents=True, exist_ok=True)
        gxx = shutil.which("g++") or shutil.which("c++")
        if gxx is None:
            raise ExecutorError("no C++ compiler available")
        tmp = str(out) + ".tmp"
        proc = subprocess.run(
            [gxx, "-O2", "-std=c++17", "-o", tmp, str(_SRC)],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            # pre-2.34 glibc keeps forkpty in libutil
            proc = subprocess.run(
                [gxx, "-O2", "-std=c++17", "-o", tmp, str(_SRC), "-lutil"],
                capture_output=True,
                text=True,
            )
        if proc.returncode != 0:
            raise ExecutorError(f"executor build failed:\n{proc.stderr}")
        os.replace(tmp, out)
    return str(out)


class ExecutorHandle:
    """Control connection to one running executor."""

    def __init__(self, socket_path: str, daemon_pid: int = 0) -> None:
        self.socket_path = socket_path
        self.daemon_pid = daemon_pid

    # -- protocol ------------------------------------------------------

    def _cmd(self, line: str, timeout_s: Optional[float] = 10.0) -> dict:
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        conn.settimeout(5.0)
        try:
            conn.connect(self.socket_path)
            conn.settimeout(timeout_s)
            conn.sendall(line.encode() + b"\n")
            buf = b""
            while not buf.endswith(b"\n"):
                chunk = conn.recv(4096)
                if not chunk:
                    raise ExecutorError("executor connection closed")
                buf += chunk
        finally:
            conn.close()
        text = buf.decode().strip()
        if text.startswith("err"):
            raise ExecutorError(text[4:] or "executor error")
        out: dict = {}
        for part in text.split()[1:]:
            if "=" in part:
                k, v = part.split("=", 1)
                try:
                    out[k] = int(v)
                except ValueError:
                    out[k] = v
        return out

    def status(self) -> dict:
        return self._cmd("status")

    def wait(self, timeout_s: Optional[float] = None) -> Optional[dict]:
        """Block until the task exits; None on timeout."""
        try:
            return self._cmd("wait", timeout_s=timeout_s)
        except socket.timeout:
            return None

    def signal(self, signo: int) -> None:
        self._cmd(f"signal {signo}")

    def stop(self, grace_s: float = 5.0, signo: int = 15) -> None:
        self._cmd(f"stop {int(grace_s * 1000)} {signo}")

    def stats(self) -> dict:
        return self._cmd("stats")

    def exec_stream(self, args: list[str], tty: bool = False) -> socket.socket:
        """Spawn a process inside the task's containment and return the
        raw bridge socket (pty master or socketpair on the other side).
        Caller owns the socket; closing it kills the exec'd process."""
        if not args:
            raise ExecutorError("exec needs argv")
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        conn.settimeout(5.0)
        try:
            conn.connect(self.socket_path)
            fields = ["exec", "1" if tty else "0"] + list(args)
            line = "\t".join(_esc(f) for f in fields)
            conn.sendall(line.encode() + b"\n")
            # Consume EXACTLY the first line: raw bridge bytes follow the
            # "ok" handshake immediately, and a fast-exiting child's output
            # (and exit trailer) can share the wire with it — recv'ing in
            # chunks "until the buffer ends with newline" swallowed them.
            buf = b""
            while not buf.endswith(b"\n"):
                chunk = conn.recv(1)
                if not chunk:
                    raise ExecutorError("executor connection closed")
                buf += chunk
        except Exception:
            conn.close()
            raise
        text = buf.decode().strip()
        if text.startswith("err"):
            conn.close()
            raise ExecutorError(text[4:] or "exec failed")
        conn.settimeout(None)
        return conn

    def shutdown(self) -> None:
        try:
            self._cmd("shutdown")
        except (ExecutorError, OSError):
            pass

    def alive(self) -> bool:
        try:
            self.status()
            return True
        except (OSError, ExecutorError):
            return False


# AF_UNIX sun_path is 108 bytes on Linux; leave headroom.
_SUN_PATH_MAX = 100


_FALLBACK_RUN_ROOT: Optional[str] = None
_RUN_ROOT_LOCK = threading.Lock()


def _run_root(sock_name_len: int) -> str:
    """Directory for the executors' control sockets.

    ``NOMAD_TPU_TORCH_RUN_DIR`` if set, else ``nomad-tpu-torch-<uid>``
    under the temp dir (``TMPDIR``). Where that temp dir is too deep for
    a socket path, one private dir is made under /tmp for this process
    instead: a task's socket path rides its task handle, so a restarted
    agent reattaches without recomputing it.
    """
    global _FALLBACK_RUN_ROOT
    run_root = os.environ.get("NOMAD_TPU_TORCH_RUN_DIR")
    if run_root:
        return run_root
    run_root = os.path.join(
        tempfile.gettempdir(), f"nomad-tpu-torch-{os.getuid()}"
    )
    if len(run_root) + 1 + sock_name_len <= _SUN_PATH_MAX:
        return run_root
    with _RUN_ROOT_LOCK:
        if _FALLBACK_RUN_ROOT is None:
            _FALLBACK_RUN_ROOT = tempfile.mkdtemp(
                prefix="nomad-tpu-torch-", dir="/tmp"
            )
    return _FALLBACK_RUN_ROOT


def _socket_path(task_dir: str) -> str:
    """Short control-socket path for a task.

    The socket can NOT live under the task dir: pytest tmp_paths (and
    real data_dirs) routinely push the alloc-dir path past the 108-byte
    sun_path limit and bind() fails.  Key a short path under the run
    root (``_run_root``) by task-dir hash instead.
    """
    tag = hashlib.sha256(os.path.abspath(task_dir).encode()).hexdigest()[:16]
    name = f"{tag}.sock"
    run_root = _run_root(len(name))
    os.makedirs(run_root, mode=0o700, exist_ok=True)
    # A shared temp dir is a shared namespace: refuse a squatted dir
    # (pre-created by another user, or loosened perms) the same way sshd
    # treats its run dir — otherwise a local user could hijack root's
    # control sockets.
    st = os.stat(run_root)
    if st.st_uid != os.getuid() or (st.st_mode & 0o077):
        raise ExecutorError(
            f"run dir {run_root} has unsafe owner/mode "
            f"(uid={st.st_uid}, mode={oct(st.st_mode & 0o777)})"
        )
    sock = os.path.join(run_root, name)
    if len(sock) > _SUN_PATH_MAX:
        raise ExecutorError(
            f"socket path too long ({len(sock)} > {_SUN_PATH_MAX}): {sock}"
        )
    return sock


def _esc(val: str) -> str:
    """Escape a spec value for the executor's line/tab-framed format.

    Spec values are job-controlled (env vars, args); a raw newline or
    tab would inject spec directives into the C++ parser (user, stdout,
    ... — privilege escalation when the agent runs as root).  The
    executor unescapes symmetrically.
    """
    return (
        val.replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace("\r", "\\r")
        .replace("\t", "\\t")
    )


def launch_executor(
    task_dir: str,
    command: str,
    args: list[str],
    env: dict[str, str],
    stdout_path: str = "",
    stderr_path: str = "",
    cwd: str = "",
    chroot: str = "",
    user: str = "",
    cgroup: str = "",
    netns: str = "",
    memory_max_bytes: int = 0,
    cpu_weight: int = 0,
    cores: Optional[list] = None,
    cache_dir: Optional[str] = None,
) -> ExecutorHandle:
    """Write the spec, launch the daemonized supervisor, return a handle."""
    binary = executor_binary(cache_dir)
    ctl_dir = Path(task_dir)
    ctl_dir.mkdir(parents=True, exist_ok=True)
    sock = _socket_path(task_dir)
    spec_path = str(ctl_dir / "executor.spec")
    for k in env:
        if "=" in k:
            raise ExecutorError(f"invalid env key {k!r}")
    lines = [f"command\t{_esc(command)}"]
    lines += [f"arg\t{_esc(a)}" for a in args]
    lines += [f"core\t{int(c)}" for c in (cores or [])]
    lines += [f"env\t{_esc(f'{k}={v}')}" for k, v in env.items()]
    if cwd:
        lines.append(f"cwd\t{_esc(cwd)}")
    if netns:
        lines.append(f"netns\t{_esc(netns)}")
    if chroot:
        lines.append(f"chroot\t{_esc(chroot)}")
    if stdout_path:
        lines.append(f"stdout\t{_esc(stdout_path)}")
    if stderr_path:
        lines.append(f"stderr\t{_esc(stderr_path)}")
    lines.append(f"socket\t{_esc(sock)}")
    lines.append(f"pidfile\t{_esc(str(ctl_dir / 'executor.pid'))}")
    if user:
        lines.append(f"user\t{_esc(user)}")
    if cgroup:
        lines.append(f"cgroup\t{_esc(cgroup)}")
        if memory_max_bytes:
            lines.append(f"memory_max\t{memory_max_bytes}")
        if cpu_weight:
            lines.append(f"cpu_weight\t{cpu_weight}")
    Path(spec_path).write_text("\n".join(lines) + "\n")

    # Stdout/stderr are opened AFTER the setuid drop in the executor
    # (so an injected path could never be opened as root); pre-create
    # and chown them here so an unprivileged task user can still append.
    if user and os.geteuid() == 0:
        import pwd

        try:
            pw = pwd.getpwnam(user)
        except KeyError:
            pw = None
        if pw is not None:
            for p in (stdout_path, stderr_path):
                if not p:
                    continue
                Path(p).touch(exist_ok=True)
                os.chown(p, pw.pw_uid, pw.pw_gid)

    proc = subprocess.run(
        [binary, spec_path], capture_output=True, text=True, timeout=30
    )
    if proc.returncode != 0 or not proc.stdout.startswith("READY"):
        raise ExecutorError(
            f"executor launch failed: {proc.stdout} {proc.stderr}"
        )
    daemon_pid = int(proc.stdout.split()[1])
    handle = ExecutorHandle(sock, daemon_pid)
    # The daemon binds before the parent prints READY; still, guard the
    # first connect with a short retry for slow filesystems.
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        if handle.alive():
            return handle
        time.sleep(0.02)
    raise ExecutorError("executor socket never came up")
