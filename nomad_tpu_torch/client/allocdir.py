"""Per-allocation directory tree.

Port of ``nomad_tpu/client/allocdir.py``.

Reference: client/allocdir/ (~1,500 LoC) — the shared alloc dir
(SharedAllocDir: alloc/data, alloc/logs, alloc/tmp) plus per-task dirs
(TaskDir: local, secrets, tmp, private), and the chroot builder the
exec driver uses (fs_linux.go: the configured chroot_env map is
materialized into the task dir, which then becomes the task's root).
Hard links are used where the filesystem allows (free), falling back
to copies — same economics as the reference's link-or-copy walk.
"""

from __future__ import annotations

import os
import shutil
import stat


SHARED_ALLOC_NAME = "alloc"


class EscapeError(Exception):
    """A job-controlled path tried to escape its sandbox."""


def alloc_sandbox(task_dir: str) -> str:
    """The confinement root for a task's job-controlled paths: the alloc
    dir (its task dirs and the shared alloc/ dir all live under it)."""
    return os.path.dirname(os.path.realpath(task_dir))


def confine(base_dir: str, path: str) -> str:
    """Resolve `path` and require it to stay inside `base_dir`.

    Job-controlled paths (template dest/source, artifact dests) must not
    reach outside the alloc dir — the reference sandboxes the same way
    (go-getter dest + consul-template path escapes were upstream CVEs).
    Symlinks are resolved before the containment check.
    """
    base = os.path.realpath(base_dir)
    resolved = os.path.realpath(
        path if os.path.isabs(path) else os.path.join(base, path)
    )
    if resolved != base and not resolved.startswith(base + os.sep):
        raise EscapeError(f"path {path!r} escapes alloc dir {base_dir!r}")
    return resolved


def build_chroot(chroot_dir: str, chroot_env: dict[str, str]) -> None:
    """Materialize ``{host_src: dst_in_chroot}`` under chroot_dir
    (reference client/allocdir/fs_linux.go buildChroot). Missing
    sources are skipped like the reference (the default map names
    paths not every distro has)."""

    def place(src: str, dst: str) -> None:
        if os.path.islink(src):
            target = os.readlink(src)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            if not os.path.lexists(dst):
                os.symlink(target, dst)
            return
        if os.path.isdir(src):
            try:
                entries = os.listdir(src)
            except OSError:
                return
            os.makedirs(dst, exist_ok=True)
            for name in entries:
                place(os.path.join(src, name), os.path.join(dst, name))
            return
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        if os.path.lexists(dst):
            return
        try:
            os.link(src, dst)  # free when same filesystem
        except OSError:
            try:
                shutil.copy2(src, dst)
            except OSError:
                pass  # unreadable/special file: skip, like the reference

    os.makedirs(chroot_dir, exist_ok=True)
    for src, dst in chroot_env.items():
        if not os.path.lexists(src):
            continue
        # dst is JOB-controlled: a traversal like ../../etc/x would make
        # this root-privileged walk write onto the host — confine it
        target = confine(chroot_dir, dst.lstrip("/"))
        place(src, target)


class AllocDir:
    def __init__(self, base_dir: str, alloc_id: str) -> None:
        self.alloc_dir = os.path.join(base_dir, "allocs", alloc_id)
        self.shared_dir = os.path.join(self.alloc_dir, SHARED_ALLOC_NAME)

    # shared paths
    @property
    def logs_dir(self) -> str:
        return os.path.join(self.shared_dir, "logs")

    @property
    def data_dir(self) -> str:
        return os.path.join(self.shared_dir, "data")

    @property
    def tmp_dir(self) -> str:
        return os.path.join(self.shared_dir, "tmp")

    def build(self) -> None:
        for d in (self.logs_dir, self.data_dir, self.tmp_dir):
            os.makedirs(d, exist_ok=True)

    def task_dir(self, task_name: str) -> "TaskDir":
        return TaskDir(self.alloc_dir, task_name)

    def build_task_dir(self, task_name: str) -> "TaskDir":
        td = self.task_dir(task_name)
        td.build()
        return td

    def destroy(self) -> None:
        shutil.rmtree(self.alloc_dir, ignore_errors=True)

    def stdout_path(self, task_name: str) -> str:
        return os.path.join(self.logs_dir, f"{task_name}.stdout.0")

    def stderr_path(self, task_name: str) -> str:
        return os.path.join(self.logs_dir, f"{task_name}.stderr.0")


class TaskDir:
    def __init__(self, alloc_dir: str, task_name: str) -> None:
        self.dir = os.path.join(alloc_dir, task_name)
        self.local_dir = os.path.join(self.dir, "local")
        self.secrets_dir = os.path.join(self.dir, "secrets")
        self.tmp_dir = os.path.join(self.dir, "tmp")

    def build(self) -> None:
        os.makedirs(self.local_dir, exist_ok=True)
        os.makedirs(self.tmp_dir, exist_ok=True)
        os.makedirs(self.secrets_dir, exist_ok=True)
        # secrets are owner-only (reference: tmpfs mount 0700 when root)
        os.chmod(self.secrets_dir, stat.S_IRWXU)
