"""Task runner: one task's lifecycle state machine.

Port of ``nomad_tpu/client/taskrunner.py``.

Reference: client/allocrunner/taskrunner/task_runner.go — the MAIN loop
:516 (restore → hooks → dispatch driver → wait → restart tracker →
repeat), task event recording, kill handling. Hook pipeline
(task_runner_hooks.go:63-159 subset): task dir → env build → artifacts →
templates → logmon → driver dispatch, with the driver handle persisted
for reattach (Restore :1065).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Callable, Optional

from ..drivers import Driver, DriverError, TaskConfig
from ..drivers.base import TaskHandle
from ..structs import Allocation, Node, Task, TaskState, now_ns
from .allocdir import AllocDir
from .getter import ArtifactError, fetch_artifact
from .logmon import LogRotator
from .restarts import DECISION_RESTART, RestartTracker
from .taskenv import build_env, interpolate
from .template import TemplateError, render_template
from .vaultclient import VaultClientError

logger = logging.getLogger("nomad_tpu_torch.taskrunner")

EVENT_RECEIVED = "Received"
EVENT_TASK_SETUP = "Task Setup"
EVENT_ARTIFACTS = "Downloading Artifacts"
EVENT_TEMPLATES = "Rendering Templates"
EVENT_STARTED = "Started"
EVENT_TERMINATED = "Terminated"
EVENT_RESTARTING = "Restarting"
EVENT_NOT_RESTARTING = "Not Restarting"
EVENT_KILLING = "Killing"
EVENT_KILLED = "Killed"
EVENT_DRIVER_FAILURE = "Driver Failure"
EVENT_SETUP_FAILURE = "Setup Failure"
EVENT_RESTORED = "Restored"
EVENT_SIGNALING = "Signaling"


class TaskRunner:
    def __init__(
        self,
        alloc: Allocation,
        task: Task,
        driver: Driver,
        alloc_dir: AllocDir,
        on_state_change,
        batch: bool = False,
        node: Optional[Node] = None,
        on_handle: Optional[Callable[[str, dict], None]] = None,
        restore_handle: Optional[dict] = None,
        restore_state: Optional[TaskState] = None,
        device_manager=None,  # the client's configured DeviceManager
        volume_paths: Optional[dict] = None,  # volume name -> (path, ro)
        service_fn=None,  # (name) -> [ServiceRegistration] (native SD)
        secret_fn=None,  # (path) -> SecretEntry | None (embedded Vault)
        vault_client=None,  # the client's VaultClient (token lifecycle)
        network_ns: str = "",  # bridge mode: the alloc's netns path
    ) -> None:
        self.network_ns = network_ns
        self.device_manager = device_manager
        self.volume_paths = volume_paths or {}
        self.service_fn = service_fn
        self.secret_fn = secret_fn
        self.vault_client = vault_client
        self._vault_accessor: Optional[str] = None
        self._vault_secret: str = ""
        self.alloc = alloc
        self.task = task
        self.driver = driver
        self.alloc_dir = alloc_dir
        self.on_state_change = on_state_change
        self.batch = batch
        self.node = node
        self.on_handle = on_handle  # persist driver handles (state db)
        self.restore_handle = restore_handle
        self.task_id = f"{alloc.id[:8]}/{task.name}"
        self.state = restore_state or TaskState(state="pending")
        self.restart_tracker = RestartTracker(self._restart_policy())
        self._kill = threading.Event()
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._rotators: list[LogRotator] = []
        self._template_restart = threading.Event()
        # check_restart trips: like a template restart but CONSUMES the
        # restart-policy budget (reference check_watcher → restartTracker
        # SetRestartTriggered(failure=true)) so flapping converges to
        # failed instead of bouncing forever
        self._failure_restart = threading.Event()
        self._failure_restart_reason = ""
        # instance token: the started_at_ns the trip was aimed at — a
        # trip raised against a PREVIOUS instance (set during the
        # stop/backoff window while state still reads "running") must
        # not kill the fresh one
        self._failure_restart_token = 0
        self._tmpl_watcher = None
        # template re-render poll cadence (env knob so tests can shrink it
        # through the full client stack)
        import os as _os

        self.template_poll_interval_s = float(
            _os.environ.get("NOMAD_TEMPLATE_POLL_INTERVAL", "2.0")
        )

    def trigger_restart(self) -> None:
        """Operator-initiated restart (reference alloc restart): bounces
        the task WITHOUT consuming the restart policy budget — same path
        a template change_mode=restart rides. A dead/backoff task has no
        process to bounce (the reference returns "Task not running")."""
        if self.state.state != "running":
            raise RuntimeError(
                f"task {self.task.name!r} is not running "
                f"({self.state.state})"
            )
        self._template_restart.set()

    def trigger_failure_restart(self, reason: str) -> None:
        """Health-check-initiated restart (reference check_watcher.go):
        counts against the restart policy. No-op unless running."""
        if self.state.state != "running":
            return
        self._failure_restart_token = self.state.started_at_ns
        self._failure_restart_reason = reason
        self._failure_restart.set()

    def signal(self, sig: str) -> None:
        """Operator-initiated signal (reference alloc signal)."""
        self.driver.signal_task(self.task_id, sig)

    def _restart_policy(self):
        from ..structs import RestartPolicy

        tg = self.alloc.job.lookup_task_group(self.alloc.task_group) if self.alloc.job else None
        return tg.restart_policy if tg is not None else RestartPolicy()

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.run, daemon=True, name=f"task-{self.task_id}"
        )
        self._thread.start()

    def run(self) -> None:
        """The MAIN loop (reference task_runner.go:516)."""
        try:
            self._run()
        finally:
            for r in self._rotators:
                r.stop()
            self._stop_template_watcher()
            if self._vault_accessor and self.vault_client is not None:
                # task is done for good: stop renewing + revoke the
                # derived token (reference task_runner vault_hook)
                self.vault_client.stop_renew(self._vault_accessor)
                self._vault_accessor = None

    def _run(self) -> None:
        self._event(EVENT_RECEIVED)
        task_dir = self.alloc_dir.build_task_dir(self.task.name)
        env = build_env(
            self.alloc,
            self.task,
            node=self.node,
            alloc_dir=self.alloc_dir.shared_dir,
            task_dir=task_dir.local_dir,
            secrets_dir=task_dir.secrets_dir,
        )
        # Assigned device instances → visibility env vars (the scheduler
        # picked the ids; reference: device plugin Reserve response).
        if self.alloc.resources is not None:
            tr_res = self.alloc.resources.tasks.get(self.task.name)
            if tr_res is not None and getattr(tr_res, "devices", None):
                dm = self.device_manager
                if dm is None:
                    from .devicemanager import DeviceManager

                    dm = DeviceManager()
                env.update(dm.task_env(tr_res))
        self._event(EVENT_TASK_SETUP)

        # Restore path: reattach to a live task instead of starting a new
        # one (reference Restore :1065 → driver RecoverTask).
        restored = False
        if self.restore_handle is not None:
            try:
                self.driver.recover_task(TaskHandle.from_dict(self.restore_handle))
                restored = True
                self._resume_vault_token(task_dir, env)
                self._event(EVENT_RESTORED)
                self.state.state = "running"
                self.on_state_change()
            except DriverError as e:
                logger.info(
                    "task %s: reattach failed (%s); restarting", self.task_id, e
                )

        while not self._kill.is_set():
            if not restored:
                # prestart hooks: artifacts then templates
                try:
                    self._prestart(task_dir, env)
                except (ArtifactError, TemplateError, VaultClientError) as e:
                    self._event(EVENT_SETUP_FAILURE, str(e))
                    if not self._maybe_restart(success=False):
                        return
                    continue
                try:
                    handle = self.driver.start_task(
                        self._task_config(task_dir, env)
                    )
                    if self.on_handle is not None:
                        self.on_handle(self.task.name, handle.to_dict())
                except DriverError as e:
                    self._event(EVENT_DRIVER_FAILURE, str(e))
                    if not self._maybe_restart(success=False):
                        return
                    continue
                self.state.state = "running"
                self.state.started_at_ns = now_ns()
                self._event(EVENT_STARTED)
                self.on_state_change()
                self._start_logmon()
                self._start_template_watcher(task_dir, env)
            restored = False

            # wait for exit OR kill OR a template-triggered restart
            result = None
            while result is None and not self._kill.is_set():
                if self._template_restart.is_set():
                    break
                if self._failure_restart.is_set():
                    if (
                        self._failure_restart_token
                        == self.state.started_at_ns
                    ):
                        break
                    # stale: aimed at a previous instance
                    self._failure_restart.clear()
                try:
                    result = self.driver.wait_task(self.task_id, timeout_s=0.2)
                except DriverError:
                    break
            # a trip aimed at a PREVIOUS instance is stale however the
            # wait loop exited (it may have broken on template/kill
            # before the in-loop staleness check ran)
            if (
                self._failure_restart.is_set()
                and self._failure_restart_token
                != self.state.started_at_ns
            ):
                self._failure_restart.clear()
            # a kill always wins over pending restarts: acting on a
            # restart first would spawn a throwaway instance
            if (
                self._failure_restart.is_set()
                and result is None
                and not self._kill.is_set()
            ):
                self._failure_restart.clear()
                # a concurrently pending template restart is satisfied
                # by this bounce too — the new instance starts from the
                # latest rendered templates
                self._template_restart.clear()
                self._event(
                    EVENT_RESTARTING,
                    self._failure_restart_reason or "unhealthy check",
                )
                try:
                    self.driver.stop_task(self.task_id, self.task.kill_timeout_s)
                    self.driver.destroy_task(self.task_id, force=True)
                except DriverError:
                    pass
                if not self._maybe_restart(success=False):
                    return
                continue
            if (
                self._template_restart.is_set()
                and result is None
                and not self._kill.is_set()
            ):
                # change_mode=restart fired: bounce the task WITHOUT
                # consuming the restart policy's budget (reference
                # restarts.go SetRestartTriggered).
                self._template_restart.clear()
                self._event(EVENT_RESTARTING, "template re-rendered")
                try:
                    self.driver.stop_task(self.task_id, self.task.kill_timeout_s)
                    self.driver.destroy_task(self.task_id, force=True)
                except DriverError:
                    pass
                self.state.restarts += 1
                self.state.last_restart_ns = now_ns()
                self.on_state_change()
                continue
            if self._kill.is_set():
                self._event(EVENT_KILLING)
                try:
                    self.driver.stop_task(self.task_id, self.task.kill_timeout_s)
                    self.driver.destroy_task(self.task_id, force=True)
                except DriverError:
                    pass
                self.state.state = "dead"
                self.state.finished_at_ns = now_ns()
                self._event(EVENT_KILLED)
                self.on_state_change()
                self._done.set()
                return
            if result is None:
                # driver lost track of the task (e.g. reattach went stale)
                self._event(EVENT_DRIVER_FAILURE, "task lost")
                if not self._maybe_restart(success=False):
                    return
                continue

            # the task exited on its own: a restart request that raced
            # the exit is stale — acting on it would kill the NEXT
            # instance within a beat (and charge the budget)
            self._failure_restart.clear()
            self._template_restart.clear()
            success = result.successful()
            self._event(
                EVENT_TERMINATED,
                f"exit_code={result.exit_code} signal={result.signal}",
            )
            try:
                self.driver.destroy_task(self.task_id, force=True)
            except DriverError:
                pass

            if success and self.batch:
                self.state.state = "dead"
                self.state.failed = False
                self.state.finished_at_ns = now_ns()
                self.on_state_change()
                self._done.set()
                return

            if not self._maybe_restart(success=success):
                return
        # Killed while between runs (e.g. during a restart delay).
        if self.state.state != "dead":
            self.state.state = "dead"
            self.state.finished_at_ns = now_ns()
            self._event(EVENT_KILLED)
            self.on_state_change()
        self._done.set()

    # -- hooks ---------------------------------------------------------

    def _secret_lookup(self, path: str):
        """Template {{ secret }} reads authenticate with the TASK'S
        derived token — a task without a vault stanza has no token and
        (under ACL enforcement) reads nothing."""
        if self.secret_fn is None:
            return None
        return self.secret_fn(path, self._vault_secret)

    def _resume_vault_token(self, task_dir, env: dict[str, str]) -> None:
        """Client-restart restore: re-enroll the persisted token for
        renewal so it doesn't silently expire mid-run (reference: vault
        tokens ride the client state db and resume renewal on restore).
        env gets VAULT_TOKEN back too, so a later restart of the restored
        task starts its fresh process with the token."""
        if not self.task.vault or self.vault_client is None:
            return
        try:
            with open(
                os.path.join(task_dir.secrets_dir, ".vault_accessor")
            ) as f:
                accessor = f.read().strip()
            with open(
                os.path.join(task_dir.secrets_dir, "vault_token")
            ) as f:
                self._vault_secret = f.read().strip()
        except OSError:
            return
        if accessor:
            self._vault_accessor = accessor
            self.vault_client.track(accessor)
            if self.task.vault.get("env", True) and self._vault_secret:
                env["VAULT_TOKEN"] = self._vault_secret

    def _prestart(self, task_dir, env: dict[str, str]) -> None:
        if self.task.vault and self.vault_client is not None \
                and self._vault_accessor is None:
            # derive the task's secrets token (reference vault_hook
            # Prestart: block task start until the token exists)
            try:
                tok = self.vault_client.derive_token(
                    self.alloc.id, self.task.name
                )
            except Exception as e:
                raise VaultClientError(f"deriving task token: {e}") from e
            self._vault_accessor = tok["accessor_id"]
            self._vault_secret = tok["secret_id"]
            token_path = os.path.join(task_dir.secrets_dir, "vault_token")
            with open(token_path, "w") as f:
                f.write(tok["secret_id"])
            os.chmod(token_path, 0o600)
            # accessor persisted beside the token: a restarted client
            # resumes renewal instead of letting the token expire
            acc_path = os.path.join(task_dir.secrets_dir, ".vault_accessor")
            with open(acc_path, "w") as f:
                f.write(tok["accessor_id"])
            os.chmod(acc_path, 0o600)
            if self.task.vault.get("env", True):
                env["VAULT_TOKEN"] = tok["secret_id"]
        if self.task.artifacts:
            self._event(EVENT_ARTIFACTS)
            for artifact in self.task.artifacts:
                fetch_artifact(artifact, task_dir.dir, env)
        if self.task.templates:
            self._event(EVENT_TEMPLATES)
            for tmpl in self.task.templates:
                render_template(
                    tmpl, task_dir.dir, env, self.service_fn,
                    self._secret_lookup,
                )

    def _start_template_watcher(self, task_dir, env: dict[str, str]) -> None:
        """change_mode lives here: the watcher re-renders and fires
        signal/restart (reference template.go runner + task runner's
        template hook)."""
        from .template import TemplateWatcher

        self._stop_template_watcher()  # joins: no straggler set() after
        self._template_restart.clear()
        if not self.task.templates:
            return
        # noop templates are WATCHED too (consul-template semantics:
        # re-render on change, take no action) — the connect sidecar's
        # upstream address files depend on exactly that.
        dynamic = list(self.task.templates)

        def signal_fn(sig: str) -> None:
            try:
                self.driver.signal_task(self.task_id, sig)
                self._event(EVENT_SIGNALING, f"template re-rendered: {sig}")
            except DriverError as e:
                logger.warning("template signal failed: %s", e)

        watcher = TemplateWatcher(
            dynamic,
            task_dir.dir,
            env,
            signal_fn=signal_fn,
            restart_fn=self._template_restart.set,
            poll_interval_s=self.template_poll_interval_s,
            service_fn=self.service_fn,
            secret_fn=self._secret_lookup,
        )
        watcher.prime()
        watcher.start()
        self._tmpl_watcher = watcher

    def _stop_template_watcher(self) -> None:
        if self._tmpl_watcher is not None:
            self._tmpl_watcher.stop()
            self._tmpl_watcher = None

    def _start_logmon(self) -> None:
        for r in self._rotators:
            r.stop()
        self._rotators = []
        lc = self.task.log_config
        for path in (
            self.alloc_dir.stdout_path(self.task.name),
            self.alloc_dir.stderr_path(self.task.name),
        ):
            rot = LogRotator(
                path,
                max_files=lc.max_files,
                max_file_size_mb=lc.max_file_size_mb,
            )
            rot.start()
            self._rotators.append(rot)

    def _maybe_restart(self, success: bool) -> bool:
        """Consult the restart tracker. False ⇒ terminal (caller returns)."""
        decision, delay = self.restart_tracker.next_restart(
            exit_success=success, batch=self.batch
        )
        if decision == DECISION_RESTART:
            self.state.restarts += 1
            self.state.last_restart_ns = now_ns()
            self._event(EVENT_RESTARTING, f"in {delay:.1f}s")
            self.on_state_change()
            self._kill.wait(delay)
            return True
        if success:
            self.state.state = "dead"
            self.state.failed = False
        else:
            self._event(EVENT_NOT_RESTARTING)
            self.state.failed = True
            self.state.state = "dead"
        self.state.finished_at_ns = now_ns()
        self.on_state_change()
        self._done.set()
        return False

    def kill(self) -> None:
        self._kill.set()

    def wait(self, timeout_s: Optional[float] = None) -> bool:
        return self._done.wait(timeout_s)

    def _setup_volume_mounts(self, task_dir) -> list[dict]:
        """Materialize task.volume_mounts (reference: volume_hook.go).

        Each mount's destination gets a symlink inside the task dir so
        filesystem drivers (exec/rawexec/java) see the volume; the mount
        list also rides TaskConfig.mounts for drivers that bind-mount
        (docker). Destinations are confined to the task dir."""
        from .allocdir import EscapeError, confine

        mounts: list[dict] = []
        for vm in self.task.volume_mounts:
            vp = self.volume_paths.get(vm.volume)
            if vp is None:
                raise DriverError(
                    f"volume_mount {vm.volume!r}: no such group volume "
                    f"resolved on this node"
                )
            host_path, vol_ro = vp
            dest = vm.destination or vm.volume
            try:
                link = confine(task_dir.dir, dest.lstrip("/"))
            except EscapeError as e:
                raise DriverError(str(e)) from None
            os.makedirs(os.path.dirname(link), exist_ok=True)
            if not os.path.lexists(link):
                os.symlink(host_path, link)
            if (vm.read_only or vol_ro) and not getattr(
                self.driver, "bind_mounts", False
            ):
                # Filesystem drivers see the volume through a symlink,
                # which cannot enforce read-only (the reference's exec
                # driver uses real ro bind mounts via libcontainer;
                # raw_exec doesn't support volume_mounts at all). Surface
                # the advisory gap instead of silently dropping it.
                logger.warning(
                    "task %s: read_only mount %r is advisory under driver "
                    "%s (no bind-mount isolation)",
                    self.task_id, vm.volume, self.task.driver,
                )
            mounts.append({
                "host_path": host_path,
                "task_path": dest,
                "read_only": vm.read_only or vol_ro,
            })
        return mounts

    def _task_config(self, task_dir, env: dict[str, str]) -> TaskConfig:
        granted_res = (
            self.alloc.resources.tasks.get(self.task.name)
            if self.alloc.resources is not None
            else None
        )
        return TaskConfig(
            id=self.task_id,
            name=self.task.name,
            alloc_id=self.alloc.id,
            env=env,
            config=interpolate(dict(self.task.config), env),
            # the GRANT, not the ask: a cores task's cpu share is
            # derived (cores x MHz/core) and drives cgroup weight
            resources_cpu=(
                granted_res.cpu
                if granted_res is not None and granted_res.cpu
                else self.task.resources.cpu
            ),
            resources_memory_mb=self.task.resources.memory_mb,
            resources_memory_max_mb=self.task.resources.memory_max_mb,
            reserved_cores=(
                list(granted_res.reserved_cores)
                if granted_res is not None
                else []
            ),
            task_dir=task_dir.dir,
            stdout_path=self.alloc_dir.stdout_path(self.task.name),
            stderr_path=self.alloc_dir.stderr_path(self.task.name),
            user=self.task.user,
            mounts=self._setup_volume_mounts(task_dir),
            network_ns=self.network_ns,
        )

    def _event(self, etype: str, details: str = "") -> None:
        self.state.events.append(
            {"type": etype, "time": now_ns(), "details": details}
        )
