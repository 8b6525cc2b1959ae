"""Template rendering.

Port of ``nomad_tpu/client/template.py``.

Reference: client/allocrunner/taskrunner/template/template.go (759 LoC,
consul-template). Without Consul/Vault in the tree, the supported
function set is the env-shaped subset real jobspecs rely on:

    {{ env "NOMAD_ALLOC_ID" }}
    {{ key "path" }}          -> empty string (no Consul KV)
    {{ meta "k" }}            -> NOMAD_META_k
    ${NOMAD_...}              -> plain interpolation

change_mode restart/signal/noop is honored by the task runner on
re-render; templates render once before task start (the reference's
initial render gate — prestart blocks until all templates render).
"""

from __future__ import annotations

import os
import re

from ..structs.structs import Template

_FUNC_RE = re.compile(
    r"\{\{\s*(env|key|meta|service|secret)\s+\"([^\"]+)\"\s*\}\}"
)


class TemplateError(Exception):
    pass


def compute_template(
    tmpl: Template, task_dir: str, env: dict[str, str], service_fn=None,
    secret_fn=None,
) -> tuple[str, str]:
    """Render without writing: (confined destination path, content)."""
    from .allocdir import EscapeError, alloc_sandbox, confine
    from .taskenv import interpolate

    sandbox = alloc_sandbox(task_dir)

    if tmpl.embedded_tmpl:
        src = tmpl.embedded_tmpl
    elif tmpl.source_path:
        path = interpolate(tmpl.source_path, env)
        if not os.path.isabs(path):
            path = os.path.join(task_dir, path)
        try:
            path = confine(sandbox, path)
        except EscapeError as e:
            raise TemplateError(str(e)) from e
        try:
            with open(path) as f:
                src = f.read()
        except OSError as e:
            raise TemplateError(f"template source: {e}") from e
    else:
        raise TemplateError("template has neither data nor source")

    def repl(m: re.Match) -> str:
        fn, arg = m.group(1), m.group(2)
        if fn == "env":
            return env.get(arg, "")
        if fn == "meta":
            return env.get(f"NOMAD_META_{arg}", env.get(f"meta.{arg}", ""))
        if fn == "service":
            # native service discovery: one "address:port" per line
            # (consul-template's {{ range service }} collapsed to the
            # address list jobs actually template in)
            if service_fn is None:
                return ""
            try:
                regs = service_fn(arg) or []
            except Exception:
                return ""
            return "\n".join(
                f"{r.address}:{r.port}" for r in regs
            )
        if fn == "secret":
            # {{ secret "path:key" }} reads the embedded secrets store
            # (the consul-template vault function collapsed to one
            # path:key lookup; values never transit the event stream)
            if secret_fn is None:
                return ""
            path, _, key = arg.partition(":")
            try:
                entry = secret_fn(path)
            except Exception as e:
                # transient lookup failure must FAIL the render, not
                # render an empty credential (prestart then retries; the
                # watcher skips the poll instead of flip-flopping)
                raise TemplateError(
                    f"secret lookup {path!r} failed: {e}"
                ) from e
            if entry is None:
                return ""
            if key:
                return entry.items.get(key, "")
            return "\n".join(
                f"{k}={v}" for k, v in sorted(entry.items.items())
            )
        return ""  # key: no Consul KV backend

    rendered = _FUNC_RE.sub(repl, src)
    rendered = interpolate(rendered, env)

    dest = interpolate(tmpl.dest_path, env)
    if not dest:
        raise TemplateError("template missing destination")
    if not os.path.isabs(dest):
        dest = os.path.join(task_dir, dest)
    try:
        dest = confine(sandbox, dest)
    except EscapeError as e:
        raise TemplateError(str(e)) from e
    return dest, rendered


def write_template(tmpl: Template, dest: str, content: str) -> None:
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    with open(dest, "w") as f:
        f.write(content)
    try:
        os.chmod(dest, int(tmpl.perms or "0644", 8))
    except ValueError:
        pass


def render_template(
    tmpl: Template, task_dir: str, env: dict[str, str], service_fn=None,
    secret_fn=None,
) -> str:
    """Render to task_dir/<dest_path>; returns the destination path."""
    dest, content = compute_template(
        tmpl, task_dir, env, service_fn, secret_fn
    )
    write_template(tmpl, dest, content)
    return dest


class TemplateWatcher:
    """The re-render loop (reference template.go's runner): poll each
    template's inputs, and when the rendered content changes, rewrite the
    destination and fire change_mode — signal via the driver, restart via
    the task runner's template-restart hook (which does NOT consume the
    restart policy's budget, matching the reference's
    SetRestartTriggered).

    Dynamic inputs here are source files (artifacts refreshed on disk)
    and any env drift; without Consul/Vault in the tree there is no KV
    watch, so polling the rendered output is the honest equivalent.
    """

    def __init__(
        self,
        templates,
        task_dir: str,
        env: dict[str, str],
        signal_fn,  # (signal_name) -> None
        restart_fn,  # () -> None
        poll_interval_s: float = 2.0,
        service_fn=None,  # (name) -> [ServiceRegistration] (native SD)
        secret_fn=None,  # (path) -> SecretEntry | None
    ) -> None:
        import threading

        self.service_fn = service_fn
        self.secret_fn = secret_fn
        self.templates = list(templates)
        self.task_dir = task_dir
        self.env = env
        self.signal_fn = signal_fn
        self.restart_fn = restart_fn
        self.poll_interval_s = poll_interval_s
        self._last: dict[int, str] = {}
        self._stop = threading.Event()
        self._thread = None

    def prime(self) -> None:
        """Record current rendered contents as the baseline (call after
        the initial prestart render)."""
        for i, tmpl in enumerate(self.templates):
            try:
                _, content = compute_template(
                    tmpl, self.task_dir, self.env, self.service_fn,
                    self.secret_fn,
                )
                self._last[i] = content
            except TemplateError:
                pass

    def start(self) -> None:
        import threading

        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(self._stop,), daemon=True,
            name="template-watcher",
        )
        self._thread.start()

    def stop(self) -> None:
        """Stop AND join: after return, no callback can fire — the task
        runner clears its restart event right after this, and a straggler
        set() would bounce the fresh task for no reason."""
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5)
        self._thread = None

    def _run(self, stop) -> None:
        while not stop.wait(self.poll_interval_s):
            restart = False
            signals: list[str] = []
            for i, tmpl in enumerate(self.templates):
                try:
                    dest, content = compute_template(
                        tmpl, self.task_dir, self.env, self.service_fn,
                        self.secret_fn,
                    )
                except TemplateError:
                    continue
                if content == self._last.get(i):
                    continue
                mode_ = tmpl.change_mode or "restart"
                if mode_ != "noop" and tmpl.splay_s > 0:
                    # randomized, NOT capped: splay exists to stagger a
                    # fleet's restarts when a shared input changes
                    import random

                    if stop.wait(random.uniform(0, tmpl.splay_s)):
                        return
                write_template(tmpl, dest, content)
                self._last[i] = content
                mode = tmpl.change_mode or "restart"
                if mode == "restart":
                    restart = True
                elif mode == "signal":
                    signals.append(tmpl.change_signal or "SIGHUP")
            if stop.is_set():
                return
            # coalesce: one restart beats any number of signals
            if restart:
                self.restart_fn()
            else:
                for sig in signals:
                    self.signal_fn(sig)
