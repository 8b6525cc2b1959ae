"""Java task driver.

Port of ``nomad_tpu/drivers/java.py``.

Reference: drivers/java/driver.go — fingerprints the JVM and launches
`java [jvm_options] -jar <jar> [args]` (or a main class) through the
shared executor machinery. Here it layers on RawExecDriver exactly the
way the reference layers on the shared executor: the only java-specific
parts are the fingerprint and the command-line translation.
"""

from __future__ import annotations

import re
import shutil
import subprocess

from .base import (
    DriverError,
    Fingerprint,
    HEALTH_STATE_HEALTHY,
    HEALTH_STATE_UNDETECTED,
    TaskConfig,
    TaskHandle,
)
from .rawexec import RawExecDriver

_VERSION_RE = re.compile(r'version "([^"]+)"')


class JavaDriver(RawExecDriver):
    name = "java"

    def fingerprint(self) -> Fingerprint:
        java = shutil.which("java")
        if java is None:
            return Fingerprint(
                attributes={},
                health=HEALTH_STATE_UNDETECTED,
                health_description="java binary not found",
            )
        version = "unknown"
        try:
            out = subprocess.run(
                [java, "-version"], capture_output=True, timeout=10
            )
            m = _VERSION_RE.search(out.stderr.decode(errors="replace"))
            if m:
                version = m.group(1)
        except (OSError, subprocess.TimeoutExpired):
            pass
        return Fingerprint(
            attributes={
                "driver.java": "1",
                "driver.java.version": version,
            },
            health=HEALTH_STATE_HEALTHY,
        )

    def start_task(self, cfg: TaskConfig) -> TaskHandle:
        from .configspec import JAVA_SPEC

        conf = JAVA_SPEC.validate(cfg.config, "java")
        jar = conf.get("jar_path")
        main_class = conf.get("class")
        if not jar and not main_class:
            raise DriverError("java config requires 'jar_path' or 'class'")
        argv = ["java"]
        argv.extend(str(o) for o in conf.get("jvm_options") or [])
        if jar:
            argv.extend(["-jar", str(jar)])
        else:
            if conf.get("class_path"):
                argv.extend(["-cp", str(conf["class_path"])])
            argv.append(str(main_class))
        argv.extend(str(a) for a in conf.get("args") or [])
        translated = TaskConfig(
            id=cfg.id,
            name=cfg.name,
            alloc_id=cfg.alloc_id,
            env=cfg.env,
            config={"command": argv[0], "args": argv[1:]},
            resources_cpu=cfg.resources_cpu,
            resources_memory_mb=cfg.resources_memory_mb,
            resources_memory_max_mb=cfg.resources_memory_max_mb,
            task_dir=cfg.task_dir,
            stdout_path=cfg.stdout_path,
            stderr_path=cfg.stderr_path,
            user=cfg.user,
        )
        handle = super().start_task(translated)
        handle.driver = self.name
        return handle
