"""``tests/test_java_driver.py`` against the port.

The reference's cases against the port, with the reference's
assertions: imports pointed at ``nomad_tpu_torch``, and every
Server and ClusterServer given its scheduler config
(``backend="host"``, the reference's default, on ``device="cpu"``)
and every agent ``device="cpu"``.

Java driver tests (reference drivers/java): fingerprint gating and
command-line translation onto the shared exec machinery.
"""

import shutil

import pytest

from nomad_tpu_torch.drivers.base import DriverError, TaskConfig
from nomad_tpu_torch.drivers.java import JavaDriver
from nomad_tpu_torch.drivers.rawexec import RawExecDriver


def test_fingerprint_matches_host():
    fp = JavaDriver().fingerprint()
    if shutil.which("java"):
        assert fp.health == "healthy"
        assert fp.attributes["driver.java"] == "1"
    else:
        assert fp.health == "undetected"


def test_command_translation(monkeypatch):
    captured = {}

    def fake_start(self, cfg):
        captured["cfg"] = cfg
        from nomad_tpu_torch.drivers.base import TaskHandle

        return TaskHandle(cfg.id, "rawexec", {})

    monkeypatch.setattr(RawExecDriver, "start_task", fake_start)
    drv = JavaDriver()
    handle = drv.start_task(
        TaskConfig(
            id="a/j",
            name="j",
            config={
                "jar_path": "app.jar",
                "jvm_options": ["-Xmx64m"],
                "args": ["serve"],
            },
        )
    )
    cfg = captured["cfg"]
    assert cfg.config["command"] == "java"
    assert cfg.config["args"] == ["-Xmx64m", "-jar", "app.jar", "serve"]
    assert handle.driver == "java"

    drv.start_task(
        TaskConfig(
            id="a/k",
            name="k",
            config={"class": "com.example.Main", "class_path": "lib/*"},
        )
    )
    cfg = captured["cfg"]
    assert cfg.config["args"] == ["-cp", "lib/*", "com.example.Main"]


def test_requires_jar_or_class():
    with pytest.raises(DriverError, match="jar_path"):
        JavaDriver().start_task(TaskConfig(id="a/x", name="x", config={}))
