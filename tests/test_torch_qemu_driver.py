"""``tests/test_qemu_driver.py`` against the port.

The reference's cases against the port, with the reference's
assertions: imports pointed at ``nomad_tpu_torch``, and every
Server and ClusterServer given its scheduler config
(``backend="host"``, the reference's default, on ``device="cpu"``)
and every agent ``device="cpu"``.

QEMU driver tests (no real qemu: a Python stub plays the VM).

Reference intent: drivers/qemu/driver_test.go — arg construction, the
allowed-image-path guard, monitor-socket graceful shutdown, reattach.
"""

import os
import signal
import stat
import textwrap
import time

import pytest

from nomad_tpu_torch.drivers.base import DriverError, TaskConfig
from nomad_tpu_torch.drivers.qemu import QemuDriver


STUB = textwrap.dedent(
    """\
    #!/usr/bin/env python3
    # qemu-system stub: records argv, serves the monitor socket, idles.
    import os, socket, sys, time

    argv_log = os.environ.get("QEMU_STUB_LOG")
    if argv_log:
        with open(argv_log, "w") as f:
            f.write("\\0".join(sys.argv[1:]))
    monitor = None
    for i, a in enumerate(sys.argv):
        if a == "-monitor" and i + 1 < len(sys.argv):
            spec = sys.argv[i + 1]  # unix:/path,server,nowait
            monitor = spec.split(":", 1)[1].split(",")[0]
    if monitor:
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(monitor)
        srv.listen(1)
        srv.settimeout(0.2)
        while True:
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            data = conn.recv(1024)
            if b"system_powerdown" in data:
                sys.exit(0)
    else:
        time.sleep(600)
    """
)


@pytest.fixture
def stub(tmp_path):
    path = tmp_path / "qemu-system-x86_64"
    path.write_text(STUB)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def _cfg(tmp_path, stub, task_id="t1", **conf):
    task_dir = tmp_path / "alloc" / "vm"
    task_dir.mkdir(parents=True, exist_ok=True)
    image = task_dir / "linux.img"
    image.write_bytes(b"fake-image")
    base = {"image_path": str(image)}
    base.update(conf)
    return TaskConfig(
        id=task_id,
        name="vm",
        config=base,
        resources_memory_mb=256,
        task_dir=str(task_dir),
        env={"QEMU_STUB_LOG": str(tmp_path / "argv.log")},
        stdout_path=str(tmp_path / "out.log"),
        stderr_path=str(tmp_path / "err.log"),
    )


def _argv(tmp_path):
    deadline = time.monotonic() + 5
    log = tmp_path / "argv.log"
    while time.monotonic() < deadline:
        if log.exists() and log.read_bytes():
            return log.read_text().split("\0")
        time.sleep(0.05)
    raise AssertionError("stub never wrote argv")


def test_fingerprint_undetected_without_binary(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    fp = QemuDriver().fingerprint()
    assert fp.health == "undetected"


def test_arg_construction_and_graceful_shutdown(tmp_path, stub):
    d = QemuDriver(qemu_binary=stub)
    cfg = _cfg(tmp_path, stub, graceful_shutdown=True,
               args=["-nodefaults"], accelerator="tcg")
    d.start_task(cfg)
    try:
        argv = _argv(tmp_path)
        assert "-machine" in argv and "type=pc,accel=tcg" in argv
        assert "-m" in argv and "256M" in argv
        assert any(a.startswith("file=") for a in argv)
        assert "-nographic" in argv and "-nodefaults" in argv
        mon = argv[argv.index("-monitor") + 1]
        assert mon.startswith("unix:") and mon.endswith(",server,nowait")
        # wait for the stub to bind the socket, then powerdown
        sock_path = mon.split(":", 1)[1].split(",")[0]
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not os.path.exists(sock_path):
            time.sleep(0.05)
        t0 = time.monotonic()
        d.stop_task("t1", timeout_s=10)
        res = d.wait_task("t1", timeout_s=5)
        assert res is not None and res.exit_code == 0, (
            "graceful powerdown should exit 0 (not a kill)"
        )
        assert time.monotonic() - t0 < 8
    finally:
        d.destroy_task("t1", force=True)


def test_port_map_builds_hostfwd(tmp_path, stub):
    d = QemuDriver(qemu_binary=stub)
    cfg = _cfg(tmp_path, stub, port_map={"ssh": 22})
    cfg.env["NOMAD_HOST_PORT_ssh"] = "22000"
    d.start_task(cfg)
    try:
        argv = _argv(tmp_path)
        netdev = argv[argv.index("-netdev") + 1]
        assert "hostfwd=tcp::22000-:22" in netdev
        assert "hostfwd=udp::22000-:22" in netdev
        assert "virtio-net,netdev=user.0" in argv
    finally:
        d.destroy_task("t1", force=True)


def test_unknown_port_label_rejected(tmp_path, stub):
    d = QemuDriver(qemu_binary=stub)
    cfg = _cfg(tmp_path, stub, port_map={"web": 80})
    with pytest.raises(DriverError, match="port label"):
        d.start_task(cfg)


def test_image_path_escape_rejected(tmp_path, stub):
    d = QemuDriver(qemu_binary=stub)
    cfg = _cfg(tmp_path, stub)
    cfg.config["image_path"] = "/etc/passwd"
    with pytest.raises(DriverError, match="allowed paths"):
        d.start_task(cfg)
    # but an operator-allowed root works
    d2 = QemuDriver(image_paths=["/etc"], qemu_binary=stub)
    cfg2 = _cfg(tmp_path, stub, task_id="t2")
    cfg2.config["image_path"] = "/etc/hostname"
    d2.start_task(cfg2)
    d2.stop_task("t2", timeout_s=2)
    d2.destroy_task("t2", force=True)


def test_memory_bounds(tmp_path, stub):
    d = QemuDriver(qemu_binary=stub)
    cfg = _cfg(tmp_path, stub)
    cfg.resources_memory_mb = 64
    with pytest.raises(DriverError, match="memory"):
        d.start_task(cfg)


def test_ungraceful_stop_kills(tmp_path, stub):
    d = QemuDriver(qemu_binary=stub)
    cfg = _cfg(tmp_path, stub)  # no graceful_shutdown: no monitor
    d.start_task(cfg)
    d.stop_task("t1", timeout_s=2)
    res = d.wait_task("t1", timeout_s=5)
    assert res is not None and res.signal in (
        signal.SIGTERM, signal.SIGKILL
    )
    d.destroy_task("t1")


def test_recover_task(tmp_path, stub):
    d = QemuDriver(qemu_binary=stub)
    cfg = _cfg(tmp_path, stub)
    handle = d.start_task(cfg)
    try:
        d2 = QemuDriver()
        d2.recover_task(handle)
        st = d2.inspect_task("t1")
        assert st.state == "running"
    finally:
        d.destroy_task("t1", force=True)


def test_config_spec_rejects_unknown_keys(tmp_path, stub):
    """hclspec analog: a typo'd stanza fails at dispatch
    (drivers/configspec.py)."""
    d = QemuDriver(qemu_binary=stub)
    cfg = _cfg(tmp_path, stub, imge_path="typo")
    with pytest.raises(DriverError, match="unknown config keys"):
        d.start_task(cfg)
    cfg2 = _cfg(tmp_path, stub, graceful_shutdown="yes")
    with pytest.raises(DriverError, match="must be bool"):
        d.start_task(cfg2)
