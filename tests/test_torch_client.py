"""The port's client, held to nomad_tpu's on the CPU.

``client_lockstep`` (chip_smoke.py; its ``small`` phase runs it on the
card and on the CPU twins) on both packages' agents: a dev agent (a
server with a co-located client in dc1, the batch worker in batches of 8
with every solve on the batch solver: nomad_tpu's with
``backend="tpu"`` on conftest's CPU devices, the port's with
``device="cpu"``) and one client agent in dc2, both real nodes pinned to
one id each and one capacity; 200 nodes built with nomad_tpu's mocks
registered over the fabric (the port's carried over the wire); two
mock-driver jobs of 20 and one raw_exec task as HCL through ``job run``;
dc1's node drained through ``node drain``; the client agent stopped with
its tasks left running and started again; every job stopped. The allocs
by (job, alloc name, node name) with their desired and client status
after each step, each task state's event types, the deployments'
statuses, the mock allocs' outcome across the restart and the bodies of
``/v1/job/<id>/allocations`` and ``/v1/node/<id>/allocations`` (minted
ids named by what they name; indexes, times, pids, sockets and paths
dropped) must be equal. Tolerance: exact.

Then where the port keeps what its client writes: the task executor in
its own build dir, never in the reference's cache; the executors'
control sockets under the temp dir (``TMPDIR``); the default data dir
its own, apart from nomad_tpu's.
"""

import functools
import importlib
import pathlib

from nomad_tpu import codec as jcodec

from nomad_tpu_torch.codec import from_wire

from test_torch_agent import _chip_smoke, _ref_fleet


def test_client_lockstep_matches_nomad_tpu(monkeypatch):
    import nomad_tpu.server.cluster as jcluster
    from nomad_tpu.scheduler.context import SchedulerConfig as JConfig

    cs = _chip_smoke()
    cfg = cs.CLIENT_SMALL
    nodes = _ref_fleet(cfg["nodes"])
    # nomad_tpu's ClusterServer builds its Server with the default
    # config; hand it the batch solver's, as its Server accepts
    monkeypatch.setattr(jcluster, "Server", functools.partial(
        jcluster.Server,
        scheduler_config=JConfig(backend="tpu", small_batch_threshold=0)))
    jout = cs.client_lockstep(importlib.import_module("nomad_tpu.agent"),
                              importlib.import_module(
                                  "nomad_tpu.cli.main").main, nodes)
    tout = cs.client_lockstep(
        importlib.import_module("nomad_tpu_torch.agent"),
        importlib.import_module("nomad_tpu_torch.cli.main").main,
        [from_wire(jcodec.to_wire(n)) for n in nodes], device="cpu")
    assert sorted(tout) == sorted(jout)
    for key in ("steps", "events", "deployments", "raw_kept",
                "restart_outcome"):
        assert tout[key] == jout[key], key
    assert sorted(tout["reads"]) == sorted(jout["reads"])
    for path in jout["reads"]:
        assert tout["reads"][path] == jout["reads"][path], path
    # what the run must show on either package
    live = cfg["jobs"] * cfg["count"] + 1
    run = tout["steps"]["run"]
    assert sum(1 for a in run if a[4] == "running") == live
    assert {a[2] for a in run} == {"node:real-dc1", "node:real-dc2"}
    drain = tout["steps"]["drain"]
    assert not [a for a in drain
                if a[2] == "node:real-dc1" and a[3] == "run"]
    assert sum(1 for a in drain if a[4] == "running") == live
    assert tout["raw_kept"] is True
    assert all(d[2] == "successful" for d in tout["deployments"])
    assert all(a[4] == "complete" for a in tout["steps"]["stop"])


def test_executor_builds_into_the_package_build_dir(tmp_path):
    from nomad_tpu_torch.drivers import executor

    pkg = pathlib.Path(executor.__file__).resolve().parents[1]
    assert executor._BUILD_DIR == pkg / "_build"
    assert executor._SRC == pkg / "drivers" / "native" / "executor.cc"
    default = pathlib.Path(executor.executor_binary())
    assert default.parent == pkg / "_build"
    assert default.name.startswith("nomad-executor-")
    # an explicit cache dir still wins, and the binary builds there
    built = pathlib.Path(executor.executor_binary(str(tmp_path)))
    assert built.parent == tmp_path and built.name == default.name


def test_executor_sockets_live_under_tmpdir(tmp_path, monkeypatch):
    """With ``TMPDIR`` set, a task's control socket goes under it, and an
    executor launched there answers on it."""
    import os
    import shutil
    import tempfile

    from nomad_tpu_torch.drivers import executor

    tmpdir = tempfile.mkdtemp(prefix="t")
    try:
        monkeypatch.delenv("NOMAD_TPU_TORCH_RUN_DIR", raising=False)
        monkeypatch.setenv("TMPDIR", tmpdir)
        monkeypatch.setattr(tempfile, "tempdir", None)
        task_dir = tmp_path / ("d" * 60) / "web"
        sock = executor._socket_path(str(task_dir))
        root = os.path.join(tmpdir, f"nomad-tpu-torch-{os.getuid()}")
        assert os.path.dirname(sock) == root
        assert os.stat(root).st_mode & 0o777 == 0o700
        h = executor.launch_executor(str(task_dir), "/bin/sh",
                                     ["-c", "exit 3"], env={})
        assert h.socket_path == sock
        assert h.wait(timeout_s=10).get("exit_code") == 3
        h.shutdown()
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def test_executor_sockets_fall_back_when_tmpdir_is_too_deep(tmp_path,
                                                           monkeypatch):
    """A temp dir too deep for a socket path gives one private run dir
    for the process, under /tmp, that every task's socket shares."""
    import os
    import shutil
    import tempfile

    from nomad_tpu_torch.drivers import executor

    deep = tmp_path / ("d" * 50) / ("e" * 50)
    deep.mkdir(parents=True)
    monkeypatch.delenv("NOMAD_TPU_TORCH_RUN_DIR", raising=False)
    monkeypatch.setenv("TMPDIR", str(deep))
    monkeypatch.setattr(tempfile, "tempdir", None)
    monkeypatch.setattr(executor, "_FALLBACK_RUN_ROOT", None)
    a = executor._socket_path(str(tmp_path / "a"))
    try:
        b = executor._socket_path(str(tmp_path / "b"))
        assert a != b and os.path.dirname(a) == os.path.dirname(b)
        assert os.path.dirname(a).startswith("/tmp/nomad-tpu-torch-")
        assert len(a) <= executor._SUN_PATH_MAX
        assert os.stat(os.path.dirname(a)).st_mode & 0o777 == 0o700
    finally:
        shutil.rmtree(os.path.dirname(a), ignore_errors=True)


def test_default_data_dir_is_the_ports_own(tmp_path, monkeypatch):
    """A default port agent and a default nomad_tpu agent never share a
    data dir (so never a client state DB); the port's lies under the
    temp dir, and its ``Client`` defaults to the same one."""
    import inspect
    import tempfile

    from nomad_tpu.agent import AgentConfig as JAgentConfig

    from nomad_tpu_torch.agent import AgentConfig
    from nomad_tpu_torch.client import Client

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    port = AgentConfig().data_dir
    assert port == str(tmp_path / "nomad_tpu_torch")
    assert port != JAgentConfig().data_dir
    assert inspect.signature(Client).parameters["data_dir"].default is None


def test_codec_carries_the_driver_plugin_payloads():
    """The driver plugin boundary's payloads (Fingerprint, TaskConfig,
    ExitResult, TaskStatus) cross the RPC fabric between a client and an
    out-of-process driver: nomad_tpu's codec registers them, and the
    port's decodes each one nomad_tpu's encodes into the port's own
    class with the same fields."""
    from nomad_tpu.drivers import base as jbase

    from nomad_tpu_torch.drivers import base as tbase

    from nomad_tpu_torch.codec import to_wire

    payloads = [
        jbase.Fingerprint(attributes={"driver.x": "1"}, health="healthy",
                          health_description="ok"),
        jbase.TaskConfig(id="a/t", name="t", alloc_id="a",
                         config={"command": "/bin/true"}, env={"K": "v"}),
        jbase.ExitResult(exit_code=3, signal=9, err="boom"),
        jbase.TaskStatus(id="a/t", name="t", state="exited",
                         exit_result=jbase.ExitResult(exit_code=1)),
    ]
    for obj in payloads:
        got = from_wire(jcodec.to_wire(obj))
        assert type(got) is getattr(tbase, type(obj).__name__)
        assert to_wire(got) == jcodec.to_wire(obj)
