"""``tests/test_jobspec.py`` and ``tests/test_hcl2.py`` against the port.

Every case of both files, with their assertions, run on
``nomad_tpu_torch.jobspec``. Each parse goes through both packages:
``parse_job`` parses the same text (and variables) with ``nomad_tpu``
and with the port and asserts the two jobs equal as wire dicts
(``codec.to_wire`` of each package), or that both raise the same error
with the same message; ``parse`` does the same for the HCL body (its
attributes and blocks, all the way down). Tolerance: exact. The
reference's assertions then run on the port's result.
"""

import pytest

from nomad_tpu import codec as ref_codec
from nomad_tpu import jobspec as ref_jobspec
from nomad_tpu.jobspec import hcl as ref_hcl
from nomad_tpu_torch import codec as port_codec
from nomad_tpu_torch import jobspec as port_jobspec
from nomad_tpu_torch.jobspec import hcl as port_hcl
from nomad_tpu_torch.jobspec import HCLParseError, JobspecError


def _both(ref_fn, port_fn, *args):
    """(reference result, port result), or the port's error re-raised
    once the reference raised the same error."""
    try:
        ref = ref_fn(*args)
    except Exception as e:  # compared with the port's below
        ref = e
    try:
        port = port_fn(*args)
    except Exception as e:
        assert isinstance(ref, Exception), f"only the port raised {e!r}"
        assert (type(ref).__name__, str(ref)) == (type(e).__name__, str(e))
        raise
    assert not isinstance(ref, Exception), f"only nomad_tpu raised {ref!r}"
    return ref, port


def parse_job(src, variables=None):
    """The port's Job, held equal to nomad_tpu's as a wire dict."""
    ref, port = _both(ref_jobspec.parse_job, port_jobspec.parse_job, src,
                      variables)
    assert port_codec.to_wire(port) == ref_codec.to_wire(ref)
    return port


def _body_dict(body):
    return {
        "attrs": body.attrs(),
        "blocks": [(b.type, list(b.labels), _body_dict(b.body))
                   for b in body.blocks()],
    }


def parse(src, variables=None):
    """The port's HCL body, held equal to nomad_tpu's."""
    ref, port = _both(ref_hcl.parse, port_hcl.parse, src, variables)
    assert _body_dict(port) == _body_dict(ref)
    return port


def parse_duration(value):
    ref, port = _both(ref_hcl.parse_duration, port_hcl.parse_duration,
                      value)
    assert port == ref
    return port


FULL_SPEC = """
# a fairly complete service jobspec
variable "dc" {
  default = "dc1"
}

job "web-app" {
  region      = "global"
  datacenters = [var.dc, "dc2"]
  type        = "service"
  priority    = 70

  meta {
    owner = "team-web"
  }

  constraint {
    attribute = "${attr.kernel.name}"
    value     = "linux"
  }

  update {
    max_parallel      = 2
    canary            = 1
    auto_revert       = true
    min_healthy_time  = "15s"
    healthy_deadline  = "3m"
  }

  spread {
    attribute = "${node.datacenter}"
    weight    = 60
    target "dc1" {
      percent = 70
    }
  }

  group "frontend" {
    count = 3

    restart {
      attempts = 3
      interval = "30m"
      delay    = "10s"
      mode     = "fail"
    }

    reschedule {
      delay          = "5s"
      delay_function = "exponential"
      unlimited      = true
    }

    migrate {
      max_parallel = 1
    }

    ephemeral_disk {
      size = 500
    }

    network {
      mode = "host"
      port "http" {
        to = 8080
      }
      port "admin" {
        static = 9090
      }
    }

    volume "data" {
      type      = "host"
      source    = "shared-data"
      read_only = true
    }

    task "server" {
      driver = "rawexec"

      config {
        command = "/bin/server"
        args    = ["-port", "8080"]
      }

      env {
        PORT   = "8080"
        REGION = var.dc
      }

      resources {
        cpu    = 500
        memory = 256
        device "tpu" {
          count = 1
        }
      }

      logs {
        max_files     = 5
        max_file_size = 20
      }

      template {
        data        = <<EOF
server {
  port = {{ env "PORT" }}
}
EOF
        destination = "local/conf.d/server.conf"
        change_mode = "restart"
      }

      artifact {
        source      = "https://example.com/app.tar.gz"
        destination = "local/app"
      }

      service {
        name = "web"
        port = "http"
        tags = ["frontend", "v1"]
        check {
          type     = "http"
          path     = "/health"
          interval = "10s"
          timeout  = "2s"
        }
      }

      kill_timeout = "20s"
    }

    task "sidecar" {
      driver = "mock"
      lifecycle {
        hook    = "prestart"
        sidecar = true
      }
    }
  }
}
"""


class TestFullSpec:
    def test_parse_full(self):
        job = parse_job(FULL_SPEC)
        assert job.id == "web-app"
        assert job.priority == 70
        assert job.datacenters == ["dc1", "dc2"]
        assert job.meta["owner"] == "team-web"
        assert job.constraints[0].ltarget == "${attr.kernel.name}"
        assert job.constraints[0].rtarget == "linux"
        assert job.update.canary == 1
        assert job.update.auto_revert is True
        assert job.update.min_healthy_time_s == 15.0
        assert job.update.healthy_deadline_s == 180.0
        assert job.spreads[0].weight == 60
        assert job.spreads[0].targets[0].value == "dc1"
        assert job.spreads[0].targets[0].percent == 70

        tg = job.task_groups[0]
        assert tg.name == "frontend" and tg.count == 3
        assert tg.restart_policy.attempts == 3
        assert tg.restart_policy.interval_s == 1800.0
        assert tg.reschedule_policy.delay_s == 5.0
        assert tg.migrate.max_parallel == 1
        assert tg.ephemeral_disk.size_mb == 500
        net = tg.networks[0]
        assert [p.label for p in net.dynamic_ports] == ["http"]
        assert net.dynamic_ports[0].to == 8080
        assert [p.label for p in net.reserved_ports] == ["admin"]
        assert net.reserved_ports[0].value == 9090
        assert tg.volumes["data"].source == "shared-data"
        assert tg.volumes["data"].read_only is True

        server = tg.tasks[0]
        assert server.driver == "rawexec"
        assert server.config["command"] == "/bin/server"
        assert server.config["args"] == ["-port", "8080"]
        assert server.env == {"PORT": "8080", "REGION": "dc1"}
        assert server.resources.cpu == 500
        assert server.resources.memory_mb == 256
        assert server.resources.devices[0].name == "tpu"
        assert server.log_config.max_files == 5
        assert "port = {{ env" in server.templates[0].embedded_tmpl
        assert server.artifacts[0].getter_source.endswith("app.tar.gz")
        svc = server.services[0]
        assert svc.name == "web" and svc.tags == ["frontend", "v1"]
        assert svc.checks[0]["interval_s"] == 10.0
        assert server.kill_timeout_s == 20.0

        sidecar = tg.tasks[1]
        assert sidecar.lifecycle.hook == "prestart"
        assert sidecar.lifecycle.sidecar is True

    def test_variable_override(self):
        job = parse_job(FULL_SPEC, variables={"dc": "dc9"})
        assert job.datacenters[0] == "dc9"
        assert job.task_groups[0].tasks[0].env["REGION"] == "dc9"

    def test_parsed_job_validates_and_runs_through_scheduler(self):
        from nomad_tpu_torch import mock

        job = parse_job(FULL_SPEC)
        job.task_groups[0].tasks[0].driver = "mock"
        job.task_groups[0].tasks[0].resources.devices = []
        job.canonicalize()
        job.validate()
        from nomad_tpu_torch.scheduler.context import SchedulerConfig
        from nomad_tpu_torch.testing import Harness

        h = Harness()
        for _ in range(4):
            n = mock.node()
            h.state.upsert_node(h.next_index(), n)
        h.state.upsert_job(h.next_index(), job)
        ev = mock.eval_for_job(job)
        h.process("service", ev, SchedulerConfig(backend="host",
                                                 device="cpu"))
        assert h.plans, "parsed job should produce a plan"


class TestSmallSpecs:
    def test_batch_with_periodic(self):
        job = parse_job(
            """
job "cleanup" {
  type = "batch"
  periodic {
    cron             = "*/15 * * * *"
    prohibit_overlap = true
  }
  group "g" {
    task "t" {
      driver = "mock"
    }
  }
}
"""
        )
        assert job.type == "batch"
        assert job.periodic.spec == "*/15 * * * *"
        assert job.periodic.prohibit_overlap is True

    def test_parameterized(self):
        job = parse_job(
            """
job "dispatcher" {
  type = "batch"
  parameterized {
    payload       = "required"
    meta_required = ["target"]
  }
  group "g" {
    task "t" {
      driver = "mock"
    }
  }
}
"""
        )
        assert job.parameterized.payload == "required"
        assert job.parameterized.meta_required == ["target"]

    def test_task_directly_under_job(self):
        job = parse_job(
            """
job "simple" {
  task "only" {
    driver = "mock"
  }
}
"""
        )
        assert job.task_groups[0].name == "simple"
        assert job.task_groups[0].tasks[0].name == "only"

    def test_distinct_hosts_sugar(self):
        job = parse_job(
            """
job "d" {
  constraint {
    distinct_hosts = true
  }
  group "g" {
    task "t" { driver = "mock" }
  }
}
"""
        )
        assert job.constraints[0].operand == "distinct_hosts"

    def test_errors(self):
        with pytest.raises(JobspecError):
            parse_job('job "empty" {}')
        with pytest.raises(HCLParseError):
            parse_job('job "bad" { count = }')
        with pytest.raises(HCLParseError):
            parse_job('job "x" { dc = var.missing \n group "g" { task "t" {driver="mock"} } }')


class TestDuration:
    def test_parse_duration(self):
        assert parse_duration("30s") == 30.0
        assert parse_duration("5m") == 300.0
        assert parse_duration("2h") == 7200.0
        assert parse_duration("250ms") == 0.25
        assert parse_duration(45) == 45.0
        with pytest.raises(ValueError):
            parse_duration("nope")


def test_parse_script_check_and_check_restart():
    """Script checks carry command/args; check_restart nests limit and
    grace (reference jobspec/parse_service.go)."""
    hcl = """
    job "checked" {
      group "g" {
        task "t" {
          driver = "mock"
          service {
            name = "svc"
            port = "8080"
            check {
              type    = "script"
              command = "/bin/check-health"
              args    = ["--fast"]
              interval = "5s"
              check_restart {
                limit = 3
                grace = "10s"
              }
            }
          }
        }
      }
    }
    """
    job = parse_job(hcl)
    check = job.task_groups[0].tasks[0].services[0].checks[0]
    assert check["type"] == "script"
    assert check["command"] == "/bin/check-health"
    assert check["args"] == ["--fast"]
    assert check["check_restart"] == {"limit": 3, "grace_s": 10.0}
    assert "task" not in check  # only set when given


# -- tests/test_hcl2.py ---------------------------------------------------


def _attrs(src, variables=None):
    return parse(src, variables).attrs()


class TestExpressions:
    def test_arithmetic_and_precedence(self):
        a = _attrs("x = 2 + 3 * 4\ny = (2 + 3) * 4\nz = 10 / 4\nm = 7 % 3")
        assert a["x"] == 14 and a["y"] == 20
        assert a["z"] == 2.5 and a["m"] == 1

    def test_unary(self):
        a = _attrs("x = -5\ny = !true\nz = -(1 + 2)")
        assert a["x"] == -5 and a["y"] is False and a["z"] == -3

    def test_comparison_and_logic(self):
        a = _attrs(
            'x = 1 < 2 && 2 <= 2\ny = "a" == "b" || 3 != 4\nz = 2 > 3'
        )
        assert a["x"] is True and a["y"] is True and a["z"] is False

    def test_conditional(self):
        a = _attrs(
            'variable "env" { default = "prod" }\n'
            'count = var.env == "prod" ? 5 : 1'
        )
        assert a["count"] == 5

    def test_index(self):
        a = _attrs(
            'variable "dcs" { default = ["dc1", "dc2"] }\n'
            'variable "m" { default = { a = 1 } }\n'
            'x = var.dcs[1]\ny = var.m["a"]'
        )
        assert a["x"] == "dc2" and a["y"] == 1

    def test_functions(self):
        a = _attrs(
            'u = upper("abc")\n'
            'j = join(",", ["a", "b"])\n'
            's = split(",", "a,b,c")\n'
            'l = length([1, 2, 3])\n'
            'c = concat([1], [2, 3])\n'
            'f = format("%s-%d", "web", 3)\n'
            'mn = min(4, 2, 9)\n'
            'r = range(3)\n'
            'lk = lookup({ a = 1 }, "b", 42)\n'
            'co = coalesce("", null, "x")\n'
            'rp = replace("a.b.c", ".", "-")\n'
        )
        assert a["u"] == "ABC"
        assert a["j"] == "a,b"
        assert a["s"] == ["a", "b", "c"]
        assert a["l"] == 3
        assert a["c"] == [1, 2, 3]
        assert a["f"] == "web-3"
        assert a["mn"] == 2
        assert a["r"] == [0, 1, 2]
        assert a["lk"] == 42
        assert a["co"] == "x"
        assert a["rp"] == "a-b-c"

    def test_unknown_function_errors(self):
        with pytest.raises(HCLParseError, match="unknown function"):
            _attrs("x = nope(1)")

    def test_string_interpolation_with_expressions(self):
        a = _attrs(
            'variable "n" { default = 3 }\n'
            'name = "web-${var.n * 2}"\n'
            'flag = "${var.n > 1 ? \\"big\\" : \\"small\\"}"'
        )
        assert a["name"] == "web-6"
        assert a["flag"] == "big"

    def test_runtime_refs_still_pass_through(self):
        a = _attrs('x = "${attr.kernel.name}"\ny = "${meta.rack}"')
        assert a["x"] == "${attr.kernel.name}"
        assert a["y"] == "${meta.rack}"


class TestLocals:
    def test_locals_reference_vars_and_locals(self):
        a = _attrs(
            'variable "base" { default = "api" }\n'
            "locals {\n"
            '  name = "${var.base}-svc"\n'
            '  caps = upper(local.name)\n'
            "}\n"
            "x = local.name\ny = local.caps"
        )
        assert a["x"] == "api-svc"
        assert a["y"] == "API-SVC"

    def test_unknown_local_errors(self):
        with pytest.raises(HCLParseError, match="unknown variable"):
            _attrs("x = local.nope")


class TestVariablePrecedence:
    def test_env_overrides_default(self, monkeypatch):
        monkeypatch.setenv("NOMAD_VAR_region", "eu")
        a = _attrs('variable "region" { default = "us" }\nx = var.region')
        assert a["x"] == "eu"

    def test_explicit_beats_env(self, monkeypatch):
        monkeypatch.setenv("NOMAD_VAR_region", "eu")
        a = _attrs(
            'variable "region" { default = "us" }\nx = var.region',
            {"region": "ap"},
        )
        assert a["x"] == "ap"


class TestDynamicBlocks:
    def test_dynamic_expands_list(self):
        body = parse(
            'variable "ports" { default = [8080, 9090] }\n'
            "group {\n"
            '  dynamic "service" {\n'
            "    for_each = var.ports\n"
            '    labels   = ["svc-${service.key}"]\n'
            "    content {\n"
            "      port = service.value\n"
            "    }\n"
            "  }\n"
            "}\n"
        )
        grp = body.block("group")
        svcs = grp.body.blocks("service")
        assert len(svcs) == 2
        assert svcs[0].labels == ["svc-0"]
        assert svcs[0].body.attrs()["port"] == 8080
        assert svcs[1].body.attrs()["port"] == 9090

    def test_dynamic_expands_map_with_iterator(self):
        body = parse(
            "outer {\n"
            '  dynamic "volume" {\n'
            '    for_each = { data = "/srv/data", logs = "/srv/logs" }\n'
            "    iterator = v\n"
            '    labels   = ["${v.key}"]\n'
            "    content {\n"
            "      source = v.value\n"
            "    }\n"
            "  }\n"
            "}\n"
        )
        vols = body.block("outer").body.blocks("volume")
        assert {b.labels[0]: b.body.attrs()["source"] for b in vols} == {
            "data": "/srv/data",
            "logs": "/srv/logs",
        }

    def test_dynamic_requires_for_each(self):
        with pytest.raises(HCLParseError, match="for_each"):
            parse('g { dynamic "x" { content { a = 1 } } }')


def test_full_jobspec_with_hcl2_features():
    """End to end: a jobspec exercising variables, locals, functions,
    conditionals, and a dynamic group volume."""
    src = """
variable "env" { default = "prod" }
variable "dcs" { default = ["dc1", "dc2"] }

locals {
  name = "web-${var.env}"
}

job "app" {
  name        = upper(local.name)
  datacenters = var.dcs
  priority    = var.env == "prod" ? 80 : 50

  group "g" {
    count = length(var.dcs) * 2

    dynamic "volume" {
      for_each = ["a", "b"]
      labels   = ["vol-${volume.value}"]
      content {
        type   = "host"
        source = "src-${volume.value}"
      }
    }

    task "t" {
      driver = "mock"
    }
  }
}
"""
    job = parse_job(src)
    assert job.name == "WEB-PROD"
    assert job.datacenters == ["dc1", "dc2"]
    assert job.priority == 80
    tg = job.task_groups[0]
    assert tg.count == 4
    assert set(tg.volumes) == {"vol-a", "vol-b"}
    assert tg.volumes["vol-a"].source == "src-a"


def test_var_override_string_coerced_to_default_type():
    """CLI -var / NOMAD_VAR_ values arrive as strings; they convert to
    the default's type (jobspec2 variable type conversion)."""
    a = _attrs(
        'variable "n" { default = 2 }\n'
        'variable "on" { default = false }\n'
        "x = var.n * 2\ny = var.on",
        {"n": "5", "on": "true"},
    )
    assert a["x"] == 10
    assert a["y"] is True
    with pytest.raises(HCLParseError, match="cannot convert"):
        _attrs('variable "n" { default = 2 }\nx = var.n', {"n": "abc"})


def test_runtime_refs_rejected_inside_expressions():
    """A runtime ref in any expression position fails loudly instead of
    computing on the literal '${...}' text."""
    for src in (
        'x = attr.cpu > 2',
        'x = true && attr.foo',
        'x = false || attr.foo',
        'x = join(",", [attr.foo, "b"])',
        'x = "${node.class == \\"gpu\\" ? 4 : 1}"',
    ):
        with pytest.raises(HCLParseError, match="runtime reference"):
            _attrs(src)
    # short-circuit keeps the guard lazy, like evaluation itself
    assert _attrs('x = false && attr.foo')["x"] is False
