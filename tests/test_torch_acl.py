"""ACL against the port: the policy DSL, the compiled ACL and the
Server's ACL endpoints.

The cases of ``tests/test_acl.py`` with their imports pointed at
``nomad_tpu_torch``: the policy DSL, the compiled ACL, and the HTTP
enforcement through the port's server agent (``device="cpu"``; the
reference's is a dev agent) and its SDK; the assertions are the
reference's. The Server cases at the end hold the port's
``acl_bootstrap``, policy and token endpoints and ``resolve_token`` to
nomad_tpu's on the same inputs.
Reference analogs: acl/policy_test.go, acl/acl_test.go,
nomad/acl_endpoint_test.go.
"""

import pytest

from nomad_tpu_torch.acl import compile_policies, parse_policy
from nomad_tpu_torch.acl.policy import PolicyError
from nomad_tpu_torch.api import APIError, NomadClient

from torch_agent_kit import server_config, start_server_agent


class TestPolicyParsing:
    def test_parse_basic(self):
        pol = parse_policy(
            """
namespace "default" {
  policy = "write"
}
node {
  policy = "read"
}
agent {
  policy = "write"
}
"""
        )
        assert pol.namespaces[0].name == "default"
        assert pol.namespaces[0].policy == "write"
        assert pol.node == "read"
        assert pol.agent == "write"

    def test_parse_capabilities(self):
        pol = parse_policy(
            """
namespace "ops-*" {
  policy       = "read"
  capabilities = ["submit-job"]
}
"""
        )
        assert pol.namespaces[0].capabilities == ["submit-job"]

    def test_invalid_policy_rejected(self):
        with pytest.raises(PolicyError):
            parse_policy('namespace "x" { policy = "banana" }')
        with pytest.raises(PolicyError):
            parse_policy('namespace "x" { capabilities = ["nope"] }')
        with pytest.raises(PolicyError):
            parse_policy('node { policy = "list" }')


class TestCompiledACL:
    def test_read_vs_write(self):
        acl = compile_policies(
            [parse_policy('namespace "default" { policy = "read" }')]
        )
        assert acl.allow_namespace_op("default", "read-job")
        assert acl.allow_namespace_op("default", "list-jobs")
        assert not acl.allow_namespace_op("default", "submit-job")
        assert not acl.allow_namespace_op("other", "read-job")

    def test_glob_specificity(self):
        acl = compile_policies(
            [
                parse_policy('namespace "*" { policy = "read" }'),
                parse_policy('namespace "ops-*" { policy = "write" }'),
            ]
        )
        assert acl.allow_namespace_op("anything", "read-job")
        assert not acl.allow_namespace_op("anything", "submit-job")
        # more-specific glob wins
        assert acl.allow_namespace_op("ops-prod", "submit-job")

    def test_deny_wins(self):
        acl = compile_policies(
            [parse_policy('namespace "secret" { policy = "deny" }')]
        )
        assert not acl.allow_namespace_op("secret", "read-job")

    def test_merge_levels(self):
        acl = compile_policies(
            [
                parse_policy('node { policy = "read" }'),
                parse_policy('node { policy = "write" }'),
            ]
        )
        assert acl.allow_node_write()

    def test_management(self):
        from nomad_tpu_torch.acl.acl import MANAGEMENT_ACL

        assert MANAGEMENT_ACL.allow_namespace_op("any", "submit-job")
        assert MANAGEMENT_ACL.allow_node_write()


@pytest.fixture(scope="module")
def acl_agent(tmp_path_factory):
    # the reference's dev agent, without its client (ROADMAP A12 part
    # 8): a server agent on the CPU
    a = start_server_agent(server_config(
        str(tmp_path_factory.mktemp("acl-agent")), acl_enabled=True),
        nodes=0)
    yield a
    a.shutdown()


@pytest.fixture(scope="module")
def root(acl_agent):
    host, port = acl_agent.http_addr
    api = NomadClient(f"http://{host}:{port}")
    token = api.acl.bootstrap()
    return NomadClient(f"http://{host}:{port}", token=token.secret_id)


class TestHTTPEnforcement:
    def test_anonymous_denied(self, acl_agent, root):
        host, port = acl_agent.http_addr
        anon = NomadClient(f"http://{host}:{port}")
        with pytest.raises(APIError) as e:
            anon.jobs.list()
        assert e.value.status == 401
        # status stays open
        assert anon.status.leader()

    def test_bootstrap_once(self, root):
        with pytest.raises(APIError):
            root.acl.bootstrap()

    def test_management_allowed(self, root):
        assert root.jobs.list() == []
        assert root.nodes.list() is not None

    def test_scoped_client_token(self, acl_agent, root):
        host, port = acl_agent.http_addr
        root.acl.policy_apply(
            "readonly", 'namespace "default" { policy = "read" }'
        )
        tok = root.acl.token_create(
            name="reader", policies=["readonly"]
        )
        reader = NomadClient(f"http://{host}:{port}", token=tok.secret_id)
        assert reader.jobs.list() == []  # list-jobs allowed
        from nomad_tpu_torch import mock

        job = mock.job()
        with pytest.raises(APIError) as e:
            reader.jobs.register(job)  # submit-job denied
        assert e.value.status == 403
        with pytest.raises(APIError) as e:
            reader.nodes.list()  # no node policy
        assert e.value.status == 403
        # token/self works for any valid token
        me = reader.acl.token_self()
        assert me.accessor_id == tok.accessor_id
        # acl admin requires management
        with pytest.raises(APIError) as e:
            reader.acl.tokens()
        assert e.value.status == 403

    def test_bad_token_401(self, acl_agent):
        host, port = acl_agent.http_addr
        bad = NomadClient(f"http://{host}:{port}", token="not-a-token")
        with pytest.raises(APIError) as e:
            bad.jobs.list()
        assert e.value.status == 401

    def test_token_lifecycle(self, root):
        tok = root.acl.token_create(name="temp", policies=["readonly"])
        listed = root.acl.tokens()
        assert any(t.accessor_id == tok.accessor_id for t in listed)
        # secrets never listed
        assert all(t.secret_id == "" for t in listed)
        root.acl.token_delete(tok.accessor_id)
        with pytest.raises(APIError):
            root.acl.token(tok.accessor_id)

    def test_body_namespace_escalation_blocked(self, acl_agent, root):
        """submit-job on 'default' must not allow registering into
        another namespace via the job body (review finding)."""
        host, port = acl_agent.http_addr
        root.acl.policy_apply(
            "submit-default", 'namespace "default" { policy = "write" }'
        )
        tok = root.acl.token_create(
            name="submitter", policies=["submit-default"]
        )
        submitter = NomadClient(f"http://{host}:{port}", token=tok.secret_id)
        from nomad_tpu_torch import mock

        ok_job = mock.job()
        assert submitter.jobs.register(ok_job)  # default ns: allowed
        evil = mock.job()
        evil.namespace = "prod"
        with pytest.raises(APIError) as e:
            submitter.jobs.register(evil)
        assert e.value.status == 403

    def test_second_bootstrap_is_400(self, acl_agent, root):
        with pytest.raises(APIError) as e:
            root.acl.bootstrap()
        assert e.value.status == 400

    def test_deployment_cross_namespace_guarded(self, acl_agent, root):
        """A default-scoped token must not read/fail other namespaces'
        deployments or allocs by ID (review finding)."""
        host, port = acl_agent.http_addr
        tok = root.acl.token_create(name="r2", policies=["readonly"])
        reader = NomadClient(f"http://{host}:{port}", token=tok.secret_id)
        # lists filter to readable namespaces (no error, just scoped)
        assert isinstance(reader.allocations.list(), list)
        assert isinstance(reader.evaluations.list(), list)
        assert isinstance(reader.deployments.list(), list)


class TestDenyWins:
    def test_coarse_deny_not_overridden(self):
        acl = compile_policies(
            [
                parse_policy('node { policy = "deny" }'),
                parse_policy('node { policy = "write" }'),
            ]
        )
        assert not acl.allow_node_read()
        assert not acl.allow_node_write()

    def test_plugin_list_vs_read(self):
        acl = compile_policies([parse_policy('plugin { policy = "list" }')])
        assert acl.allow_plugin_list()
        assert not acl.allow_plugin_read()


# ---------------------------------------------------------------------------
# The Server's ACL endpoints, nomad_tpu's and the port's on the same inputs
# ---------------------------------------------------------------------------

_RULES = {
    "submit-a": 'namespace "team-a" { policy = "read"\n'
                '  capabilities = ["submit-job"] }',
    "nodes": 'node { policy = "read" }',
}


def _acl_view(acl):
    return (acl.is_management(),
            acl.allow_namespace_op("team-a", "submit-job"),
            acl.allow_namespace_op("team-a", "read-job"),
            acl.allow_namespace_op("team-b", "submit-job"),
            acl.allow_node_read(), acl.allow_node_write())


def _acl_steps(srv, acl_structs, conflict):
    """Bootstrap, two policies, a client token over both, its
    resolution, then one policy deleted and the token resolved again
    (the cache is keyed by the ACL tables' index), the second bootstrap
    refused, the token deleted and refused."""
    out = []
    root = srv.acl_bootstrap()
    out.append(("root", root.type, root.policies,
                _acl_view(srv.resolve_token(root.secret_id))))
    srv.acl_policy_upsert([acl_structs.ACLPolicy(name=n, rules=r)
                           for n, r in sorted(_RULES.items())])
    tok = srv.acl_token_create(acl_structs.ACLToken(
        name="team-a", type="client", policies=sorted(_RULES)))
    out.append(("token", tok.type, tok.policies,
                _acl_view(srv.resolve_token(tok.secret_id))))
    srv.acl_policy_delete(["nodes"])
    out.append(("after delete",
                _acl_view(srv.resolve_token(tok.secret_id))))
    with pytest.raises(conflict):
        srv.acl_bootstrap()
    srv.acl_token_delete([tok.accessor_id])
    with pytest.raises(PermissionError, match="token not found"):
        srv.resolve_token(tok.secret_id)
    out.append(("anonymous", srv.resolve_token("")))
    out.append(("tables", sorted(p.name for p in srv.state.acl_policies()),
                sorted(t.type for t in srv.state.acl_tokens())))
    return out


def test_acl_endpoints_match_nomad_tpu():
    from nomad_tpu.acl import structs as jacl
    from nomad_tpu.scheduler.context import SchedulerConfig as JConfig
    from nomad_tpu.server import Server as JServer
    from nomad_tpu.server.server import ConflictError as JConflict

    from nomad_tpu_torch.acl import structs as tacl
    from nomad_tpu_torch.scheduler.context import SchedulerConfig
    from nomad_tpu_torch.server import ConflictError, Server

    jsrv = JServer(num_workers=1, scheduler_config=JConfig())
    tsrv = Server(num_workers=1, scheduler_config=SchedulerConfig(
        backend="host", device="cpu"))
    try:
        jout = _acl_steps(jsrv, jacl, JConflict)
        tout = _acl_steps(tsrv, tacl, ConflictError)
        assert tout == jout
        assert jsrv.state.latest_index() == tsrv.state.latest_index()
    finally:
        jsrv.shutdown()
        tsrv.shutdown()


def test_invalid_policy_refused_at_the_endpoint():
    from nomad_tpu_torch.acl.structs import ACLPolicy, ACLToken
    from nomad_tpu_torch.scheduler.context import SchedulerConfig
    from nomad_tpu_torch.server import Server

    srv = Server(num_workers=1, scheduler_config=SchedulerConfig(
        backend="host", device="cpu"))
    try:
        with pytest.raises(PolicyError):
            srv.acl_policy_upsert([ACLPolicy(name="bad",
                                             rules='node { policy = "x" }')])
        with pytest.raises(ValueError, match="requires at least one"):
            srv.acl_token_create(ACLToken(name="t", type="client"))
        assert srv.state.latest_index() == 0
    finally:
        srv.shutdown()
