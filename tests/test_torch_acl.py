"""ACL against the port: the policy DSL, the compiled ACL and the
Server's ACL endpoints.

The ``parse_policy`` / ``compile_policies`` cases of ``tests/test_acl.py``
with their imports pointed at ``nomad_tpu_torch`` (its HTTP enforcement
cases wait for the agent and the API); the assertions are the
reference's. The Server cases at the end hold the port's
``acl_bootstrap``, policy and token endpoints and ``resolve_token`` to
nomad_tpu's on the same inputs.
Reference analogs: acl/policy_test.go, acl/acl_test.go,
nomad/acl_endpoint_test.go.
"""

import pytest

from nomad_tpu_torch.acl import compile_policies, parse_policy
from nomad_tpu_torch.acl.policy import PolicyError


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
