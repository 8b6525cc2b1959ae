"""``tests/test_federation.py`` against the port.

Every case, with the reference's assertions, run on the port's
``ClusterServer``: per-region raft clusters joined by gossip,
cross-region forwarding (RPC and the HTTP ``?region=`` parameter), and
ACL replication from the authoritative region. Each server's schedulers
run on the CPU (``SchedulerConfig(device="cpu")``); no case reads a
client agent.
"""

import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.scheduler.context import SchedulerConfig
from nomad_tpu_torch.server.cluster import ClusterServer as _ClusterServer


def ClusterServer(*args, **kwargs):
    """The port's ClusterServer, its schedulers on the CPU."""
    kwargs.setdefault("scheduler_config", SchedulerConfig(device="cpu"))
    return _ClusterServer(*args, **kwargs)


def wait_until(fn, timeout_s=10.0, interval=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


def _settle(*servers):
    """Let each server's in-flight evals finish before it shuts down: a
    plan still waiting on its raft apply holds the shutdown for the
    apply timeout."""
    for cs in servers:
        cs.server.wait_for_evals(10)


@pytest.fixture
def two_regions():
    """One server per region, gossip-joined (the WAN federation shape)."""
    us = ClusterServer(
        "us-1", port=0, num_workers=1, region="us", bootstrap_expect=1
    )
    eu = ClusterServer(
        "eu-1", port=0, num_workers=1, region="eu", bootstrap_expect=1
    )
    us.start()
    eu.start()
    assert wait_until(lambda: us.is_leader(), 10)
    assert wait_until(lambda: eu.is_leader(), 10)
    eu.join([us.rpc.addr])
    # both sides see each other in gossip
    assert wait_until(
        lambda: any(m.id == "us-1" for m in eu.serf.members())
        and any(m.id == "eu-1" for m in us.serf.members()),
        10,
    )
    yield us, eu
    _settle(us, eu)
    eu.shutdown()
    us.shutdown()


def test_regions_are_separate_raft_clusters(two_regions):
    us, eu = two_regions
    time.sleep(1.0)  # give any (wrong) reconciliation a chance to run
    assert us.is_leader() and eu.is_leader(), (
        "each region keeps its own leader"
    )
    with us.raft._lock:
        assert "eu-1" not in us.raft.peers, (
            "cross-region member must not join raft"
        )
    with eu.raft._lock:
        assert "us-1" not in eu.raft.peers


def test_regions_endpoint_lists_both(two_regions):
    us, eu = two_regions
    assert us.rpc_self("Status.regions", {}) == ["eu", "us"]
    assert eu.rpc_self("Status.regions", {}) == ["eu", "us"]


def test_cross_region_write_forwards(two_regions):
    us, eu = two_regions
    job = mock.job(id="eu-job")
    # submitted to the US server, addressed to region eu
    us.rpc_self("Job.register", {"job": job, "region": "eu"})
    assert eu.server.state.job_by_id("default", "eu-job") is not None
    assert us.server.state.job_by_id("default", "eu-job") is None, (
        "the job must land only in the addressed region"
    )


def test_cross_region_read_forwards(two_regions):
    us, eu = two_regions
    eu.rpc_self("Job.register", {"job": mock.job(id="eu-only")})
    jobs = us.rpc_self("Job.list", {"namespace": None, "region": "eu"})
    assert [j.id for j in jobs] == ["eu-only"]
    # unknown region is a clean error
    from nomad_tpu_torch.rpc import RPCError

    with pytest.raises(RPCError, match="no known servers"):
        us.rpc_self("Job.list", {"namespace": None, "region": "ap"})


def test_http_region_param_forwards(two_regions, tmp_path):
    """The HTTP surface addresses a federated region with ?region=
    (CLI -region / SDK region ride this)."""
    from nomad_tpu_torch.agent.http import HTTPAgentServer
    from nomad_tpu_torch.api.client import NomadClient

    us, eu = two_regions
    http = HTTPAgentServer(us)
    http.start()
    try:
        api_eu = NomadClient(
            f"http://127.0.0.1:{http.addr[1]}", region="eu"
        )
        api_eu.jobs.register(mock.job(id="via-http"))
        assert wait_until(
            lambda: eu.server.state.job_by_id("default", "via-http"), 5
        )
        assert us.server.state.job_by_id("default", "via-http") is None
        got = api_eu.jobs.get("via-http")
        assert got.id == "via-http", "reads forward too"
        # and the regions listing serves federation discovery
        api = NomadClient(f"http://127.0.0.1:{http.addr[1]}")
        assert api.status.regions() == ["eu", "us"]
    finally:
        http.shutdown()


def test_cross_region_requires_target_region_token(two_regions):
    """Federated ACL: the target region re-authorizes the forwarded
    token against ITS OWN acl state (tokens are region-local unless the
    operator creates them in both regions — the reference's non-global
    token semantics)."""
    us, eu = two_regions
    eu.acl_enforce = True
    # a request forwarded from us with no/unknown token must be denied
    with pytest.raises(Exception, match="token"):
        us.rpc_self(
            "Job.register",
            {
                "job": mock.job(id="sneak"),
                "region": "eu",
                "__cross_region_token__": "",
            },
        )
    assert eu.server.state.job_by_id("default", "sneak") is None
    # a management token minted IN eu authorizes
    from nomad_tpu_torch.acl.structs import ACLToken

    tok = ACLToken.new(name="eu-mgmt", type="management")
    eu.server.raft_apply("acl_token_upsert", [tok])
    us.rpc_self(
        "Job.register",
        {
            "job": mock.job(id="legit"),
            "region": "eu",
            "__cross_region_token__": tok.secret_id,
        },
    )
    assert eu.server.state.job_by_id("default", "legit") is not None


@pytest.fixture
def replicated_regions():
    """us = authoritative; eu replicates ACL state from it
    (reference leader.go:1282,1423)."""
    us = ClusterServer(
        "us-1", port=0, num_workers=1, region="us", bootstrap_expect=1,
        authoritative_region="us",
    )
    eu = ClusterServer(
        "eu-1", port=0, num_workers=1, region="eu", bootstrap_expect=1,
        authoritative_region="us", acl_replication_interval_s=0.1,
    )
    us.start()
    eu.start()
    assert wait_until(lambda: us.is_leader(), 10)
    assert wait_until(lambda: eu.is_leader(), 10)
    eu.join([us.rpc.addr])
    assert wait_until(
        lambda: any(m.id == "us-1" for m in eu.serf.members())
        and any(m.id == "eu-1" for m in us.serf.members()),
        10,
    )
    yield us, eu
    _settle(us, eu)
    eu.shutdown()
    us.shutdown()


def test_acl_replication_us_token_authorizes_in_eu(replicated_regions):
    """The VERDICT r4 item-4 done-criterion: an eu-submitted job
    authorizes via a us-minted, replicated GLOBAL token."""
    from nomad_tpu_torch.acl.structs import ACLPolicy, ACLToken

    us, eu = replicated_regions
    us.acl_enforce = True
    eu.acl_enforce = True
    # mint policy + global client token in the AUTHORITATIVE region
    us.server.acl_policy_upsert([
        ACLPolicy(
            name="submitter",
            rules='namespace "default" { policy = "write" }',
        )
    ])
    tok = ACLToken.new(name="ci", type="client", policies=["submitter"])
    tok.global_ = True
    us.server.raft_apply("acl_token_upsert", [tok])
    # a local (non-global) us token must NOT replicate
    local_tok = ACLToken.new(name="us-only", type="client",
                             policies=["submitter"])
    us.server.raft_apply("acl_token_upsert", [local_tok])

    assert wait_until(
        lambda: eu.server.state.acl_token_by_accessor(tok.accessor_id)
        is not None,
        10,
    ), "global token should replicate to eu"
    assert eu.server.state.acl_policy_by_name("submitter") is not None
    assert (
        eu.server.state.acl_token_by_accessor(local_tok.accessor_id) is None
    ), "non-global tokens are region-local"

    # an eu-submitted job (forwarded from us) authorizes via the
    # replicated token against EU's OWN acl state
    us.rpc_self(
        "Job.register",
        {
            "job": mock.job(id="replicated-auth"),
            "region": "eu",
            "__cross_region_token__": tok.secret_id,
        },
    )
    assert eu.server.state.job_by_id("default", "replicated-auth") is not None

    # revocation replicates too: delete in us, eu converges to deny
    us.server.acl_token_delete([tok.accessor_id])
    assert wait_until(
        lambda: eu.server.state.acl_token_by_accessor(tok.accessor_id)
        is None,
        10,
    ), "token deletion should replicate"


def test_global_token_create_routes_to_authoritative(replicated_regions):
    """A global token minted via the NON-authoritative region lands in
    the authoritative region's raft and replicates back (reference
    acl_endpoint.go global-token forwarding)."""
    from nomad_tpu_torch.acl.structs import ACLPolicy, ACLToken

    us, eu = replicated_regions
    us.server.acl_policy_upsert([
        ACLPolicy(name="p", rules='namespace "default" { policy = "read" }')
    ])
    req = ACLToken(name="made-in-eu", type="client", policies=["p"])
    req.global_ = True
    created = eu.rpc_self("ACL.token_create", {"token": req})
    assert created is not None
    assert wait_until(
        lambda: us.server.state.acl_token_by_accessor(created.accessor_id)
        is not None,
        5,
    ), "global token must live in the authoritative region"
    assert wait_until(
        lambda: eu.server.state.acl_token_by_accessor(created.accessor_id)
        is not None,
        10,
    ), "and replicate back to eu"
