"""ACL policy DSL.

Reference: acl/policy.go — HCL rules like:

    namespace "default" {
      policy = "write"
    }
    namespace "ops-*" {
      policy       = "read"
      capabilities = ["submit-job"]
    }
    node    { policy = "read" }
    agent   { policy = "write" }
    operator { policy = "read" }
    plugin  { policy = "list" }

Shorthand policies expand to capability sets exactly as the reference's
expandNamespacePolicy (acl/policy.go:92).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..jobspec.hcl import parse as parse_hcl

# Namespace capabilities (reference acl/policy.go:37-66)
CAP_DENY = "deny"
CAP_LIST_JOBS = "list-jobs"
CAP_READ_JOB = "read-job"
CAP_SUBMIT_JOB = "submit-job"
CAP_DISPATCH_JOB = "dispatch-job"
CAP_READ_LOGS = "read-logs"
CAP_READ_FS = "read-fs"
CAP_ALLOC_EXEC = "alloc-exec"
CAP_ALLOC_LIFECYCLE = "alloc-lifecycle"
CAP_SCALE_JOB = "scale-job"
CAP_ALLOC_NODE_EXEC = "alloc-node-exec"
# embedded secrets store (the Vault-analog; reference: Nomad variables
# ACL + vault policy scoping). NOT granted by the "read" shorthand — a
# read-only token must not see secret values unless explicitly given.
CAP_READ_SECRET = "read-secret"
CAP_WRITE_SECRET = "write-secret"

NAMESPACE_CAPABILITIES = [
    CAP_DENY,
    CAP_LIST_JOBS,
    CAP_READ_JOB,
    CAP_SUBMIT_JOB,
    CAP_DISPATCH_JOB,
    CAP_READ_LOGS,
    CAP_READ_FS,
    CAP_ALLOC_EXEC,
    CAP_ALLOC_LIFECYCLE,
    CAP_SCALE_JOB,
    CAP_ALLOC_NODE_EXEC,
    CAP_READ_SECRET,
    CAP_WRITE_SECRET,
]

_READ_CAPS = [CAP_LIST_JOBS, CAP_READ_JOB]
_WRITE_CAPS = _READ_CAPS + [
    CAP_SUBMIT_JOB,
    CAP_DISPATCH_JOB,
    CAP_READ_LOGS,
    CAP_READ_FS,
    CAP_ALLOC_EXEC,
    CAP_ALLOC_LIFECYCLE,
    CAP_SCALE_JOB,
    CAP_READ_SECRET,
    CAP_WRITE_SECRET,
]

POLICY_DENY = "deny"
POLICY_READ = "read"
POLICY_WRITE = "write"
POLICY_LIST = "list"
POLICY_SCALE = "scale"


class PolicyError(Exception):
    pass


@dataclass
class NamespacePolicy:
    name: str  # may contain glob '*'
    policy: str = ""
    capabilities: list[str] = field(default_factory=list)


@dataclass
class Policy:
    namespaces: list[NamespacePolicy] = field(default_factory=list)
    node: str = ""  # deny | read | write
    agent: str = ""
    operator: str = ""
    plugin: str = ""  # deny | list | read


def expand_namespace_policy(policy: str) -> list[str]:
    if policy == POLICY_DENY:
        return [CAP_DENY]
    if policy == POLICY_READ:
        return list(_READ_CAPS)
    if policy == POLICY_WRITE:
        return list(_WRITE_CAPS)
    if policy == POLICY_SCALE:
        return [CAP_SCALE_JOB, CAP_LIST_JOBS, CAP_READ_JOB]
    raise PolicyError(f"invalid namespace policy {policy!r}")


def parse_policy(rules: str) -> Policy:
    """Parse HCL rules text into a Policy (reference acl/policy.go:237)."""
    try:
        body = parse_hcl(rules)
    except Exception as e:
        raise PolicyError(f"failed to parse policy: {e}") from None
    pol = Policy()
    for blk in body.blocks("namespace"):
        name = blk.labels[0] if blk.labels else "default"
        a = blk.body.attrs()
        np = NamespacePolicy(
            name=name,
            policy=a.get("policy", ""),
            capabilities=[str(c) for c in a.get("capabilities", [])],
        )
        if np.policy:
            if np.policy not in (
                POLICY_DENY,
                POLICY_READ,
                POLICY_WRITE,
                POLICY_SCALE,
            ):
                raise PolicyError(f"invalid namespace policy {np.policy!r}")
        for c in np.capabilities:
            if c not in NAMESPACE_CAPABILITIES:
                raise PolicyError(f"invalid namespace capability {c!r}")
        pol.namespaces.append(np)
    for key in ("node", "agent", "operator"):
        blk = body.block(key)
        if blk is not None:
            p = blk.body.attrs().get("policy", "")
            if p not in (POLICY_DENY, POLICY_READ, POLICY_WRITE):
                raise PolicyError(f"invalid {key} policy {p!r}")
            setattr(pol, key, p)
    blk = body.block("plugin")
    if blk is not None:
        p = blk.body.attrs().get("policy", "")
        if p not in (POLICY_DENY, POLICY_LIST, POLICY_READ):
            raise PolicyError(f"invalid plugin policy {p!r}")
        pol.plugin = p
    return pol
