"""ACL system (reference: acl/ + nomad/acl.go; port of
``nomad_tpu/acl``): the policy and token records, the policy DSL and the
compiled ACL. The HTTP route table (``nomad_tpu/acl/enforce.py``) comes
with the agent."""

from .acl import ACL, ACLError, compile_policies
from .policy import (
    CAP_DENY,
    NAMESPACE_CAPABILITIES,
    Policy,
    parse_policy,
)
from .structs import ACLPolicy, ACLToken

__all__ = [
    "ACL",
    "ACLError",
    "ACLPolicy",
    "ACLToken",
    "CAP_DENY",
    "NAMESPACE_CAPABILITIES",
    "Policy",
    "compile_policies",
    "parse_policy",
]
