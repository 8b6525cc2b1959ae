"""The HCL2-subset parser (port of ``nomad_tpu/jobspec/hcl.py``).

The ACL policy DSL (``acl/policy.py``) parses its rules with it. The
jobspec front end above it (``nomad_tpu/jobspec/parse.py``) is not
ported yet.
"""

from .hcl import Body, HCLParseError, parse, parse_duration

__all__ = ["Body", "HCLParseError", "parse", "parse_duration"]
