"""Jobspec DSL (reference: jobspec/ + jobspec2/; port of
``nomad_tpu/jobspec``): the HCL2-subset parser and the stanza mapping
from an HCL body to a Job."""

from .hcl import Body, HCLParseError, parse, parse_duration
from .parse import JobspecError, parse_job

__all__ = [
    "Body",
    "HCLParseError",
    "JobspecError",
    "parse",
    "parse_duration",
    "parse_job",
]
