"""Python SDK over the HTTP API (reference: api/ Go SDK, 19k LoC — one
resource group per class here like one file per resource there; port
of ``nomad_tpu/api``)."""

from .client import APIError, NomadClient

__all__ = ["APIError", "NomadClient"]
