"""Agent: HTTP API + embedded server/client (reference command/agent/).

Port of ``nomad_tpu/agent/__init__.py``.
"""

from .agent import Agent, AgentConfig
from .http import HTTPAgentServer

__all__ = ["Agent", "AgentConfig", "HTTPAgentServer"]
