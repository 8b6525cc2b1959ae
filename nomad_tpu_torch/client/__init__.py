"""Port of ``nomad_tpu/client/__init__.py``."""

from .allocrunner import AllocRunner
from .client import Client, ServerRPC
from .fingerprint import fingerprint_node
from .restarts import RestartTracker
from .taskrunner import TaskRunner
