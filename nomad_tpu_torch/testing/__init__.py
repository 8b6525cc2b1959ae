from . import chaos  # noqa: F401  (scenario harness + fault-plane re-export)
from .harness import Harness, RejectPlanHarness
from .waits import wait_for_state
