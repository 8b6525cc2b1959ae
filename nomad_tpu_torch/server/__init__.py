"""The server's scheduling pipeline (port of ``nomad_tpu.server``).

Evals flow ``Server.job_register`` → FSM → :class:`EvalBroker` → a
:class:`Worker` (one eval at a time) or the :class:`TPUBatchWorker`
(batches solved on the card, committed on a second thread) →
:class:`PlanQueue` → :class:`PlanApplier` (verification, then the raft
apply) → the state store. Host code: nothing here imports torch; the
batch worker reaches the card through ``scheduler.gpu`` at its first
solve. The job lifecycle's leader subsystems (:class:`DeploymentsWatcher`,
:class:`NodeDrainer`, :class:`PeriodicDispatch`) and ``job_plan`` are host
code too, as are the tenancy and cluster tables' pieces: the
:class:`VolumeWatcher`, the :class:`AllocWatchHub`, the
:class:`NodeRegisterBatcher` and ``search``.
"""

from .blocked_evals import BlockedEvals
from .core_sched import CoreScheduler, core_eval
from .deployment_watcher import DeploymentsWatcher
from .drainer import NodeDrainer
from .eval_broker import EvalBroker
from .heartbeat import HeartbeatWheel, rate_scaled_interval
from .periodic import CronSpec, PeriodicDispatch, next_launch
from .plan_apply import PlanApplier, evaluate_node_plan, evaluate_plan
from .plan_queue import PlanQueue
from .raft import FSM, InmemLog
from .search import fuzzy_search, prefix_search
from .server import ConflictError, NodeRegisterBatcher, Server
from .volume_watcher import VolumeWatcher
from .watch_hub import AllocWatchHub
from .worker import TPUBatchWorker, Worker, WorkerPlanner
