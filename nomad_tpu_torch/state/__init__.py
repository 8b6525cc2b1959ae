from .store import (
    ALL_TABLES,
    JobSummary,
    StateSnapshot,
    StateSnapshotImpl,
    StateStore,
    TABLE_ALLOCS,
    TABLE_DEPLOYMENTS,
    TABLE_EVALS,
    TABLE_JOBS,
    TABLE_NODES,
)
