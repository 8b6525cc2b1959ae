from .factories import (
    alloc,
    batch_job,
    eval_for_job,
    evaluation,
    job,
    node,
    system_job,
    sysbatch_job,
)
