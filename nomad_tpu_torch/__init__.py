"""nomad_tpu_torch — the batch placement path of nomad_tpu in PyTorch.

A port of the JAX package ``nomad_tpu`` to PyTorch and CUDA for NVIDIA
Hopper cards. It keeps ``nomad_tpu``'s layout and names so each module's
counterpart is found at the same path:

  structs/        shared vocabulary (Job, Node, Allocation, Evaluation, Plan)
  state/          in-memory state store with the per-node usage aggregate,
                  and its writes as stream events (state/events.py)
  scheduler/      reconcile, feasibility, and the batch solver (scheduler/gpu)
  server/         the scheduling pipeline, the job lifecycle (plan, the
                  deployment watcher, the node drainer, periodic jobs),
                  tenancy and the cluster tables (namespaces, ACL, volumes
                  and the volume watcher, services, secrets and task
                  tokens, search, the alloc watch hub), gossip
                  membership, the solver pool
  acl/            ACL policies and tokens, the policy DSL, the compiled ACL,
                  the HTTP route table
  stream/         the event broker
  jobspec/        the HCL2-subset parser and the jobspec -> Job mapping
  agent/ api/     a server agent with its HTTP API, the Python SDK
  cli/            the command line (`python -m nomad_tpu_torch.cli`)
  connect/        the Connect admission hook and its sidecar relay
  rpc/            the TCP fabric the pool and membership speak over
  mock/ testing/  factories and the in-memory scheduling harness
  csrc/           the hand-written CUDA kernels the solver launches

The solver runs on ``SchedulerConfig.device`` ("cuda" unless the caller
asks for "cpu"); on a CPU tensor every kernel wrapper runs its plain
PyTorch twin instead.
"""

__version__ = "0.1.0"
